// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// K3's kernels for f16 queries (paged_attention.cuh), compiled apart from
// the other query types' so that the sources build in parallel.

#include "paged_attention.cuh"

template cudaError_t conch::paged::launch_type<__half>(const conch::paged::PagedParams&, int, int, cudaStream_t);
