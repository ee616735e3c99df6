// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Native paged KV-cache block allocator for the serving engine: free list
// and refcounts with the semantics of conch_tpu_torch/serving/block_allocator.py.
// The engine takes it under CONCH_ENABLE_CPP_EXT=1 (conch_tpu_torch/native.py
// builds this file with g++ at first use).
//
// Opaque-handle C ABI for ctypes.

#include <cstdint>
#include <vector>

namespace {

struct Allocator {
  std::vector<int32_t> free_list;
  std::vector<int32_t> refcount;
};

}  // namespace

extern "C" {

void* conch_allocator_create(int64_t num_pages) {
  auto* a = new Allocator();
  a->free_list.reserve(num_pages);
  for (int64_t i = num_pages - 1; i >= 0; --i) a->free_list.push_back(static_cast<int32_t>(i));
  a->refcount.assign(num_pages, 0);
  return a;
}

void conch_allocator_destroy(void* handle) { delete static_cast<Allocator*>(handle); }

int64_t conch_allocator_num_free(void* handle) {
  return static_cast<Allocator*>(handle)->free_list.size();
}

// Returns page id, or -1 if exhausted.
int64_t conch_allocator_allocate(void* handle) {
  auto* a = static_cast<Allocator*>(handle);
  if (a->free_list.empty()) return -1;
  const int32_t page = a->free_list.back();
  a->free_list.pop_back();
  a->refcount[page] = 1;
  return page;
}

// Returns new refcount, or -1 on double free.
int64_t conch_allocator_free(void* handle, int64_t page) {
  auto* a = static_cast<Allocator*>(handle);
  if (a->refcount[page] <= 0) return -1;
  if (--a->refcount[page] == 0) a->free_list.push_back(static_cast<int32_t>(page));
  return a->refcount[page];
}

// Returns new refcount, or -1 if the page is not allocated (fork of a
// freed page would silently resurrect it while still on the free list).
int64_t conch_allocator_fork(void* handle, int64_t page) {
  auto* a = static_cast<Allocator*>(handle);
  if (a->refcount[page] <= 0) return -1;
  return ++a->refcount[page];
}

int64_t conch_allocator_refcount(void* handle, int64_t page) {
  return static_cast<Allocator*>(handle)->refcount[page];
}

}  // extern "C"
