# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0
