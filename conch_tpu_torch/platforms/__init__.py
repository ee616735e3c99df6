# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

from conch_tpu_torch.platforms.platform import Platform, current_platform, resolve_device

__all__ = ["Platform", "current_platform", "resolve_device"]
