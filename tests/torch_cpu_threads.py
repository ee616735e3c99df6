# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""One intra-op thread for the port's CPU tests.

Each ``tests/test_torch_*.py`` that runs the port on the CPU imports
``one_torch_thread``, an autouse fixture, into its namespace. The test
workers share the machine's cores, and PyTorch's default of one OpenMP
thread a core makes every worker's parallel regions spin against the
others': six workers running the port's files on an 8-core CPU took twice
the worker time with the default as with one thread each, at tensor
sizes that threads do not speed up.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's tests with one PyTorch intra-op thread, then restore."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
