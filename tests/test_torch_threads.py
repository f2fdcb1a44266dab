# SPDX-License-Identifier: Apache-2.0
"""A module-scoped autouse fixture that runs torch's CPU ops on one thread.

The port's tests run many small CPU ops (the quantizer's refinement loop
above all). When several test processes share the host's cores, torch's
default thread pool spends far longer waiting at its barriers than
computing: quantizing the trained checkpoint's two first blocks took 64 s on
8 threads and 1.6 s on one, beside five busy processes. Import it into a
test module to use it there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_torch_thread_inside_a_module():
    assert torch.get_num_threads() == 1
