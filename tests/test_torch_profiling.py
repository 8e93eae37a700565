"""``utils.profiling.device_ms`` on the CPU, where torch.profiler records
no device event: it profiles the window three times in all, counts the
two windows it took again in ``RETAKEN_WINDOWS`` (chip_smoke.py allows
for their extra kernel launches by that count), and then raises."""
import torch_threads  # noqa: F401  (first: one torch thread per worker)

import pytest
import torch

from hotformerloc_torch.utils import profiling


def test_device_ms_counts_retaken_windows_then_raises():
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(4)

    before = profiling.RETAKEN_WINDOWS
    with pytest.raises(RuntimeError, match="no device time"):
        profiling.device_ms(fn, iters=2)
    assert profiling.RETAKEN_WINDOWS - before == 2
    assert len(calls) == 1 + 3 * 2            # warm-up, then three windows
