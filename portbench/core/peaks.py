"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W) and the roofline bound.

Frozen copy of hotformerloc_torch/utils/profiling.py's H100 peaks and
``bound_ms`` (commit 17534d0), with the bf16 rate the share of peak
is taken against.
"""
from __future__ import annotations

H100_BYTES_S = 3.35e12
H100_PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    """(ms, "bytes" or "operations"): the least time an H100 could take
    for work that moves ``nbytes`` and does ``flops`` operations of
    ``dtype`` ("fp32" or "bf16"), the larger of the two times."""
    tb, tf = nbytes / H100_BYTES_S, flops / H100_PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"
