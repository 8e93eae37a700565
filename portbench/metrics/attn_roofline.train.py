"""attn_roofline.train: the window-attention kernels' bound (the larger of
their counted FLOPs over the bf16 peak and bytes over the HBM rate,
core/counts.py) over their device time in the traced sub-window.
Layer: window attention (K1 and K2)."""
from portbench.core.peaks import bound_ms


def read(s):
    t = s.get("layer_s", {}).get("attention", 0.0)
    if s.get("entry") != "train" or t <= 0 or not s.get("attn_flops"):
        return None
    ms, _ = bound_ms(s["attn_bytes"], s["attn_flops"], "bf16")
    return 100.0 * ms / (t * 1e3)
