"""mfu.train: the model's counted FLOPs in the traced sub-window
(core/counts.py) over its seconds, as a share of the H100's bf16 peak.
Layer: the model step."""
from portbench.core.peaks import H100_PEAK_FLOPS


def read(s):
    if s.get("entry") != "train" or not s.get("model_flops") \
            or s["window_s"] <= 0:
        return None
    return 100.0 * s["model_flops"] / s["window_s"] / H100_PEAK_FLOPS["bf16"]
