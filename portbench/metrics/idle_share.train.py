"""idle_share.train: the share of the traced sub-window in which no
operation ran on the device (1 - union of the device's event intervals
over the sub-window's host-clock seconds). Layer: the device."""


def read(s):
    if s.get("entry") != "train" or s.get("window_s", 0) <= 0 \
            or s.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
