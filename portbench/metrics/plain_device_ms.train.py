"""plain_device_ms.train: device ms per submap of every kernel, copy and
fill that is neither window attention nor an octree conv, in the traced
sub-window. Layer: the plain layers (MLPs, norms, RTSA, pooling,
down-convs, loss, optimizer)."""


def read(s):
    t = s.get("layer_s", {}).get("plain", 0.0)
    if s.get("entry") != "train" or t <= 0 or not s.get("submaps"):
        return None
    return t * 1e3 / s["submaps"]
