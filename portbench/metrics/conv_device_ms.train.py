"""conv_device_ms.train: device ms per submap of the octree-conv kernels
(K3-K6 and their partial sums) in the traced sub-window. Layer: the
octree convs (stem, CPE)."""


def read(s):
    t = s.get("layer_s", {}).get("conv", 0.0)
    if s.get("entry") != "train" or t <= 0 or not s.get("submaps"):
        return None
    return t * 1e3 / s["submaps"]
