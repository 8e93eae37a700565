"""launches_per_submap.serve: device kernel launches in the traced
sub-window per submap (copies and fills left out). Layer: the entry's
Python dispatch."""


def read(s):
    if s.get("entry") != "serve" or not s.get("submaps"):
        return None
    return s["kernels"] / s["submaps"]
