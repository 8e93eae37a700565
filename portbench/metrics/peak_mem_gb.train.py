"""peak_mem_gb.train: the card's peak of allocated memory over the run
(``torch.cuda.max_memory_allocated``), in GB. Layer: the device (what
the checkpoint policy trades)."""


def read(s):
    if s.get("entry") != "train" or not s.get("peak_mem_bytes"):
        return None
    return s["peak_mem_bytes"] / 1e9
