"""Imported first by every tests/test_torch_*.py: one intra-op thread per
test process.

Under ``pytest -n N`` each worker's torch otherwise starts one intra-op
thread per core, so N workers spin N x cores threads over the cores and
a test that takes 16 s alone took over 400 s beside five others. The
tests' sizes and tolerances are untouched; only the thread count is."""
import torch

torch.set_num_threads(1)
