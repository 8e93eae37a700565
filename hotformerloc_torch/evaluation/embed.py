"""Serving entry point: points -> descriptors.

Counterpart of hotformerloc_tpu/training/step.py:make_embed_step as the
evaluator drives it (bf16 compute, evaluation/pnv_evaluate.py). On the
card a call shape's forward is replayed as one CUDA graph from its
second call on, so the host no longer launches its ~2000 kernels one by
one.
"""
from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
from hotformerloc_torch.utils import profiling

# Graphs one serving call holds: a shape seen twice is captured, and a
# caller serves one batch shape and at times a last partial batch.
MAX_GRAPHS = 4


def compute_dtype(device) -> torch.dtype:
    """The compute dtype of the train and evaluate entry points: bf16 on
    the card, fp32 on the CPU (as the JAX trainer picks per backend)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


class CudaGraphReplay:
    """``run()``, a forward that reads static input buffers, captured into
    one CUDA graph whose memory comes from ``pool``. Calling the object
    replays the graph and returns ``run``'s outputs: the graph's own
    tensors, overwritten by the next replay. A capture error raises."""

    def __init__(self, run: Callable[[], Dict[str, torch.Tensor]], pool):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = run()

    def __call__(self) -> Dict[str, torch.Tensor]:
        self.graph.replay()
        return self.outputs


def make_embed_fn(model: HOTFormerLoc, dtype: torch.dtype = torch.bfloat16,
                  graphs: bool = True, capture: Optional[Callable] = None
                  ) -> Callable[[torch.Tensor, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """Return ``embed(points, pmask, normals=None) -> {'global',
    'octree_overflow'}`` (``normals`` (B, P, 3) for the 'N' input
    feature) running ``model`` in ``dtype`` (a converted copy when the
    model's parameters have another dtype) under
    ``torch.inference_mode``. Inputs are moved to the model's device.
    cuDNN TF32 is switched off during the call so fp32 runs stay fp32.
    Each call is one ``hfl.embed`` span, the root of the model's spans.

    On a CUDA model, with ``graphs``, a call shape (the inputs' shapes and
    dtypes) runs eagerly on its first call, which loads the kernels and
    warms the allocator, and is captured on its second by
    ``capture(run, pool) -> replay`` (``CudaGraphReplay``; every graph in
    one memory pool). From then on a call of that shape copies its inputs
    into the graph's static buffers, replays it and returns copies of its
    outputs, so a result may be held across calls. At most
    ``MAX_GRAPHS`` graphs are held; the least recently used goes first.
    Calls stay eager with ``graphs`` False, on the CPU unless the caller
    gives a ``capture``, and while a ``profiling.counting()`` scope is
    open: counters keep references to the forward's tensors, and spans
    need the host's ranges."""
    params = next(model.parameters())
    m = model if params.dtype == dtype else copy.deepcopy(model).to(dtype)
    m.eval()
    device = params.device
    if not graphs:
        capture = None
    elif capture is None and device.type == "cuda":
        capture = CudaGraphReplay
    held: "OrderedDict[tuple, tuple]" = OrderedDict()   # key: (bufs, replay)
    seen = set()
    pool = None

    def forward(points, pmask, normals):
        return m(points, pmask, dtype=dtype, normals=normals)

    def graphed(inputs):
        """The call through a graph, or None where it runs eagerly."""
        nonlocal pool
        key = tuple((tuple(t.shape), t.dtype) if t is not None else None
                    for t in inputs)
        if key in held:
            held.move_to_end(key)
            bufs, replay = held[key]
            for b, t in zip(bufs, inputs):
                if b is not None:
                    b.copy_(t)
        elif key in seen:
            if pool is None and device.type == "cuda":
                pool = torch.cuda.graph_pool_handle()
            bufs = [None if t is None else t.to(device, copy=True)
                    for t in inputs]
            replay = capture(lambda: forward(*bufs), pool)
            seen.discard(key)
            held[key] = (bufs, replay)
            if len(held) > MAX_GRAPHS:
                held.popitem(last=False)
        else:
            seen.add(key)
            return None
        return {k: v.clone() for k, v in replay().items()}

    def embed(points: torch.Tensor, pmask: torch.Tensor,
              normals: Optional[torch.Tensor] = None):
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with profiling.annotate("hfl.embed"), torch.inference_mode():
                out = None
                if capture is not None and not profiling.counting_open():
                    out = graphed((points, pmask, normals))
                if out is None:
                    out = forward(points.to(device), pmask.to(device),
                                  None if normals is None
                                  else normals.to(device))
                return out
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    return embed
