"""Serve cells: ``make_embed_fn(model, bf16)`` called on each batch,
batches arriving in an open loop at the traffic file's fixed ``rate``
(batches a second; about four fifths of the highest rate the cell
sustains, measured once on the card in a closed loop). At that load the
end-to-end metric is the tail of the batches' latency: the rate served
is the rate offered, whatever the program's speed.

A batch is a pool entry in pinned host memory: copied to the card,
embedded, its ``global`` descriptors copied back to pinned host memory.
Batch k is due at k / rate after the window opens and starts then, or
as soon as the one before has finished; its latency runs from its due
time to its descriptors on the host, so a stall counts against the
batches queued behind it. The window runs whole batches until
``seconds`` have passed. The traced sub-window serves batches back to
back, to read the layers' own costs.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench.core import counts, reference
from portbench.core.runner import Run


def run(r: Run) -> Dict:
    from hotformerloc_torch.evaluation.embed import make_embed_fn
    from hotformerloc_torch.models.config import ModelConfig
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc

    cfg = ModelConfig(**r.fields)
    model = HOTFormerLoc(cfg, device=r.device)
    r.load(model)
    r.mark("model")
    embed = r.hooks.get("embed", make_embed_fn)(
        model, getattr(torch, r.cell.workload["dtype"]))
    pool = r.pinned(r.pool["points"])
    P, B = pool.shape[:2]
    pmask = r.pinned(np.ones(pool.shape[1:3], dtype=bool))
    host = [r.pinned(np.empty((B, cfg.output_dim), np.float32)),
            r.pinned(np.zeros((), np.int64))]

    def serve(k: int):
        """Batch k of the traffic, queued: copy in, embed, copy out."""
        x = pool[k % P].to(r.device, non_blocking=True)
        m = pmask.to(r.device, non_blocking=True)
        out = embed(x, m)
        host[0].copy_(out["global"], non_blocking=True)
        host[1].copy_(out["octree_overflow"], non_blocking=True)

    for k in range(int(r.cell.workload.get("warmup_batches", 2))):
        serve(k)
    r.sync()
    r.end_setup()
    served, lat = [], []
    failed = overflow = 0
    rate = float(r.cell.traffic["rate"])
    late = 0.0                   # how late the generator started a batch
    t0 = time.perf_counter()
    k = 0
    while True:
        due = t0 + k / rate
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - due)
        serve(k)
        r.sync()
        te = time.perf_counter()
        lat.append(te - due)
        d = host[0].numpy().copy()
        served.append(d)
        overflow += int(host[1])
        if int(host[1]) > 0 or not np.isfinite(d).all():
            failed += 1
        k += 1
        if te - t0 >= r.seconds:
            break
    r.metric("serve_batch_p95_ms", float(np.percentile(lat, 95)) * 1e3, "ms")
    r.attempted, r.failed = k * B, failed * B
    # below the knee the served rate is the offered one: a note, no metric
    r.note(f"served {k * B / (te - t0):.2f} submaps/s of {rate * B:.2f} "
           f"offered, generator late by at most {late * 1e3:.2f} ms")

    if r.trace:
        n = int(r.cell.workload.get("trace_batches", 4))
        summary = r.profile(lambda i: serve(k + i), n)
        summary.update(entry="serve", submaps=n * B)
        traced = [(k + i) % P for i in range(n)]
    r.mark("window")
    r.read_peak()
    del embed, model
    r.free()

    ref_w = r.cell.workload["check"]
    if r.trace:
        pts = torch.from_numpy(r.pool["points"][traced]).to(r.device)
        lev = counts.level_counts(r.ref_fields_cfg(), pts.flatten(0, 1))
        tot = counts.batch_counts(r.ref_fields_cfg(), lev,
                                  list(range(n * B)))
        summary.update(model_flops=tot["flops"], attn_flops=tot["attn_flops"],
                       attn_bytes=tot["attn_bytes"])
        r.per_layer(summary)

    # the comparison: a sample of the served answers, drawn from the seed
    rng = np.random.default_rng([int(r.seed), 1])
    n = min(int(ref_w["sample"]), k * B)
    picks = rng.choice(k * B, size=n, replace=False)
    picks.sort()
    clouds = sorted({(int(i) // B) % P * B + int(i) % B for i in picks})
    ref = reference.build(r.fields, r.weights, r.device)
    pts = torch.from_numpy(r.pool["points"].reshape(P * B, -1, 3)[clouds]
                           ).to(r.device)
    ref_desc, ovf = reference.embed(ref, pts, int(ref_w["chunk"]))
    ref_desc = ref_desc.cpu().numpy()
    at = {c: i for i, c in enumerate(clouds)}
    gap = 0.0
    for i in picks:
        b, j = divmod(int(i), B)
        gap = max(gap, float(np.abs(served[b][j]
                                    - ref_desc[at[b % P * B + j]]).max()))
    r.compare("desc_max_abs", gap)
    r.compare("octree_overflow", float(overflow + ovf))
    r.mark("reference")
    return r.result()
