"""Data parallelism over torch.distributed.

Counterpart of hotformerloc_tpu/parallel/mesh.py. The JAX package shards
each global batch over a 1-D 'data' mesh and lets XLA insert the
embedding all-gather the metric loss needs. Here every rank is one
process on one card (as ``torchrun`` starts them): it loads its own rows
of each global batch in the JAX step's microbatch layout (``local_rows``:
its 1/n share of every global microbatch; ``DataLoader(process_index=
rank, process_count=world, micro_batches=accum_steps)``), and the train
step gathers the embeddings and mask rows explicitly
(``training/step.py``), so the loss sees the full (B, B) affinity and
mines hard negatives across every rank. The norms' batch statistics are
summed over the ranks inside the forward (``all_reduce_sum_diff``,
``all_reduce_sum``), so they are those of the whole global microbatch,
as under JAX's mesh.

``group`` arguments: None means one process without a process group;
every helper is then the identity (``rank`` 0, ``world`` 1). A group of
size 1 runs the real collectives.

Backends: NCCL on the card (``cuda:LOCAL_RANK``), gloo on the CPU. Gloo
also carries CUDA tensors where several ranks share one card, which
NCCL refuses: every collective here then copies its CUDA tensor to the
host and back (``_staged``), explicitly and only for gloo. NCCL never
stages, and nothing falls back from one backend to the other.
"""
from __future__ import annotations

import glob
import os
import signal
import socket
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def env_world() -> int:
    """WORLD_SIZE as ``torchrun`` sets it; 1 when it is not set."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_from_env(device="cuda", backend: Optional[str] = None
                  ) -> Tuple[dist.ProcessGroup, torch.device]:
    """Join the process group that ``torchrun`` describes in RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. On the card the
    backend is NCCL and the rank's device ``cuda:LOCAL_RANK``; on the
    CPU (``device="cpu"``) gloo. ``backend`` overrides the choice: gloo
    on the card lets ranks share cards, which NCCL refuses (local rank
    l takes card l mod the card count, so every rank takes card 0 on a
    one-card host). Returns (the world group, the rank's device)."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if backend == "gloo":
            local %= torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    addr = os.environ.get("MASTER_ADDR", "localhost")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    return dist.group.WORLD, dev


def close(group: Optional[dist.ProcessGroup]) -> None:
    """Leave the process group ``init_from_env`` joined (None: nothing)."""
    if group is not None:
        dist.destroy_process_group()


def rank(group: Optional[dist.ProcessGroup] = None) -> int:
    return 0 if group is None else dist.get_rank(group)


def world(group: Optional[dist.ProcessGroup] = None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a collective of ``t`` goes through the host: a CUDA
    tensor on the gloo backend."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_rows(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along
    dim 0 in rank order (the global batch when rank r holds rows
    r·b .. (r+1)·b, as in a single pass or an evaluation; see
    ``all_gather_micro`` for the microbatch layout). Not
    differentiable: callers gather detached tensors."""
    if group is None:
        return x
    host = _staged(group, x)
    src = (x.cpu() if host else x).contiguous()
    is_bool = src.dtype == torch.bool
    if is_bool:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(world(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    if is_bool:
        out = out.view(torch.bool)
    return out.to(x.device) if host else out


def all_reduce_sum_(tensors: Sequence[torch.Tensor],
                    group: Optional[dist.ProcessGroup] = None) -> None:
    """Sum ``tensors`` over the ranks in place, as one flattened fp32
    buffer (one collective). Every rank ends with the same bits."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    host = _staged(group, flat)
    buf = flat.cpu() if host else flat
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if host:
        flat = buf.to(flat.device)
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view(t.shape))
            off += n


def _summed(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """A new tensor: ``x`` summed over the ranks of ``group``."""
    host = _staged(group, x)
    buf = (x.detach().cpu() if host else x.detach()).clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device) if host else buf


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient over
    the ranks (SyncBatchNorm's rule: every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g.contiguous(), ctx.group), None


def all_reduce_sum_diff(x: torch.Tensor,
                        group: Optional[dist.ProcessGroup] = None
                        ) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably: the gradient of each
    rank's ``x`` is the sum of every rank's gradient of the result. At
    world 1 (or without a group) ``x`` itself, with no collective."""
    if world(group) <= 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None
                   ) -> torch.Tensor:
    """``x`` summed over the ranks, outside autograd (the result has no
    gradient). At world 1 (or without a group) ``x`` itself, with no
    collective."""
    if world(group) <= 1:
        return x
    return _summed(x, group)


def all_gather_micro(x: torch.Tensor, accum: int,
                     group: Optional[dist.ProcessGroup] = None
                     ) -> torch.Tensor:
    """The global batch in its own row order from every rank's rows of
    it, in the microbatch layout (``local_rows``): rank r holds rows
    i·mb + r·lb .. i·mb + (r+1)·lb of each global microbatch i, stacked
    microbatch by microbatch. Not differentiable."""
    if group is None:
        return x
    n, lb = world(group), x.shape[0] // accum
    every = all_gather_rows(x, group)
    return every.view(n, accum, lb, *x.shape[1:]).transpose(0, 1) \
        .reshape(n * x.shape[0], *x.shape[1:])


def local_rows(total: int, accum: int, index: int, count: int
               ) -> np.ndarray:
    """The global rows of a batch of ``total`` rows that rank ``index`` of
    ``count`` holds in the microbatch layout: ``accum`` global
    microbatches of mb = total / accum rows (rows i·mb .. (i+1)·mb - 1,
    as the JAX step reshapes the batch to (accum, mb)), each split into
    ``count`` equal runs, run r going to rank r. Microbatch i of the
    rank is then its local rows i·lb .. (i+1)·lb - 1, lb = mb / count."""
    if total % (accum * count):
        raise ValueError(f"a batch of {total} does not split into "
                         f"{accum} microbatches over {count} ranks")
    mb = total // accum
    lb = mb // count
    return (np.arange(accum)[:, None] * mb + index * lb
            + np.arange(lb)[None]).reshape(-1)


def any_rank(flag: bool, device, group: Optional[dist.ProcessGroup] = None
             ) -> bool:
    """True on every rank when ``flag`` is true on any."""
    if group is None:
        return flag
    t = torch.tensor([float(flag)], device=device)
    all_reduce_sum_([t], group)
    return bool(t.item() > 0)


def barrier(group: Optional[dist.ProcessGroup] = None) -> None:
    if group is not None:
        dist.barrier(group=group)


def broadcast_module_(module: torch.nn.Module, src: int = 0,
                      group: Optional[dist.ProcessGroup] = None) -> None:
    """Overwrite every parameter and buffer of ``module`` with rank
    ``src``'s, one flattened buffer per dtype."""
    if group is None:
        return
    by_dtype = {}
    for t in [*module.parameters(), *module.buffers()]:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            host = _staged(group, flat)
            buf = flat.cpu() if host else flat
            dist.broadcast(buf, src, group=group)
            off = 0
            for t in ts:
                n = t.numel()
                t.copy_(buf[off:off + n].view(t.shape))
                off += n


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun(argv: Sequence[str], processes: int, log_dir: str,
             timeout: Optional[float] = None, env: Optional[dict] = None,
             cwd: Optional[str] = None) -> List[str]:
    """Run ``argv`` (a script and its arguments, or ``-m module ...``)
    as ``processes`` ranks on this host under torchrun (``python -m
    torch.distributed.run --standalone``), each rank's output redirected
    into ``log_dir``, and return each rank's output. The ranks run in
    ``cwd`` (this process's when None). Raises, after stopping torchrun
    and every rank, if a rank fails or ``timeout`` seconds pass."""
    log_dir = os.path.abspath(log_dir)     # torchrun may run in cwd
    os.makedirs(log_dir, exist_ok=True)
    agent_log = os.path.join(log_dir, "torchrun.log")
    with open(agent_log, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(processes), "--log-dir", log_dir,
             "--redirects", "3", *argv],
            stdout=log, stderr=subprocess.STDOUT, cwd=cwd, env=env,
            start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = f"timeout after {timeout} s"
    finally:
        try:                    # torchrun's agent and ranks: one session
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()

    def read(path):             # a rank torchrun never started has none
        if not os.path.exists(path):
            return ""
        with open(path) as f:
            return f.read()

    runs = sorted(glob.glob(os.path.join(log_dir, "*", "attempt_0")),
                  key=os.path.getmtime)
    outs = [read(os.path.join(runs[-1], str(r), "stdout.log"))
            + read(os.path.join(runs[-1], str(r), "stderr.log"))
            if runs else "" for r in range(processes)]
    if rc != 0:
        raise RuntimeError(
            f"torchrun of {' '.join(argv)} ended with {rc}:\n"
            + read(agent_log)[-3000:] + "".join(
                f"--- rank {r}\n{o[-3000:]}" for r, o in enumerate(outs)))
    return outs
