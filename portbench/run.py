"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell's
files are found by the names in ``BENCHMARK.json`` (core/spec.py). Set-up
(imports, kernels built or loaded from ``hotformerloc_torch/build/``,
weights and traffic from the seed, warm-up of the cell's shapes) runs
until the first timed batch or step; then the window; then, with
``--trace 1``, a short profiled sub-window; then the comparison with the
plain reference (core/reference.py). The last line of standard output
is the result as one JSON object; the numbers compared, each beside its
limit, are also the last lines of standard error. Exits 2 without the
cards the cell asks for, 3 when a module of JAX or of the JAX package
was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hotformerloc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``hotformerloc_torch`` is not ``hotformerloc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches inside the checkout, at fixed paths
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.core import serve, train
    from portbench.core.runner import Run
    from portbench.core.spec import find_cell, load_benchmark

    cell = find_cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    r = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
            T_START)
    result = {"serve": serve.run, "train": train.run}[cell.entry](r)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("phases " + " ".join(f"{k} {v:.2f}" for k, v in r.marks.items()),
          file=sys.stderr)
    for line in r.notes:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
