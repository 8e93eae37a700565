"""No module the harness loads is JAX's or the JAX package's, compared
by whole top-level name."""
import subprocess
import sys
import textwrap

from portbench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hotformerloc_tpu"}


def test_forbidden_names_compare_whole_top_level():
    sys.path.insert(0, str(spec.BENCH_DIR))
    import run
    saved = dict(sys.modules)
    try:
        sys.modules["hotformerloc_tpu_extra"] = sys
        sys.modules["jaxtyping"] = sys
        assert run.forbidden_modules() == [] or \
            set(run.forbidden_modules()) <= set(saved) & FORBIDDEN
        sys.modules["hotformerloc_tpu.models"] = sys
        assert "hotformerloc_tpu" in run.forbidden_modules()
    finally:
        for k in ("hotformerloc_tpu_extra", "jaxtyping",
                  "hotformerloc_tpu.models"):
            sys.modules.pop(k, None)


def test_a_run_loads_no_jax():
    """A whole tiny serve and train run on the CPU, in a fresh process:
    nothing of JAX or the JAX package is loaded."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        sys.path.insert(0, %r)
        import torch
        torch.set_num_threads(2)
        from helpers import run_cpu, tiny_cell, tiny_mesa_cell
        import run
        for cell in (tiny_cell("cswild-serve-b128"), tiny_mesa_cell()):
            assert run_cpu(cell)["attempted"] > 0
        bad = run.forbidden_modules()
        loaded = sorted({m.split(".")[0] for m in sys.modules})
        print("BAD", bad, "TOP", len(loaded))
    """) % (str(spec.ROOT), str(spec.BENCH_DIR / "tests"))
    env = {k: v for k, v in __import__("os").environ.items()}
    env["PYTHONPATH"] = str(spec.BENCH_DIR)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "BAD []" in p.stdout
