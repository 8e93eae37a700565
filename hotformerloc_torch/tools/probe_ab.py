"""Paired runs of the probe tools of two checkouts on one card: an A/B of
a change to the probe kernels against its parent.

Each run is a process of its own, started in that checkout with
``PYTHONPATH`` set to it, so it imports that checkout's package and
builds that checkout's kernels. The tool runs ``gather_bench`` (T1, T2),
``mosaic_probe constructs`` (T3) and ``mosaic_probe gather`` (T4's six
row gathers) in the order A B B A (``--rounds`` times), so a drift of
the card hits both sides alike, and writes every run's lines under
``--out`` (``<side><round><a|b>/``). The result is one JSON line
(also ``--out``/probe_ab.json): per side and probe line, the device ms of
each run (``device_ms``; on the CPU ``cpu_ms``), beside the lines'
library, plain and bound times from the same runs, and the median of
each over the runs (``median``). The constructs' ``floor`` line (the
card's floor: ``empty_device_ms``, ``*_copy_device_ms``,
``*_chain_device_ms``) comes from the checkouts whose tool prints each
key.

    python -m hotformerloc_torch.tools.probe_ab --a PARENT_DIR --b . \\
        --out ab_out
    python -m hotformerloc_torch.tools.probe_ab --a . --b . --device cpu \\
        --reps 1 --batch 1 --out /tmp/ab        # checks the path on the CPU
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

TOOLS = (("gather_bench", []), ("mosaic_probe", ["constructs"]),
         ("mosaic_probe", ["gather"]))
# the numbers of a tool's line kept per run
KEYS = ("device_ms", "cpu_ms", "library_device_ms", "plain_device_ms",
        "bound_ms", "cluster", "slice", "active_clusters", "body",
        "empty_device_ms", "warp_copy_device_ms", "grid_copy_device_ms",
        "warp_chain_device_ms", "grid_chain_device_ms")


def out_file(tool: str, argv: list) -> str:
    """The JSON file a run of ``tool`` with ``argv`` writes under --out."""
    return ("gather_bench.json" if tool == "gather_bench"
            else f"mosaic_probe_{argv[0]}.json")


def tool_lines(tool: str, argv: list, data: dict) -> dict:
    """{probe line name: line} of a run's JSON file ``data``."""
    if tool == "gather_bench":
        return data["results"]
    key = "construct" if argv[0] == "constructs" else "probe"
    return {ln[key]: ln for ln in data["lines"]}


def run_tool(tree: str, tool: str, argv: list, out: str) -> dict:
    """Run one probe tool in ``tree``; returns {probe line name: line}."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    cmd = [sys.executable, "-m", f"hotformerloc_torch.tools.{tool}", *argv,
           "--out", os.path.abspath(out)]
    subprocess.run(cmd, cwd=tree, env=env, check=True)
    with open(os.path.join(out, out_file(tool, argv))) as fh:
        return tool_lines(tool, argv, json.load(fh))


def summarise(runs: list) -> dict:
    """{side: {probe: {key: [value per run]}}} from [(side, lines)]."""
    out: dict = {}
    for side, lines in runs:
        for probe, ln in lines.items():
            ent = out.setdefault(side, {}).setdefault(probe, {})
            for k in KEYS:
                if k in ln:
                    ent.setdefault(k, []).append(ln[k])
    return out


def medians(summary: dict) -> dict:
    """{side: {probe: {key: median over runs}}} of ``summarise``'s
    numeric lists."""
    return {side: {probe: {k: statistics.median(v) for k, v in ent.items()
                           if all(isinstance(e, (int, float)) for e in v)}
                   for probe, ent in probes.items()}
            for side, probes in summary.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", required=True, help="checkout B (the change)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    common = ["--device", args.device, "--reps", str(args.reps)]
    runs = []
    for r in range(args.rounds):
        for i, side in enumerate("abba"):
            tree = args.a if side == "a" else args.b
            lines = {}
            for tool, extra in TOOLS:
                argv_t = [*extra, *common]
                if tool == "gather_bench":
                    argv_t += ["--batch", str(args.batch)]
                lines.update(run_tool(tree, tool, argv_t, os.path.join(
                    args.out, f"{side}{r}{'ab'[i // 2]}")))
            runs.append((side, lines))
    summary = summarise(runs)
    result = {"order": "abba" * args.rounds, "a": os.path.abspath(args.a),
              "b": os.path.abspath(args.b), "device": args.device,
              "runs": summary, "median": medians(summary)}
    with open(os.path.join(args.out, "probe_ab.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
