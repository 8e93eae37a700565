"""BENCHMARK.json and the files it names: every configuration, traffic,
cell and metric file parses and is found by name, the entries keep to
the benchmark's contract, and a new cell is files and an entry."""
import json
import re
import shutil

import pytest

from portbench.core import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "portbench" / "run.py").exists()


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.find_cell(BENCH, name)
    assert cell.entry in ("serve", "train")
    assert cell.config["model"] and cell.traffic["batch"] > 0
    limits = set(cell.workload["limits"])
    if cell.entry == "serve":
        assert limits == {"desc_max_abs", "octree_overflow"}
    else:            # the first gradient and the parameters' change
        assert {"grad_diff", "delta_gap"} <= limits
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:         # each moves a metric the cell reports
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]))


def test_config_files_are_their_configs():
    from hotformerloc_torch.models import config as mc
    for c in BENCH["configs"]:
        fields = spec.model_fields(spec.load_json(spec.ROOT / c["file"]))
        assert mc.ModelConfig(**fields).resolve_capacities()
    ox = spec.model_fields(spec.load_json(spec.ROOT / BENCH["configs"][0][
        "file"]))
    assert mc.ModelConfig(**ox) == mc.oxford_config()


def test_new_cell_is_files_and_an_entry(tmp_path):
    """A later cell adds a traffic file, a workload file, a metric reader
    and BENCHMARK.json entries; no existing file of portbench changes."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "oxford-serve-b4", "config": "oxford",
                               "traffic": "surface-b4", "chips": 1,
                               "why": "small query batches"})
    bench["per_layer"].append({
        "name": "busy_ms.serve", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "serve_batch_p95_ms", "workloads": ["oxford-serve-b4"]})
    for m in bench["end_to_end"]:
        if "serve_batch_p95_ms" == m["name"]:
            m["workloads"].append("oxford-serve-b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "portbench"
    (pb / "traffic" / "surface-b4.json").write_text(json.dumps(
        {"points": 4096, "batch": 4, "pool": 8, "pairs": False}))
    wl = json.loads((pb / "workloads" / "oxford-serve-b32.json").read_text())
    (pb / "workloads" / "oxford-serve-b4.json").write_text(json.dumps(wl))
    (pb / "metrics" / "busy_ms.serve.py").write_text(
        "def read(s):\n    return s['busy_s'] * 1e3\n")
    cell = spec.find_cell(spec.load_benchmark(tmp_path), "oxford-serve-b4",
                          root=tmp_path)
    assert cell.traffic["batch"] == 4 and cell.entry == "serve"
    assert [m["name"] for m in cell.per_layer] == ["busy_ms.serve"]
    assert spec.metric_reader("busy_ms.serve", tmp_path)({"busy_s": 2}) \
        == 2000
    for p, data in before.items():
        assert p.read_bytes() == data
