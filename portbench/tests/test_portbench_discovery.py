"""Everything a cell needs is found by name, and a cell, a mix, a limit
file and a metric are added as new files and entries alone."""
import json
import shutil

import pytest

from portbench import registry

BENCH = registry.load_benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = registry.cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert registry.driver(cell.traffic["kind"]).run
    assert set(cell.limits)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.reader(metric).read)


def test_a_cell_added_as_new_files_alone(tmp_path):
    """A copy of the benchmark gains a cell, its mix, its limits and a
    metric as new files and entries; the registry finds each by name."""
    here = tmp_path / "portbench"
    shutil.copytree(registry.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (here / "traffic" / "finetune-2x1024.json").write_text(json.dumps(
        dict(json.loads((here / "traffic" / "finetune-4x4096.json")
                        .read_text()), batch=2, seq_len=1024)))
    (here / "limits" / "mamba2-short.json").write_text(
        json.dumps({"loss_gap": 1.0}))
    (here / "metrics" / "steps_traced.new.py").write_text(
        "def read(view):\n    return 7.0\n")
    bench["workloads"].append({"name": "mamba2-short",
                               "config": "mamba2-780m",
                               "traffic": "finetune-2x1024", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "steps_traced.new", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["mamba2-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for conf in bench["configs"]:
        dst = tmp_path / conf["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(registry.ROOT / conf["file"], dst)
    cell = registry.cell("mamba2-short", root=tmp_path, here=here)
    assert cell.traffic["seq_len"] == 1024
    assert cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["steps_traced.new"]
    assert registry.reader("steps_traced.new", here=here).read(None) == 7.0


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
