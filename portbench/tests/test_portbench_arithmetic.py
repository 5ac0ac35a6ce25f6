"""The yardstick's frozen arithmetic on known shapes (PERF.md's kernel
table) and the useful flops of each configuration's step."""
import json

import pytest

from portbench import peaks, registry
from portbench.drivers.finetune import facts_of
from portbench.reference import layout as L


def test_b1_bound_at_the_main_path_batch():
    ms = peaks.bytes_ms(peaks.nary_accum_bytes(4, 801_181_696, 2))
    assert ms == pytest.approx(3.827, abs=5e-4)


def test_b9_gradient_at_phi3_training_microbatch():
    flops = peaks.b9_backward_flops(2, 4096, 32, 96)
    assert flops == pytest.approx(5.155e11, rel=1e-3)
    assert peaks.flops_ms(flops) == pytest.approx(0.521, abs=5e-4)


def test_ties_batch_bytes_are_its_three_launches():
    k, n = 4, 1000
    assert peaks.ties_hist_bytes(k, n) == (12 + 12 + 16) * n


def test_resolve_least_time_of_phi3():
    ms = peaks.bytes_ms(peaks.resolve_least_bytes(4, 3_821_079_552, 2))
    assert ms == pytest.approx(13.687, abs=1e-3)


def _config(name):
    bench = registry.load_benchmark()
    conf = {c["name"]: c for c in bench["configs"]}[name]
    return json.loads((registry.ROOT / conf["file"]).read_text())


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "mamba2-780m"])
def test_layouts_count_the_published_parameters(name):
    cfg = _config(name)
    assert L.param_count(cfg) == cfg["params"]


def test_train_flops_of_phi3():
    cfg = _config("phi3-mini-3.8b")
    traffic = registry.cell("phi3-finetune").traffic
    f = facts_of(cfg, traffic)
    dense = 6.0 * 3_722_578_944 * 16384
    attn = 3 * 32 * 4.0 * 4 * 32 * 96 * (4096 * 4097 // 2)
    assert f["step_flops"] == pytest.approx(dense + attn, rel=1e-12)
    assert f["step_flops"] == pytest.approx(4.0555e14, rel=1e-4)
    assert f["b9_shape"] == (2, 4096, 32, 96)


def test_train_flops_of_mamba2_count_no_ssd():
    cfg = _config("mamba2-780m")
    f = facts_of(cfg, registry.cell("mamba2-finetune").traffic)
    assert f["step_flops"] == pytest.approx(6.0 * 702_918_912 * 8 * 4096,
                                            rel=1e-12)
    assert f["b9_shape"] is None
