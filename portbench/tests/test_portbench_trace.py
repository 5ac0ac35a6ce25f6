"""The traced stretch's arithmetic and the seeded generators."""
import torch

from portbench import gen
from portbench.devtrace import Op, Span, Trace


def _trace():
    ops = [Op("a", 10, 20), Op("b", 15, 30), Op("a", 40, 50)]
    spans = [Span("resolve", 0, 100, 1), Span("engine.plan", 30, 40, 2)]
    return Trace(0, 100, ops, spans)


def test_busy_is_the_union_and_gaps_are_named():
    t = _trace()
    assert t.busy_ns() == 30
    assert t.gaps() == [(0, 10), (30, 40), (50, 100)]
    assert t.idle_by_span() == {"resolve": 60e-9, "engine.plan": 10e-9}
    assert t.seconds_by_op() == {"a": 20e-9, "b": 15e-9}
    b = t.breakdown()
    assert b["device_ops"][0] == ["a", 20e-9]
    assert len(b["idle_gaps"]) == 2


def test_ops_in_spans():
    t = _trace()
    assert [o.t0 for o in t.ops_in("engine.plan")] == [40]
    assert len(t.ops_in("resolve")) == 3


def test_requests_come_in_rounds_of_the_mix():
    mix = [{"strategy": "ties", "cfg": {"trim_method": "histogram"},
            "draw": {"trim": [0.1, 0.3]}},
           {"strategy": "task_arithmetic", "draw": {"lam": [0.3, 1.0]}}]
    stream = gen.merge_requests(2 ** 33 + 5, mix)
    reqs = [next(stream) for _ in range(40)]
    for i in range(0, 40, 2):
        assert {r["strategy"] for r in reqs[i:i + 2]} == {"ties",
                                                          "task_arithmetic"}
    trims = [r["cfg"]["trim"] for r in reqs if r["strategy"] == "ties"]
    assert all(0.1 <= t <= 0.3 for t in trims)
    again = gen.merge_requests(2 ** 33 + 5, mix)
    assert [next(again) for _ in range(40)] == reqs


def test_inputs_repeat_from_the_seed():
    a = gen.tokens(2 ** 40 + 1, 3, 2, 8, 100, "cpu")
    assert torch.equal(a, gen.tokens(2 ** 40 + 1, 3, 2, 8, 100, "cpu"))
    assert not torch.equal(a, gen.tokens(2 ** 40 + 1, 4, 2, 8, 100, "cpu"))
