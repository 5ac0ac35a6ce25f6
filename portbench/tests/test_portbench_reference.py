"""The plain references on small hand-worked cases, and against the
program where both compute in fp32 (tiny widths, the CPU)."""
import hashlib
import math

import pytest
import torch

import tiny
from portbench import gen
from portbench.reference import dense, layout as L, merge as M, ssm


def test_ties_by_hand():
    xs = torch.tensor([[1., -1., 2., 0.], [2., -3., -1., 0.],
                       [-1., -2., 1., 0.]])
    out = M.ties_columns(xs, torch.zeros(4), torch.zeros(3))
    assert out.tolist() == [1.5, -2.0, 1.5, 0.0]


def test_ties_trims_under_the_threshold():
    xs = torch.tensor([[0.1, -0.5], [0.3, 0.2]])
    out = M.ties_columns(xs, torch.zeros(2), torch.tensor([0.2, 0.2]))
    # column 0: 0.1 trimmed, 0.3 kept; column 1: -0.5 elected over 0.2
    assert out.tolist() == pytest.approx([0.3, -0.5])


def test_histogram_threshold_by_hand():
    a = torch.arange(1, 11, dtype=torch.float32) / 10     # 0.1 .. 1.0
    amax, counts = M.hist_stats([a], torch.zeros(10))
    assert float(amax[0]) == pytest.approx(1.0)
    assert int(counts.sum()) == 10
    thr = M.thresholds(amax, counts, 10, 0.2)
    want = math.floor(0.2 / (1.0 + 1e-12) * 512) / 512
    assert float(thr[0]) == pytest.approx(want)
    assert 0.1 < float(thr[0]) <= 0.2


def test_task_arithmetic_by_hand():
    out = M.task_arithmetic_columns(torch.tensor([[2., 2.], [1., 4.]]),
                                    torch.tensor([1., 2.]), 0.5)
    assert out.tolist() == [1.5, 3.0]


def test_bf16_steps():
    one = torch.tensor([1.0], dtype=torch.bfloat16)
    nxt = torch.tensor([1.0078125], dtype=torch.bfloat16)
    zero, nzero = (torch.tensor([v], dtype=torch.bfloat16)
                   for v in (0.0, -0.0))
    assert int(M.bf16_steps(one, nxt)) == 1
    assert int(M.bf16_steps(zero, nzero)) == 0
    assert int(M.bf16_steps(one, -one)) == 2 * 0x3F80
    nan = torch.tensor([float("nan")], dtype=torch.bfloat16)
    assert int(M.bf16_steps(one, nan)) == 2 ** 40


def test_merkle_and_seed_by_hand():
    a, b = "11" * 32, "22" * 32
    assert M.merkle_root([a]) == bytes.fromhex(a)
    want = hashlib.sha256(b"\x01" + bytes.fromhex(a)
                          + bytes.fromhex(b)).digest()
    assert M.merkle_root([b, a]) == want
    assert M.seed_of(b"\x00" * 32) == 0
    assert M.seed_of(b"\xff" * 32) == 2 ** 63 - 1


def test_content_ids_and_root_match_the_program():
    from repro_torch.core.hashing import pytree_digest
    from repro_torch.core.merkle import merkle_root
    cfg = tiny.config("phi3-mini-3.8b")
    lay = L.layout(cfg)
    _, contribs = gen.merge_inputs(lay, 11, 3, 0.1, torch.bfloat16, "cpu")
    ids = [M.tree_id({leaf.key: c[leaf.path] for leaf in lay})
           for c in contribs]
    assert ids == [pytree_digest(L.nest(c)).hex() for c in contribs]
    assert M.merkle_root(ids) == merkle_root([bytes.fromhex(i)
                                              for i in ids])


def test_ssd_chunks_equal_the_recurrence():
    g = torch.Generator().manual_seed(0)
    s, h, p, n = 32, 2, 3, 4
    x = torch.randn(s, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(s, h, generator=g, dtype=torch.float64)
    a = -torch.rand(h, generator=g, dtype=torch.float64)
    bm = torch.randn(s, h, n, generator=g, dtype=torch.float64)
    cm = torch.randn(s, h, n, generator=g, dtype=torch.float64)
    y = ssm.ssd(x, dt, a, bm, cm, chunk=8)
    state = torch.zeros(h, p, n, dtype=torch.float64)
    want = []
    for t in range(s):
        state = state * torch.exp(dt[t] * a)[:, None, None] \
            + (dt[t][:, None, None] * x[t][:, :, None] * bm[t][:, None, :])
        want.append((state * cm[t][:, None, :]).sum(-1))
    assert torch.allclose(y, torch.stack(want), atol=1e-10)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "mamba2-780m"])
def test_reference_loss_and_gradient_match_the_program_in_fp32(name):
    """At tiny widths with the program's products in fp32, the reference
    and the program give the same loss and gradients to rounding."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = tiny.config(name)
    ref = {"dense": dense, "ssm": ssm}[cfg["family"]]
    model = Model(get_config(cfg["port_config"]).replace(
        compute_dtype="float32", remat="none"))
    lay = L.layout(cfg)
    toks = gen.tokens(3, 1, 2, 32, cfg["vocab_size"], "cpu")
    p = gen.params(lay, 3, "cpu")
    for t in p.values():
        t.requires_grad_(True)
    loss = sum(ref.row_loss(cfg, p, toks[r], lambda a, b: a @ b)
               for r in range(2)) / 2
    loss.backward()
    q = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    got, _ = model.loss(L.nest(q), {"tokens": toks})
    got.backward()
    assert float(got.detach()) == pytest.approx(float(loss.detach()),
                                                rel=1e-5)
    for k in p:
        assert torch.allclose(q[k].grad, p[k].grad, rtol=1e-3, atol=1e-6), k
