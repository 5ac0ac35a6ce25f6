"""The arithmetic of B9's bf16 gradient on the tensor cores
(`csrc/flash_attention_bwd.cuh`, `bwd_dkdv_mma` and `bwd_dq_mma`),
modelled in torch on the CPU.

The kernels take S = Q K^T and dP = dO V^T from bf16 operands into fp32
(products of bf16 values are exact in fp32), form P = exp(S scale - lse)
and dS = P (dP - Dd) in fp32, then feed P and dS to the tensor cores as
an A operand in three bf16 terms, hi = bf16(x), mid = bf16(x - hi),
lo = bf16(x - hi - mid), each product again in fp32 from bf16 operands,
the small terms first. `_model` does the same with fp32 matrix products
of bf16-valued tensors (the order of the fp32 sums differs from the
card's).

Checked here:
  * the three terms recompose every fp32 value exactly, on seeded values
    in [0, 1] (P) and signed values over 20 decades (dS);
  * the modelled dq, dk and dv, rounded to bf16, hold `chip_smoke.py`'s
    bf16 rule against `flash_attention_backward_plain` (no element
    beyond one bf16 ulp of |plain| + 1e-4 max |plain|);
  * unrounded, they lie within 2e-6 of each gradient's largest magnitude
    of `jax.grad` of the reference's `chunked_attention` in fp32 on the
    same bf16-valued inputs (`test_b9_backward_plain_matches_jax_grad`'s
    tolerance).
How far one and two terms land is printed (run with -s), not asserted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward_plain, flash_attention_plain)

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
# (B, S, H, HK, D, causal, q scale): MHA, GQA, MQA at D = 128, D = 16,
# a non-causal call, and q x8 (peaked P, cancelling dP - Dd)
SHAPES = {
    "mha": (2, 70, 4, 4, 64, True, 1.0),
    "gqa": (1, 90, 8, 2, 96, True, 1.0),
    "mqa": (1, 65, 4, 1, 128, True, 1.0),
    "d16": (2, 37, 4, 2, 16, True, 1.0),
    "full": (2, 50, 4, 2, 64, False, 1.0),
    "peaked": (2, 80, 4, 2, 96, True, 8.0),
}


def _split(x: torch.Tensor, terms: int = 3):
    """fp32 -> `terms` fp32 tensors of bf16 values, hi first."""
    out, r = [], x
    for _ in range(terms):
        t = r.to(torch.bfloat16).float()
        out.append(t)
        r = r - t
    return out


def _dot(parts, z):
    """sum over the terms of part @ z, the small terms first."""
    acc = None
    for part in reversed(parts):
        y = torch.matmul(part, z)
        acc = y if acc is None else acc + y
    return acc


def _model(q, k, v, o, lse, dout, *, causal=True, terms=3):
    """(dq, dk, dv) in fp32 as the bf16 kernels compute them; q, k, v, o,
    dout hold bf16 values (any float dtype), lse [B, H, Sq] fp32."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = d ** -0.5
    f32 = torch.float32

    def heads(x):                                          # B,HK,G,S,D
        return x.to(f32).reshape(b, sq, hk, g, d).permute(0, 2, 3, 1, 4)

    qf, gf = heads(q), heads(dout)
    kf = k.to(f32).permute(0, 2, 1, 3).unsqueeze(2)        # B,HK,1,Sk,D
    vf = v.to(f32).permute(0, 2, 1, 3).unsqueeze(2)
    dd = (dout.to(f32) * o.to(f32)).sum(-1)                # B,Sq,H
    dd = dd.reshape(b, sq, hk, g).permute(0, 2, 3, 1).unsqueeze(-1)
    lc = lse.reshape(b, hk, g, sq, 1)
    x = (torch.matmul(qf, kf.transpose(-1, -2)) * scale - lc) * LOG2E
    p = torch.exp2(x)
    if causal:
        p = p.masked_fill(torch.ones(sq, sk, dtype=torch.bool).triu(1), 0.0)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - dd)
    pt, dst = _split(p, terms), _split(ds, terms)
    dv = _dot([t.transpose(-1, -2) for t in pt], gf).sum(dim=2)
    dk = _dot([t.transpose(-1, -2) for t in dst], qf).sum(dim=2) * scale
    dq = _dot(dst, kf) * scale
    return (dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d),
            dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))


def _inputs(b, s, h, hk, d, mult, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in
        ((b, s, h, d), (b, s, hk, d), (b, s, hk, d), (b, s, h, d)))
    return q * mult, k, v, g


def _beyond(got, want) -> int:
    g, w = got.float(), want.float()
    lim = 2.0 ** -7 * w.abs() + 1e-4 * float(w.abs().max())
    return int(((g - w).abs() > lim).sum())


def _rel(a, b) -> float:
    """max |a - b| over max |a| (a the reference)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("kind", ["p_unit", "p_small", "ds_signed"])
def test_three_bf16_terms_recompose_fp32_exactly(kind):
    """hi + mid + lo equals the fp32 value exactly (in float64), each
    term is a bf16 value, and the last rounding is exact (mid + lo is
    x - hi in fp32); two terms leave up to 2^-17 of |x|."""
    rng = np.random.default_rng(["p_unit", "p_small", "ds_signed"]
                                .index(kind))
    n = 200_000
    if kind == "p_unit":          # P in [0, 1]
        x = rng.uniform(0.0, 1.0, n)
    elif kind == "p_small":       # P far below 1: keys far from the max
        x = 10.0 ** rng.uniform(-30.0, 0.0, n)
    else:                         # dS: signed, over 20 decades
        x = rng.standard_normal(n) * 10.0 ** rng.uniform(-14.0, 6.0, n)
    x = torch.from_numpy(x.astype(np.float32))
    hi, mid, lo = _split(x)
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert torch.equal(mid + lo, x - hi)
    xd = x.double()
    two = ((hi.double() + mid.double()) - xd).abs()
    assert bool((two <= 2.0 ** -17 * xd.abs()).all())
    one = (hi.double() - xd).abs()
    den = xd.abs().clamp_min(1e-300)
    print(f"[split] {kind}: two terms leave at most "
          f"{float((two / den).max()):.3e} of |x|, one term "
          f"{float((one / den).max()):.3e}")


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_modelled_bf16_gradient_holds_chip_smoke_rule(case):
    """The model with three terms, each output rounded to bf16 once, has
    no element beyond one bf16 ulp of |plain| + 1e-4 max |plain| of
    `flash_attention_backward_plain` on the same bf16 inputs."""
    b, s, h, hk, d, causal, mult = SHAPES[case]
    q, k, v, g = _inputs(b, s, h, hk, d, mult, seed=s)
    o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    want = flash_attention_backward_plain(q, k, v, o, lse, g, causal=causal)
    report = []
    for terms in (3, 2, 1):
        got = [x.to(torch.bfloat16) for x in
               _model(q, k, v, o, lse, g, causal=causal, terms=terms)]
        beyond = [_beyond(x, y) for x, y in zip(got, want)]
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, want))
        report.append(f"{terms} terms: beyond (dq, dk, dv) {beyond}, max "
                      f"abs err {err:.3e}")
        if terms == 3:
            assert beyond == [0, 0, 0], report[-1]
    print(f"[bf16 rule] {case}: " + "; ".join(report))


@pytest.mark.parametrize("case", ["gqa", "full", "peaked"])
def test_modelled_gradient_matches_jax_grad(case):
    """Unrounded, the three-term model lies within 2e-6 of each
    gradient's largest magnitude of `jax.grad` of `chunked_attention` in
    fp32 (a query chunk smaller than S, so its scan runs), on the same
    bf16-valued inputs; the forward's o and lse from the plain version
    in fp32."""
    b, s, h, hk, d, causal, mult = SHAPES[case]
    q, k, v, g = (x.float() for x in _inputs(b, s, h, hk, d, mult, seed=s))
    qn, kn, vn, gn = (x.numpy() for x in (q, k, v, g))

    def jfn(q, k, v):
        out = JL.chunked_attention(q, k, v, q_chunk=32, causal=causal,
                                   compute_dtype=jnp.float32)
        return jnp.sum(out * gn)

    jgrads = jax.grad(jfn, argnums=(0, 1, 2))(qn, kn, vn)
    o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    report = []
    for terms in (3, 2, 1):
        got = _model(q, k, v, o, lse, g, causal=causal, terms=terms)
        rels = [_rel(a, bb.numpy()) for a, bb in zip(jgrads, got)]
        report.append(f"{terms} terms: (dq, dk, dv) "
                      + ", ".join(f"{r:.2e}" for r in rels))
        if terms == 3:
            assert max(rels) <= 2e-6, report[-1]
    print(f"[jax.grad] {case}: " + "; ".join(report))
