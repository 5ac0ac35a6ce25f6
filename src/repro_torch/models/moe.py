"""Token-choice top-k Mixture-of-Experts (`repro.models.moe`), with the
reference's two dispatch backends:

`einsum`  GShard-style one-hot dispatch and combine einsums (the
          baseline; its dispatch matmul spends O(G s E C D) flops on a
          one-hot operand).
`gather`  index-based dispatch, the default: each assignment's position
          within its expert (an exclusive count over the group), token
          ids laid into an [E, C] table (assignments at or past the
          capacity C dropped), expert inputs gathered, outputs gathered
          back per assignment.

Tokens are grouped [G, s, D]; `moe_block` makes the groups the batch
rows, as the reference does. Every expert runs over all C of its slots,
used or not (the reference's design: a decode step reads every expert's
weights).

Exact against the reference: the router's top-k indices (a stable
descending sort, so the lower expert index comes first among equal
probabilities, as `jax.lax.top_k` orders them), each assignment's
position `pos`, `keep = pos < C`, the dispatch table and its used-slot
mask. All of it comes from one stable sort of the group's assignments
by expert, which lists each expert's assignments in token-major order,
their `pos` order: an assignment's `pos` is its rank in the sorted list
less its expert's first rank (`searchsorted`), taken back to assignment
order through the inverse permutation, and slot c of expert e holds the
(start(e) + c)-th sorted assignment while c < count(e). Gathers only: no
scatter, no atomics, and no one-hot (whose bounds check would stall the
host on every layer). The combine gathers each assignment's output row
([s, k, D]; a dropped assignment reads slot min(pos, C - 1) and is
weighted 0, as in the reference), multiplies it by its gate in the
compute dtype and sums over k, so two replicas produce the same bytes.
Floats (router logits, softmax, matmuls) are held to the reference
within a tolerance.

The shared expert (`num_shared_experts`, DeepSeek-V2's) is defined and
applied as the reference's; Qwen3-MoE has none.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import _gelu, mlp, mlp_def
from repro_torch.models.schema import PDef


def moe_def(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    f = m.d_ff_expert
    scale = 0.02
    p = {
        "router": PDef((d, m.num_experts), (None, None), scale=scale),
        "experts": {
            "w_gate": PDef((m.num_experts, d, f), ("ep", "fsdp", None),
                           scale=scale),
            "w_up": PDef((m.num_experts, d, f), ("ep", "fsdp", None),
                         scale=scale),
            "w_down": PDef((m.num_experts, f, d), ("ep", None, "fsdp"),
                           scale=scale),
        },
    }
    if m.num_shared_experts:
        p["shared"] = mlp_def(d, m.num_shared_experts * m.d_ff_shared,
                              "swiglu", scale)
    return p


def _one_hot(x: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: a zero row for an index outside [0, n); a
    comparison, so no bounds check reads the indices back to the
    host."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def _router(p, x, m: MoEConfig):
    """x: [G, s, D] -> (gates [G, s, k] fp32, idx [G, s, k] int32, aux):
    fp32 logits and softmax, the top k by a stable descending sort, the
    gates renormalised by max(sum, 1e-9), and the Switch load-balancing
    loss, whose density counts each token's first choice only."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices
    idx = order[..., :m.top_k]
    gates = torch.gather(probs, -1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = torch.mean(_one_hot(idx[..., 0], m.num_experts,
                                  torch.float32), dim=(0, 1))
    mean_probs = torch.mean(probs, dim=(0, 1))
    aux = m.num_experts * torch.sum(density * mean_probs)
    return gates, idx.to(torch.int32), aux


def _capacity(m: MoEConfig, s: int) -> int:
    c = int(m.top_k * s * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8


def _dispatch(idx: torch.Tensor, num_experts: int, c: int
              ) -> Tuple[torch.Tensor, ...]:
    """(pos [G, s, k], keep [G, s, k], table [G, E, C], slot_used
    [G, E, C]) of the reference's `moe_gather`, as integers and bools:
    `pos`, each assignment's exclusive count of earlier assignments to
    its expert over the token-major s * k axis; `table[g, e, c]`, the
    token of expert e's c-th kept assignment (0 where the slot is
    unused)."""
    g, s, k = idx.shape
    dev = idx.device
    e_flat = idx.reshape(g, s * k).long()
    e_sorted, order = torch.sort(e_flat, dim=1, stable=True)   # [G, sk]
    experts = torch.arange(num_experts, device=dev).expand(g, -1) \
        .contiguous()
    start = torch.searchsorted(e_sorted, experts)               # [G, E]
    count = torch.searchsorted(e_sorted, experts, right=True) - start
    rank = torch.arange(s * k, device=dev) \
        - torch.gather(start, 1, e_sorted)
    inverse = torch.argsort(order, dim=1)
    pos = torch.gather(rank, 1, inverse).to(torch.int32).reshape(g, s, k)
    keep = pos < c
    slots = torch.arange(c, device=dev)
    used = slots < count[:, :, None]                            # [G, E, C]
    at = torch.clamp(start[:, :, None] + slots, max=s * k - 1)
    assign = torch.gather(order, 1, at.reshape(g, -1))
    table = torch.where(used, (assign // k).reshape(g, num_experts, c),
                        0).to(torch.int32)
    return pos, keep, table, used


def _expert_ffn(experts, xin, variant, compute_dtype):
    """xin: [E, N, D] expert-major stacked inputs -> [E, N, D]: the
    reference's `_expert_ffn` einsums as one batched product per
    weight. Each weight is cast to the compute dtype just before its
    product, so outside autograd one cast lives at a time (Jamba's
    expert leaf is 12.9 GB in fp32)."""
    g = torch.bmm(xin, experts["w_gate"].to(compute_dtype))
    u = torch.bmm(xin, experts["w_up"].to(compute_dtype))
    act = F.silu(g) if variant == "swiglu" else _gelu(g)
    return torch.bmm(act * u, experts["w_down"].to(compute_dtype))


def moe_einsum(p, x, cfg: ModelConfig, compute_dtype):
    """GShard-style masked-einsum dispatch (the baseline). x: [G, s, D]
    -> (y [G, s, D], aux)."""
    m = cfg.moe
    cd = compute_dtype
    gdim, s, d = x.shape
    e = m.num_experts
    c = _capacity(m, s)
    gates, idx, aux = _router(p, x, m)
    onehot = _one_hot(idx, e, cd)                                # [G,s,k,E]
    pos, keep, _, _ = _dispatch(idx, e, c)
    pos_oh = _one_hot(pos, c, cd) * keep[..., None].to(cd)       # [G,s,k,C]
    dispatch = torch.einsum("gske,gskc->gsec", onehot, pos_oh)
    combine = torch.einsum("gske,gskc->gsec", gates.to(cd)[..., None]
                           * onehot, pos_oh)
    xin = torch.einsum("gsec,gsd->gecd", dispatch, x.to(cd))
    yout = _expert_ffn(p["experts"],
                       xin.transpose(0, 1).reshape(e, gdim * c, d),
                       "swiglu", cd).reshape(e, gdim, c, d).transpose(0, 1)
    y = torch.einsum("gsec,gecd->gsd", combine, yout)
    return y, aux


def moe_gather(p, x, cfg: ModelConfig, compute_dtype):
    """Index-based dispatch (the default). x: [G, s, D] -> (y [G, s, D],
    aux). Expert inputs are gathered expert-major, [E, G * C, D], so the
    expert products need no transpose."""
    m = cfg.moe
    cd = compute_dtype
    gdim, s, d = x.shape
    e, k = m.num_experts, m.top_k
    c = _capacity(m, s)
    gates, idx, aux = _router(p, x, m)
    pos, keep, table, used = _dispatch(idx, e, c)

    # gather rows: xin[e, (g, c)] = x[g, table[g, e, c]], unused slots 0
    goff = torch.arange(gdim, device=x.device)[:, None, None]
    rows = (table.long() + goff * s).transpose(0, 1).reshape(e, gdim * c)
    xin = x.to(cd).reshape(gdim * s, d)[rows] \
        * used.transpose(0, 1).reshape(e, gdim * c, 1).to(cd)
    yout = _expert_ffn(p["experts"], xin, "swiglu", cd)     # [E, G*C, D]

    # combine: out[g, s] = sum_k gate * yout[e_k, (g, min(pos_k, C - 1))]
    at = idx.long() * (gdim * c) + goff * c \
        + torch.clamp(pos, max=c - 1).long()
    got = yout.reshape(e * gdim * c, d)[at.reshape(-1)] \
        .reshape(gdim, s, k, d)
    w = (gates * keep).to(cd)[..., None]
    return torch.sum(got * w, dim=2), aux


def moe_block(p, x, cfg: ModelConfig, compute_dtype, impl: str = "gather"):
    """x: [B, S, D] -> (y, aux). Groups = batch rows."""
    m = cfg.moe
    fn = moe_einsum if impl == "einsum" else moe_gather
    y, aux = fn(p, x, cfg, compute_dtype)
    if m.num_shared_experts:
        y = y + mlp(p["shared"], x, "swiglu", compute_dtype)
    return y, aux
