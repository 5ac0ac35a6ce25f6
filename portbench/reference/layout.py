"""Parameter layouts of the benchmark's configurations, worked out from
their files alone: each leaf's path, shape, initial law and whether it
is an embedding. The program's trees carry the same paths and shapes
(the harness checks that before a run); the benchmark makes every leaf
itself from the seed and hands the same tensors to both sides.

Families: "dense" (a pre-norm decoder: RMSNorm, RoPE attention, a gated
SiLU MLP, its layers stacked along a leading axis) and "ssm" (Mamba2's
SSD mixers without an MLP, the embedding tied to the output head).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    init: str            # "normal" (times `scale`), "ones" or "zeros"
    scale: float = 0.0

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def key(self) -> str:
        """The path as `jax.tree_util.keystr` writes it."""
        return "".join(f"[{k!r}]" for k in self.path)


def _dense(cfg: Dict) -> List[Leaf]:
    n, d, f = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    hd = cfg["head_dim"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    s = cfg["init_scale"]
    blk = ("blocks", "sub0")
    out = [Leaf(("embed",), (cfg["vocab_size"], d), "normal", s),
           Leaf(("final_norm",), (d,), "ones")]
    if not cfg["tie_embeddings"]:
        out.append(Leaf(("lm_head",), (d, cfg["vocab_size"]), "normal", s))
    out += [
        Leaf(blk + ("pre_norm",), (n, d), "ones"),
        Leaf(blk + ("attn", "wq"), (n, d, q), "normal", s),
        Leaf(blk + ("attn", "wk"), (n, d, kv), "normal", s),
        Leaf(blk + ("attn", "wv"), (n, d, kv), "normal", s),
        Leaf(blk + ("attn", "wo"), (n, q, d), "normal", s),
        Leaf(blk + ("ffn_norm",), (n, d), "ones"),
        Leaf(blk + ("ffn", "w_gate"), (n, d, f), "normal", s),
        Leaf(blk + ("ffn", "w_up"), (n, d, f), "normal", s),
        Leaf(blk + ("ffn", "w_down"), (n, f, d), "normal", s),
    ]
    return out


def ssm_dims(cfg: Dict) -> Tuple[int, int, int]:
    """(d_inner, SSD heads, conv channels)."""
    d_inner = cfg["expand"] * cfg["d_model"]
    heads = d_inner // cfg["ssm_head_dim"]
    conv = d_inner + 2 * cfg["n_groups"] * cfg["d_state"]
    return d_inner, heads, conv


def _ssm(cfg: Dict) -> List[Leaf]:
    n, d = cfg["n_layers"], cfg["d_model"]
    d_inner, heads, conv = ssm_dims(cfg)
    s = cfg["init_scale"]
    mix = ("blocks", "sub0", "mixer")
    w_in = 2 * d_inner + 2 * cfg["n_groups"] * cfg["d_state"] + heads
    return [
        Leaf(("embed",), (cfg["vocab_size"], d), "normal", s),
        Leaf(("final_norm",), (d,), "ones"),
        Leaf(("blocks", "sub0", "pre_norm"), (n, d), "ones"),
        Leaf(mix + ("w_in",), (n, d, w_in), "normal", s),
        Leaf(mix + ("conv_w",), (n, cfg["d_conv"], conv), "normal", s),
        Leaf(mix + ("conv_b",), (n, conv), "zeros"),
        Leaf(mix + ("a_log",), (n, heads), "zeros"),
        Leaf(mix + ("dt_bias",), (n, heads), "zeros"),
        Leaf(mix + ("d_skip",), (n, heads), "ones"),
        Leaf(mix + ("norm",), (n, d_inner), "ones"),
        Leaf(mix + ("w_out",), (n, d_inner, d), "normal", s),
    ]


def layout(cfg: Dict) -> List[Leaf]:
    """The configuration's leaves, sorted by path (the program's flatten
    order: dict keys sorted)."""
    leaves = {"dense": _dense, "ssm": _ssm}[cfg["family"]](cfg)
    return sorted(leaves, key=lambda leaf: leaf.path)


def param_count(cfg: Dict) -> int:
    return sum(leaf.numel for leaf in layout(cfg))


def non_embedding_params(cfg: Dict) -> int:
    """Parameters outside the token embedding (an untied head counts)."""
    return sum(leaf.numel for leaf in layout(cfg) if leaf.path != ("embed",))


def at(tree: Dict, path: Tuple[str, ...]):
    """The leaf of a nested tree at `path`."""
    for k in path:
        tree = tree[k]
    return tree


def nest(flat: Dict[Tuple[str, ...], object]) -> Dict:
    """{path: tensor} -> the nested dict the program takes."""
    out: Dict = {}
    for path, value in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out
