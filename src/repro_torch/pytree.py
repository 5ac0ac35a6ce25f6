"""Parameter pytrees in JAX's flatten order.

The reference package flattens with `jax.tree_util`: dict keys are
visited in SORTED order, lists and tuples in index order, and `None`
is an empty subtree. `torch.utils._pytree` keeps dict insertion order
instead, which would shift every global leaf index the engine keys on
(sub-roots, strategy seeds). This module is the port's one flattener,
and `keystr` reproduces `jax.tree_util.keystr` byte for byte
(`['a'][0]`), since leaf paths are hashed into tags and sub-roots.

Containers are dict, list, tuple and None; anything else is a leaf.

>>> flat, td = flatten_with_path({"b": [1, (2, 3)], "a": {"z": 4}})
>>> [(keystr(p), x) for p, x in flat]
[("['a']['z']", 4), ("['b'][0]", 1), ("['b'][1][0]", 2), ("['b'][1][1]", 3)]
>>> td.unflatten([x * 10 for _, x in flat])
{'a': {'z': 40}, 'b': [10, (20, 30)]}
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

Path = Tuple[Any, ...]


class TreeDef:
    """Structure of a pytree with its leaves taken out. Equal
    structures compare equal; `unflatten` rebuilds dicts in sorted key
    order, as JAX does."""

    __slots__ = ("node", "num_leaves")

    def __init__(self, node: Tuple, num_leaves: int):
        self.node = node
        self.num_leaves = num_leaves

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, TreeDef) and self.node == other.node

    def __hash__(self) -> int:
        return hash(self.node)

    def __repr__(self) -> str:
        return f"TreeDef({self.node!r})"

    def flatten_up_to(self, tree: Any) -> List[Any]:
        """Leaves of `tree`, which must have this structure."""
        out: List[Any] = []
        _up_to(self.node, tree, out)
        return out

    def unflatten(self, leaves: Sequence[Any]) -> Any:
        return _build(self.node, iter(leaves))


_LEAF = ("*",)


def _flatten(tree: Any, path: Path, out: List[Tuple[Path, Any]]) -> Tuple:
    if tree is None:
        return ("None",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys),
                tuple(_flatten(tree[k], path + (("key", k),), out)
                      for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, len(tree),
                tuple(_flatten(x, path + (("idx", i),), out)
                      for i, x in enumerate(tree)))
    out.append((path, tree))
    return _LEAF


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[Path, Any]], TreeDef]:
    """[(path, leaf)] in JAX's order, and the tree's structure."""
    out: List[Tuple[Path, Any]] = []
    node = _flatten(tree, (), out)
    return out, TreeDef(node, len(out))


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    flat, td = flatten_with_path(tree)
    return [leaf for _, leaf in flat], td


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def keystr(path: Path) -> str:
    """`jax.tree_util.keystr`: `[repr(key)]` per dict key, `[i]` per
    sequence index."""
    return "".join(f"[{k!r}]" if kind == "key" else f"[{k}]"
                   for kind, k in path)


def _up_to(node: Tuple, tree: Any, out: List[Any]) -> None:
    kind = node[0]
    if kind == "*":
        out.append(tree)
    elif kind == "None":
        if tree is not None:
            raise ValueError(f"expected None, got {type(tree).__name__}")
    elif kind == "dict":
        if not isinstance(tree, dict) or set(tree) != set(node[1]):
            raise ValueError("tree structure mismatch at a dict node")
        for k, child in zip(node[1], node[2]):
            _up_to(child, tree[k], out)
    else:
        want = list if kind == "list" else tuple
        if not isinstance(tree, want) or len(tree) != node[1]:
            raise ValueError(f"tree structure mismatch at a {kind} node")
        for x, child in zip(tree, node[2]):
            _up_to(child, x, out)


def _build(node: Tuple, it) -> Any:
    kind = node[0]
    if kind == "*":
        return next(it)
    if kind == "None":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(node[1], node[2])}
    items = [_build(c, it) for c in node[2]]
    return items if kind == "list" else tuple(items)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    flat, td = flatten(tree)
    others = [td.flatten_up_to(r) for r in rest]
    return td.unflatten([fn(x, *xs) for x, *xs in zip(flat, *others)])


def leaf_paths(treedef: TreeDef) -> List[str]:
    """keystr path per leaf of a structure, in flatten order."""
    dummy = treedef.unflatten(list(range(treedef.num_leaves)))
    return [keystr(p) for p, _ in flatten_with_path(dummy)[0]]
