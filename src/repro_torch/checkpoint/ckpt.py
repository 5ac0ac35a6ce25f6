"""Atomic checkpoints (`repro.checkpoint.ckpt`), file for file the
reference's.

Layout: <dir>/step_<n>/ holding one .npy per tensor, named t00000.npy,
... in the sorted order of the tensors' `jax.tree_util.keystr` paths
(the port's `pytree.keystr` writes them byte for byte), plus
manifest.json (path -> file, dtype, shape; the step; user metadata such
as the data cursor). Writes go to a temp directory, then an atomic
rename: a crash mid-save never corrupts the latest checkpoint. A
directory written by either package restores in the other.

bf16 without ml_dtypes: the reference's np.save of an ml_dtypes bf16
array writes the header descr '<V2' and the raw 2-byte values; the port
writes that header and those bytes from the tensor's 16-bit view, and
restores a leaf through the manifest's dtype (a bare np.load gives void
values, which the reference cannot turn back into an array: ROADMAP C,
reference-side hazards).

CRDT state checkpoints serialize (A, R, V) as JSON and the content-
addressed payload store as tensors: a restarted node rejoins the gossip
with its full causal history.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.api.replica import resolve_device
from repro_torch.core.state import AddEntry, CRDTMergeState
from repro_torch.core.version_vector import VersionVector
from repro_torch.dtypes import dtype_name

_ASYNC_POOL = ThreadPoolExecutor(max_workers=1,
                                 thread_name_prefix="ckpt-writer")


class _Host:
    """A tensor's value on the host: its numpy array (bf16 as uint16)
    and its numpy dtype name."""
    __slots__ = ("array", "dtype")

    def __init__(self, t: Any, copy: bool = False):
        if isinstance(t, _Host):
            self.array, self.dtype = t.array, t.dtype
            return
        if not torch.is_tensor(t):
            t = torch.as_tensor(np.asarray(t))
        t = t.detach()
        self.dtype = dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        self.array = t.contiguous().cpu().numpy()
        if copy and t.device.type == "cpu":   # a CUDA tensor was copied
            self.array = self.array.copy()
        if self.dtype == "bfloat16":
            self.array = self.array.view(np.uint16)


def _flatten(tree: Any) -> Dict[str, _Host]:
    flat, _ = pytree.flatten_with_path(tree)
    return {pytree.keystr(p): _Host(v) for p, v in flat}


def _save_npy(path: str, h: _Host) -> None:
    if h.dtype != "bfloat16":
        np.save(path, h.array)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": h.array.shape})
        f.write(h.array.tobytes())


def _load_npy(path: str, device: torch.device) -> torch.Tensor:
    """One .npy file as a tensor on `device`; a 2-byte void array is bf16
    as the reference writes it."""
    arr = np.load(path)
    if not arr.flags.c_contiguous:        # (a 0-dim array stays 0-dim)
        arr = arr.copy(order="C")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save_checkpoint(directory: str, state: Any, step: int,
                    metadata: Optional[Dict] = None, keep: int = 2) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tensors = _flatten(state)
    names = {}
    for i, (path, h) in enumerate(sorted(tensors.items())):
        fname = f"t{i:05d}.npy"
        _save_npy(os.path.join(tmp, fname), h)
        names[path] = {"file": fname, "dtype": h.dtype,
                       "shape": list(h.array.shape)}
    manifest = {"step": step, "tensors": names,
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    _retain(directory, keep)
    return final


def save_checkpoint_async(directory: str, state: Any, step: int,
                          metadata: Optional[Dict] = None,
                          keep: int = 2) -> "Future[str]":
    """Snapshot to host memory now (one device-to-host copy a tensor;
    later in-place training steps do not reach it), write to disk on a
    background thread. The future resolves to the committed path;
    writes are serialized on one thread, so checkpoints commit in
    order."""
    host_state = pytree.tree_map(lambda t: _Host(t, copy=True), state)
    return _ASYNC_POOL.submit(save_checkpoint, directory, host_state, step,
                              metadata, keep)


def _retain(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def restore_checkpoint(path: str, like: Any, device: Any = None
                       ) -> Tuple[Any, Dict]:
    """Restore into the structure of `like` (tensors, meta tensors or
    anything with its structure), each leaf in the manifest's dtype, on
    `device` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tensors = manifest["tensors"]
    flat, treedef = pytree.flatten_with_path(like)
    leaves = []
    for p, _ in flat:
        info = tensors[pytree.keystr(p)]
        t = _load_npy(os.path.join(path, info["file"]), dev)
        if dtype_name(t.dtype) != info["dtype"]:
            raise ValueError(f"{info['file']}: {t.dtype} on disk, "
                             f"{info['dtype']} in the manifest")
        leaves.append(t)
    return treedef.unflatten(leaves), manifest["metadata"]


# ---------------------------------------------------------------------------
# CRDT state
# ---------------------------------------------------------------------------


def save_crdt_state(directory: str, state: CRDTMergeState, node: str) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"crdt_{node}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {
        "adds": [[e.element_id, e.tag, e.node] for e in sorted(state.adds)],
        "removes": sorted(state.removes),
        "vv": state.vv.to_dict(),
        "store": {},
    }
    for eid, tree in state.store.items():
        entry = {}
        for i, (path, h) in enumerate(sorted(_flatten(tree).items())):
            fname = f"{eid[:16]}_{i:04d}.npy"
            _save_npy(os.path.join(tmp, fname), h)
            entry[path] = fname
        meta["store"][eid] = entry
    with open(os.path.join(tmp, "crdt.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_crdt_state(path: str, like_contribution: Any,
                       device: Any = None) -> CRDTMergeState:
    """The state `save_crdt_state` wrote, payloads in the structure of
    `like_contribution`, on `device` (CUDA unless the caller names
    another)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "crdt.json")) as f:
        meta = json.load(f)
    flat, treedef = pytree.flatten_with_path(like_contribution)
    store = {}
    for eid, entry in meta["store"].items():
        leaves = [_load_npy(os.path.join(path, entry[pytree.keystr(p)]), dev)
                  for p, _ in flat]
        store[eid] = treedef.unflatten(leaves)
    return CRDTMergeState(
        frozenset(AddEntry(*a) for a in meta["adds"]),
        frozenset(meta["removes"]),
        VersionVector(meta["vv"]), store)
