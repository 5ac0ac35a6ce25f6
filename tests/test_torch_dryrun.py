"""The pure parts of the reference's dry-run and sharding tail on the
port, against the reference, on the CPU: `sharding.policy`'s
logical-axis resolution (`resolve_leaf_spec`) over a grid of mesh
shapes for every leaf of every registered config, `Model.param_shapes`
and `logical_specs`, `ModelConfig.shapes()`, the dry run's
`input_specs` (meta tensors), `VARIANTS` / `apply_variant` composed,
`_model_flops` for every arch x shape, and `pad_heads_to_tp`
(tensor-parallel head padding) on smoke Whisper and MiniCPM. Every check is exact: shapes, dtypes, specs, counts and flops
equal, parameters bitwise.

The reference's `repro.launch.dryrun` sets XLA_FLAGS to 512 host devices
when imported; `_jdryrun` imports it and puts the variable back before
any JAX backend starts, so the other tests in the process keep one
device. The reference's `resolve_leaf_spec` reads only `mesh.shape`, so
it is given a stand-in with that mapping.
"""
import dataclasses
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.sharding.policy import AXIS_MAP as JAXIS_MAP  # noqa: E402
from repro.sharding.policy import resolve_leaf_spec as jresolve  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import (get_config, list_archs, SHAPES,  # noqa: E402
                                 smoke_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.sharding import policy  # noqa: E402

torch.set_num_threads(1)

ARCHS = sorted(jlist_archs())
# single pod, multi-pod, the reference's reduced test meshes, one card
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 8, "model": 1},
          {"data": 1, "model": 16}, {"data": 1, "model": 1})


@functools.cache
def _jdryrun():
    """The reference's `repro.launch.dryrun`, imported with XLA_FLAGS put
    back as it was (module docstring)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _jspecs(tree):
    """The reference's logical-spec tree as {keystr: spec}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def test_registry_and_axis_map_equal_reference():
    """Exact: the port registers the reference's ten configs, and its
    logical-axis map is the reference's; importing the reference's dry
    run leaves this process with one JAX device."""
    assert list_archs() == ARCHS and len(ARCHS) == 10
    assert policy.AXIS_MAP == JAXIS_MAP
    _jdryrun()
    assert len(jax.devices()) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_leaf_spec_every_leaf(arch):
    """Exact: for every parameter leaf of the full config (and of its
    `headpad16` variant), over each mesh shape in MESHES, the port's
    spec tuple equals the reference's PartitionSpec entries; on one card
    every leaf replicates."""
    for cfg in (get_config(arch), get_config(arch).replace(
            pad_heads_to_tp=16)):
        jcfg = jget_config(arch).replace(
            pad_heads_to_tp=cfg.pad_heads_to_tp)
        leaves = schema_leaves(Model(cfg).schema())
        for mesh in MESHES:
            stand_in = SimpleNamespace(shape=mesh)
            want = {p: tuple(jresolve(d.spec, d.shape, stand_in))
                    for p, d in leaves}
            got = {p: policy.resolve_leaf_spec(d.spec, d.shape, mesh)
                   for p, d in leaves}
            assert got == want, (arch, mesh)
            if mesh == {"data": 1, "model": 1}:
                assert all(e is None for s in got.values() for e in s)
        assert _jspecs(JModel(jcfg).logical_specs()) == \
            {p: d.spec for p, d in leaves}


@pytest.mark.parametrize("logical,shape", [
    (("dp", "sp_any", None), (4, 32768, 512)),
    ((None, "dp", "sp_any", None, None), (3, 128, 32768, 8, 128)),
    ((None, "dp", "sp_any", None, None), (3, 1, 524288, 8, 128)),
    ((None, "dp", "tp", None, None), (48, 2, 96, 64, 128)),
    ((None, "dp", None, "tp"), (48, 6, 3, 6400)),
    (("dp", "ep", None, None), (256, 160, 192, 5120)),
    (("sp", "tp"), (30, 36)),
    (("fsdp", "fsdp"), (64, 64))])
def test_resolve_leaf_spec_other_axes(logical, shape):
    """Exact: the batch, sequence, KV-cache and expert axes (dp, sp,
    sp_any, ep), an axis used twice, and dimensions that do not divide,
    over each mesh shape in MESHES."""
    for mesh in MESHES:
        want = tuple(jresolve(logical, shape, SimpleNamespace(shape=mesh)))
        assert policy.resolve_leaf_spec(logical, shape, mesh) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_logical_specs_and_shapes(arch):
    """Exact, at full size without allocating: `Model.param_shapes` are
    meta tensors of the reference's shapes and dtypes, leaf for leaf by
    path; `logical_specs` the reference's tree; `cfg.shapes()` the
    reference's cells (long_500k only where the config supports it)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = pytree.flatten_with_path(Model(cfg).param_shapes())[0]
    want, _ = jax.tree_util.tree_flatten_with_path(
        JModel(jcfg).param_shapes())
    assert [pytree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, t), (_, s) in zip(got, want):
        assert t.device.type == "meta"
        assert tuple(t.shape) == s.shape and \
            str(t.dtype).split(".")[-1] == str(s.dtype)
    assert {p: s for p, s in _port_specs(Model(cfg))} == \
        _jspecs(JModel(jcfg).logical_specs())
    assert [dataclasses.asdict(s) for s in cfg.shapes()] == \
        [dataclasses.asdict(s) for s in jcfg.shapes()]


def _port_specs(model):
    """The port's logical-spec tree as (keystr, spec) pairs, walked by
    hand (a spec is a tuple, which the pytree walk would descend)."""
    def walk(node, path):
        if isinstance(node, tuple):
            yield "".join(f"['{k}']" for k in path), node
            return
        for k in sorted(node):
            yield from walk(node[k], path + (k,))
    return list(walk(model.logical_specs(), ()))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_model_flops(arch):
    """Exact: `input_specs` gives the reference's batch (tokens, and
    frames or patches) as meta tensors of its shapes and dtypes, at full
    and smoke size; `_model_flops` equals the reference's for every cell
    of `SHAPES` (params_total, params_active, model_flops, tokens)."""
    jd = _jdryrun()
    for name in SHAPES:
        for smoke in (False, True):
            cfg, shape, batch = dryrun.input_specs(arch, name, smoke=smoke)
            jcfg, jshape, jbatch = jd.input_specs(arch, name, smoke=smoke)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
            assert sorted(batch) == sorted(jbatch)
            for k, t in batch.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == jbatch[k].shape
                assert str(t.dtype).split(".")[-1] == str(jbatch[k].dtype)
        assert dryrun._model_flops(get_config(arch), SHAPES[name]) == \
            jd._model_flops(jget_config(arch), JSHAPES[name])


@pytest.mark.parametrize("variant", ["base", "castbf16+accum4",
                                     "headpad16+parambf16+optbf16",
                                     "qchunk1k+noremat+bf16psum",
                                     "accum2+optint8", "accum16+"])
def test_variants_compose_like_the_reference(variant):
    """Exact: `VARIANTS` has the reference's names, and `apply_variant`
    of a '+'-joined list gives the reference's config, field for field,
    for every arch; an unknown name raises KeyError in both."""
    jd = _jdryrun()
    assert sorted(dryrun.VARIANTS) == sorted(jd.VARIANTS)
    for arch in ARCHS:
        got = dryrun.apply_variant(get_config(arch), variant)
        want = jd.apply_variant(jget_config(arch), variant)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for mod, cfg in ((dryrun, get_config(ARCHS[0])),
                     (jd, jget_config(ARCHS[0]))):
        with pytest.raises(KeyError):
            mod.apply_variant(cfg, "castbf16+nosuch")


@pytest.mark.parametrize("arch", ["whisper-tiny", "minicpm-2b"])
def test_pad_heads_to_tp(arch):
    """Exact: `pad_heads_to_tp=16` on the smoke config rounds the query
    and KV head counts up to 16 as the reference's `Model` does; the
    parameter shapes equal the reference's leaf for leaf, and
    `Model.init` draws its parameters bit for bit; the padded model
    serves a prefill on the CPU (B9's plain version over 16 heads)."""
    cfg = smoke_config(arch).replace(pad_heads_to_tp=16)
    jcfg = jsmoke(arch).replace(pad_heads_to_tp=16)
    model, jmodel = Model(cfg), JModel(jcfg)
    assert (model.cfg.n_heads, model.cfg.n_kv_heads) == \
        (jmodel.cfg.n_heads, jmodel.cfg.n_kv_heads) == (16, 16)
    got = pytree.flatten_with_path(model.init(prng.PRNGKey(2),
                                              device="cpu"))[0]
    want, _ = jax.tree_util.tree_flatten_with_path(
        jmodel.init(jax.random.PRNGKey(2)))
    assert [pytree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    shapes = [tuple(t.shape) for t in pytree.leaves(model.param_shapes())]
    assert shapes == [s.shape for s in jax.tree_util.tree_leaves(
        jmodel.param_shapes())]
    params = model.init(prng.PRNGKey(2), device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model))
    logits, _ = model.prefill(params, batch)
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
