"""The port's sharding rules (``repro_torch/distributed/sharding.py``),
specs, cache / input specs and analytic FLOPs against the JAX package's,
compared as tuples (no process group)."""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs.flops import analytic_flops_per_device as j_flops
from repro.distributed.sharding import batch_spec as j_batch_spec
from repro.distributed.sharding import filter_spec as j_filter_spec
from repro.distributed.sharding import pspec as j_pspec
from repro.distributed.sharding import stack_specs as j_stack_specs
from repro.launch.mesh import make_smoke_mesh as j_smoke_mesh
from repro.models.transformer import Model as JModel
from repro.models.transformer import input_pspecs as j_input_pspecs
from repro.training.train_loop import train_state_specs as j_state_specs
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.flops import analytic_flops_per_device
from repro_torch.distributed.sharding import (P, batch_spec, filter_spec,
                                              is_spec, pspec, stack_specs)
from repro_torch.models.params import ParamDef, init_from_defs
from repro_torch.models.transformer import Model, input_pspecs
from repro_torch.training.train_loop import train_state_specs
from repro_torch.tree import keystr, tree_flatten_with_path

PROD_SIZES = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


def _port_flat(tree):
    flat, _ = tree_flatten_with_path(tree, is_leaf=is_spec)
    return [(keystr(p), tuple(s)) for p, s in flat]


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def _ref_mesh(sizes):
    """What the reference's input_pspecs / cache_specs read of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes),
                                 devices=np.empty(tuple(sizes.values())))


@pytest.mark.parametrize("shape,logical", [
    ((6144, 6144), ("residual", "tp")),
    ((6144, 100), ("residual", "tp")),
    ((7,), ("tp",)),
    ((32, 64, 48), ("experts", None, "residual")),
    ((16, 8), (None, "vocab")),
    ((64, 32), (("pod", "data"), "model")),
])
def test_pspec_matches_reference(shape, logical):
    assert tuple(pspec(shape, logical)) == tuple(j_pspec(shape, logical))


def test_pspec_divisibility_downgrade():
    assert pspec((6144, 6144), ("residual", "tp")) == P("data", "model")
    assert pspec((6144, 100), ("residual", "tp")) == P("data", None)
    assert pspec((7,), ("tp",)) == P(None)


@pytest.mark.parametrize("spec", [
    (("pod", "data"), "model"), ("pod",), (None, ("data", "model")),
    ("data", None, "model"), (("pod",), None)])
def test_filter_spec_matches_reference(spec):
    jm = j_smoke_mesh()
    got = filter_spec(P(*spec), ("data", "model"))
    assert tuple(got) == tuple(j_filter_spec(JP(*spec), jm))


def test_batch_and_stack_specs_match_reference():
    jm = j_smoke_mesh()
    assert tuple(batch_spec(("data", "model"), None, "model")) == tuple(
        j_batch_spec(jm, None, "model"))
    assert tuple(batch_spec(("pod", "data", "model"))) == (("pod", "data"),)
    s = stack_specs({"w": P("data", "model")}, 1)
    js = j_stack_specs({"w": JP("data", "model")}, 1)
    assert tuple(s["w"]) == tuple(js["w"]) == (None, "data", "model")
    s2 = stack_specs({"w": P(None)}, 2)
    assert tuple(s2["w"]) == tuple(j_stack_specs({"w": JP(None)}, 2)["w"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch):
    """Published widths, leaf for leaf with equal paths; the specs cover
    param_struct's leaves at their ranks."""
    model, jmodel = Model(ARCHS[arch]), JModel(J_ARCHS[arch])
    got, want = _port_flat(model.param_specs()), _ref_flat(
        jmodel.param_specs())
    assert got == want
    struct, _ = tree_flatten_with_path(model.param_struct())
    assert [keystr(p) for p, _ in struct] == [p for p, _ in got]
    for (_, t), (_, s) in zip(struct, got):
        assert t.device.type == "meta" and t.dtype == torch.float32
        assert len(s) == t.ndim
    jstruct = jax.tree.leaves(jmodel.param_struct("bfloat16"))
    pstruct = [t for _, t in tree_flatten_with_path(
        model.param_struct("bfloat16"))[0]]
    assert [tuple(t.shape) for t in pstruct] == [s.shape for s in jstruct]
    assert all(t.dtype == torch.bfloat16 for t in pstruct)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_state_specs_match_reference(arch):
    got = _port_flat(train_state_specs(Model(ARCHS[arch])))
    want = _ref_flat(j_state_specs(JModel(J_ARCHS[arch])))
    assert got == want


_DECODE = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)
           if SHAPES[s].mode == "decode" and j_applicable(J_ARCHS[a],
                                                          J_SHAPES[s])]


@pytest.mark.parametrize("arch,shape", _DECODE)
def test_cache_specs_match_reference(arch, shape):
    model, jmodel = Model(ARCHS[arch]), JModel(J_ARCHS[arch])
    assert _port_flat(model.cache_specs(SHAPES[shape])) == _ref_flat(
        jmodel.cache_specs(J_SHAPES[shape]))
    for mesh in PROD_SIZES.values():
        assert _port_flat(model.cache_specs(SHAPES[shape], mesh)) == \
            _ref_flat(jmodel.cache_specs(J_SHAPES[shape], _ref_mesh(mesh)))
    # one leaf of specs per leaf of the cache, at its rank
    shapes = model.cache_struct(SHAPES[shape].global_batch,
                                SHAPES[shape].seq_len)
    specs = model.cache_specs(SHAPES[shape])
    for seg, sspec in zip(shapes, specs):
        assert sorted(seg) == sorted(sspec)
        for name, (shp, _) in seg.items():
            assert len(sspec[name]) == len(shp)


@pytest.mark.parametrize("mesh", sorted(PROD_SIZES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_pspecs_match_reference(arch, mesh):
    sizes = PROD_SIZES[mesh]
    for s in sorted(SHAPES):
        if not j_applicable(J_ARCHS[arch], J_SHAPES[s]):
            continue
        got = {k: tuple(v) for k, v in input_pspecs(
            ARCHS[arch], SHAPES[s], sizes).items()}
        want = {k: tuple(v) for k, v in j_input_pspecs(
            J_ARCHS[arch], J_SHAPES[s], _ref_mesh(sizes)).items()}
        assert got == want, (arch, s)


@pytest.mark.parametrize("n_dev", [256, 512])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_flops_equal_reference(arch, n_dev):
    for s in sorted(SHAPES):
        got = analytic_flops_per_device(ARCHS[arch], SHAPES[s], n_dev)
        want = j_flops(J_ARCHS[arch], J_SHAPES[s], n_dev)
        assert got == want, (arch, s, n_dev)
        assert got > 0


def test_init_from_defs_ignores_logical():
    """A def's logical axes leave its init's draws as they were."""
    plain = {"w": ParamDef((8, 4)), "b": ParamDef((4,), init="zeros"),
             "s": ParamDef((6, 2), init="small")}
    axes = {"w": ParamDef((8, 4), ("residual", "tp")),
            "b": ParamDef((4,), ("tp",), init="zeros"),
            "s": ParamDef((6, 2), (None, "tp"), init="small")}
    a = init_from_defs(plain, 3, torch.device("cpu"), lead=(2,))
    b = init_from_defs(axes, 3, torch.device("cpu"), lead=(2,))
    for k in plain:
        assert torch.equal(a[k], b[k])
    assert plain["w"].spec() == P(None, None)
    assert axes["w"].spec() == P(None, None)   # 8 and 4 do not divide 16
    assert ParamDef((32, 16), ("residual", "tp")).spec() == P("data", "model")
