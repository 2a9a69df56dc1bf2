"""The port's dry run (``repro_torch/launch/dryrun.py``): DTensor on a fake
256-rank process group. Every process group is opened and destroyed
inside one call (``run_one`` / ``fake_process_group``) or lives in a
subprocess, so none outlives its test."""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.models.transformer import Model as JModel
from repro.models.transformer import input_pspecs as j_input_pspecs
from repro.models.transformer import input_specs as j_input_specs
from repro.training.train_loop import train_state_specs as j_state_specs
from repro_torch.configs import ARCHS, SHAPES, applicable
from repro_torch.configs.flops import analytic_flops_per_device
from repro_torch.launch import dryrun

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZES = {"data": 16, "model": 16}


def _spec_bytes(shape, itemsize, spec) -> int:
    """A leaf's bytes over the extents of the mesh axes its spec names."""
    ext = 1
    for entry in spec:
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            ext *= SIZES.get(ax, 1)
    n = math.prod(shape) * itemsize
    assert n % ext == 0
    return n // ext


def test_cli_decode_full_depth(tmp_path):
    """The reference's assertions (tests/test_dryrun_smoke.py) on the
    port's CLI: qwen2.5-3b x decode_32k, all 36 layers, on 16 x 16."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    data = json.loads((tmp_path / "qwen2.5-3b__decode_32k__16x16.json")
                      .read_text())
    assert data["status"] == "ok", data
    assert data["n_layers"] == 36 and data["n_devices"] == 256
    assert data["cost_analysis"]["flops"] > 0
    assert data["memory_analysis"]["temp_size_in_bytes"] > 0
    assert sum(v["count"] for v in data["collectives"].values()) > 0


def test_train_two_layers_bytes_collectives_flops():
    """qwen2.5-3b x train_4k cut to 2 layers on 16 x 16: the argument bytes
    are the reference's specs' shards, byte for byte; the step gathers
    weights and reduces gradients; the counted FLOPs are within 2x of the
    analytic count at the same depth."""
    r = dryrun.run_one("qwen2.5-3b", "train_4k", False, n_layers=2,
                       verbose=False)
    assert r["status"] == "ok", r
    jcfg = dataclasses.replace(J_ARCHS["qwen2.5-3b"], n_layers=2)
    jmodel = JModel(jcfg)
    shape = J_SHAPES["train_4k"]
    specs = j_state_specs(jmodel)
    want = 0
    struct = jmodel.param_struct()
    def is_p(x):
        return isinstance(x, JP)
    for part in ("params", "mu", "nu"):      # fp32, as the state holds them
        for s, sp in zip(jax.tree.leaves(struct),
                         jax.tree.leaves(specs[part], is_leaf=is_p)):
            want += _spec_bytes(s.shape, 4, sp)
    # the reference's "step" is an int32 scalar; the port keeps the step a
    # host int, so it has no bytes on the device
    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=SIZES)
    ispecs = j_input_pspecs(jcfg, shape, mesh)
    for k, s in j_input_specs(jcfg, shape).items():
        want += _spec_bytes(s.shape, np.dtype(s.dtype).itemsize, ispecs[k])
    mem = r["memory_analysis"]
    assert mem["argument_size_in_bytes"] == want
    assert mem["temp_size_in_bytes"] > 0
    coll = r["collectives"]
    assert coll["all-gather"]["count"] >= 1
    assert coll["reduce-scatter"]["count"] + coll["all-reduce"]["count"] >= 1
    analytic = analytic_flops_per_device(
        dataclasses.replace(ARCHS["qwen2.5-3b"], n_layers=2),
        SHAPES["train_4k"], 256)
    assert r["flops_analytic_per_dev"] == analytic
    assert 0.5 <= r["cost_analysis"]["flops"] / analytic <= 2.0


def test_collective_counter_on_a_matmul():
    """One 2-D DTensor matmul on a (2, 2) mesh of a 4-rank fake group:
    [8, 16] sharded (data on rows, model on the contraction) times
    [16, 32] sharded on the contraction over model leaves partial sums
    over model; holding the result to rows over data all-reduces each
    device's [4, 32] fp32 (512 B), then replicating it all-gathers [8, 32]
    (1024 B). The FLOPs are the matmul's 2 * 8 * 16 * 32 over 4 devices."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import P, from_local_struct

    with dryrun.fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            a = from_local_struct((8, 16), torch.float32, P("data", "model"),
                                  mesh)
            b = from_local_struct((16, 32), torch.float32, P("model", None),
                                  mesh)
            assert a.to_local().shape == (4, 8)

            def step(a, b):
                c = (a @ b).redistribute(mesh, [Shard(0), Replicate()])
                return c.redistribute(mesh, [Replicate(), Replicate()])
            got = dryrun.trace_step(step, (a, b), 4)
    coll = got["collectives"]
    assert coll["all-reduce"] == {"count": 1, "bytes": 4 * 32 * 4}
    assert coll["all-gather"] == {"count": 1, "bytes": 8 * 32 * 4}
    for k in ("reduce-scatter", "all-to-all", "collective-permute"):
        assert coll[k] == {"count": 0, "bytes": 0}
    assert got["cost_analysis"]["flops"] == 2 * 8 * 16 * 32 / 4
    mem = got["memory_analysis"]
    assert mem["argument_size_in_bytes"] == (4 * 8 + 16 * 16) * 4
    assert mem["output_size_in_bytes"] == 8 * 32 * 4
    assert mem["temp_size_in_bytes"] >= 8 * 32 * 4


def test_meshes():
    """The production meshes' shapes and axis names on fake groups of 256
    and 512 ranks, the smoke mesh on one, and the reference's RuntimeError
    where the group has fewer ranks than the mesh."""
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
    for n, multi, shape, names in (
            (256, False, (16, 16), ("data", "model")),
            (512, True, (2, 16, 16), ("pod", "data", "model"))):
        with dryrun.fake_process_group(n):
            mesh = make_production_mesh(multi_pod=multi)
            assert tuple(mesh.shape) == shape
            assert tuple(mesh.mesh_dim_names) == names
    with dryrun.fake_process_group(256):
        with pytest.raises(RuntimeError, match="need 512 ranks"):
            make_production_mesh(multi_pod=True)
    with dryrun.fake_process_group(1):
        mesh = make_smoke_mesh()
        assert tuple(mesh.shape) == (1, 1)
        assert tuple(mesh.mesh_dim_names) == ("data", "model")


def test_applicable_matches_reference():
    for a in ARCHS:
        for s in SHAPES:
            assert applicable(ARCHS[a], SHAPES[s]) == j_applicable(
                J_ARCHS[a], J_SHAPES[s]), (a, s)


def test_min_depth_holds_every_kind():
    got = {a: dryrun.min_depth(ARCHS[a]) for a in ARCHS}
    assert got["qwen2.5-3b"] == 1 and got["rwkv6-3b"] == 1
    assert got["gemma2-9b"] == 2            # local and global layers
    assert got["llama4-scout-17b-a16e"] == 4    # a global layer every 4th
    for a, n in got.items():
        cfg = ARCHS[a]
        cut = dataclasses.replace(cfg, n_layers=n)
        assert set(cut.layer_kinds()) == set(cfg.layer_kinds())
