"""The expert-parallel MoE dispatch on a mesh (``models/moe.py``,
``_moe_on_mesh``) against the unsharded port, on 4 ``gloo`` processes,
mesh (2, 2) ("data", "model"); and the dry run's MoE train rows.

deepseek-v2-lite and llama4-scout ``reduced()`` in float32 (params from
the JAX ``Model.init`` through ``repro_torch.convert``), at a capacity
factor of 0.5, where assignments drop. The routed stacks are split over
experts on "model", as the production specs split them (the reduced 4
experts fall below the production divisibility downgrade, so the test's
specs name "model" on E); the batch over "data". Tolerances:
``moe_apply`` within 1e-5 of the largest output (the contributions are
summed across devices in another order), the kept assignments equal; a
train step's loss within 1e-6 relative and each gradient leaf within
1e-5 of the leaf's largest magnitude, as ``test_torch_sharded_train.py``
holds them."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _gloo import run_workers
from repro.configs import get_arch as ref_get_arch
from repro.models.transformer import Model as RefModel
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import make_batch_for
from repro_torch.launch import dryrun

ARCHES = ("deepseek-v2-lite-16b", "llama4-scout-17b-a16e")
B, S, CF = 4, 16, 0.5

WORKER = r"""
import dataclasses, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import (P, distribute, full_tensor,
                                              gather_fsdp, placements,
                                              set_mesh)
from repro_torch.models import moe
from repro_torch.models.transformer import Model, input_pspecs, layer_slice
from repro_torch.training.train_loop import train_state_specs
from repro_torch.tree import tree_leaves, tree_map

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
B, S, CF = int(sys.argv[4]), int(sys.argv[5]), float(sys.argv[6])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
ROUTED = ("wi0", "wi1", "wo")


def ep_specs(specs):
    # the routed stacks [n, E, ...] split over experts on "model"
    for seg in specs["segments"]:
        ffn = seg.get("ffn", {})
        for k in ROUTED:
            if k in ffn:
                sp = list(ffn[k])
                sp[1] = "model"
                ffn[k] = P(*sp)
    return specs


try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    set_mesh(mesh)
    blob = torch.load(f"{d}/in.pt")
    out = {}
    for arch, item in blob.items():
        base = get_arch(arch).reduced()
        cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
            base.moe, capacity_factor=CF))
        model = Model(cfg)
        specs = ep_specs(train_state_specs(model)["params"])
        params = distribute(item["params"], specs, mesh)
        res = {}
        # moe_apply on layer 0's ffn against the unsharded port
        p_plain = layer_slice(item["params"]["segments"][0], 0)["ffn"]
        p_mesh = tree_map(gather_fsdp, layer_slice(params["segments"][0],
                                                   0)["ffn"])
        assert p_mesh["wi0"].placements[1].is_shard(0), p_mesh["wi0"]
        x = item["x"]
        xd = distribute_tensor(x, mesh, placements(P("data", None, None),
                                                   mesh))
        # the kept masks the dispatch applies: each _routed call's, this
        # rank's batch shard and experts on the mesh, all of both unsharded
        masks = []
        routed = moe._routed

        def spy(*a, **k):
            y, kept = routed(*a, **k)
            masks.append(kept)
            return y, kept
        moe._routed = spy
        try:
            with implicit_replication(), torch.no_grad():
                y, aux = moe.moe_apply(cfg, p_mesh, xd)
                y0, aux0 = moe.moe_apply(cfg, p_plain, x)
        finally:
            moe._routed = routed
        assert len(masks) == 2, len(masks)
        y = full_tensor(y)
        res["y_err"] = float((y - y0).abs().max() / y0.abs().max())
        res["aux"] = (float(full_tensor(aux)), float(aux0))
        # rank = 2 * data + model: a batch shard's assignments are kept on
        # one "model" rank each (the one holding the expert), summed there
        every = [torch.empty_like(masks[0], dtype=torch.int32)
                 for _ in range(4)]
        dist.all_gather(every, masks[0].to(torch.int32))
        per_shard = [every[2 * d] + every[2 * d + 1] for d in range(2)]
        res["kept"] = torch.cat(per_shard).reshape(B, S, -1)
        res["kept0"] = masks[1].reshape(B, S, -1)
        # one train step's loss and gradients
        shape = ShapeConfig("t", seq_len=S, global_batch=B, mode="train")
        batch = distribute(item["batch"], input_pspecs(cfg, shape, mesh), mesh)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        with implicit_replication():
            loss, _ = model.loss(params, batch)
            loss.backward()
        res["loss"] = float(full_tensor(loss))
        res["grads"] = tree_map(lambda t: full_tensor(t.grad), params)
        ref = tree_map(lambda t: t.clone().requires_grad_(True),
                       item["params"])
        loss0, _ = model.loss(ref, item["batch"])
        loss0.backward()
        res["loss0"] = float(loss0)
        res["grads0"] = tree_map(lambda t: t.grad, ref)
        out[arch] = res
    if rank == 0:
        torch.save(out, f"{d}/out.pt")
finally:
    set_mesh(None)
    dist.destroy_process_group()
"""


def _cfgs(arch):
    return (dataclasses.replace(ref_get_arch(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_arch(arch).reduced(), dtype="float32"))


def test_ep_dispatch_and_train_step_match_unsharded(tmp_path):
    blob = {}
    for i, arch in enumerate(ARCHES):
        rcfg, cfg = _cfgs(arch)
        jp = RefModel(rcfg).init(jax.random.key(i))
        shape = ShapeConfig("t", seq_len=S, global_batch=B, mode="train")
        x = torch.from_numpy(np.random.default_rng(i).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        blob[arch] = {"params": params_from_jax(jax.tree.map(np.asarray, jp)),
                      "batch": make_batch_for(cfg, shape, seed=i), "x": x}
    torch.save(blob, tmp_path / "in.pt")
    run_workers(WORKER, tmp_path, B, S, CF)
    got = torch.load(tmp_path / "out.pt")
    from repro_torch.tree import keystr, tree_flatten_with_path
    for arch in ARCHES:
        r = got[arch]
        assert r["y_err"] <= 1e-5, (arch, r["y_err"])
        a, a0 = r["aux"]
        assert abs(a - a0) <= 1e-6 * abs(a0), (arch, a, a0)
        assert int(r["kept"].max()) <= 1, f"{arch}: an assignment kept twice"
        assert torch.equal(r["kept"].bool(), r["kept0"]), arch
        assert not bool(r["kept0"].all()), f"{arch}: no assignment dropped"
        assert abs(r["loss"] - r["loss0"]) <= 1e-6 * abs(r["loss0"]), arch
        want = tree_flatten_with_path(r["grads0"])[0]
        have = tree_flatten_with_path(r["grads"])[0]
        assert [keystr(p) for p, _ in have] == [keystr(p) for p, _ in want]
        for (path, w), (_, g) in zip(want, have):
            tol = 1e-5 * float(w.abs().max())
            assert float((g - w).abs().max()) <= tol, (arch, keystr(path))


@pytest.mark.parametrize("arch", ARCHES)
def test_dry_run_moe_rows_gather_no_whole_batch(arch):
    """The dry run's train_4k row on 16 x 16: no all-gather is as large as
    the batch's [B, S, D] activations, and llama4's all-gather a step per
    device is at least 5x under the 360 GB the dry run measured when every
    device gathered the whole batch to route it (PERF.md)."""
    cfg = ARCHS[arch]
    r = dryrun.run_one(arch, "train_4k", False, n_layers=dryrun.min_depth(cfg),
                       verbose=False)
    assert r["status"] == "ok", r
    shape = dryrun.get_shape("train_4k")
    batch = (shape.global_batch * shape.seq_len * cfg.d_model
             * torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size())
    assert r["collective_max_bytes"]["all-gather"] < batch, r
    if arch.startswith("llama4"):
        assert r["collectives"]["all-gather"]["bytes"] <= 360e9 / 5, r
