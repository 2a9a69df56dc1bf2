"""The dry run's three perf variants in the port, against the JAX package
where it has the piece: the ring-buffer decode (``--windowed-kv``),
flash-decoding over a sequence-sharded cache (``--flash-decode``) and the
sequence-parallel residual (``--seq-parallel``).

Tolerances: the ring decode against the reference's ``_windowed_decode``
on the same numpy inputs within 1e-5 of the largest output (fp32; the
same math in another summation order), the written cache exactly; a
model's decode on the ring against the full cache within 1e-5 of each
step's largest logit; flash-decode on 4 ``gloo`` processes, mesh (2, 2),
against the unsharded decode within 1e-5 of the largest logit (partial
softmax statistics combined across shards), the cache rows within 1e-5
of the cache's largest value (the new K / V from sharded projections)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _gloo import run_workers
from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES
from repro.models import attention as j_attention
from repro.models import transformer as j_transformer
from repro.models.transformer import Model as JModel
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.distributed.sharding import is_spec
from repro_torch.launch import dryrun
from repro_torch.models import attention, transformer
from repro_torch.models.transformer import Model
from repro_torch.tree import tree_map


def test_ring_decode_matches_reference():
    """A ring of W = 8 slots past its wrap (positions 13 and 21), GQA 4 / 2
    heads, softcap 30."""
    rng = np.random.default_rng(0)
    B, W, H, KV, hd = 2, 8, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, W, KV, hd)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.array([13, 21], np.int32)
    want, wcache = j_attention._windowed_decode(
        jnp.asarray(q), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos), scale=0.25,
        logit_cap=30.0)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got = attention._windowed_decode(
        torch.from_numpy(q), cache, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.from_numpy(pos).long(), scale=0.25,
        logit_cap=30.0)
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * np.abs(want).max()
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(wcache[name]))


def _flat_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: is_spec(x) or isinstance(
            x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_windowed_cache_structs_and_specs_match_reference(arch):
    shape = SHAPES["decode_32k"]
    try:
        transformer.WINDOWED_KV_CACHE = True
        j_transformer.WINDOWED_KV_CACHE = True
        got = Model(ARCHS[arch]).cache_struct(shape.global_batch,
                                              shape.seq_len)
        jm = JModel(J_ARCHS[arch])
        want = jm.cache_struct(J_SHAPES["decode_32k"])
        assert [{k: tuple(s) for k, (s, _) in seg.items()} for seg in got] \
            == [{k: tuple(v.shape) for k, v in seg.items()} for seg in want]
        assert _flat_specs(Model(ARCHS[arch]).cache_specs(shape)) == \
            _flat_specs(jm.cache_specs(J_SHAPES["decode_32k"]))
    finally:
        transformer.WINDOWED_KV_CACHE = False
        j_transformer.WINDOWED_KV_CACHE = False


def test_windowed_decode_through_the_model_equals_the_full_cache():
    """h2o-danube ``reduced()`` (window 64), a 40-token prompt, 50 decode
    steps past the ring's wrap at 64, teacher-forced by the full cache's
    greedy tokens: the ring's logits equal the full cache's under the
    window's mask."""
    cfg = dataclasses.replace(get_arch("h2o-danube-3-4b").reduced(),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    P, L, steps = 40, 100, 50
    prompt = torch.randint(0, cfg.vocab_size, (1, P),
                           generator=torch.Generator().manual_seed(0))
    _, pre = model.prefill(params, {"tokens": prompt})
    full = model.alloc_cache(1, L, device="cpu")
    for seg, p in zip(full, pre):
        for k in seg:
            seg[k][:, :, :P] = p[k]
    try:
        transformer.WINDOWED_KV_CACHE = True
        ring = model.alloc_cache(1, L, device="cpu")
    finally:
        transformer.WINDOWED_KV_CACHE = False
    W = cfg.sliding_window
    assert ring[0]["k"].shape[2] == W
    for seg, p in zip(ring, pre):
        for k in seg:
            seg[k][:, :, :P] = p[k]
    tok = prompt[:, -1:]
    with torch.no_grad():
        for i in range(steps):
            batch = {"token": tok, "pos": torch.tensor([P + i])}
            want, _ = model.decode_step(params, full, batch)
            got, _ = model.decode_step(params, ring, batch)
            err = float((got - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (i, err)
            tok = want.argmax(-1).reshape(1, 1)
    assert P + steps > W


FD_WORKER = r"""
import dataclasses, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import distribute, full_tensor, set_mesh
from repro_torch.models import attention
from repro_torch.models.transformer import Model, input_pspecs
from repro_torch.tree import tree_map

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
n_calls = [0]
fd = attention._flash_decode_sharded


def counted(*a, **k):
    n_calls[0] += 1
    return fd(*a, **k)
attention._flash_decode_sharded = counted
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    blob = torch.load(f"{d}/in.pt")
    out = {}
    for (arch, B, axis), case in blob["cases"].items():
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        model = Model(cfg)
        shape = ShapeConfig("d", seq_len=blob["L"], global_batch=B,
                            mode="decode")
        params = distribute(blob["params"][arch], model.param_specs(), mesh)
        cache = distribute(case["cache"], model.cache_specs(shape, mesh), mesh)
        batch = distribute(case["batch"], input_pspecs(cfg, shape, mesh), mesh)
        set_mesh(mesh)
        attention.SHARDED_DECODE_AXIS = axis
        n_calls[0] = 0
        try:
            with implicit_replication(), torch.no_grad():
                logits, cache = model.decode_step(params, cache, batch)
        finally:
            attention.SHARDED_DECODE_AXIS = None
            set_mesh(None)
        out[(arch, B, axis)] = {"logits": full_tensor(logits),
                                "cache": tree_map(full_tensor, cache),
                                "calls": n_calls[0]}
    if rank == 0:
        torch.save(out, f"{d}/out.pt")
finally:
    dist.destroy_process_group()
"""


def test_flash_decode_on_four_processes_equals_unsharded(tmp_path):
    """qwen2.5-3b and gemma2-9b ``reduced()`` (gemma: window 64 on its
    local layer, softcaps), an 80-token prompt in a 96-slot cache, one
    decode step at position 80: batch 2 with the cache's sequence over
    ("model",), and batch 1 over ("pod", "data", "model") (the mesh's
    ("data", "model")), the dry run's two axis choices."""
    P, L = 80, 96
    blob = {"L": L, "params": {}, "cases": {}}
    want = {}
    for arch in ("qwen2.5-3b", "gemma2-9b"):
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        model = Model(cfg)
        params = model.init(0, device="cpu")
        blob["params"][arch] = params
        for B, axis in ((2, ("model",)), (1, ("pod", "data", "model"))):
            prompt = torch.randint(0, cfg.vocab_size, (B, P),
                                   generator=torch.Generator().manual_seed(B))
            _, pre = model.prefill(params, {"tokens": prompt})
            cache = model.alloc_cache(B, L, device="cpu")
            for seg, p in zip(cache, pre):
                for k in seg:
                    seg[k][:, :, :P] = p[k]
            batch = {"token": prompt[:, -1:].to(torch.int32),
                     "pos": torch.full((B,), P, dtype=torch.int32)}
            blob["cases"][(arch, B, axis)] = {
                "cache": tree_map(torch.clone, cache), "batch": batch}
            with torch.no_grad():
                logits, cache = model.decode_step(params, cache, batch)
            want[(arch, B, axis)] = (logits, cache, cfg.n_layers)
    torch.save(blob, tmp_path / "in.pt")
    run_workers(FD_WORKER, tmp_path)
    got = torch.load(tmp_path / "out.pt")
    for key, (logits, cache, n_layers) in want.items():
        g = got[key]
        assert g["calls"] == n_layers, (key, g["calls"])
        err = float((g["logits"] - logits).abs().max())
        assert err <= 1e-5 * float(logits.abs().max()), (key, err)
        for gs, ws in zip(g["cache"], cache):
            for k in ws:
                tol = 1e-5 * float(ws[k].abs().max())
                assert float((gs[k] - ws[k]).abs().max()) <= tol, (key, k)


def _defaults():
    return (attention.SHARDED_DECODE_AXIS, transformer.WINDOWED_KV_CACHE,
            transformer.SEQ_PARALLEL_RESIDUAL)


@pytest.mark.parametrize("arch,shape,flag", [
    ("qwen2.5-3b", "decode_32k", "flash_decode"),
    ("h2o-danube-3-4b", "decode_32k", "windowed_kv"),
    ("qwen2.5-3b", "train_4k", "seq_parallel")])
def test_dry_run_rows_with_each_flag(arch, shape, flag):
    """Each flag's row at min depth is ``ok`` and names the flag; the
    switches are back to their defaults after it. ``--windowed-kv`` cuts
    h2o-danube's decode_32k cache by 32,768 / 4,096 = 8x."""
    n = dryrun.min_depth(ARCHS[arch])
    r = dryrun.run_one(arch, shape, False, n_layers=n, verbose=False,
                       **{flag: True})
    assert _defaults() == (None, False, False)
    assert r["status"] == "ok", r
    assert r["variants"] == [flag]
    if flag == "windowed_kv":
        base = dryrun.run_one(arch, shape, False, n_layers=n, verbose=False)
        assert base["status"] == "ok", base
        assert base["cache_size_in_bytes"] == 8 * r["cache_size_in_bytes"]
        assert (base["memory_analysis"]["argument_size_in_bytes"]
                - r["memory_analysis"]["argument_size_in_bytes"]
                == base["cache_size_in_bytes"] - r["cache_size_in_bytes"])


def test_dry_run_cli_takes_the_flags(tmp_path):
    import json
    import os
    import subprocess
    import sys
    from _gloo import ROOT
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--arch", "h2o-danube-3-4b", "--shape", "decode_32k",
         "--min-depth", "--flash-decode", "--windowed-kv", "--seq-parallel",
         "--out", str(tmp_path), "--tag", "_all"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    row = json.loads((tmp_path / "h2o-danube-3-4b__decode_32k__16x16_all"
                      ".json").read_text())
    assert row["status"] == "ok", row
    assert row["variants"] == ["flash_decode", "windowed_kv", "seq_parallel"]
