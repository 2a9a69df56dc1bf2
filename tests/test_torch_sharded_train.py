"""Two sharded train steps of the port on 4 ``gloo`` processes, mesh (2, 2)
("data", "model"), against the unsharded port steps on the same params and
batches: the proof that the port's shardings (``train_state_specs``,
``input_pspecs`` and the model's ``maybe_constrain`` calls) compute what
the unsharded port computes. Existing tests hold the unsharded port to the
JAX package.

qwen2.5-3b ``reduced()`` in float32, params from the JAX ``Model.init``
through ``repro_torch.convert``; AdamW with no warmup, so each step moves
the params, and a clip norm below the gradients' global norm, so clipping
acts on both steps. Tolerances: each step's loss and the optimizer's
global gradient norm (summed over DTensor leaves) within 1e-6 relative;
each first-step gradient leaf and each param after either step
(``full_tensor()``) within 1e-5 of the leaf's largest magnitude (partial
sums reduce across devices in another order)."""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models.transformer import Model as RefModel
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import make_batch_for
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import TrainState, make_train_step
from repro_torch.tree import (keystr, tree_flatten_with_path, tree_leaves,
                              tree_map)

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD, B, S = 4, 4, 64
# AdamW's eps: at the trainer's 1e-8 a step moves a weight whose gradient
# is 1e-8 about as far as one whose gradient is 1, so a gradient that
# cancels to that size (and that a reordered sum moves by tens of percent)
# would decide the comparison, on either step; at 1e-3 the update stays
# proportional to such a gradient, and the clip scale, which m / sqrt(v)
# cancels at eps 0, still sets the size of every small update
EPS = 1e-3
# below the global gradient norm of both steps (asserted), so the clip
# scale, computed from the sharded global norm, enters every update
CLIP = 0.5

WORKER = r"""
import dataclasses, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import distribute, full_tensor, set_mesh
from repro_torch.models.transformer import Model, input_pspecs
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainState, make_train_step,
                                             train_state_specs)
from repro_torch.tree import tree_leaves, tree_map

rank, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
B, S = int(sys.argv[4]), int(sys.argv[5])
EPS, CLIP = float(sys.argv[6]), float(sys.argv[7])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    set_mesh(mesh)
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                              dtype="float32")
    model = Model(cfg)
    blob = torch.load(f"{d}/in.pt")
    shape = ShapeConfig("t", seq_len=S, global_batch=B, mode="train")
    params = distribute(blob["params"], train_state_specs(model)["params"],
                        mesh)
    batches = [distribute(b, input_pspecs(cfg, shape, mesh), mesh)
               for b in blob["batches"]]
    state = TrainState(params)
    with implicit_replication():
        model.loss(params, batches[0])[0].backward()
    grads = tree_map(lambda p: full_tensor(p.grad), params)
    for p in tree_leaves(params):
        p.grad = None
    step = make_train_step(model, OptConfig(warmup_steps=0, eps=EPS,
                                            clip_norm=CLIP))
    steps = []
    for batch in batches:
        with implicit_replication():
            state, m = step(state, batch)
        steps.append({
            "loss": float(full_tensor(m["loss"])),
            "grad_norm": float(full_tensor(m["grad_norm"])),
            # clone: a replicated leaf's full_tensor is its local
            # tensor, which the next step updates in place
            "params": tree_map(lambda p: full_tensor(p.detach()).clone(),
                               state["params"])})
    emb = state["params"]["embed"]
    assert emb.to_local().shape[0] * 2 == emb.shape[0], emb.placements
    if rank == 0:
        torch.save({"steps": steps, "grads": grads}, f"{d}/out.pt")
finally:
    set_mesh(None)
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _close(got, want, tol_rel: float) -> None:
    """Leaf for leaf, the same paths and shapes, each within ``tol_rel`` of
    the leaf's largest magnitude in ``want``."""
    want_flat = tree_flatten_with_path(want)[0]
    got_flat = tree_flatten_with_path(got)[0]
    assert [keystr(p) for p, _ in got_flat] == [keystr(p) for p, _ in
                                               want_flat]
    for (path, w), (_, g) in zip(want_flat, got_flat):
        w = w.detach()
        assert g.shape == w.shape, keystr(path)
        tol = tol_rel * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol, keystr(path)


def test_sharded_step_matches_unsharded(tmp_path):
    rcfg = dataclasses.replace(ref_get_arch("qwen2.5-3b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                              dtype="float32")
    jp = RefModel(rcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    shape = ShapeConfig("t", seq_len=S, global_batch=B, mode="train")
    batches = [make_batch_for(cfg, shape, seed=i) for i in range(2)]
    torch.save({"params": params, "batches": batches}, tmp_path / "in.pt")

    # the unsharded port's gradient and steps on the same params and batches
    state = TrainState(params_from_jax(jax.tree.map(np.asarray, jp)))
    Model(cfg).loss(state["params"], batches[0])[0].backward()
    want_grads = tree_map(lambda p: p.grad.clone(), state["params"])
    for p in tree_leaves(state["params"]):
        p.grad = None
    step = make_train_step(Model(cfg), OptConfig(warmup_steps=0, eps=EPS,
                                                 clip_norm=CLIP))
    want = []
    for batch in batches:
        state, m = step(state, batch)
        want.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "params": tree_map(lambda p: p.detach().clone(),
                                        state["params"])})

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), port, str(tmp_path), str(B),
         str(S), str(EPS), str(CLIP)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]

    got = torch.load(tmp_path / "out.pt")
    _close(got["grads"], want_grads, 1e-5)
    for i, (g, w) in enumerate(zip(got["steps"], want)):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), (i, k, g[k], w[k])
        assert w["grad_norm"] > CLIP, (i, w["grad_norm"])
        _close(g["params"], w["params"], 1e-5)
    # each step moved the params (lr > 0 at step 0 without warmup)
    assert not torch.equal(params["embed"], want[0]["params"]["embed"])
    assert not torch.equal(want[0]["params"]["embed"],
                           want[1]["params"]["embed"])
