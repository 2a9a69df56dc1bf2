"""The kernel wrappers on a mesh take each device's local shards
(``distributed.sharding.run_local``), on 4 ``gloo`` processes, mesh
(2, 2) ("data", "model").

During sharded train steps (loss and backward, params placed by
``train_state_specs``, the batch by ``input_pspecs``) of qwen2.5-3b,
deepseek-v2-lite and rwkv6-3b ``reduced()`` in float32, a spy on
``swap_linear``, ``flash_attention`` and ``wkv6`` where the models call
them sees only plain tensors, and sees each called. rwkv6's sharded step
equals the unsharded one: the loss within 1e-6 relative, each gradient
leaf within 1e-5 of the leaf's largest magnitude (as
``test_torch_sharded_train.py`` holds qwen's). A K-sharded linear with a
bias or an activation raises ``ValueError``, as a quantized weight with
a sharded x does; without them, and a
column-parallel one with both, equal the plain product within 1e-5 of
its largest value."""
from _gloo import run_workers

WORKER = r"""
import dataclasses, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_batch_for
from repro_torch.distributed.sharding import distribute, full_tensor, set_mesh
from repro_torch.kernels.qtensor import QuantizedTensor
from repro_torch.models import attention, layers, ssm
from repro_torch.models.transformer import Model, input_pspecs
from repro_torch.training.train_loop import train_state_specs
from repro_torch.tree import tree_leaves, tree_map

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
calls = {}


def spy(mod, name):
    fn = getattr(mod, name)

    def wrapped(*args, **kw):
        ts = [a for a in list(args) + list(kw.values())
              if isinstance(a, torch.Tensor)]
        assert not any(isinstance(t, DTensor) for t in ts), name
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)
    setattr(mod, name, wrapped)


def close(got, want, tol):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())


try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    spy(layers, "swap_linear")
    spy(attention, "flash_attention")
    spy(ssm, "wkv6")
    B, S = 4, 32
    for arch in ("qwen2.5-3b", "deepseek-v2-lite-16b", "rwkv6-3b"):
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        model = Model(cfg)
        plain = model.init(0, device="cpu")
        shape = ShapeConfig("t", seq_len=S, global_batch=B, mode="train")
        batch = make_batch_for(cfg, shape, seed=1)
        set_mesh(mesh)
        params = distribute(plain, train_state_specs(model)["params"], mesh)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        with implicit_replication():
            loss, _ = model.loss(params, distribute(
                batch, input_pspecs(cfg, shape, mesh), mesh))
            loss.backward()
        set_mesh(None)
        want = {"swap_linear"} | ({"wkv6"} if arch == "rwkv6-3b"
                                  else {"flash_attention"})
        assert want <= set(calls), (arch, calls)
        calls.clear()
        if arch == "rwkv6-3b":
            ref = tree_map(lambda t: t.clone().requires_grad_(True), plain)
            loss0, _ = model.loss(ref, batch)
            loss0.backward()
            loss = float(full_tensor(loss))
            assert abs(loss - float(loss0)) <= 1e-6 * abs(float(loss0))
            close(tree_map(lambda t: full_tensor(t.grad), params),
                  tree_map(lambda t: t.grad, ref), 1e-5)

    # a K-sharded (row-parallel) linear refuses a fused bias or activation
    set_mesh(mesh)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=g)
    w = torch.randn(16, 12, generator=g)
    b = torch.randn(12, generator=g)
    rep = [Replicate(), Replicate()]
    xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    for pl, kw in (([Replicate(), Shard(0)], {"b": b}),
                   ([Replicate(), Shard(0)], {"act": "silu"})):
        wd = distribute_tensor(w, mesh, pl)
        try:
            layers.linear(xd, wd, **kw)
        except ValueError as e:
            assert "K-sharded" in str(e), e
        else:
            raise AssertionError(f"no refusal for {kw}")
    # a quantized weight (serving) takes plain tensors only
    wq = QuantizedTensor(w.to(torch.int8), torch.ones(12), (16, 12),
                         "float32")
    try:
        layers.linear(xd, wq)
    except ValueError as e:
        assert "QuantizedTensor" in str(e), e
    else:
        raise AssertionError("no refusal for a quantized weight")
    with implicit_replication():
        y = layers.linear(xd, distribute_tensor(w, mesh, [Replicate(),
                                                          Shard(0)]))
        assert y.placements[1].is_partial(), y.placements
        yc = layers.linear(xd, distribute_tensor(w, mesh, [Replicate(),
                                                           Shard(1)]),
                           distribute_tensor(b, mesh, [Replicate(),
                                                       Shard(0)]),
                           act="silu")
        assert yc.placements[1].is_shard(1), yc.placements
    close(full_tensor(y), x @ w, 1e-5)
    close(full_tensor(yc), torch.nn.functional.silu(x @ w + b), 1e-5)
    set_mesh(None)
finally:
    dist.destroy_process_group()
"""


def test_kernels_take_local_shards():
    run_workers(WORKER)
