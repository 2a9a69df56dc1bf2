"""The port's training path against the JAX package's, on the CPU.

qwen2.5-3b ``reduced()`` in float32, params from the JAX ``Model.init``
handed over as numpy: the schedule, AdamW (in place here, functional
there), the synthetic batches (bitwise), ``Model.loss`` and its gradient
(the port's through ``SwapLinearFn`` and ``FlashAttentionFn``, the
reference's XLA autodiff), three train steps, checkpoints across the two
packages, ``scale_config`` and the ``launch/train.py`` CLI.

Tolerances: the loss within 1e-5 relative, each gradient leaf within 1e-4
of that leaf's largest |g| (float32; the sums run in another order), the
optimizer's leaves within 1e-6.
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.data.pipeline import make_batch_for as ref_make_batch_for  # noqa: E402
from repro.launch.train import scale_config as ref_scale_config  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.training import checkpoint as ref_checkpoint  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training.train_loop import TrainState as RefTrainState  # noqa: E402
from repro.training.train_loop import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, make_batch_for  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.serve import scale_config as serve_scale_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.optimizer import (OptConfig, adamw_init,  # noqa: E402
                                            adamw_update, lr_at)
from repro_torch.training.train_loop import TrainState, make_train_step  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402

ARCH = "qwen2.5-3b"
B, S = 2, 64


def to_np(a):
    """A JAX or torch leaf as numpy, bf16 as its uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.uint16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def pair(arch=ARCH, seed=0):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    ref_params = ref_model.init(jax.random.key(seed))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def batches(ref_cfg, batch=B, seq=S, seed=0, step=0):
    """The reference's batch ``step`` and the same batch as torch tensors."""
    rb = RefSyntheticLM(ref_cfg, seq, batch, seed).sample(step)
    return rb, {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}


def assert_grads_close(grads, ref_grads, tol=1e-4):
    """Each leaf within ``tol`` of that leaf's largest reference |g| (a leaf
    the loss never reads must be exactly zero in both)."""
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    flat = tree_flatten_with_path(grads)[0]
    assert len(flat) == len(ref_flat)
    for (path, g), (_, rg) in zip(flat, ref_flat):
        rg = np.asarray(rg, np.float64)
        g = np.zeros_like(rg) if g is None else g.detach().numpy()
        err = float(np.abs(g - rg).max())
        assert err <= tol * float(np.abs(rg).max()), (path, err,
                                                      np.abs(rg).max())


def port_loss_and_grads(model, params, batch):
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = model.loss(params, batch)
    loss.backward()
    grads = jax.tree.map(lambda p: p.grad, params,
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    return loss, metrics, grads


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("cfg", [OptConfig(peak_lr=1e-3, warmup_steps=10,
                                           total_steps=100),
                                 OptConfig(), OptConfig(warmup_steps=0)],
                         ids=["short", "default", "no-warmup"])
def test_lr_at_matches_reference(cfg):
    ref_cfg = ref_opt.OptConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 10_000, 20_000):
        want = float(ref_opt.lr_at(jnp.asarray(step), ref_cfg))
        assert lr_at(step, cfg) == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("gscale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(gscale):
    """Three steps on a tree of 1-D, 2-D and 3-D leaves, in place here:
    params, mu, nu and the metrics within 1e-6 (decay only on ndim >= 2;
    at gscale 10 the global norm is far above clip_norm 1)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 4), "b": (4,), "c": {"d": (3, 5, 2), "e": (7,)}}
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = OptConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    ref_cfg = ref_opt.OptConfig(**dataclasses.asdict(cfg))
    rp = jax.tree.map(jnp.asarray, tree)
    rmu, rnu = ref_opt.adamw_init(rp)
    p = params_from_jax(tree)
    mu, nu = adamw_init(p)
    for step in range(3):
        g = jax.tree.map(
            lambda a: (rng.normal(0, gscale, a.shape)).astype(np.float32),
            tree)
        rp, rmu, rnu, rm = ref_opt.adamw_update(
            rp, jax.tree.map(jnp.asarray, g), rmu, rnu,
            jnp.asarray(step, jnp.int32), ref_cfg)
        m = adamw_update(p, params_from_jax(g), mu, nu, step, cfg)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        assert m["lr"] == pytest.approx(float(rm["lr"]), rel=1e-6)
        for got, want in ((p, rp), (mu, rmu), (nu, rnu)):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7)
    if gscale > 1:
        assert float(rm["grad_norm"]) > 10 * cfg.clip_norm


# ------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2-vl-72b",
                                  "hubert-xlarge"])
def test_synthetic_batches_bitwise(arch):
    """The reference's draws in the reference's order: dense, vlm (vision
    embeddings in the config's bf16, M-RoPE positions) and audio
    (features, mask, random targets)."""
    ref_cfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    for seed, step in ((0, 0), (3, 7)):
        want = RefSyntheticLM(ref_cfg, 48, 3, seed).sample(step)
        got = SyntheticLM(cfg, 48, 3, seed).sample(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert str(got[k].dtype).replace("torch.", "") == \
                str(want[k].dtype), k
            np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]))


def test_prefetch_yields_the_stream():
    cfg = get_arch(ARCH).reduced()
    ds = SyntheticLM(cfg, 16, 2, seed=5)
    ref = RefSyntheticLM(ref_get_arch(ARCH).reduced(), 16, 2, seed=5)
    for step, b in zip(range(4), ds.prefetch(depth=2)):
        want = ref.sample(step)
        for k in want:
            np.testing.assert_array_equal(to_np(b[k]), to_np(want[k]))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2-vl-72b"])
def test_make_batch_for_matches_reference(arch, mode):
    want = ref_make_batch_for(ref_get_arch(arch).reduced(),
                              RefShape("s", 24, 2, mode), seed=2)
    got = make_batch_for(get_arch(arch).reduced(), ShapeConfig("s", 24, 2,
                                                               mode), seed=2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]))


@pytest.mark.parametrize("preset", ["smoke", "100m", "full"])
def test_scale_config_matches_reference(preset):
    """Moved to launch/train.py as in the reference, the reference's rules
    (moe, hybrid and M-RoPE included); serve.py re-exports it."""
    assert serve_scale_config is train_cli.scale_config
    for arch in ARCHS:
        got = dataclasses.asdict(train_cli.scale_config(get_arch(arch),
                                                        preset))
        want = dataclasses.asdict(ref_scale_config(ref_get_arch(arch),
                                                   preset))
        assert got == want, arch


# ------------------------------------------------------------- loss
def test_loss_and_grads_match_reference():
    ref_model, ref_params, model, params = pair()
    rb, tb = batches(ref_model.cfg)
    (want, ref_m), ref_grads = jax.value_and_grad(
        ref_model.loss, has_aux=True)(ref_params, rb)
    loss, m, grads = port_loss_and_grads(model, params, tb)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(m["tokens"]) == float(ref_m["tokens"]) == B * S
    assert float(m["aux"]) == float(ref_m["aux"]) == 0.0
    assert_grads_close(grads, ref_grads)


def test_loss_chunks_cover_the_sequence(monkeypatch):
    """At a LOSS_CHUNK of 16 the 64-token loss runs 4 checkpointed chunks
    and equals the one-chunk loss; a sequence the chunk does not divide
    takes one chunk, as in the reference."""
    from repro_torch.models import transformer
    ref_model, _, model, params = pair()
    _, tb = batches(ref_model.cfg)
    with torch.no_grad():
        whole = model.loss(params, tb)[0]
        monkeypatch.setattr(transformer, "LOSS_CHUNK", 16)
        calls = []
        real = transformer._chunk_nll
        monkeypatch.setattr(transformer, "_chunk_nll",
                            lambda h, *a: calls.append(h.shape[1])
                            or real(h, *a))
        chunked = model.loss(params, tb)[0]
        assert calls == [16] * 4
        calls.clear()
        model.loss(params, {k: v[:, :40] for k, v in tb.items()})
        assert calls == [40]
    assert float(chunked) == pytest.approx(float(whole), rel=1e-6)


@pytest.mark.parametrize("loss_chunk,want", [(16, [16] * 8), (512, [64])])
def test_loss_recomputes_only_when_chunked(monkeypatch, loss_chunk, want):
    """Backward recomputes each checkpointed chunk's logits (two calls a
    chunk) where the sequence takes several chunks; a single chunk holds
    the whole of the logits anyway and is not checkpointed (one call)."""
    from repro_torch.models import transformer
    _, _, model, params = pair()
    _, tb = batches(model.cfg)
    monkeypatch.setattr(transformer, "LOSS_CHUNK", loss_chunk)
    calls = []
    real = transformer._chunk_nll
    monkeypatch.setattr(transformer, "_chunk_nll",
                        lambda h, *a: calls.append(h.shape[1])
                        or real(h, *a))
    port_loss_and_grads(model, params, tb)
    assert calls == want


def test_launches_per_train_step(monkeypatch):
    """What a train step asks of the kernels, counted on the CPU where the
    wrappers run their plain versions: per layer, the 7 linears in the
    forward, 7 again when backward recomputes the checkpointed layer, and
    one act="none" recompute of wi0 inside its backward (15); attention
    once in the forward and once in the recompute (2). The lm head is a
    plain fp32 matmul, as in the reference."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import swap_linear as sl
    counts = {"sl": 0, "fa": 0}
    real_sl, real_fa = sl._swap_linear, fa._flash_attention

    def count(name, real):
        def fn(*a):
            counts[name] += 1
            return real(*a)
        return fn
    monkeypatch.setattr(sl, "_swap_linear", count("sl", real_sl))
    monkeypatch.setattr(fa, "_flash_attention", count("fa", real_fa))
    _, _, model, params = pair()
    _, tb = batches(model.cfg)
    port_loss_and_grads(model, params, tb)
    L = model.cfg.n_layers
    assert counts == {"sl": 15 * L, "fa": 2 * L}


def test_three_train_steps_match_reference():
    ref_model, ref_params, model, params = pair()
    cfg = OptConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_make_train_step(
        ref_model, ref_opt.OptConfig(**dataclasses.asdict(cfg))))
    rstate = RefTrainState(ref_params)
    state = TrainState(params)
    step_fn = make_train_step(model, cfg)
    for i in range(3):
        rb, tb = batches(ref_model.cfg, step=i)
        rstate, rm = ref_step(rstate, rb)
        state, m = step_fn(state, tb)
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
        assert m["lr"] == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert state["step"] == int(rstate["step"]) == 3
    assert all(p.grad is None for p in tree_leaves(state["params"]))
    # Adam's update is scale-free, so where a gradient is near zero its
    # summation-order noise moves the step; a step of the wrong sign would
    # move a param by 2 lr, and none moves by a tenth of that
    worst = max(float(np.abs(a.detach().numpy() - np.asarray(b)).max())
                for a, b in zip(tree_leaves(state["params"]),
                                jax.tree.leaves(rstate["params"])))
    assert worst <= 0.1 * cfg.peak_lr


# ------------------------------------------------------------- checkpoint
def test_checkpoint_round_trips_across_packages(tmp_path):
    """The port restores the reference's checkpoint and the reference the
    port's, bitwise, and the two write the same bytes."""
    _, ref_params, model, params = pair("gemma2-9b", seed=3)
    ref_checkpoint.save(str(tmp_path / "ref"), ref_params)
    checkpoint.save(str(tmp_path / "port"), params)
    for name in ("params.bin", "meta.json"):
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()
    like = jax.tree.map(torch.zeros_like, params,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    back = checkpoint.restore(str(tmp_path / "ref"), like)
    ref_like = jax.tree.map(jnp.zeros_like, ref_params)
    ref_back = ref_checkpoint.restore(str(tmp_path / "port"), ref_like)
    for a, b, c in zip(tree_leaves(back), jax.tree.leaves(ref_params),
                       jax.tree.leaves(ref_back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(c), np.asarray(b))
    # a bf16 tree round-trips as its bit patterns
    half = jax.tree.map(lambda t: t.to(torch.bfloat16), params,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    checkpoint.save(str(tmp_path / "half"), half)
    again = checkpoint.restore(str(tmp_path / "half"), half)
    for a, b in zip(tree_leaves(again), tree_leaves(half)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_checkpoint_refuses_a_mismatch(tmp_path):
    checkpoint.save(str(tmp_path), {"w": torch.ones(4, 4),
                                    "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), {"w": torch.ones(5, 4),
                                           "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="2 tensors, tree expects 1"):
        checkpoint.restore(str(tmp_path), {"w": torch.ones(4, 4)})


# ------------------------------------------------------------- launcher
def test_train_cli_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(["--arch", ARCH, "--reduce", "smoke", "--steps", "3",
                        "--device", "cpu", "--ckpt", str(tmp_path)])
    text = out.getvalue()
    assert re.search(r"\[train\] qwen2.5-3b-reduced: [\d.]+M params, 3 steps "
                     r"@ batch=8 seq=256 device=cpu", text)
    steps = re.findall(r"step +(\d+) loss= *([\d.]+) lr=\S+ gnorm=[\d.]+ "
                       r"tok/s=[\d,]+", text)
    assert [int(s) for s, _ in steps] == [0, 2]
    assert re.search(r"\[train\] loss [\d.]+ -> [\d.]+ \((DECREASED|no "
                     r"decrease)\)", text)
    assert (tmp_path / "params.bin").exists()


def test_train_cli_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", ARCH, "--reduce", "smoke", "--steps", "1"])
