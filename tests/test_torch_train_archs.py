"""``Model.loss`` and its gradient against the JAX package's
``jax.value_and_grad(Model.loss)``, one arch of each family the port
serves, ``reduced()`` in float32 on the CPU:

- gemma2-9b: the attention and final softcaps, the window on its local
  layer (S 96 passes the reduced 64-token window), post-norms, the
  embedding scale;
- llama4-scout: the moe layers' load-balance aux loss in the loss, the
  block-local chunk (8 tokens reduced), capacity drops;
- deepseek-v2-lite: MLA (B4 at a value head dim of its own) and moe;
- zamba2-7b: Mamba2's chunked SSD under autograd and the shared block,
  one param tree whose gradient sums over its occurrences (Mamba2's
  ``norm``, which nothing reads, gets a zero gradient in both);
- rwkv6-3b: wkv6 under ``WKV6Fn`` (its plain version forward on the CPU,
  ``wkv6_grad`` backward);
- qwen2-vl-72b: M-RoPE positions and vision embeddings in the batch;
- hubert-xlarge: the bidirectional encoder, ``mask_emb`` on the masked
  frames and the loss weighed by the mask;
- h2o-danube-3-4b: the sliding window on every layer (S 96 passes the
  reduced 64-token window);
- granite-20b: multi-query attention and the non-gated GELU MLP.

``reduced()`` sets head dim 64 and at most 4 heads; danube and granite
are also held at their published head geometry on the reduced widths
(danube 32 / 8 heads of 120, granite 48 / 1 heads of 128), the
attention ``chip_smoke.py`` phase 17 trains on the card.

Tolerance: the loss within 1e-5 relative, each gradient leaf within 1e-4
of that leaf's largest |g| (float32; the sums run in another order).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402

# arch: (batch, seq)
ARCHS = {
    "gemma2-9b": (2, 96),
    "llama4-scout-17b-a16e": (2, 32),
    "deepseek-v2-lite-16b": (2, 32),
    "zamba2-7b": (2, 32),
    "rwkv6-3b": (2, 32),
    "qwen2-vl-72b": (2, 32),
    "hubert-xlarge": (2, 32),
    "h2o-danube-3-4b": (2, 96),
    "granite-20b": (2, 32),
}
# the published head geometry on the reduced widths
GEOMETRY = {
    "h2o-danube-3-4b": dict(n_heads=32, n_kv_heads=8, head_dim=120),
    "granite-20b": dict(n_heads=48, n_kv_heads=1, head_dim=128),
}


def _check_loss_and_grads(arch, **geometry):
    """The port's loss and every gradient leaf against the reference's on
    the reduced config (with ``geometry``'s fields replaced in both)."""
    B, S = ARCHS[arch]
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(),
                                  dtype="float32", **geometry)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                              **geometry)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    rb = RefSyntheticLM(ref_cfg, S, B, seed=1).sample(0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}

    (want, ref_m), ref_grads = jax.jit(jax.value_and_grad(
        ref_model.loss, has_aux=True))(ref_params, rb)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, m = model.loss(params, tb)
    loss.backward()

    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(m["tokens"]) == float(ref_m["tokens"])
    assert float(m["aux"].detach()) == pytest.approx(float(ref_m["aux"]), rel=1e-5,
                                            abs=1e-12)
    if cfg.moe is not None:
        assert float(ref_m["aux"]) > 0
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    flat = tree_flatten_with_path(params)[0]
    assert len(flat) == len(ref_flat)
    for (path, p), (_, rg) in zip(flat, ref_flat):
        rg = np.asarray(rg, np.float64)
        g = np.zeros_like(rg) if p.grad is None else p.grad.numpy()
        err = float(np.abs(g - rg).max())
        assert err <= 1e-4 * float(np.abs(rg).max()), (path, err)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_reference(arch):
    _check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", sorted(GEOMETRY))
def test_loss_and_grads_at_published_head_geometry(arch):
    """danube's 32 / 8 heads of 120 (its window at the reduced 64 tokens,
    S 96) and granite's 48 query heads of 128 on one KV head: B4's
    grouping and head dim under ``FlashAttentionFn``'s backward."""
    _check_loss_and_grads(arch, **GEOMETRY[arch])


# per layer kind: (swap_linear, flash_attention, wkv6) launches of one train
# step. Each layer is checkpointed, so its forward runs twice; a gated MLP
# (swiglu, GeGLU, a moe layer's shared expert) relaunches its gate once at
# act "none" in SwapLinearFn's backward. dense: wq, wk, wv, wo + wi0, wi1,
# wo (hubert's and granite's GELU MLP: wi, wo); MLA + moe: wq, wo + the
# shared expert's three; Mamba2 and rwkv6: wo. The head, the routed experts
# and the other projections are plain matmuls, as in the reference.
# chip_smoke.py's ``train_launches`` holds the card's train steps to the
# same counts.
LAUNCHES_PER_LAYER = {
    "gemma2-9b": {"dense": (15, 2, 0)},
    "llama4-scout-17b-a16e": {"moe": (15, 2, 0)},
    "deepseek-v2-lite-16b": {"moe": (11, 2, 0)},
    "zamba2-7b": {"mamba2": (2, 0, 0), "shared_attn": (15, 2, 0)},
    "rwkv6-3b": {"rwkv6": (2, 0, 2)},
    "qwen2-vl-72b": {"dense": (15, 2, 0)},
    "hubert-xlarge": {"dense": (12, 2, 0)},
    "h2o-danube-3-4b": {"dense": (15, 2, 0)},
    "granite-20b": {"dense": (12, 2, 0)},
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_launches_per_train_step(monkeypatch, arch):
    """What one train step asks of the kernels, counted on the CPU where
    the wrappers run their plain versions, per layer kind of the plan."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import swap_linear as sl
    from repro_torch.kernels import wkv6 as kw
    counts = [0, 0, 0]

    def count(i, real):
        def fn(*a):
            counts[i] += 1
            return real(*a)
        return fn
    monkeypatch.setattr(sl, "_swap_linear", count(0, sl._swap_linear))
    monkeypatch.setattr(fa, "_flash_attention", count(1, fa._flash_attention))
    monkeypatch.setattr(kw, "_wkv6", count(2, kw._wkv6))
    B, S = ARCHS[arch]
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    rb = RefSyntheticLM(dataclasses.replace(ref_get_arch(arch).reduced(),
                                            dtype="float32"), S, B,
                        seed=1).sample(0)
    loss, _ = model.loss(params, {k: torch.from_numpy(np.array(v))
                                  for k, v in rb.items()})
    loss.backward()
    want = [0, 0, 0]
    for seg in model.plan:
        for i, n in enumerate(LAUNCHES_PER_LAYER[arch][seg.kind]):
            want[i] += n * seg.n
    assert counts == want


def test_zamba2_gradient_stays_finite_at_strong_decays():
    """zamba2 at 12 reduced layers: on batch 0 the SSD's decays are strong
    enough that exp(l_t - l_i) above a chunk's diagonal overflows. The
    port masks the exponent before the exp, so its gradient stays finite
    (the reference exps it unmasked, and backward's inf * 0 turns its
    gradient there NaN); its loss equals the reference's, and on batch 2,
    where the reference's gradient is finite, every leaf matches it."""
    arch, B, S = "zamba2-7b", 2, 32
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), n_layers=12,
                                  dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=12,
                              dtype="float32")
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    grad_fn = jax.jit(jax.value_and_grad(ref_model.loss, has_aux=True))
    for step in (0, 2):
        rb = RefSyntheticLM(ref_cfg, S, B, seed=0).sample(step)
        (want, _), ref_grads = grad_fn(ref_params, rb)
        for p in tree_leaves(params):
            p.grad = None
        loss, _ = model.loss(params, {k: torch.from_numpy(np.array(v))
                                      for k, v in rb.items()})
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
        flat = tree_flatten_with_path(params)[0]
        assert all(bool(torch.isfinite(p.grad).all()) for _, p in flat
                   if p.grad is not None)
        if step == 0:
            continue
        ref_flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
        for (path, p), (_, rg) in zip(flat, ref_flat):
            rg = np.asarray(rg, np.float64)
            g = np.zeros_like(rg) if p.grad is None else p.grad.numpy()
            err = float(np.abs(g - rg).max())
            assert err <= 1e-4 * float(np.abs(rg).max()), (path, err)
