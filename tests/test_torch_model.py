"""The port's dense model against the JAX package's, on the same weights.

qwen2.5-3b covers GQA with qkv bias, RoPE and swiglu; gemma2-9b covers the
sliding window on alternating layers, the attention and final logit
softcaps, ``plus_one`` norms, post-norms, the embedding scale and gelu_glu.
Both ``reduced()``, float32, params from JAX ``Model.init`` handed over as
numpy (``repro_torch.convert``).

Tolerance: 1e-5 (float32 on both sides; the sums run in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.models.transformer import alloc_cache as ref_alloc_cache  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen2.5-3b", "gemma2-9b"]
# llama4's moe stack and its frontend stub: the numbers are held in
# tests/test_torch_moe.py
LAYOUT_ARCHS = ARCHS + ["llama4-scout-17b-a16e"]


def _pair(arch, seed=0):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    ref_params = ref_model.init(jax.random.key(seed))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_params_layout_matches_reference(arch):
    """Same keys, shapes and dtypes, leaf for leaf in JAX's order; the
    port's own init draws the same shapes."""
    ref_model, ref_params, model, params = _pair(arch)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    own = model.init(0, device="cpu")
    for tree in (params, own):
        flat = tree_flatten_with_path(tree)[0]
        assert len(flat) == len(ref_flat)
        for (p, leaf), (rp, rleaf) in zip(flat, ref_flat):
            assert p == tuple(getattr(k, "key", getattr(k, "idx", None))
                              for k in rp)
            assert tuple(leaf.shape) == tuple(rleaf.shape)
            assert leaf.dtype == torch.float32


@pytest.mark.parametrize("seq", [32, 96])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch, seq):
    """seq 96 passes gemma's 64-token reduced window."""
    ref_model, ref_params, model, params = _pair(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, model.cfg.vocab_size, (2, seq)).astype(np.int32)
    want, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == (2, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(cache[0]["k"].shape) == (
        model.cfg.n_layers, 2, seq, model.cfg.n_kv_heads,
        model.cfg.resolved_head_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    ref_model, ref_params, model, params = _pair(arch)
    B, L = 2, 16
    rng = np.random.default_rng(2)
    toks = rng.integers(0, model.cfg.vocab_size, (B, 5)).astype(np.int32)
    ref_cache = ref_alloc_cache(ref_model, ShapeConfig("d", L, B, "decode"))
    cache = model.alloc_cache(B, L, device="cpu")
    for t in range(toks.shape[1]):
        tok = toks[:, t:t + 1]
        want, ref_cache = ref_model.decode_step(
            ref_params, ref_cache,
            {"token": jnp.asarray(tok), "pos": jnp.full((B,), t, jnp.int32)})
        got, cache = model.decode_step(
            params, cache, {"token": torch.from_numpy(tok),
                            "pos": torch.full((B,), t, dtype=torch.long)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", sorted(port_configs.ARCHS))
def test_every_arch_builds_and_prefills_on_cpu(arch):
    """Every config the port carries builds and runs one prefill on the
    CPU: token ids, or frame features for a model without token inputs
    (hubert); finite last-position logits."""
    cfg = get_arch(arch).reduced()
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    if cfg.embed_inputs:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32))}
    else:
        batch = {"features": torch.from_numpy(rng.standard_normal(
            (2, 16, cfg.d_frontend)).astype(np.float32))}
    logits, _ = model.prefill(params, batch)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("op", ["tree_map", "tree_flatten", "cast"])
def test_tree_ops_release_leaves_without_gc(op):
    """Flattening, mapping and casting a param tree keep no reference to
    its leaves: a tree dropped by its caller frees its tensors at once,
    not when the cyclic garbage collector next runs (device tensors of a
    swapped-out block would otherwise outlive their ledger charge)."""
    import gc
    import weakref

    from repro_torch import tree as tr
    leaf = torch.zeros(8)
    ref = weakref.ref(leaf)
    tree = {"b": [leaf, None], "a": (torch.ones(2),)}
    gc.disable()
    try:
        if op == "cast":
            out = Model(get_arch("qwen2.5-3b").reduced()).cast(tree)
        elif op == "tree_map":
            out = tr.tree_map(lambda a: a + 1, tree)
        else:
            leaves, treedef = tr.tree_flatten(tree)
            out = tr.tree_unflatten(treedef, [a * 2 for a in leaves])
            del leaves
        del tree, leaf
        assert ref() is None
        assert out["b"][1] is None and len(out["a"]) == 1
    finally:
        gc.enable()
    with pytest.raises(ValueError):
        tr.tree_unflatten(tr.tree_flatten({"a": 1, "b": 2})[1], [1])
