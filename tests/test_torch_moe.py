"""llama4-scout's MoE stack in the port against the JAX package's.

``moe_apply`` (router, top-k, capacity with dropped assignments, the
routed and shared experts, the aux loss), block-local (iRoPE) attention
in ``online_attention`` and in ``flash_attention``'s plain version, the
reduced model's prefill and contiguous decode, its swap units, the
swapped pass, the quantized store and the serve CLI.

The reduced config is ``reduced()`` with 4 layers, float32: d_model 256,
4 heads / 2 KV heads of 64, 4 experts of 128 plus a shared one, top-1,
attn_chunk 8 (layers 0-2 local, layer 3 global), vocab 512. Params come
from the JAX ``Model.init`` and are handed over as numpy.

Tolerances, with their reasons:
  * float32: rtol = atol = 1e-5 (the sums run in another order);
  * ``moe_apply`` alone: 1e-5 of the output's largest value. A routed
    stack's init scale is E ** -0.5 (its fan_in is E, the reference's
    rule), so the expert outputs reach several hundred, and fp32 sums in
    another order differ there by a few 1e-5 absolute;
  * swapped vs unswapped inside the port on mmap: bitwise (the same ops
    on the same bytes);
  * quantized store files and CRCs: byte-equal; its swapped logits
    against the JAX package's quantized swapped logits and against the
    port's in-memory model on the round-tripped weights: 1e-5 (float32).
    Neither package's quantized logits come within 2e-2 of the fp
    model's on this config (int8 about 3e-2, int4 above 1 relative to the
    largest logit: the reduced model's expert activations reach several
    hundred), so the test holds the port to the reference's error, not to
    a bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.core.cost_model import DelayModel as RefDelayModel  # noqa: E402
from repro.core.runtime import SwappedModel as RefSwappedModel  # noqa: E402
from repro.core.runtime import split_units as ref_split_units  # noqa: E402
from repro.core.runtime import unit_infos as ref_unit_infos  # noqa: E402
from repro.core.swap_engine import MemoryLedger as RefLedger  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.attention import online_attention as ref_online  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.models.transformer import alloc_cache as ref_alloc_cache  # noqa: E402
from repro.serving.paged_kv import PagedBatchView as RefView  # noqa: E402
from repro.serving.paged_kv import PagedKVCache as RefPagedKV  # noqa: E402
from repro.store import build_store as ref_build_store  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import (SwappedModel, split_units,  # noqa: E402
                                      unit_infos)
from repro_torch.core.swap_engine import MemoryLedger  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import swap_linear as sl  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.attention import online_attention  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.paged_kv import PagedBatchView, PagedKVCache  # noqa: E402
from repro_torch.store import build_store  # noqa: E402
from repro_torch.store.quantized_store import roundtrip  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

ARCH = "llama4-scout-17b-a16e"
TOL = dict(rtol=1e-5, atol=1e-5)
BUDGET = 8 * 1024 * 1024


def _cfgs(**kw):
    ref = dataclasses.replace(ref_get_arch(ARCH).reduced(), n_layers=4,
                              dtype="float32", **kw)
    own = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=4,
                              dtype="float32", **kw)
    return ref, own


@pytest.fixture(scope="module")
def pair():
    ref_cfg, cfg = _cfgs()
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def _tokens(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------------------------ moe
def _ref_routing(cfg, router, xf):
    """top_e as the reference's moe_apply computes it."""
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_apply_matches_reference(pair, top_k):
    """Routing identical, at least one assignment dropped by the capacity,
    then the output and the aux loss within 1e-5."""
    ref_model, ref_params, model, params = pair
    ref_cfg = dataclasses.replace(
        ref_model.cfg, moe=dataclasses.replace(ref_model.cfg.moe,
                                               top_k=top_k))
    cfg = dataclasses.replace(
        model.cfg, moe=dataclasses.replace(model.cfg.moe, top_k=top_k))
    B, S, D = 2, 48, cfg.d_model
    x = np.random.default_rng(5).standard_normal((B, S, D)).astype(np.float32)
    ref_p = jax.tree.map(lambda a: a[0], ref_params["segments"][0]["ffn"])
    p = {k: v for k, v in params["segments"][0]["ffn"].items()}
    p = jax.tree.map(lambda a: a[0], p)

    top_e = _ref_routing(cfg, ref_p["router"], x.reshape(-1, D))
    _, own_e, _ = moe.route(cfg, p["router"], torch.from_numpy(x)
                            .reshape(-1, D))
    np.testing.assert_array_equal(own_e.numpy(), top_e)
    C = moe.capacity(cfg, B * S)
    assert C == max(8, int(-(-B * S * top_k // cfg.moe.n_routed)
                           * cfg.moe.capacity_factor) // 8 * 8)
    counts = np.bincount(top_e.reshape(-1), minlength=cfg.moe.n_routed)
    assert np.maximum(counts - C, 0).sum() > 0, (counts, C)

    want, want_aux = ref_moe.moe_apply(ref_cfg, ref_p, jnp.asarray(x))
    got, aux = moe.moe_apply(cfg, p, torch.from_numpy(x))
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


# ------------------------------------------------------------------ attention
def _qkv(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((B, S, n, hd)) * 0.5).astype(np.float32)
                 for n in (H, KV, KV))


@pytest.mark.parametrize("block", [8, 24, 100])
@pytest.mark.parametrize("window", [None, 6])
def test_block_local_attention_matches_reference(block, window):
    """S 24: three chunks of 8, and chunks of S or more, which equal no
    chunk. ``online_attention``'s block_local and ``flash_attention``'s
    plain version with ``chunk`` against the reference's online_attention."""
    B, S, H, KV, hd = 2, 24, 4, 2, 16
    q, k, v = _qkv(B, S, H, KV, hd, block)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kw = dict(causal=True, window=window, scale=hd ** -0.5, logit_cap=None)
    want = np.asarray(ref_online(*(jnp.asarray(a) for a in (q, k, v)),
                                 jnp.asarray(pos), None, chunk=8,
                                 block_local=block, **kw))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tpos = torch.from_numpy(pos)
    got = online_attention(*t, tpos, None, chunk=8, block_local=block, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = fa.flash_attention_plain(*t, tpos, scale=hd ** -0.5,
                                     window=window, chunk=block)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    assert torch.equal(fa.flash_attention(*t, tpos, scale=hd ** -0.5,
                                          window=window, chunk=block), plain)
    if block >= S:
        none = fa.flash_attention_plain(*t, tpos, scale=hd ** -0.5,
                                        window=window)
        assert torch.equal(plain, none)
    else:
        # the mask bites: query 8 attends to key 8 alone
        assert not np.allclose(plain.numpy(), fa.flash_attention_plain(
            *t, tpos, scale=hd ** -0.5, window=window).numpy(), **TOL)


def test_flash_attention_chunk_arguments():
    t = [torch.zeros(1, 4, 2, 8) for _ in range(3)]
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="chunk"):
        fa.flash_attention_plain(*t, pos, scale=1.0, chunk=0)
    with pytest.raises(ValueError, match="non-causal"):
        fa.flash_attention(*t, pos, scale=1.0, causal=False, chunk=2)
    out = fa.flash_attention(*t, pos, scale=1.0, causal=False,
                             chunk=fa.LARGE_WINDOW)
    assert torch.equal(out, fa.flash_attention(*t, pos, scale=1.0,
                                               causal=False))


# ------------------------------------------------------------------ model
def test_params_layout_matches_reference(pair):
    """Same keys (``frontend`` included), shapes and dtypes, leaf for
    leaf; the port's own init draws the same shapes."""
    ref_model, ref_params, model, params = pair
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    own = model.init(0, device="cpu")
    assert tuple(own["frontend"].shape) == (model.cfg.d_frontend,
                                            model.cfg.d_model)
    for tree in (params, own):
        flat = tree_flatten_with_path(tree)[0]
        assert len(flat) == len(ref_flat)
        for (p, leaf), (rp, rleaf) in zip(flat, ref_flat):
            assert p == tuple(getattr(k, "key", getattr(k, "idx", None))
                              for k in rp)
            assert tuple(leaf.shape) == tuple(rleaf.shape)
            assert leaf.dtype == torch.float32
    # a routed stack's fan_in is E: the reference's scale
    stack = own["segments"][0]["ffn"]["wi0"]
    assert abs(float(stack.std()) - model.cfg.moe.n_routed ** -0.5) < 0.05


def test_prefill_logits_match_reference(pair):
    """S 24 > attn_chunk 8: the local layers' mask cuts the prompt."""
    ref_model, ref_params, model, params = pair
    tokens = _tokens(model.cfg, 2, 24)
    want, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == (2, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(cache[0]["k"].shape) == (4, 2, 24, 2, 64)


def test_decode_steps_across_a_chunk_boundary(pair):
    """Contiguous decode of positions 0-5 as context, then four steps at
    positions 6-9, across the chunk boundary at 8."""
    ref_model, ref_params, model, params = pair
    B, L = 2, 16
    toks = _tokens(model.cfg, B, 10, seed=2)
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
        if t >= 6:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ runtime
def test_units_and_infos_match_reference(pair):
    """Unit names and byte sizes (the embed unit holds ``frontend``) and
    the info table's FLOPs: active experts only, no chunk discount."""
    ref_model, ref_params, model, params = pair
    ref_units = ref_split_units(ref_model, ref_params)
    units = split_units(model, params)
    assert [u.name for u in units] == [u.name for u in ref_units]
    assert sorted(units[0].params) == ["embed", "frontend"]
    want = ref_unit_infos(ref_model, ref_units, 2, 24)
    got = unit_infos(model, units, 2, 24)
    assert [(r.name, r.size, r.depth, r.flops) for r in got] == \
        [(r.name, r.size, r.depth, r.flops) for r in want]


def test_swapped_equals_unswapped_bitwise(pair, tmp_path):
    ref_model, ref_params, model, params = pair
    tokens = torch.from_numpy(_tokens(model.cfg, 2, 24))
    sm = SwappedModel(model, params, str(tmp_path), device="cpu",
                      store_backend="mmap")
    try:
        sm.partition(BUDGET, DelayModel(), 2, 24)
        assert sm.plan.n_blocks >= 3
        sl.launches.reset()
        got, stats = sm.forward({"tokens": tokens})
        direct = sm.forward_unswapped({"tokens": tokens})
    finally:
        sm.close()
    assert torch.equal(got, direct)
    assert stats["peak_resident_mb"] * 1e6 <= BUDGET
    want, _ = model.prefill(params, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_decode_loop_tokens_match_reference(pair, tmp_path):
    """Weight-streaming greedy decode: a 6-token prompt fed one token at
    a time, then 5 new tokens, past position 8 where the local layers'
    block-local mask starts cutting the context."""
    ref_model, ref_params, model, params = pair
    prompt = _tokens(model.cfg, 2, 6, seed=3)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref.partition(budget=BUDGET, dm=RefDelayModel(), batch=2, seq=6)
    want, _ = ref.decode_loop(jnp.asarray(prompt), max_new_tokens=5,
                              max_len=16)
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    try:
        sm.partition(BUDGET, DelayModel(), 2, 6)
        got, stats = sm.decode_loop(torch.from_numpy(prompt),
                                    max_new_tokens=5, max_len=16)
    finally:
        sm.close()
    assert got.tolist() == np.asarray(want).tolist()
    assert stats["peak_resident_mb"] * 1e6 <= BUDGET


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_store_matches_reference(pair, tmp_path, bits):
    """Unit files and CRCs byte-equal to the JAX package's store; the 3-D
    expert stacks quantized but not fused (dequantized at use), the shared
    expert's 2-D weights fused; the swapped logits equal the reference's
    quantized swapped model's and the in-memory model's on round-tripped
    weights, and so carry the reference's quantization error."""
    ref_model, ref_params, model, params = pair
    ref = ref_build_store([(u.name, u.params) for u in
                           ref_split_units(ref_model, ref_params)],
                          str(tmp_path / "ref"), backend="quant", bits=bits)
    port = build_store([(u.name, u.params) for u in
                        split_units(model, params)],
                       str(tmp_path / "port"), backend="quant", device="cpu",
                       bits=bits)
    assert port.order == ref.order
    for name in ref.order:
        with open(ref._path(name), "rb") as a, open(port._path(name),
                                                    "rb") as b:
            assert a.read() == b.read(), name
        assert port.resident_nbytes(name) == ref.resident_nbytes(name)
    assert port.digests == ref.digests
    leaves = dict(zip(
        [p for p, _ in tree_flatten_with_path(
            split_units(model, params)[1].params)[0]],
        port._qmeta["layer000_moe"].leaves))
    for key in ("wi0", "wi1", "wo"):
        routed, shared = leaves[("ffn", key)], leaves[("ffn", "shared", key)]
        assert routed.scale_offset >= 0 and not routed.fusable
        assert len(routed.shape) == 3 and routed.bits == bits
        assert shared.scale_offset >= 0 and shared.fusable

    tokens = _tokens(model.cfg, 2, 24)
    prec = "int8" if bits == 8 else "int4"
    ref_sm = RefSwappedModel(ref_model, ref_params, str(tmp_path / "rsm"),
                             store_backend="quant", precision=prec)
    sm = SwappedModel(model, params, str(tmp_path / "sm"), device="cpu",
                      store_backend="quant", precision=prec)
    try:
        ref_sm.partition(budget=BUDGET, dm=RefDelayModel(), batch=2, seq=24)
        sm.partition(BUDGET, DelayModel(), 2, 24)
        want, _ = ref_sm.forward({"tokens": jnp.asarray(tokens)})
        got, _ = sm.forward({"tokens": torch.from_numpy(tokens)})
        direct = sm.forward_unswapped(
            {"tokens": torch.from_numpy(tokens)},
            unit_params=[roundtrip(u.params, bits) for u in sm.units])
    finally:
        sm.close()
        ref_sm.close()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), **TOL)
    fp, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    ref_fp, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    err = float((got - fp).abs().max() / fp.abs().max())
    ref_err = float(np.abs(np.asarray(want) - np.asarray(ref_fp)).max()
                    / np.abs(np.asarray(ref_fp)).max())
    assert err == pytest.approx(ref_err, rel=1e-3, abs=1e-5)


# ------------------------------------------------------------------ paged
def _paged_logits_port(sm, cfg, prompt, tok):
    kv = PagedKVCache(cfg, MemoryLedger(1 << 30), page_tokens=4,
                      max_pages=16, device="cpu")
    assert kv.alloc(0, len(prompt))
    state, _ = sm.forward_partial(
        {"tokens": torch.tensor([prompt], dtype=torch.int32)},
        collect_cache=True)
    pids, slots = kv.slots(0, range(len(prompt)))
    for lid, c in state.caches.items():
        kv.write_rows(lid, pids, slots, c["k"][0], c["v"][0])
    assert kv.extend(0, 1)
    out = sm.decode_step_paged(
        {"token": torch.tensor([[tok]], dtype=torch.int32),
         "pos": torch.tensor([len(prompt)])}, PagedBatchView(kv, [0]))
    return out[0, -1].numpy()


def _paged_logits_ref(sm, cfg, prompt, tok):
    kv = RefPagedKV(cfg, RefLedger(1 << 30), page_tokens=4, max_pages=16)
    assert kv.alloc(0, len(prompt))
    state, _ = sm.forward_partial(
        {"tokens": jnp.asarray([prompt], jnp.int32)}, collect_cache=True)
    for lid, c in state.caches.items():
        kv.write(0, lid, 0, np.asarray(c["k"][0]), np.asarray(c["v"][0]))
    assert kv.extend(0, 1)
    out = sm.decode_step_paged(
        {"token": jnp.asarray([[tok]], jnp.int32),
         "pos": jnp.asarray([len(prompt)], jnp.int32)}, RefView(kv, [0]))
    return np.asarray(out)[0, -1]


def _contiguous_logits(model, params, prompt, tok, ref: bool):
    toks = list(prompt) + [tok]
    L = len(toks)
    if ref:
        cache = ref_alloc_cache(model, ShapeConfig("d", L, 1, "decode"))
    else:
        cache = model.alloc_cache(1, L, device="cpu")
    for t, x in enumerate(toks):
        if ref:
            out, cache = model.decode_step(params, cache, {
                "token": jnp.asarray([[x]], jnp.int32),
                "pos": jnp.asarray([t], jnp.int32)})
        else:
            out, cache = model.decode_step(params, cache, {
                "token": torch.tensor([[x]]), "pos": torch.tensor([t])})
    return np.asarray(out)[0, -1] if ref else out[0, -1].numpy()


def test_paged_decode_ignores_block_local(pair, tmp_path):
    """Kept from the reference for parity: a paged decode step passes only
    the window to its attention hook, so a local layer past position
    attn_chunk (8) attends globally there, while the contiguous decode
    masks block-locally. Both packages agree on both paths; the paths
    agree with each other inside the first chunk only."""
    ref_model, ref_params, model, params = pair
    ref_sm = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref_sm.partition(budget=BUDGET, dm=RefDelayModel(), batch=1, seq=12)
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    sm.partition(BUDGET, DelayModel(), 1, 12)
    try:
        rng = np.random.default_rng(4)
        prompt = list(map(int, rng.integers(0, model.cfg.vocab_size, 12)))
        tok = int(rng.integers(0, model.cfg.vocab_size))
        for n in (6, 12):       # decode at position 6 (chunk 0), 12 (chunk 1)
            p_port = _paged_logits_port(sm, model.cfg, prompt[:n], tok)
            p_ref = _paged_logits_ref(ref_sm, ref_model.cfg, prompt[:n], tok)
            c_port = _contiguous_logits(model, params, prompt[:n], tok, False)
            c_ref = _contiguous_logits(ref_model, ref_params, prompt[:n], tok,
                                       True)
            np.testing.assert_allclose(p_port, p_ref, **TOL)
            np.testing.assert_allclose(c_port, c_ref, **TOL)
            if n < model.cfg.attn_chunk:
                np.testing.assert_allclose(p_port, c_port, **TOL)
                np.testing.assert_allclose(p_ref, c_ref, **TOL)
            else:
                assert np.abs(p_port - c_port).max() > 1e-3
                assert np.abs(p_ref - c_ref).max() > 1e-3
    finally:
        sm.close()
        ref_sm.close()


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("paged", [False, True])
def test_serve_entry_runs_on_cpu(capsys, paged):
    args = ["--arch", ARCH, "--reduce", "smoke", "--requests", "2",
            "--prompt-len", "12", "--new-tokens", "3", "--device", "cpu"]
    if paged:
        args += ["--budget-mb", "24", "--paged", "--kv-frac", "0.3",
                 "--page-tokens", "4", "--max-batch", "2"]
    else:
        args += ["--budget-mb", "8"]
    out = serve.main(args)
    text = capsys.readouterr().out
    if paged:
        assert "[serve-paged] 2 requests x 3 new tokens" in text
        assert "(OK)" in text
        assert [len(r.output) for r in out["requests"]] == [3, 3]
    else:
        assert "[serve] swapped prefill" in text and "device=cpu" in text
        assert tuple(out["tokens"].shape) == (2, 3)
        assert torch.isfinite(out["logits"]).all()
