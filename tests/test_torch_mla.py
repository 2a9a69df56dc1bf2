"""deepseek-v2-lite's Multi-head Latent Attention in the port against the
JAX package's.

``mla_apply`` (the prefill that up-projects k and v from the latents and
attends through ``flash_attention`` at a query-key head dim of 48 and a
value head dim of 32; the absorbed decode on the latent cache),
``flash_attention``'s plain version at a value head dim of its own, the
reduced model's prefill and contiguous decode, its swap units, the swapped
pass, weight-streaming decode, the in-memory engine, the quantized store,
the paged cache's refusal and the serve CLI.

The reduced config is ``reduced()`` in float32: 2 moe layers, d_model 256,
4 heads, MLA kv_lora_rank 64 / qk_nope 32 / qk_rope 16 / v 32, 4 routed
experts of 128 at top-2 plus a shared expert of 128, vocab 512. Params
come from the JAX ``Model.init`` and are handed over as numpy.

Tolerances, with their reasons:
  * float32: rtol = atol = 1e-5 (the sums run in another order);
  * the absorbed decode against the up-projected attention on the same
    cache, inside the port: 1e-5 (the same function, associated another
    way: (q W_uk^T) c^T against q (c W_uk)^T);
  * swapped vs unswapped inside the port on mmap: bitwise (the same ops
    on the same bytes);
  * quantized store files and CRCs: byte-equal; its swapped logits
    against the JAX package's quantized swapped logits: 1e-5, and the
    distance of each from its fp model the same (the E ** -0.5 expert init
    keeps both packages' quantized logits far from the fp ones, so the
    test holds the port to the reference's error, not to a bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.cost_model import DelayModel as RefDelayModel  # noqa: E402
from repro.core.runtime import SwappedModel as RefSwappedModel  # noqa: E402
from repro.core.runtime import split_units as ref_split_units  # noqa: E402
from repro.core.runtime import unit_infos as ref_unit_infos  # noqa: E402
from repro.core.swap_engine import MemoryLedger as RefLedger  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingEngine as RefServingEngine  # noqa: E402
from repro.serving.paged_kv import PagedKVCache as RefPagedKV  # noqa: E402
from repro.store import build_store as ref_build_store  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import (SwappedModel, split_units,  # noqa: E402
                                      unit_infos)
from repro_torch.core.swap_engine import MemoryLedger  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.layers import apply_rope, rope_angles  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.paged_kv import PagedKVCache  # noqa: E402
from repro_torch.store import build_store  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-5, atol=1e-5)
BUDGET = 8 * 1024 * 1024
SWAP_BUDGET = 5 * 1024 * 1024     # under the 5.9 MB of units: 3 blocks
# the reference's mla_apply, compiled once per shape (cfg is static)
ref_mla_apply = jax.jit(ref_attn.mla_apply, static_argnums=0)


@pytest.fixture(scope="module")
def pair():
    ref_cfg = dataclasses.replace(ref_get_arch(ARCH).reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def _tokens(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _attn_params(ref_params, params):
    """Layer 0's attention params: (reference, port)."""
    ref_p = jax.tree.map(lambda a: a[0], ref_params["segments"][0]["attn"])
    p = {k: v[0] for k, v in params["segments"][0]["attn"].items()}
    return ref_p, p


def _x(cfg, B, S, seed):
    return (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
            .astype(np.float32))


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S), (B, S)).astype(
        np.int32)


# ------------------------------------------------------------------ model
def test_reduced_model_builds_and_defs_match_reference(pair):
    """MLA defs replace GQA's; the full-width config builds too. The
    port's own init draws the reference's shapes, and params_from_jax
    carries every MLA leaf across."""
    ref_model, ref_params, model, params = pair
    full = Model(get_arch(ARCH))
    attn_defs = full.defs["segments"][0]["attn"]
    assert sorted(attn_defs) == ["kv_norm", "w_dkv", "w_krope", "w_uk",
                                 "w_uv", "wo", "wq"]
    assert attn_defs["wq"].shape == (2048, 16 * 192)
    assert attn_defs["w_uv"].shape == (512, 16 * 128)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    own = model.init(0, device="cpu")
    for tree in (params, own):
        flat = tree_flatten_with_path(tree)[0]
        assert len(flat) == len(ref_flat)
        for (p, leaf), (rp, rleaf) in zip(flat, ref_flat):
            assert p == tuple(getattr(k, "key", getattr(k, "idx", None))
                              for k in rp)
            assert tuple(leaf.shape) == tuple(rleaf.shape)
    for (p, leaf), (_, rleaf) in zip(tree_flatten_with_path(params)[0],
                                     ref_flat):
        assert np.array_equal(leaf.numpy(), np.asarray(rleaf)), p
    assert torch.equal(own["segments"][0]["attn"]["kv_norm"],
                       torch.ones_like(own["segments"][0]["attn"]["kv_norm"]))


def test_mla_prefill_and_cache_match_reference(pair):
    ref_model, ref_params, model, params = pair
    cfg = model.cfg
    ref_p, p = _attn_params(ref_params, params)
    x, pos = _x(cfg, 2, 19, 3), _pos(2, 19)
    want, want_cache = ref_mla_apply(ref_model.cfg, ref_p,
                                          jnp.asarray(x), jnp.asarray(pos),
                                          None, None)
    got, cache = attention.mla_apply(cfg, p, torch.from_numpy(x),
                                     torch.from_numpy(pos).long(), None,
                                     None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(cache) == ["c_kv", "k_rope"]
    for name in cache:
        assert tuple(cache[name].shape) == want_cache[name].shape
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(want_cache[name]), **TOL)


def _prefilled(cfg, p, B, S, L):
    """The port's latent cache after an S-token prefill, padded to L."""
    x = _x(cfg, B, S, 4)
    _, c = attention.mla_apply(cfg, p, torch.from_numpy(x),
                               torch.from_numpy(_pos(B, S)).long(), None,
                               None)
    return {k: torch.nn.functional.pad(v, (0, 0, 0, L - S))
            for k, v in c.items()}


def test_absorbed_decode_steps_match_reference(pair):
    """Three absorbed decode steps on a 5-token prefill's latent cache:
    each step's output and the cache rows it writes."""
    ref_model, ref_params, model, params = pair
    ref_p, p = _attn_params(ref_params, params)
    B, S, L = 2, 5, 12
    c = _prefilled(model.cfg, p, B, S, L)
    _, rc = ref_mla_apply(ref_model.cfg, ref_p,
                          jnp.asarray(_x(model.cfg, B, S, 4)),
                          jnp.asarray(_pos(B, S)), None, None)
    rc = {k: jnp.pad(v, ((0, 0), (0, L - S), (0, 0))) for k, v in rc.items()}
    for t in range(S, S + 3):
        x = _x(model.cfg, B, 1, 10 + t)
        dpos = np.full((B,), t, np.int32)
        want, rc = ref_mla_apply(ref_model.cfg, ref_p, jnp.asarray(x),
                                      jnp.asarray(dpos[:, None]), rc,
                                      jnp.asarray(dpos))
        got, c2 = attention.mla_apply(model.cfg, p, torch.from_numpy(x),
                                      torch.from_numpy(dpos[:, None]).long(),
                                      c, torch.from_numpy(dpos).long())
        assert c2 is c                   # updated in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in c:
            np.testing.assert_allclose(c[name].numpy(), np.asarray(rc[name]),
                                       **TOL)


def test_absorbed_decode_equals_up_projected_attention(pair):
    """The absorption's identity inside the port: a decode step's output
    equals attention over k and v up-projected from the same latent cache
    (k = [c W_uk, k_rope], v = c W_uv, q = [q_nope, q_rope])."""
    ref_model, ref_params, model, params = pair
    cfg = model.cfg
    m = cfg.mla
    ref_p, p = _attn_params(ref_params, params)
    B, S, L, H = 2, 7, 10, cfg.n_heads
    c = _prefilled(cfg, p, B, S, L)
    x = torch.from_numpy(_x(cfg, B, 1, 21))
    dpos = torch.full((B,), S, dtype=torch.long)
    got, c = attention.mla_apply(cfg, p, x, dpos[:, None], c, dpos)

    nd, rd, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q = (x @ p["wq"]).reshape(B, 1, H, nd + rd)
    ang = rope_angles(dpos[:, None], rd, cfg.rope_theta)
    q = torch.cat([q[..., :nd], apply_rope(q[..., nd:], ang)], dim=-1)
    k_nope = (c["c_kv"] @ p["w_uk"]).reshape(B, L, H, nd)
    k = torch.cat([k_nope, c["k_rope"][:, :, None, :].expand(B, L, H, rd)],
                  dim=-1)
    v = (c["c_kv"] @ p["w_uv"]).reshape(B, L, H, vd)
    out = attention.online_attention(q, k, v, dpos[:, None], dpos + 1,
                                     causal=True, window=None,
                                     scale=(nd + rd) ** -0.5, logit_cap=None)
    want = out.reshape(B, 1, H * vd) @ p["wo"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ------------------------------------------------------------------ B4 at dv
@pytest.mark.parametrize("mask", [(True, None, None), (True, 5, None),
                                  (False, None, None), (True, None, 30.0)])
@pytest.mark.parametrize("shape", [(2, 19, 4, 4, 48, 32),
                                   (1, 23, 4, 2, 192, 128),
                                   (2, 9, 4, 1, 32, 64)])
def test_flash_attention_plain_dv_matches_reference(shape, mask):
    """flash_attention (the plain version on the CPU) with v at a head dim
    of its own, at MLA's reduced (48, 32) with KV = H, at deepseek's
    (192, 128) with KV < H, and a dv above hd, against the reference's
    online_attention."""
    B, S, H, KV, hd, dv = shape
    causal, window, cap = mask
    rng = np.random.default_rng(hd + dv)
    q, k = ((rng.standard_normal((B, S, n, hd)) * 0.5).astype(np.float32)
            for n in (H, KV))
    v = (rng.standard_normal((B, S, KV, dv)) * 0.5).astype(np.float32)
    pos = _pos(B, S)
    want = ref_attn.online_attention(
        *(jnp.asarray(a) for a in (q, k, v, pos)), None, causal=causal,
        window=window, scale=hd ** -0.5, logit_cap=cap, chunk=8)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = fa.flash_attention(*t, torch.from_numpy(pos), scale=hd ** -0.5,
                             causal=causal, window=window, softcap=cap)
    assert tuple(got.shape) == (B, S, H, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, fa.flash_attention_plain(
        *t, torch.from_numpy(pos), scale=hd ** -0.5, causal=causal,
        window=window, softcap=cap))


def test_flash_attention_dv_arguments():
    """dv above 256 and a k whose head dim is not q's are refused; the
    tensor cores take bf16 (192, 128) and the reduced (48, 32) (padded to
    (64, 64)), not (128, 192), whose widths have no instantiation."""
    q = torch.zeros(1, 4, 2, 48)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="value head_dim"):
        fa.flash_attention(q, q, torch.zeros(1, 4, 2, 320), pos, scale=1.0)
    with pytest.raises(ValueError, match="share hd"):
        fa.flash_attention(q, torch.zeros(1, 4, 2, 32),
                           torch.zeros(1, 4, 2, 32), pos, scale=1.0)
    with pytest.raises(ValueError, match="share hd"):
        fa.flash_attention(q, q, torch.zeros(1, 4, 1, 32), pos, scale=1.0)
    assert fa.path(torch.bfloat16, 192, 128) == "tc"
    assert fa.path(torch.float32, 192, 128) == "simt"
    assert fa.path(torch.bfloat16, 48, 32) == "tc"
    assert fa.path(torch.float32, 48, 32) == "tf32x3"
    assert fa.path(torch.bfloat16, 128, 192) == "simt"


# ------------------------------------------------------------------ model
def test_prefill_logits_match_reference(pair):
    ref_model, ref_params, model, params = pair
    tokens = _tokens(model.cfg, 2, 20)
    want, want_cache = ref_model.prefill(ref_params,
                                         {"tokens": jnp.asarray(tokens)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == (2, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(cache[0]["c_kv"].shape) == (2, 2, 20, 64)
    assert tuple(cache[0]["k_rope"].shape) == (2, 2, 20, 16)
    np.testing.assert_allclose(cache[0]["c_kv"].numpy(),
                               np.asarray(want_cache[0]["c_kv"]), **TOL)


def test_decode_steps_match_reference(pair):
    """Contiguous decode: the latent cache (``Model.cache_struct``) and
    four steps' logits."""
    ref_model, ref_params, model, params = pair
    from repro.configs.base import ShapeConfig
    from repro.models.transformer import alloc_cache as ref_alloc_cache
    B, L = 2, 12
    assert model.cache_struct(B, L) == [
        {"c_kv": ((2, B, L, 64), torch.float32),
         "k_rope": ((2, B, L, 16), torch.float32)}]
    toks = _tokens(model.cfg, B, 4, seed=2)
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


# ------------------------------------------------------------------ runtime
def test_units_and_infos_match_reference(pair):
    ref_model, ref_params, model, params = pair
    ref_units = ref_split_units(ref_model, ref_params)
    units = split_units(model, params)
    assert [u.name for u in units] == [u.name for u in ref_units]
    want = ref_unit_infos(ref_model, ref_units, 2, 20)
    got = unit_infos(model, units, 2, 20)
    assert [(r.name, r.size, r.depth, r.flops) for r in got] == \
        [(r.name, r.size, r.depth, r.flops) for r in want]


def test_swapped_equals_unswapped_bitwise(pair, tmp_path):
    """The swapped pass on mmap, and a resumable pass that collects the
    latent cache per layer."""
    ref_model, ref_params, model, params = pair
    tokens = torch.from_numpy(_tokens(model.cfg, 2, 20))
    sm = SwappedModel(model, params, str(tmp_path), device="cpu",
                      store_backend="mmap")
    try:
        sm.partition(SWAP_BUDGET, DelayModel(), 2, 20)
        assert sm.plan.n_blocks >= 3
        got, stats = sm.forward({"tokens": tokens})
        direct = sm.forward_unswapped({"tokens": tokens})
        state, _ = sm.forward_partial({"tokens": tokens}, collect_cache=True)
    finally:
        sm.close()
    assert torch.equal(got, direct)
    assert stats["peak_resident_mb"] * 1e6 <= SWAP_BUDGET
    want, cache = model.prefill(params, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert sorted(state.caches) == [0, 1]
    for lid, c in state.caches.items():
        assert sorted(c) == ["c_kv", "k_rope"]
        for name in c:
            assert torch.equal(c[name], cache[0][name][lid])


def test_decode_loop_tokens_match_reference(pair, tmp_path):
    """Weight-streaming greedy decode: a 4-token prompt fed one token at
    a time through the latent cache, then 4 new tokens."""
    ref_model, ref_params, model, params = pair
    prompt = _tokens(model.cfg, 2, 4, seed=3)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref.partition(budget=BUDGET, dm=RefDelayModel(), batch=2, seq=4)
    want, _ = ref.decode_loop(jnp.asarray(prompt), max_new_tokens=4,
                              max_len=12)
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    try:
        sm.partition(BUDGET, DelayModel(), 2, 4)
        got, stats = sm.decode_loop(torch.from_numpy(prompt),
                                    max_new_tokens=4, max_len=12)
    finally:
        sm.close()
    assert got.tolist() == np.asarray(want).tolist()
    assert stats["peak_resident_mb"] * 1e6 <= BUDGET


def test_serving_engine_tokens_match_reference(pair):
    """The in-memory engine: prefill through B4's plain version, then the
    absorbed decode on the padded latent cache, one request retiring
    early (its rows gathered out)."""
    ref_model, ref_params, model, params = pair
    prompts = [list(map(int, p)) for p in _tokens(model.cfg, 3, 8, seed=5)]
    new = [5, 3, 5]
    ref_reqs = [RefRequest(i, p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, new))]
    RefServingEngine(ref_model, ref_params, max_len=32).generate(ref_reqs)
    reqs = [Request(i, p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]
    ServingEngine(model, params, max_len=32, device="cpu").generate(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert [len(r.output) for r in reqs] == new


@pytest.mark.parametrize("eager", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_store_matches_reference(pair, tmp_path, bits, eager):
    """Unit files and CRCs byte-equal to the JAX package's store; wq and
    wo fused, the latent projections and the 3-D expert stacks quantized
    but widened at use; the swapped logits equal the reference's quantized
    swapped model's (lazy or eager) and so carry its quantization error."""
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
    for key in ("wq", "wo"):
        assert leaves[("attn", key)].scale_offset >= 0
        assert leaves[("attn", key)].fusable
    for key in ("w_dkv", "w_uk", "w_uv"):
        assert leaves[("attn", key)].scale_offset >= 0
        assert not leaves[("attn", key)].fusable
    assert leaves[("attn", "kv_norm")].scale_offset < 0

    tokens = _tokens(model.cfg, 2, 20)
    prec = "int8" if bits == 8 else "int4"
    opts = {"eager": True} if eager else None
    ref_sm = RefSwappedModel(ref_model, ref_params, str(tmp_path / "rsm"),
                             store_backend="quant", precision=prec,
                             store_options=opts)
    sm = SwappedModel(model, params, str(tmp_path / "sm"), device="cpu",
                      store_backend="quant", precision=prec,
                      store_options=opts)
    try:
        ref_sm.partition(budget=BUDGET, dm=RefDelayModel(), batch=2, seq=20)
        sm.partition(BUDGET, DelayModel(), 2, 20)
        want, _ = ref_sm.forward({"tokens": jnp.asarray(tokens)})
        got, _ = sm.forward({"tokens": torch.from_numpy(tokens)})
    finally:
        sm.close()
        ref_sm.close()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    fp, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    ref_fp, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    err = float((got - fp).abs().max() / fp.abs().max())
    ref_err = float(np.abs(np.asarray(want) - np.asarray(ref_fp)).max()
                    / np.abs(np.asarray(ref_fp)).max())
    assert err == pytest.approx(ref_err, rel=1e-3, abs=1e-5)


def test_paged_cache_refuses_mla(pair):
    """Kept from the reference: paged serving covers GQA stacks only; an
    MLA model keeps the contiguous latent cache."""
    ref_model, _, model, _ = pair
    with pytest.raises(ValueError, match="MLA"):
        RefPagedKV(ref_model.cfg, RefLedger(1 << 30), page_tokens=4,
                   max_pages=16)
    with pytest.raises(ValueError, match="MLA"):
        PagedKVCache(model.cfg, MemoryLedger(1 << 30), page_tokens=4,
                     max_pages=16, device="cpu")


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("mode", ["swapped", "in-memory", "paged"])
def test_serve_entry_runs_on_cpu(capsys, mode):
    args = ["--arch", ARCH, "--reduce", "smoke", "--requests", "2",
            "--prompt-len", "12", "--new-tokens", "3", "--device", "cpu"]
    if mode == "paged":
        with pytest.raises(ValueError, match="MLA"):
            serve.main(args + ["--budget-mb", "24", "--paged", "--kv-frac",
                               "0.3", "--page-tokens", "4"])
        return
    if mode == "swapped":
        args += ["--budget-mb", "8"]
    out = serve.main(args)
    text = capsys.readouterr().out
    if mode == "swapped":
        assert "[serve] swapped prefill" in text and "device=cpu" in text
        assert tuple(out["tokens"].shape) == (2, 3)
        assert torch.isfinite(out["logits"]).all()
    else:
        assert "[serve] 2 requests x 3 new tokens" in text
        assert [len(r.output) for r in out["requests"]] == [3, 3]
