"""qwen2-vl's M-RoPE and vision-embedding frontend in the port against the
JAX package on the same weights: ``rope_angles`` with sections, the
prefill with vision embeddings and three distinct position streams, the
decode steps, the engines (contiguous and paged), the swapped forward on
mmap and on the int8 lazy store, weight-streaming decode, the CLI, and
the reference's temporal-stream mask, kept for parity.

qwen2-vl-72b ``reduced()`` in float32 (2 layers, d_model 256, 4 / 2 heads
of 64, M-RoPE sections (8, 12, 12), 16 vision tokens at d_frontend 64),
params from the JAX ``Model.init`` handed over as numpy. The positions
put the 16 vision tokens on a 4 x 4 patch grid (h = i // 4, w = i % 4)
and the text on the index, with the temporal stream the index, so the
three sections see different angles while the reference's mask (which
reads the temporal stream) stays the index mask. Tolerances, with their
reasons:
  * angles and rotated q / k: 1e-6 (the same fp32 products);
  * port vs JAX, float32: rtol = atol = 1e-5 (sums in another order);
  * bf16 compute: 2e-2 (the compute dtype's rounding);
  * swapped vs unswapped inside the port on mmap: bitwise;
  * greedy tokens: equal.
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
from repro.core.runtime import unit_infos as ref_unit_infos  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro.serving import kv_cache as ref_kv  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel, unit_infos  # noqa: E402
from repro_torch.core.swap_engine import MemoryLedger  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving import engine, kv_cache  # noqa: E402
from repro_torch.serving.batch_engine import BatchDecodeEngine  # noqa: E402
from repro_torch.serving.paged_kv import PagedKVCache  # noqa: E402

ARCH = "qwen2-vl-72b"
TOL = dict(rtol=1e-5, atol=1e-5)
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BUDGET = 4 * 1024 * 1024
BIG_LEDGER = 1 << 30
B, S = 2, 32


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _pair(dtype="float32"):
    ref_model = RefModel(dataclasses.replace(ref_get_arch(ARCH).reduced(),
                                             dtype=dtype))
    ref_params = jax.jit(ref_model.init)(jax.random.key(0))
    model = Model(dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


@pytest.fixture(scope="module")
def setup():
    return _pair()


def grid_positions(B, S, nv, side):
    """[B, S, 3]: the temporal stream the index; h and w the patch grid
    (``i // side``, ``i % side``) over the ``nv`` vision tokens and the
    index over the text."""
    i = np.arange(S)
    hw = np.where(i < nv, i // side, i), np.where(i < nv, i % side, i)
    pos = np.stack([i, *hw], axis=-1)
    return np.broadcast_to(pos, (B, S, 3)).astype(np.int32).copy()


def vision_batch(cfg, seed=0, B=B, S=S):
    """Token ids, seeded vision embeddings for the first
    ``n_vision_tokens`` positions and the grid positions, as numpy."""
    rng = np.random.default_rng(seed)
    nv = cfg.n_vision_tokens
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                   ).astype(np.int32),
            "vision_embeds": rng.standard_normal(
                (B, nv, cfg.d_frontend)).astype(np.float32),
            "positions": grid_positions(B, S, nv, int(nv ** 0.5))}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in lens]


# ------------------------------------------------------------ M-RoPE
def test_rope_angles_and_apply_rope_with_sections_match_jax():
    """Distinct t / h / w streams: each frequency slot reads the stream of
    its section; sections that miss head_dim / 2 are refused by both."""
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 200, (2, 7, 3)).astype(np.int32)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    sec = (8, 12, 12)
    want = ref_layers.rope_angles(jnp.asarray(pos), 64, 1e6, sec)
    got = layers.rope_angles(torch.from_numpy(pos), 64, 1e6, sec)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ROPE_TOL)
    # slot 9 lies in the h section: it reads stream 1 alone
    np.testing.assert_allclose(
        _np(got[..., 9]), pos[..., 1] * _np(layers.rope_angles(
            torch.ones((1, 1), dtype=torch.int32), 64, 1e6))[0, 0, 9],
        **ROPE_TOL)
    np.testing.assert_allclose(
        _np(layers.apply_rope(torch.from_numpy(x), got)),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), want)), **ROPE_TOL)
    with pytest.raises(ValueError, match="head_dim / 2"):
        layers.rope_angles(torch.from_numpy(pos), 64, 1e6, (8, 12, 8))
    with pytest.raises(AssertionError):
        ref_layers.rope_angles(jnp.asarray(pos), 64, 1e6, (8, 12, 8))


# ------------------------------------------------------------ the model
def test_params_tree_and_units_match_jax(setup, tmp_path):
    """``embed`` and ``frontend`` in the embed unit, an untied head; unit
    names and info rows equal the reference's."""
    ref_model, ref_params, model, params = setup
    assert sorted(params) == sorted(ref_params) == [
        "embed", "final_norm", "frontend", "lm_head", "segments"]
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref_rows = ref_unit_infos(ref_model, ref.units, B, S)
    ref_names = [u.name for u in ref.units]
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    try:
        assert [u.name for u in sm.units] == ref_names
        assert sorted(sm.units[0].params) == ["embed", "frontend"]
        rows = unit_infos(model, sm.units, B, S)
        assert [(r.name, r.size, r.depth, r.flops) for r in rows] == \
            [(r.name, r.size, r.depth, r.flops) for r in ref_rows]
    finally:
        sm.close()


def test_prefill_with_vision_embeds_matches_jax(setup):
    """Logits and every cache leaf; the vision rows come from the
    frontend, and moving only their h / w streams moves the logits."""
    ref_model, ref_params, model, params = setup
    batch = vision_batch(model.cfg)
    want, wcache = jax.jit(ref_model.prefill)(ref_params, _j(batch))
    got, gcache = model.prefill(params, _t(batch))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for g_seg, w_seg in zip(gcache, wcache):
        for name in g_seg:
            assert tuple(g_seg[name].shape) == w_seg[name].shape
            np.testing.assert_allclose(_np(g_seg[name]),
                                       np.asarray(w_seg[name]), **TOL)
    text_only = {k: v for k, v in batch.items() if k != "vision_embeds"}
    assert not torch.allclose(model.prefill(params, _t(text_only))[0], got)
    moved = dict(batch, positions=batch["positions"].copy())
    moved["positions"][:, :model.cfg.n_vision_tokens, 1:] += 5
    got2, _ = model.prefill(params, _t(moved))
    want2, _ = jax.jit(ref_model.prefill)(ref_params, _j(moved))
    np.testing.assert_allclose(_np(got2), np.asarray(want2), **TOL)
    assert (got2 - got).abs().max().item() > 1e-3 * got.abs().max().item()


def test_decode_steps_and_pad_match_jax(setup):
    """Three decode steps from the padded prefill cache, with [B, 1, 3]
    positions, the cache updated in place; every leaf equal after. The
    padded cache's shapes equal the reference's (positions are an input,
    not cache state)."""
    ref_model, ref_params, model, params = setup
    L = S + 8
    batch = vision_batch(model.cfg, seed=1)
    want, wcache = jax.jit(ref_model.prefill)(ref_params, _j(batch))
    got, gcache = model.prefill(params, _t(batch))
    wcache = ref_kv.pad_prefill_cache(ref_model, wcache, L, B)
    gcache = kv_cache.pad_prefill_cache(model, gcache, L, B)
    target = ref_model.cache_struct(ShapeConfig("serve", seq_len=L,
                                                global_batch=B,
                                                mode="decode"))
    for g_seg, t_seg in zip(gcache, target):
        for name in g_seg:
            assert tuple(g_seg[name].shape) == t_seg[name].shape
    tok = np.array(jnp.argmax(want[:, -1], -1), np.int32)[:, None]
    step = jax.jit(ref_model.decode_step)
    for t in range(3):
        p = S + t
        want, wcache = step(ref_params, wcache, {
            "token": jnp.asarray(tok), "pos": jnp.full((B,), p, jnp.int32),
            "positions": jnp.full((B, 1, 3), p, jnp.int32)})
        got, out = model.decode_step(params, gcache, {
            "token": torch.from_numpy(tok), "pos": torch.full((B,), p),
            "positions": torch.full((B, 1, 3), p)})
        assert all(o is g for o, g in zip(out, gcache))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        tok = np.array(jnp.argmax(want[:, -1], -1), np.int32)[:, None]
    for g_seg, w_seg in zip(gcache, wcache):
        for name in g_seg:
            np.testing.assert_allclose(_np(g_seg[name]),
                                       np.asarray(w_seg[name]), **TOL)


def test_bf16_prefill_with_vision_embeds_matches_jax():
    ref_model, ref_params, model, params = _pair("bfloat16")
    batch = vision_batch(model.cfg, seed=2)
    want, _ = jax.jit(ref_model.prefill)(ref_params, _j(batch))
    got, _ = model.prefill(params, _t(batch))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_TOL)


def test_temporal_stream_masks_in_both_packages(setup):
    """A reference fault kept for parity: M-RoPE's causal mask compares
    the temporal stream with the key's index. With that stream constant
    (0), every query sees key 0 alone, so perturbing tokens 1 .. S-2 moves
    neither package's last logits; the packages agree. Under the index
    stream the same perturbation moves them."""
    ref_model, ref_params, model, params = setup
    rng = np.random.default_rng(4)
    toks = rng.integers(0, model.cfg.vocab_size, (1, S)).astype(np.int32)
    other = toks.copy()
    other[0, 1:S - 1] = rng.integers(0, model.cfg.vocab_size, S - 2)
    idx = np.broadcast_to(np.arange(S)[None, :, None], (1, S, 3))
    flat = idx.copy()
    flat[..., 0] = 0
    prefill = jax.jit(ref_model.prefill)
    out = {}
    for name, pos in (("flat", flat), ("index", idx)):
        for which, t in (("a", toks), ("b", other)):
            b = {"tokens": t, "positions": pos.astype(np.int32)}
            want, _ = prefill(ref_params, _j(b))
            got, _ = model.prefill(params, _t(b))
            np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
            out[name, which] = (_np(got), np.asarray(want))
    for k in range(2):
        np.testing.assert_allclose(out["flat", "b"][k], out["flat", "a"][k],
                                   rtol=0, atol=1e-6)
        assert np.abs(out["index", "b"][k] - out["index", "a"][k]).max() \
            > 1e-3 * np.abs(out["index", "a"][k]).max()


# ------------------------------------------------------------ engines
def test_engine_tokens_and_pad_prompts_match_jax(setup):
    """``pad_prompts`` gives the reference's [B, L, 3] index positions;
    ragged requests through ``ServingEngine`` give its tokens."""
    ref_model, ref_params, model, params = setup
    prompts = _prompts(model.cfg, (12, 5, 9), seed=5)
    max_new = [4, 3, 5]
    reqs = [engine.Request(i, p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    ref_reqs = [ref_engine.Request(i, p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
    got, want = engine.pad_prompts(model.cfg, reqs), \
        ref_engine.pad_prompts(ref_model.cfg, ref_reqs)
    assert sorted(got) == sorted(want) == ["positions", "tokens"]
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    ref_engine.ServingEngine(ref_model, ref_params, max_len=64).generate(
        ref_reqs)
    st = engine.ServingEngine(model, params, max_len=64,
                              device="cpu").generate(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert [len(r.output) for r in reqs] == max_new
    assert st["decode_steps"] == max(max_new) - 1


def test_paged_decode_matches_engine(setup, tmp_path):
    """The swapped paged engine (prefill with broadcast positions, each
    batched step with [B, 1, 3]) gives ``ServingEngine``'s tokens for
    each request served alone; the pages all come back."""
    _, _, model, params = setup
    prompts = _prompts(model.cfg, (9, 20, 6), seed=6)
    max_new = [3, 5, 4]
    solo = []
    eng = engine.ServingEngine(model, params, max_len=64, device="cpu")
    for p, n in zip(prompts, max_new):
        r = engine.Request(0, p, max_new_tokens=n)
        eng.generate([r])
        solo.append(r.output)
    sm = SwappedModel(model, params, str(tmp_path), device="cpu")
    try:
        sm.partition(BUDGET, DelayModel(), 2, 16)
        be = BatchDecodeEngine(sm, PagedKVCache(
            model.cfg, MemoryLedger(BIG_LEDGER), page_tokens=4,
            max_pages=40, device="cpu"), max_batch=4)
        reqs = [engine.Request(i, p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
        for r in reqs:
            be.submit(r)
        be.run_all()
    finally:
        sm.close()
    assert [r.output for r in reqs] == solo
    assert max(len(t.batch) for t in be.trace) == 3
    assert be.kv.pages_in_use == 0


# ------------------------------------------------------------ swapped
def test_swapped_mmap_bitwise_and_matches_jax(setup, tmp_path):
    """The swapped forward with vision embeddings and grid positions is
    bitwise the unswapped one, and within 1e-5 of the reference's swapped
    forward on the same plan."""
    ref_model, ref_params, model, params = setup
    batch = vision_batch(model.cfg, seed=7)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref.partition(BUDGET, RefDelayModel(), B, S)
    want, _ = ref.forward(_j(batch))
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    try:
        sm.partition(BUDGET, DelayModel(), B, S)
        assert sm.plan.points == ref.plan.points and sm.plan.n_blocks >= 2
        got, st = sm.forward(_t(batch))
        assert torch.equal(got, sm.forward_unswapped(_t(batch)))
        assert 0 < st["peak_resident_mb"] * 1e6 <= BUDGET
    finally:
        sm.close()
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_decode_loop_matches_jax(setup, tmp_path):
    """Weight-streaming decode with [B, 1, 3] positions each token."""
    ref_model, ref_params, model, params = setup
    prompts = np.asarray(_prompts(model.cfg, (6, 6), seed=8), np.int32)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref.partition(BUDGET, RefDelayModel(), 2, 6)
    want, _ = ref.decode_loop(jnp.asarray(prompts), max_new_tokens=3,
                              max_len=32)
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    try:
        sm.partition(BUDGET, DelayModel(), 2, 6)
        gen, _ = sm.decode_loop(torch.from_numpy(prompts), max_new_tokens=3,
                                max_len=32)
    finally:
        sm.close()
    assert gen.tolist() == np.asarray(want).tolist()


def test_int8_lazy_store_matches_the_reference_quant_store(setup, tmp_path):
    """The int8 lazy store: the linears stream quantized through B1's
    plain version, the embedding and the frontend are widened on the
    loader; the logits are within
    1e-5 of the reference's quantized swapped logits and the files equal
    the reference's byte for byte."""
    ref_model, ref_params, model, params = setup
    batch = vision_batch(model.cfg, seed=9)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"),
                          store_backend="quant", precision="int8")
    ref.partition(BUDGET, RefDelayModel(), B, S)
    want, _ = ref.forward(_j(batch))
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"),
                      store_backend="quant", precision="int8", device="cpu")
    try:
        sm.partition(BUDGET, DelayModel(), B, S)
        got, st = sm.forward(_t(batch))
    finally:
        sm.close()
    assert st["precision"] == "int8" and st["store_backend"] == "quant"
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for name in ("embed", "layer000_dense", "head"):
        with open(ref.store._path(name), "rb") as a, \
                open(sm.store._path(name), "rb") as b:
            assert a.read() == b.read(), name


def test_prefill_runs_the_attention_wrapper_on_the_temporal_stream(setup):
    """The prefill hands the attention wrapper [B, S] query positions (the
    temporal stream), never the [B, S, 3] tensor."""
    _, _, model, params = setup
    seen = []
    wrapped = fa.flash_attention_plain

    def spy(q, k, v, q_pos, **kw):
        seen.append(q_pos.clone())
        return wrapped(q, k, v, q_pos, **kw)
    batch = vision_batch(model.cfg, seed=10)
    fa.flash_attention_plain = spy
    try:
        model.prefill(params, _t(batch))
    finally:
        fa.flash_attention_plain = wrapped
    assert len(seen) == model.cfg.n_layers
    for q_pos in seen:
        np.testing.assert_array_equal(q_pos.numpy(),
                                      batch["positions"][..., 0])


# ------------------------------------------------------------ the CLI
@pytest.mark.parametrize("mode", ["swapped", "in-memory", "paged"])
def test_serve_qwen2_vl_on_cpu(capsys, mode):
    args = ["--arch", ARCH, "--reduce", "smoke", "--requests", "2",
            "--prompt-len", "16", "--new-tokens", "3", "--device", "cpu"]
    args += {"swapped": ["--budget-mb", "8"], "in-memory": [],
             "paged": ["--budget-mb", "24", "--paged", "--kv-frac", "0.3",
                       "--max-batch", "8"]}[mode]
    out = serve.main(args)
    text = capsys.readouterr().out
    if mode == "swapped":
        assert "store=mmap/fp" in text and "[serve] decode 2 x 3" in text
        assert tuple(out["tokens"].shape) == (2, 3)
    elif mode == "paged":
        assert "[serve-paged] 2 requests x 3 new tokens" in text
    else:
        assert [len(r.output) for r in out["requests"]] == [3, 3]
