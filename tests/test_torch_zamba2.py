"""zamba2's hybrid stack in the port against the JAX package on the same
weights: Mamba2's causal conv, chunked SSD and decode step, the model with
its shared attention block, the swapped forward (the shared unit stored
once, pinned, charged once), the multi-model runtime and scheduler,
weight-streaming decode, the in-memory engine, the int8 store and the CLI.

zamba2-7b ``reduced()`` in float32 (4 layers: mamba2, shared, mamba2,
shared; d_model 256; Mamba2 d_state 16, head_dim 32, chunk 16), params
from the JAX ``Model.init`` handed over as numpy. Tolerances, with their
reasons:
  * port vs JAX, float32: rtol = atol = 1e-5 (the same chunked
    factorization; sums run in another order);
  * bf16 compute: 2e-2 (the compute dtype's rounding);
  * chunked vs a naive per-step loop: 1e-4, the reference's own
    (``tests/test_ssm_reference.py``);
  * swapped vs unswapped inside the port on mmap: bitwise (the same ops on
    the same bytes);
  * greedy tokens: equal.
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
from repro.core.runtime import unit_infos as ref_unit_infos  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingEngine as RefServingEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.multi_model import MultiModelRuntime  # noqa: E402
from repro_torch.core.runtime import SwappedModel, unit_infos  # noqa: E402
from repro_torch.core.serving_scheduler import ServingScheduler  # noqa: E402
from repro_torch.kernels import swap_linear as sl  # noqa: E402
from repro_torch.kernels import swap_linear_q as slq  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
NAIVE_TOL = dict(rtol=1e-4, atol=1e-4)
BUDGET = 8 * 1024 * 1024
WAIT = 60.0


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module")
def setup():
    ref_model = RefModel(dataclasses.replace(ref_get_arch(ARCH).reduced(),
                                             dtype="float32"))
    ref_params = jax.jit(ref_model.init)(jax.random.key(0))
    model = Model(dataclasses.replace(get_arch(ARCH).reduced(),
                                      dtype="float32"))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def _mamba_params(setup, j=0):
    """Layer j of the first mamba2 segment in both packages."""
    _, ref_params, _, params = setup
    return (jax.tree.map(lambda a: a[j], ref_params["segments"][0]),
            tree_map(lambda a: a[j], params["segments"][0]))


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)
                                                ).astype(np.int32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_causal_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    want, wst = ref_ssm.conv1d_causal(_j(x), _j(w), _j(st))
    got, gst = ssm.conv1d_causal(_t(x), _t(w), _t(st))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gst), np.asarray(wst), **TOL)
    # a run split in two with the tail carried equals one run
    a, ast = ssm.conv1d_causal(_t(x[:, :4]), _t(w), _t(st))
    b, _ = ssm.conv1d_causal(_t(x[:, 4:]), _t(w), ast)
    np.testing.assert_allclose(_np(torch.cat([a, b], 1)), _np(got), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_chunked_and_step_match_jax(setup, with_state, dtype):
    cfg = setup[0].cfg
    p, tp = _mamba_params(setup)
    d_inner, nh, ds = ref_ssm.mamba2_dims(cfg)
    B, S, D = 2, 32, cfg.d_model
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((B, S, D)) * 0.5).astype(np.float32)
    h0 = cs = None
    if with_state:
        h0 = (rng.standard_normal((B, nh, cfg.ssm.head_dim, ds)) * 0.3
              ).astype(np.float32)
        cs = (rng.standard_normal((B, cfg.ssm.d_conv - 1, d_inner + 2 * ds))
              * 0.5).astype(np.float32)
    tol = TOL if dtype == "float32" else BF16_TOL
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    p = jax.tree.map(lambda a: a.astype(jdt), p)
    tp = tree_map(lambda a: a.to(tdt), tp)

    def j(a):
        return None if a is None else jnp.asarray(a, jdt)

    def t(a):
        return None if a is None else torch.from_numpy(a).to(tdt)
    chunked = jax.jit(lambda *a: ref_ssm.mamba2_chunked(cfg, *a))
    step = jax.jit(lambda *a: ref_ssm.mamba2_step(cfg, *a))
    want, (wh, wc) = chunked(p, j(x), _j(h0), j(cs))
    got, (gh, gc) = ssm.mamba2_chunked(cfg, tp, t(x), _t(h0), t(cs))
    assert got.dtype == tdt and gh.dtype == torch.float32 and gc.dtype == tdt
    for a, b in ((got, want), (gh, wh), (gc, wc)):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), **tol)

    x1 = x[:, -1:]
    h1, c1 = np.array(wh, np.float32), np.array(wc, np.float32)
    want, (wh, wc) = step(p, j(x1), jnp.asarray(h1), j(c1))
    got, (gh, gc) = ssm.mamba2_step(cfg, tp, t(x1), torch.from_numpy(h1),
                                    t(c1))
    for a, b in ((got, want), (gh, wh), (gc, wc)):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), **tol)


def _naive_mamba2(cfg, p, x):
    """The literal per-step recurrence (``tests/test_ssm_reference.py``),
    on the port's projections."""
    d_inner, nh, ds = ssm.mamba2_dims(cfg)
    hd = cfg.ssm.head_dim
    B, S, D = x.shape
    z, xs, Bv, Cv, dt, a, _ = ssm._mamba2_inputs(cfg, p, x, None)
    h = torch.zeros((B, nh, hd, ds))
    ys = []
    for t in range(S):
        h = a[:, t][:, :, None, None] * h + torch.einsum(
            "bnh,bd,bn->bnhd", xs[:, t], Bv[:, t], dt[:, t])
        ys.append(torch.einsum("bnhd,bd->bnh", h, Cv[:, t]))
    y = torch.stack(ys, 1) + xs * p["D_skip"][:, None]
    return ssm._mamba2_out(cfg, p, y.reshape(B, S, d_inner), z,
                           x.dtype), h


def test_mamba2_chunked_matches_naive(setup):
    cfg = setup[0].cfg
    _, tp = _mamba_params(setup)
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)) * 0.5).astype(np.float32))
    y_naive, h_naive = _naive_mamba2(cfg, tp, x)
    y_chunk, (h_chunk, _) = ssm.mamba2_chunked(cfg, tp, x)
    np.testing.assert_allclose(_np(y_chunk), _np(y_naive), **NAIVE_TOL)
    np.testing.assert_allclose(_np(h_chunk), _np(h_naive), **NAIVE_TOL)


# ------------------------------------------------------------ the model
def test_model_tree_units_and_infos_match_jax(setup, tmp_path):
    """The params tree (a top-level shared block, {} for its segments),
    the unit names (one shared name per occurrence), a store that holds
    the shared unit once, and the info rows equal the reference's."""
    ref_model, ref_params, model, params = setup
    assert [s.kind for s in model.plan] == [s.kind for s in ref_model.plan]
    assert [s.scanned for s in model.plan] == \
        [s.scanned for s in ref_model.plan]
    assert params["segments"][1] == {} == params["segments"][3]
    assert sorted(params["shared_attn"]) == sorted(ref_params["shared_attn"])
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref_rows = ref_unit_infos(ref_model, ref.units, 2, 32)
    ref_names = [u.name for u in ref.units]
    ref_stored = sorted(ref.store.skeletons)
    ref_pinned = ref.engine.pinned
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    try:
        names = [u.name for u in sm.units]
        assert names == ref_names and names.count("shared_attn") == 2
        assert [u.layer_id for u in sm.units
                if u.kind == "shared_attn"] == [1, 3]
        assert sorted(sm.store.skeletons) == ref_stored
        assert len(sm.store.skeletons) == len(names) - 1
        assert sm.engine.pinned == frozenset(ref_pinned) == {"shared_attn"}
        rows = unit_infos(model, sm.units, 2, 32)
        assert [(r.name, r.size, r.depth, r.flops) for r in rows] == \
            [(r.name, r.size, r.depth, r.flops) for r in ref_rows]
    finally:
        sm.close()


def test_model_prefill_and_decode_steps_match_jax(setup):
    """Prefill logits and every cache leaf (the shared block's K/V without
    a layer axis, as the reference keeps them), then three decode steps
    from the padded cache, the cache updated in place."""
    from repro.serving import kv_cache as ref_kv
    from repro_torch.serving import kv_cache
    ref_model, ref_params, model, params = setup
    B, S, L = 2, 32, 40
    toks = _prompts(model.cfg, B, S)
    want, wcache = jax.jit(ref_model.prefill)(ref_params,
                                              {"tokens": jnp.asarray(toks)})
    got, gcache = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert [sorted(c) for c in gcache] == [["conv", "h"], ["k", "v"]] * 2
    for g_seg, w_seg in zip(gcache, wcache):
        for name in g_seg:
            assert tuple(g_seg[name].shape) == w_seg[name].shape
            np.testing.assert_allclose(_np(g_seg[name]),
                                       np.asarray(w_seg[name]), **TOL)
    wcache = ref_kv.pad_prefill_cache(ref_model, wcache, L, B)
    gcache = kv_cache.pad_prefill_cache(model, gcache, L, B)
    tok = np.array(jnp.argmax(want[:, -1], -1), np.int32)[:, None]
    ref_step = jax.jit(ref_model.decode_step)
    for step in range(3):
        want, wcache = ref_step(ref_params, wcache, {
            "token": jnp.asarray(tok), "pos": jnp.full((B,), S + step,
                                                       jnp.int32)})
        got, out = model.decode_step(params, gcache, {
            "token": torch.from_numpy(tok),
            "pos": torch.full((B,), S + step)})
        assert all(o is g for o, g in zip(out, gcache))   # in place
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        tok = np.array(jnp.argmax(want[:, -1], -1), np.int32)[:, None]
    for g_seg, w_seg in zip(gcache, wcache):
        for name in g_seg:
            np.testing.assert_allclose(_np(g_seg[name]),
                                       np.asarray(w_seg[name]), **TOL)


def test_prefill_refuses_ragged_chunks(setup):
    """A reference fault kept for parity: a prompt longer than the chunk
    (16) that is not a multiple of it is refused (the reference asserts)."""
    ref_model, ref_params, model, params = setup
    toks = _prompts(model.cfg, 1, 20)
    with pytest.raises(ValueError, match="chunks of 16"):
        model.prefill(params, {"tokens": torch.from_numpy(toks)})
    with pytest.raises(AssertionError):
        ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)})


# ------------------------------------------------------------ swapped
def test_swapped_mmap_bitwise_shared_unit_charged_once(setup, tmp_path):
    """The swapped forward is bitwise the unswapped one and within 1e-5 of
    the reference's; the shared unit is charged once, stays charged (and
    nothing else) after the pass, and is a cache hit on the next pass."""
    ref_model, ref_params, model, params = setup
    toks = _prompts(model.cfg, 2, 32)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref.partition(BUDGET, RefDelayModel(), 2, 32)
    want, _ = ref.forward({"tokens": jnp.asarray(toks)})
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    try:
        sm.partition(BUDGET, DelayModel(), 2, 32)
        assert sm.plan.points == ref.plan.points and sm.plan.n_blocks >= 2
        batch = {"tokens": torch.from_numpy(toks)}
        got, _ = sm.forward(batch)
        eng = sm.engine
        shared = sm.store.nbytes("shared_attn")
        assert eng.cache.resident_bytes == shared > 0
        assert eng.ledger.resident == shared
        assert torch.equal(got, sm.forward_unswapped(batch))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        eng.stats.__init__()
        got2, stats = sm.forward(batch)
        assert torch.equal(got2, got)
        assert stats["cache_hit_rate"] > 0
        assert eng.ledger.resident == eng.cache.resident_bytes == shared
        # collect_cache: each occurrence's K/V under its own layer id
        state, _ = sm.forward_partial(batch, collect_cache=True)
        _, cache = model.prefill(params, batch)
        assert sorted(state.caches) == [0, 1, 2, 3]
        for lid, si, lead in ((0, 0, (0,)), (1, 1, ()), (2, 2, (0,)),
                              (3, 3, ())):
            for name, t in state.caches[lid].items():
                assert torch.equal(t, cache[si][name][lead])
    finally:
        sm.close()


def test_pinned_unit_outgrows_a_lone_models_budget_in_both(setup, tmp_path):
    """A reference fault kept for parity: a lone model plans without
    reserving its pinned shared unit, so a ledger budget equal to the plan
    budget raises MemoryError once the unit stays charged beside the next
    block; the plan budget plus the shared unit's bytes runs, within its
    ledger, to the same logits."""
    ref_model, ref_params, model, params = setup
    toks = _prompts(model.cfg, 2, 32)
    plan_b = int(3.4e6)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"),
                          budget=plan_b)
    sm = SwappedModel(model, params, str(tmp_path / "port"), budget=plan_b,
                      device="cpu")
    try:
        shared = sm.store.nbytes("shared_attn")
        assert shared == ref.store.nbytes("shared_attn")
        ref.partition(plan_b, RefDelayModel(), 2, 32)
        sm.partition(plan_b, DelayModel(), 2, 32)
        assert sm.plan.points == ref.plan.points and sm.plan.m == 1
        with pytest.raises(MemoryError):
            ref.forward({"tokens": jnp.asarray(toks)})
        with pytest.raises(MemoryError):
            sm.forward({"tokens": torch.from_numpy(toks)})
        assert sm.engine.ledger.resident == sm.engine.cache.resident_bytes
        for m in (ref, sm):
            m.engine.ledger.budget = plan_b + shared
        want, _ = ref.forward({"tokens": jnp.asarray(toks)})
        got, _ = sm.forward({"tokens": torch.from_numpy(toks)})
        assert ref.engine.ledger.peak <= plan_b + shared
        assert sm.engine.ledger.peak <= plan_b + shared
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    finally:
        sm.close()
        ref.close()


def test_multi_model_scheduler_charges_the_shared_unit_once(setup, tmp_path):
    """zamba2 beside qwen2.5-3b under 2 executors: each served prefill is
    bitwise its tenant's unswapped forward, and once the queue drains only
    the cache stays charged, the pinned shared unit once among it; a
    budget the cache and the pinned unit swallow leaves no room to plan."""
    _, _, model, params = setup
    qmodel = Model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                                       dtype="float32"))
    tenants = {ARCH: (model, params),
               "qwen2.5-3b": (qmodel, qmodel.init(1, device="cpu"))}
    rt = MultiModelRuntime(32 * 1024 * 1024, cache_frac=0.2, executors=2,
                           device="cpu")
    try:
        for a, (m, p) in tenants.items():
            rt.add_model(a, m, p, str(tmp_path))
        rt.plan(batch=2, seq=16)
        batches = {a: {"tokens": torch.from_numpy(_prompts(m.cfg, 2, 16, i))}
                   for i, (a, (m, _)) in enumerate(tenants.items())}
        refs = {a: rt.models[a].forward_unswapped(b)
                for a, b in batches.items()}
        with ServingScheduler(rt) as sched:
            reqs = [sched.submit(a, batches[a],
                                 priority=float(1 + (i % 2) * 7))
                    for i in range(4) for a in tenants]
            for r in reqs:
                r.wait(WAIT)
        for r in reqs:
            assert torch.equal(r.logits, refs[r.model]), r.model
        shared = rt.models[ARCH].store.nbytes(f"{ARCH}/shared_attn")
        assert shared > 0 and rt.models[ARCH].engine.pinned == \
            {f"{ARCH}/shared_attn"}
        assert rt.ledger.resident == rt.cache.resident_bytes >= shared
        assert rt.ledger.peak <= 32 * 1024 * 1024
    finally:
        rt.close()
    rt = MultiModelRuntime(512 * 1024, cache_frac=0.9, device="cpu")
    try:
        rt.add_model("z", model, params, str(tmp_path / "z"))
        assert rt.block_budget() <= 0
        with pytest.raises(ValueError, match="no room for blocks"):
            rt.plan(batch=2, seq=32)
    finally:
        rt.close()


def test_decode_loop_and_engine_match_jax(setup, tmp_path):
    ref_model, ref_params, model, params = setup
    B, S, NEW = 2, 8, 3
    prompts = _prompts(model.cfg, B, S, seed=7)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref.partition(BUDGET, RefDelayModel(), B, S)
    want, _ = ref.decode_loop(jnp.asarray(prompts), max_new_tokens=NEW,
                              max_len=64)
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    try:
        sm.partition(BUDGET, DelayModel(), B, S)
        gen, stats = sm.decode_loop(torch.from_numpy(prompts),
                                    max_new_tokens=NEW, max_len=64)
    finally:
        sm.close()
    assert gen.tolist() == np.asarray(want).tolist()
    assert 0 < stats["peak_resident_mb"] * 1e6 <= BUDGET
    ref_eng = RefServingEngine(ref_model, ref_params, max_len=64)
    ref_reqs = [RefRequest(i, list(map(int, p)), max_new_tokens=NEW)
                for i, p in enumerate(prompts)]
    ref_eng.generate(ref_reqs)
    eng = ServingEngine(model, params, max_len=64, device="cpu")
    reqs = [Request(i, list(map(int, p)), max_new_tokens=NEW)
            for i, p in enumerate(prompts)]
    st = eng.generate(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs] \
        == gen.tolist()
    assert st["decode_steps"] == NEW - 1


def test_left_padding_enters_the_mamba2_state(setup):
    """A reference fault kept for parity: the engine left-pads unequal
    prompts with token 0, and Mamba2 runs those pads through its state and
    conv, so a padded request's prefill is not its solo one. The port
    gives the reference's tokens for the padded batch, and the padded
    row's logits differ from its solo prefill by far more than float32
    rounding."""
    ref_model, ref_params, model, params = setup
    long, short = _prompts(model.cfg, 1, 32, seed=9)[0], \
        _prompts(model.cfg, 1, 16, seed=10)[0]
    prompts = [list(map(int, long)), list(map(int, short))]
    max_new = [4, 3]
    ref_eng = RefServingEngine(ref_model, ref_params, max_len=64)
    ref_reqs = [RefRequest(i, p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
    ref_eng.generate(ref_reqs)
    eng = ServingEngine(model, params, max_len=64, device="cpu")
    reqs = [Request(i, p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    eng.generate(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert [len(r.output) for r in reqs] == max_new
    padded = np.zeros((1, 32), np.int32)
    padded[0, 16:] = short
    solo, _ = model.prefill(params, {"tokens": torch.from_numpy(
        short[None].astype(np.int32))})
    pad, _ = model.prefill(params, {"tokens": torch.from_numpy(padded)})
    assert (pad - solo).abs().max().item() > 1e-3 * solo.abs().max().item()


def test_int8_lazy_store_matches_the_reference_quant_store(setup, tmp_path):
    """The int8 lazy store: Mamba2's ``wo`` and the shared block's seven
    linears stay quantized and run B1's plain version (``swap_linear_q``);
    the input projections are widened at load. The swapped logits are
    within 1e-5 of the reference's quantized swapped logits, and the
    store's files equal the reference's byte for byte."""
    ref_model, ref_params, model, params = setup
    toks = _prompts(model.cfg, 2, 32)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"),
                          store_backend="quant", precision="int8")
    ref.partition(BUDGET, RefDelayModel(), 2, 32)
    want, _ = ref.forward({"tokens": jnp.asarray(toks)})
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"),
                      store_backend="quant", precision="int8", device="cpu")
    calls = {"q": 0, "fp": 0}
    plain_q, plain_fp = slq.swap_linear_q_plain, sl.swap_linear_plain

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    try:
        sm.partition(BUDGET, DelayModel(), 2, 32)
        slq.swap_linear_q_plain = count("q", plain_q)
        sl.swap_linear_plain = count("fp", plain_fp)
        got, st = sm.forward({"tokens": torch.from_numpy(toks)})
    finally:
        slq.swap_linear_q_plain, sl.swap_linear_plain = plain_q, plain_fp
        sm.close()
    assert st["precision"] == "int8" and st["store_backend"] == "quant"
    # 2 x Mamba2 wo + 2 x the shared block's 7 + the quantized head
    assert calls == {"q": 2 + 2 * 7 + 1, "fp": 0}
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for name in ("layer000_mamba2", "shared_attn", "head"):
        with open(ref.store._path(name), "rb") as a, \
                open(sm.store._path(name), "rb") as b:
            assert a.read() == b.read(), name


# ------------------------------------------------------------ the CLI
@pytest.mark.parametrize("mode", ["swapped", "in-memory"])
def test_serve_zamba2_on_cpu(capsys, mode):
    args = ["--arch", ARCH, "--reduce", "smoke", "--requests", "2",
            "--prompt-len", "16", "--new-tokens", "3", "--device", "cpu"]
    if mode == "swapped":
        args += ["--budget-mb", "12"]
    out = serve.main(args)
    text = capsys.readouterr().out
    if mode == "swapped":
        assert "store=mmap/fp" in text and "[serve] decode 2 x 3" in text
        assert tuple(out["tokens"].shape) == (2, 3)
    else:
        assert [len(r.output) for r in out["requests"]] == [3, 3]


def test_serve_paged_refuses_zamba2():
    with pytest.raises(ValueError, match="paged KV serving covers"):
        serve.main(["--arch", ARCH, "--reduce", "smoke", "--budget-mb", "24",
                    "--paged", "--requests", "1", "--prompt-len", "16",
                    "--device", "cpu"])
