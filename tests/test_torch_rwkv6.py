"""rwkv6 (Finch) in the port against the JAX package on the same weights:
the WKV recurrence, the time-mix and channel-mix, the whole model, the
swapped forward on mmap, weight-streaming decode and the in-memory engine.

rwkv6-3b ``reduced()`` in float32 (8 WKV heads of 32), params from the JAX
``Model.init`` handed over as numpy. Tolerances, with their reasons:
  * port vs JAX, float32: rtol = atol = 1e-5 (the same chunked
    factorization; sums run in another order);
  * bf16 inputs to the recurrence: 2e-2 (one bf16 rounding of the output);
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
from repro.kernels import ref as kref  # noqa: E402
from repro.kernels.wkv6 import wkv6 as ref_wkv6  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.serving import kv_cache as ref_kv  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServingEngine as RefServingEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel, unit_infos  # noqa: E402
from repro_torch.kernels import wkv6 as kw  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.store.mmap_store import MmapStore  # noqa: E402

ARCH = "rwkv6-3b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BUDGET = 8 * 1024 * 1024


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module")
def setup():
    ref_model = RefModel(dataclasses.replace(ref_get_arch(ARCH).reduced(),
                                             dtype="float32"))
    ref_params = ref_model.init(jax.random.key(0))
    model = Model(dataclasses.replace(get_arch(ARCH).reduced(),
                                      dtype="float32"))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def _layer_params(setup, j):
    """Layer j's params in both packages."""
    _, ref_params, _, params = setup
    return (jax.tree.map(lambda a: a[j], ref_params["segments"][0]),
            jax.tree.map(lambda a: a[j], params["segments"][0],
                         is_leaf=lambda a: isinstance(a, torch.Tensor)))


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)
                                                ).astype(np.int32)


def _wkv_inputs(BH, S, hd, seed):
    """r, k, v ~ 0.5 N(0, 1), u ~ 0.1 N(0, 1); log decays uniform over the
    whole clamp range [-5, -1e-4], both ends included."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((3, BH, S, hd)) * 0.5).astype(np.float32)
    w = rng.uniform(ssm.W_LOG_MIN, ssm.W_LOG_MAX, (BH, S, hd))
    w[0, :, :] = ssm.W_LOG_MIN                  # the e^80 corner
    w[1, :, 0] = ssm.W_LOG_MAX
    u = (rng.standard_normal((BH, hd)) * 0.1).astype(np.float32)
    return r, k, v, w.astype(np.float32), u


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_plain_matches_pallas_kernel_and_oracle(S, dtype):
    BH, hd = 4, 32
    ins = _wkv_inputs(BH, S, hd, seed=S)
    jx = [jnp.asarray(a, jnp.dtype(dtype)) for a in ins]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in ins]
    got, S_fin = kw.wkv6_plain(*tt)
    assert got.dtype == tt[0].dtype and S_fin.dtype == torch.float32
    tol = TOL if dtype == "float32" else BF16_TOL
    for want in (ref_wkv6(*jx, interpret=True), kref.wkv6_ref(*jx)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol)
    assert np.isfinite(_np(S_fin)).all()


def test_wkv6_plain_state_in_and_out(setup):
    """The final state equals the reference time-mix's S_fin from a given
    S0, and a run split in two with the state carried equals one run."""
    cfg = setup[0].cfg
    p, _ = _layer_params(setup, 1)
    B, S = 2, 32
    nh, hd = ref_ssm.rwkv6_dims(cfg)
    rng = np.random.default_rng(3)
    xn = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)) * 0.5,
                     jnp.float32)
    S0 = jnp.asarray(rng.standard_normal((B, nh, hd, hd)) * 0.3, jnp.float32)
    r, k, v, _, logw, _ = ref_ssm._rwkv_time_inputs(cfg, p, xn, None)
    _, (want_S, _) = ref_ssm.rwkv6_time_mix_chunked(cfg, p, xn, S0)

    def rows(t):
        t = np.asarray(t).transpose(0, 2, 1, 3).reshape(B * nh, S, hd)
        return torch.from_numpy(np.ascontiguousarray(t))
    u = torch.from_numpy(np.broadcast_to(np.asarray(p["u"])[None],
                                         (B, nh, hd)).reshape(B * nh, hd))
    r, k, v, w = map(rows, (r, k, v, logw))
    s0 = torch.from_numpy(np.array(S0).reshape(B * nh, hd, hd))
    y, S_fin = kw.wkv6_plain(r, k, v, w, u, s0)
    np.testing.assert_allclose(_np(S_fin).reshape(B, nh, hd, hd),
                               np.asarray(want_S), **TOL)
    h = S // 2
    y1, S_mid = kw.wkv6_plain(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0)
    y2, S_end = kw.wkv6_plain(r[:, h:].contiguous(), k[:, h:].contiguous(),
                              v[:, h:].contiguous(), w[:, h:].contiguous(),
                              u, S_mid)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y), **TOL)
    np.testing.assert_allclose(_np(S_end), _np(S_fin), **TOL)


def test_wkv6_wrapper_checks_and_cpu_dispatch():
    r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(2, 48, 32, seed=1))
    before = kw.launches.count
    y, S_fin = kw.wkv6(r, k, v, w, u)
    y_p, S_p = kw.wkv6_plain(r, k, v, w, u)
    assert torch.equal(y, y_p) and torch.equal(S_fin, S_p)
    assert kw.launches.count == before          # the CPU runs no kernel
    with pytest.raises(ValueError, match="chunks of 16"):
        kw.wkv6(r[:, :20], k[:, :20], v[:, :20], w[:, :20], u)
    with pytest.raises(ValueError):
        kw.wkv6(r, k[:, :16], v, w, u)
    with pytest.raises(ValueError):
        kw.wkv6(r, k, v, w, u, torch.zeros(2, 32, 31))


# ------------------------------------------------------------ the layers
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_and_channel_mix_match_jax(setup, with_state):
    cfg = setup[0].cfg
    p, tp = _layer_params(setup, 0)
    nh, hd = ref_ssm.rwkv6_dims(cfg)
    B, S, D = 2, 32, cfg.d_model
    rng = np.random.default_rng(5)
    xn = (rng.standard_normal((B, S, D)) * 0.5).astype(np.float32)
    S0 = sh = None
    if with_state:
        S0 = (rng.standard_normal((B, nh, hd, hd)) * 0.3).astype(np.float32)
        sh = (rng.standard_normal((B, 1, D)) * 0.5).astype(np.float32)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)
    want, (wS, wsh) = ref_ssm.rwkv6_time_mix_chunked(cfg, p, j(xn), j(S0),
                                                     j(sh))
    got, (gS, gsh) = ssm.rwkv6_time_mix_chunked(cfg, tp, t(xn), t(S0), t(sh))
    for a, b in ((got, want), (gS, wS), (gsh, wsh)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)

    S1 = np.array(wS)
    x1, s1 = xn[:, -1:], xn[:, -2:-1]
    want, (wS, wsh) = ref_ssm.rwkv6_time_mix_step(cfg, p, j(x1), j(S1), j(s1))
    got, (gS, gsh) = ssm.rwkv6_time_mix_step(cfg, tp, t(x1), t(S1), t(s1))
    for a, b in ((got, want), (gS, wS), (gsh, wsh)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)

    want, wsh = ref_ssm.rwkv6_channel_mix(cfg, p, j(xn), j(sh))
    got, gsh = ssm.rwkv6_channel_mix(cfg, tp, t(xn), t(sh))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gsh), np.asarray(wsh), **TOL)


# ------------------------------------------------------------ the model
def test_model_prefill_and_decode_step_match_jax(setup):
    ref_model, ref_params, model, params = setup
    toks = _prompts(model.cfg, 2, 32)
    want, wcache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)})
    got, gcache = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert [sorted(c) for c in gcache] == [["S", "shift1", "shift2"]]
    for name in ("S", "shift1", "shift2"):
        np.testing.assert_allclose(_np(gcache[0][name]),
                                   np.asarray(wcache[0][name]), **TOL)
    tok = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)[:, None]
    want, wcache = ref_model.decode_step(ref_params, wcache, {
        "token": jnp.asarray(tok), "pos": jnp.full((2,), 32, jnp.int32)})
    state = model.alloc_cache(2, 40, device="cpu")
    for name in gcache[0]:
        state[0][name].copy_(gcache[0][name])
    got, out = model.decode_step(params, state, {
        "token": torch.from_numpy(tok), "pos": torch.full((2,), 32)})
    assert out[0] is state[0]                   # updated in place
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for name in ("S", "shift1", "shift2"):
        np.testing.assert_allclose(_np(state[0][name]),
                                   np.asarray(wcache[0][name]), **TOL)


def test_prefill_refuses_ragged_chunks(setup):
    """A reference fault kept for parity: a prompt longer than 16 tokens
    that is not a multiple of 16 is refused (the reference asserts)."""
    ref_model, ref_params, model, params = setup
    toks = _prompts(model.cfg, 1, 20)
    with pytest.raises(ValueError, match="chunks of 16"):
        model.prefill(params, {"tokens": torch.from_numpy(toks)})
    with pytest.raises(AssertionError):
        ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)})


# ------------------------------------------------------------ swapped
def test_swapped_mmap_bitwise_and_matches_jax(setup, tmp_path):
    ref_model, ref_params, model, params = setup
    toks = _prompts(model.cfg, 2, 32)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref.partition(BUDGET, RefDelayModel(), 2, 32)
    want, _ = ref.forward({"tokens": jnp.asarray(toks)})
    ref_rows = ref_unit_infos(ref_model, ref.units, 2, 32)
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"),
                      store_backend="quant", device="cpu")
    try:
        assert sm.store_backend == "mmap" and sm.precision == "fp"
        assert isinstance(sm.store, MmapStore)
        rows = unit_infos(model, sm.units, 2, 32)
        assert [(r.name, r.size, r.depth, r.flops) for r in rows] == \
            [(r.name, r.size, r.depth, r.flops) for r in ref_rows]
        sm.partition(BUDGET, DelayModel(), 2, 32)
        assert sm.plan.points == ref.plan.points and sm.plan.n_blocks >= 2
        batch = {"tokens": torch.from_numpy(toks)}
        got, stats = sm.forward(batch)
        assert torch.equal(got, sm.forward_unswapped(batch))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        assert stats["peak_resident_mb"] * 1e6 <= BUDGET
        state, _ = sm.forward_partial(batch, collect_cache=True)
        assert torch.equal(state.logits, got)
        _, cache = model.prefill(params, batch)
        assert sorted(state.caches) == [0, 1]
        for lid, c in state.caches.items():
            assert sorted(c) == ["S", "shift1", "shift2"]
            for name in c:
                assert torch.equal(c[name], cache[0][name][lid])
    finally:
        sm.close()


def test_decode_loop_matches_jax_and_engine(setup, tmp_path):
    ref_model, ref_params, model, params = setup
    B, S, NEW = 2, 12, 5
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
    eng = ServingEngine(model, params, max_len=64, device="cpu")
    reqs = [Request(i, list(map(int, prompts[i])), max_new_tokens=NEW)
            for i in range(B)]
    eng.generate(reqs)
    assert [r.output for r in reqs] == gen.tolist()


def test_engine_generate_matches_jax_and_is_deterministic(setup):
    ref_model, ref_params, model, params = setup
    prompts = [list(map(int, p)) for p in _prompts(model.cfg, 4, 16, seed=8)]
    ref_eng = RefServingEngine(ref_model, ref_params, max_len=64)
    ref_reqs = [RefRequest(i, p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
    ref_eng.generate(ref_reqs)
    eng = ServingEngine(model, params, max_len=64, device="cpu")
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
    stats = eng.generate(reqs)
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert stats["decode_steps"] == 7
    reqs2 = [Request(10 + i, p, max_new_tokens=8)
             for i, p in enumerate(prompts)]
    eng.generate(reqs2)
    assert [r.output for r in reqs2] == [r.output for r in reqs]


def test_left_padding_enters_the_rnn_state(setup):
    """A reference fault kept for parity: the engine left-pads unequal
    prompts with token 0, and an RNN runs those pads through its state, so
    a padded request's tokens are not those of its solo run. The port
    gives the reference's tokens for the padded batch, and the padded
    row's prefill logits differ from its solo prefill: by far more than
    float32 rounding (about 1e-7 here), though the random weights' fast
    decay (about e^-1 a step) keeps it small."""
    ref_model, ref_params, model, params = setup
    long, short = _prompts(model.cfg, 1, 16, seed=9)[0], \
        _prompts(model.cfg, 1, 12, seed=10)[0]
    prompts = [list(map(int, long)), list(map(int, short))]
    max_new = [6, 4]
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
    padded = np.zeros((1, 16), np.int32)
    padded[0, 4:] = short
    solo, _ = model.prefill(params, {"tokens": torch.from_numpy(
        short[None].astype(np.int32))})
    pad, _ = model.prefill(params, {"tokens": torch.from_numpy(padded)})
    assert (pad - solo).abs().max().item() > 1e-5 * solo.abs().max().item()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b", "zamba2-7b"])
def test_cache_pad_and_gather_match_jax(arch):
    ref_model = RefModel(dataclasses.replace(ref_get_arch(arch).reduced(),
                                             dtype="float32"))
    ref_params = ref_model.init(jax.random.key(1))
    model = Model(dataclasses.replace(get_arch(arch).reduced(),
                                      dtype="float32"))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    B, S, L = 3, 16, 24
    toks = _prompts(model.cfg, B, S, seed=11)
    _, rc = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)})
    _, gc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    rpad = ref_kv.pad_prefill_cache(ref_model, rc, L, B)
    gpad = kv_cache.pad_prefill_cache(model, gc, L, B)
    rows = [2, 0]
    rg = ref_kv.gather_cache_rows(ref_model, rpad, rows, L, B)
    gg = kv_cache.gather_cache_rows(model, gpad, rows, L, B)
    for got_tree, want_tree in ((gpad, rpad), (gg, rg)):
        assert [sorted(c) for c in got_tree] == [sorted(c) for c in want_tree]
        for g_seg, w_seg in zip(got_tree, want_tree):
            for name in g_seg:
                assert tuple(g_seg[name].shape) == w_seg[name].shape
                np.testing.assert_allclose(_np(g_seg[name]),
                                           np.asarray(w_seg[name]), **TOL)
    with pytest.raises(ValueError):
        kv_cache.pad_prefill_cache(model, gc, L, B - 1)


# ------------------------------------------------------------ the CLI
@pytest.mark.parametrize("mode", ["swapped", "in-memory"])
def test_serve_rwkv6_on_cpu(capsys, mode):
    args = ["--arch", ARCH, "--reduce", "smoke", "--requests", "2",
            "--prompt-len", "16", "--new-tokens", "3", "--device", "cpu"]
    if mode == "swapped":
        args += ["--budget-mb", "8", "--store", "quant"]
    out = serve.main(args)
    text = capsys.readouterr().out
    if mode == "swapped":
        assert "store=mmap/fp" in text and "[serve] decode 2 x 3" in text
        assert tuple(out["tokens"].shape) == (2, 3)
    else:
        assert [len(r.output) for r in out["requests"]] == [3, 3]


def test_serve_paged_refuses_rwkv6():
    with pytest.raises(ValueError, match="paged KV serving covers"):
        serve.main(["--arch", ARCH, "--reduce", "smoke", "--budget-mb", "8",
                    "--paged", "--requests", "1", "--prompt-len", "16",
                    "--device", "cpu"])
