"""``wkv6`` (B6) under autograd on the CPU: ``WKV6Fn`` and ``wkv6_grad``.

Where grad mode is on and an input requires grad, ``wkv6`` runs through
``WKV6Fn``: the forward is the kernel (its plain version on the CPU), the
backward ``wkv6_grad`` in torch ops. These tests hold that gradient to
autograd through ``wkv6_plain`` on the same inputs, and the port's
chunked time-mix gradient to ``jax.grad`` of the JAX package's.

Tolerances, with their reasons:
  * ``WKV6Fn`` against autograd through ``wkv6_plain``, float32 on both
    sides: 1e-5 of each input's largest |g| (the sums run in another
    order);
  * every log decay at the clamp (-5): the reference is autograd through
    ``wkv6_plain`` in float64. Autograd through the float32 plain version
    sums the decay's gradient as ``revcumsum(dl + dlprev) - dlprev``,
    whose terms there are up to e^5 larger than the result, and lands
    1e-5 to 3e-5 of the largest |g| from the float64 value; ``wkv6_grad``
    sums it term by term and stays within 1e-5 of it, which the test
    checks, and no further from it than the float32 plain version;
  * the time-mix against ``jax.grad`` of the reference's: 1e-4 of each
    leaf's largest |g| (float32; the projections and the layer norm sum
    in another order too).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import swap_linear as sl  # noqa: E402
from repro_torch.kernels import wkv6 as kw  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = 1e-5
TIME_MIX_TOL = 1e-4
ARCH = "rwkv6-3b"

# name: (BH, S, hd, initial state, the loss reads the final state)
CASES = {
    "one_short_chunk": (3, 12, 8, False, False),
    "four_chunks": (4, 64, 16, False, False),
    "initial_state": (2, 64, 16, True, False),
    "final_state_read": (2, 48, 16, False, True),
    "state_in_and_out": (3, 32, 32, True, True),
}


def _inputs(BH, S, hd, state, seed, clamp=False):
    """numpy r, k, v ~ 0.5 N(0, 1), log decays -exp(N(0, 1)) clamped to
    [-5, -1e-4] (all -5 under ``clamp``), u ~ 0.3 N(0, 1), an initial
    state ~ 0.3 N(0, 1) or None, and the outputs' gradients dy ~ N(0, 1),
    dS ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 0.5, (BH, S, hd)) for _ in range(3))
    w = (np.full((BH, S, hd), ssm.W_LOG_MIN) if clamp else
         np.clip(-np.exp(rng.normal(0, 1, (BH, S, hd))), ssm.W_LOG_MIN,
                 ssm.W_LOG_MAX))
    u = rng.normal(0, 0.3, (BH, hd))
    s0 = rng.normal(0, 0.3, (BH, hd, hd)) if state else None
    dy = rng.normal(0, 1, (BH, S, hd))
    ds = rng.normal(0, 1, (BH, hd, hd))
    return [r, k, v, w, u, s0], dy, ds


def _grads(fn, arrays, dy, ds, read_final, dtype=torch.float32):
    """(y, the inputs' gradients) of ``sum(y dy) [+ sum(S_fin dS)]``
    through ``fn`` on leaves made from ``arrays`` in ``dtype``."""
    leaves = [None if a is None else
              torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in arrays]
    y, s_fin = fn(*leaves)
    loss = torch.sum(y * torch.tensor(dy, dtype=dtype))
    if read_final:
        loss = loss + torch.sum(s_fin * torch.tensor(ds, dtype=dtype))
    loss.backward()
    return y.detach(), [t.grad for t in leaves if t is not None]


def _rel(got, want) -> float:
    return (float((got.double() - want.double()).abs().max())
            / max(float(want.double().abs().max()), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_wkv6_fn_matches_autograd_through_plain(case):
    BH, S, hd, state, read_final = CASES[case]
    arrays, dy, ds = _inputs(BH, S, hd, state, seed=len(case))
    y, got = _grads(kw.wkv6, arrays, dy, ds, read_final)
    y0, want = _grads(kw.wkv6_plain, arrays, dy, ds, read_final)
    assert torch.equal(y, y0)
    assert len(got) == len(want) == (6 if state else 5)
    for g, g0 in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == g0.shape
        assert _rel(g, g0) <= TOL


@pytest.mark.parametrize("S", [16, 48])
def test_wkv6_fn_at_the_clamp(S):
    """Every log decay at -5: k e^-l reaches e^75 inside a chunk."""
    arrays, dy, ds = _inputs(2, S, 32, True, seed=S, clamp=True)
    _, got = _grads(kw.wkv6, arrays, dy, ds, True)
    _, exact = _grads(kw.wkv6_plain, arrays, dy, ds, True, torch.float64)
    _, plain32 = _grads(kw.wkv6_plain, arrays, dy, ds, True)
    for g, g64, g32 in zip(got, exact, plain32):
        assert torch.isfinite(g).all()
        assert _rel(g, g64) <= TOL
        assert _rel(g, g64) <= max(_rel(g32, g64), 1e-6)


def test_wkv6_grad_of_an_unused_final_state_is_zero():
    """``dstate_fin`` zeros (what autograd materializes for an output the
    loss never reads) give the same gradient as a loss on y alone."""
    arrays, dy, _ = _inputs(2, 32, 16, True, seed=5)
    r, k, v, w, u, s0 = (torch.tensor(a, dtype=torch.float32)
                         for a in arrays)
    dyt = torch.tensor(dy, dtype=torch.float32)
    got = kw.wkv6_grad(r, k, v, w, u, s0, dyt, torch.zeros((2, 16, 16)))
    _, want = _grads(kw.wkv6_plain, arrays, dy, None, False)
    for g, g0 in zip(got, want):
        assert _rel(g, g0) <= TOL
    none = kw.wkv6_grad(r, k, v, w, u, None, dyt, torch.zeros((2, 16, 16)))
    assert len(none) == 6 and none[5] is None


def test_wkv6_grad_returns_the_inputs_dtypes():
    """bf16 inputs: each gradient in its input's dtype (the state's fp32),
    computed in fp32: within 2e-2 of autograd through the plain version."""
    arrays, dy, ds = _inputs(2, 32, 16, True, seed=6)
    leaves = [torch.tensor(a, dtype=torch.bfloat16) for a in arrays[:5]]
    leaves.append(torch.tensor(arrays[5], dtype=torch.float32))
    for t in leaves:
        t.requires_grad_(True)

    def run(fn):
        for t in leaves:
            t.grad = None
        y, s_fin = fn(*leaves)
        (torch.sum(y.float() * torch.tensor(dy, dtype=torch.float32))
         + torch.sum(s_fin * torch.tensor(ds, dtype=torch.float32))
         ).backward()
        return [t.grad for t in leaves]
    got, want = run(kw.wkv6), run(kw.wkv6_plain)
    for g, g0, t in zip(got, want, leaves):
        assert g.dtype == t.dtype
        assert _rel(g, g0) <= 2e-2


def test_wkv6_runs_the_function_only_under_grad(monkeypatch):
    """Inference never enters the Function, so it runs as it did; the
    backward never runs the plain version."""
    arrays, dy, _ = _inputs(2, 16, 8, False, seed=7)
    r, k, v, w, u, _ = (None if a is None else
                        torch.tensor(a, dtype=torch.float32)
                        for a in arrays)
    assert kw.wkv6(r, k, v, w, u)[0].grad_fn is None
    r.requires_grad_(True)
    with torch.no_grad():
        assert kw.wkv6(r, k, v, w, u)[0].grad_fn is None
    y, _ = kw.wkv6(r, k, v, w, u)
    assert type(y.grad_fn).__name__ == "WKV6FnBackward"
    monkeypatch.setattr(kw, "wkv6_plain", None)         # a call raises
    y.backward(torch.tensor(dy, dtype=torch.float32))
    assert r.grad is not None and k.grad is None


def test_wkv6_differentiates_on_the_cpu():
    """On the CPU every input of ``wkv6`` gets its gradient (the guard the
    kernel had before its backward is gone)."""
    arrays, dy, _ = _inputs(2, 16, 8, False, seed=6)
    leaves = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
              for a in arrays[:5]]
    y, _ = kw.wkv6(*leaves)
    y.sum().backward()
    assert all(t.grad is not None for t in leaves)


# ------------------------------------------------------------ the time-mix
@pytest.fixture(scope="module")
def pair():
    ref_cfg = dataclasses.replace(ref_get_arch(ARCH).reduced(),
                                  dtype="float32")
    ref_params = RefModel(ref_cfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    return (ref_cfg, jax.tree.map(lambda a: a[1], ref_params["segments"][0]),
            cfg, jax.tree.map(lambda a: a[1], params["segments"][0],
                              is_leaf=lambda a: isinstance(a, torch.Tensor)))


@pytest.mark.parametrize("S", [16, 48])
def test_time_mix_grads_match_jax(pair, S):
    """The port's ``rwkv6_time_mix_chunked`` (B6 under ``WKV6Fn``)
    against ``jax.grad`` of the reference's, on seeded numpy inputs: the
    gradients of every layer param, ``xn`` and ``S0`` of ``sum(out dout)
    + sum(S_fin dS)``."""
    ref_cfg, ref_p, cfg, p = pair
    nh, hd = ref_ssm.rwkv6_dims(ref_cfg)
    B, D = 2, ref_cfg.d_model
    rng = np.random.default_rng(S)
    xn = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    s0 = rng.normal(0, 0.3, (B, nh, hd, hd)).astype(np.float32)
    dout = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    ds = rng.normal(0, 1, (B, nh, hd, hd)).astype(np.float32)

    def ref_loss(p_, xn_, s0_):
        out, (s_fin, _) = ref_ssm.rwkv6_time_mix_chunked(ref_cfg, p_, xn_,
                                                         s0_)
        return jnp.sum(out * dout) + jnp.sum(s_fin * ds)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(ref_p, jnp.asarray(xn),
                                                 jnp.asarray(s0))

    tp = {name: t.detach().clone().requires_grad_(True)
          for name, t in p.items()}
    txn = torch.tensor(xn, requires_grad=True)
    ts0 = torch.tensor(s0, requires_grad=True)
    out, (s_fin, _) = ssm.rwkv6_time_mix_chunked(cfg, tp, txn, ts0)
    assert type(s_fin.grad_fn).__name__ != "NoneType"
    (torch.sum(out * torch.from_numpy(dout))
     + torch.sum(s_fin * torch.from_numpy(ds))).backward()

    got = [(name, tp[name].grad) for name in sorted(tp)]
    got += [("xn", txn.grad), ("S0", ts0.grad)]
    ref = [(name, want[0][name]) for name in sorted(tp)]
    ref += [("xn", want[1]), ("S0", want[2])]
    for (name, g), (_, rg) in zip(got, ref):
        rg = np.asarray(rg, np.float64)
        g = np.zeros_like(rg) if g is None else g.numpy()
        err = float(np.abs(g - rg).max())
        assert err <= TIME_MIX_TOL * float(np.abs(rg).max()), (name, err)


def test_launches_per_rwkv6_train_step(monkeypatch):
    """What an rwkv6 train step asks of the kernels, counted on the CPU
    where the wrappers run their plain versions: per layer, ``wkv6`` in
    the forward and again when backward recomputes the checkpointed layer
    (2), and ``swap_linear`` for the time-mix's ``wo`` the same two times
    (act "none": no recompute in its backward). The other projections, the
    channel mix and the head are plain matmuls, as in the reference."""
    counts = {"wkv6": 0, "swap_linear": 0}
    real_wkv6, real_sl = kw._wkv6, sl._swap_linear

    def count(name, real):
        def fn(*a):
            counts[name] += 1
            return real(*a)
        return fn
    monkeypatch.setattr(kw, "_wkv6", count("wkv6", real_wkv6))
    monkeypatch.setattr(sl, "_swap_linear", count("swap_linear", real_sl))
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    loss, _ = model.loss(params, {"tokens": tokens,
                                  "targets": torch.roll(tokens, -1, 1)})
    loss.backward()
    L = cfg.n_layers
    assert counts == {"wkv6": 2 * L, "swap_linear": 2 * L}
    assert all(t.grad is not None for t in
               (params["segments"][0]["u"], params["segments"][0]["w_base"]))
