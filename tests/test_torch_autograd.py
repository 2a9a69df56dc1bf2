"""Two of the three kernels that train, ``swap_linear`` (B5) and
``flash_attention`` (B4), under autograd on the CPU (the third, ``wkv6``
(B6), is ``tests/test_torch_wkv6_grad.py``'s).

Where grad mode is on and an input requires grad, each wrapper runs its
``autograd.Function``: the forward is the kernel (its plain version on the
CPU), the backward an explicit gradient in torch ops. These tests hold
that gradient to autograd through the plain version on the same inputs,
within 1e-5 of the largest |g| (float32 on both sides; the sums run in
another order), and check the routing: no Function without grad, so
inference is as it was. The grad guards of the other three kernels raise
only for CUDA tensors; ``tests/test_torch_cuda.py`` holds them on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import swap_linear as sl  # noqa: E402
from repro_torch.kernels.dequant import dequant_int8  # noqa: E402
from repro_torch.kernels.swap_linear_q import swap_linear_q  # noqa: E402

TOL = 1e-5


def _leaf(rng, shape, scale=1.0):
    return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32,
                        requires_grad=True)


def _close(got, want):
    bound = TOL * max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= bound


def _grads(fn, inputs, dy):
    for t in inputs:
        t.grad = None
    out = fn()
    out.backward(dy)
    return out.detach(), [t.grad.clone() for t in inputs]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
def test_swap_linear_fn_matches_autograd_through_plain(act, bias):
    rng = np.random.default_rng(0)
    x, w = _leaf(rng, (37, 48)), _leaf(rng, (48, 29), 48 ** -0.5)
    b = _leaf(rng, (29,), 0.3) if bias else None
    inputs = [t for t in (x, w, b) if t is not None]
    dy = torch.tensor(rng.normal(0, 1, (37, 29)), dtype=torch.float32)
    y, got = _grads(lambda: sl.swap_linear(x, w, b, act=act), inputs, dy)
    assert type(sl.swap_linear(x, w, b, act=act).grad_fn).__name__ == \
        "SwapLinearFnBackward"
    y0, want = _grads(lambda: sl.swap_linear_plain(x, w, b, act=act),
                      inputs, dy)
    assert torch.equal(y, y0)
    for g, g0 in zip(got, want):
        _close(g, g0)


def test_activation_grad_matches_autograd():
    z = torch.linspace(-8, 8, 4001, dtype=torch.float64, requires_grad=True)
    for act in ("silu", "gelu"):
        from repro_torch.kernels.swap_linear_q import activation
        g, = torch.autograd.grad(activation(z, act).sum(), z)
        np.testing.assert_allclose(
            sl.activation_grad(z.detach(), act).numpy(), g.numpy(),
            rtol=1e-12, atol=1e-12)


def test_swap_linear_runs_the_function_only_under_grad():
    rng = np.random.default_rng(1)
    x, w = _leaf(rng, (4, 8)), _leaf(rng, (8, 3))
    assert sl.swap_linear(x.detach(), w.detach()).grad_fn is None
    with torch.no_grad():
        assert sl.swap_linear(x, w).grad_fn is None
    only_w = sl.swap_linear(x.detach(), w, act="silu")
    assert type(only_w.grad_fn).__name__ == "SwapLinearFnBackward"
    only_w.sum().backward()
    assert w.grad is not None and x.grad is None


def test_swap_linear_fn_recomputes_only_under_an_activation(monkeypatch):
    """The backward launches the kernel once more (``act="none"``) where an
    activation was fused, and not otherwise: the launch count the card's
    training step is held to."""
    calls = []
    real = sl._swap_linear
    monkeypatch.setattr(sl, "_swap_linear",
                        lambda *a: calls.append(a[3]) or real(*a))
    rng = np.random.default_rng(2)
    x, w = _leaf(rng, (5, 6)), _leaf(rng, (6, 7))
    for act, want in (("none", ["none"]), ("silu", ["silu", "none"]),
                      ("gelu", ["gelu", "none"])):
        calls.clear()
        sl.swap_linear(x, w, act=act).sum().backward()
        assert calls == want


ATTN_CASES = {
    # name: (B, S, H, KV, hd, dv, causal, window, softcap, chunk)
    "causal": (2, 37, 4, 4, 16, 16, True, None, None, None),
    "gqa": (2, 33, 6, 2, 16, 16, True, None, None, None),
    "window": (1, 40, 4, 2, 8, 8, True, 9, None, None),
    "softcap": (2, 24, 4, 2, 16, 16, True, None, 3.0, None),
    "chunk": (1, 40, 4, 1, 8, 8, True, None, None, 8),
    "non_causal": (2, 29, 4, 4, 16, 16, False, None, None, None),
    "dv_differs": (2, 31, 4, 4, 24, 16, True, None, None, None),
    "window_softcap_gqa": (1, 50, 8, 2, 16, 16, True, 12, 2.5, None),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_fn_matches_autograd_through_plain(case):
    B, S, H, KV, hd, dv, causal, window, cap, chunk = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q, k = _leaf(rng, (B, S, H, hd)), _leaf(rng, (B, S, KV, hd))
    v = _leaf(rng, (B, S, KV, dv))
    # positions shuffled within the sequence: the mask reads q_pos
    pos = torch.tensor(np.stack([rng.permutation(S) for _ in range(B)]))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=cap,
              chunk=chunk)
    dy = torch.tensor(rng.normal(0, 1, (B, S, H, dv)), dtype=torch.float32)
    out, got = _grads(lambda: fa.flash_attention(q, k, v, pos, **kw),
                      [q, k, v], dy)
    out0, want = _grads(lambda: fa.flash_attention_plain(q, k, v, pos, **kw),
                        [q, k, v], dy)
    assert torch.equal(out, out0)
    for g, g0 in zip(got, want):
        _close(g, g0)


def test_flash_attention_grad_blocks_do_not_change_the_gradient():
    """Blocks of 7 query rows (ragged last block) == one block of all S."""
    rng = np.random.default_rng(4)
    B, S, H, KV, hd = 2, 45, 4, 2, 16
    q = torch.tensor(rng.normal(0, 1, (B, S, H, hd)), dtype=torch.float32)
    k = torch.tensor(rng.normal(0, 1, (B, S, KV, hd)), dtype=torch.float32)
    v = torch.tensor(rng.normal(0, 1, (B, S, KV, hd)), dtype=torch.float32)
    pos = torch.arange(S).expand(B, S)
    kw = dict(scale=0.25, causal=True, window=20, softcap=4.0)
    out = fa.flash_attention_plain(q, k, v, pos, **kw)
    dout = torch.tensor(rng.normal(0, 1, out.shape), dtype=torch.float32)
    a = fa.flash_attention_grad(q, k, v, pos, out, dout, block=7, **kw)
    b = fa.flash_attention_grad(q, k, v, pos, out, dout, block=S, **kw)
    for x, y in zip(a, b):
        _close(x, y)


def test_flash_attention_runs_the_function_only_under_grad(monkeypatch):
    """Inference never enters the Function; the backward never runs the
    plain version (it is off the training path)."""
    rng = np.random.default_rng(5)
    q = _leaf(rng, (1, 8, 2, 8))
    k, v = _leaf(rng, (1, 8, 2, 8)), _leaf(rng, (1, 8, 2, 8))
    pos = torch.arange(8)[None]
    with torch.no_grad():
        assert fa.flash_attention(q, k, v, pos, scale=0.3).grad_fn is None
    out = fa.flash_attention(q, k, v, pos, scale=0.3)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    monkeypatch.setattr(fa, "flash_attention_plain", None)  # a call raises
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))


def test_refuse_grad_names_the_kernel():
    w = torch.ones(3, requires_grad=True)
    _build.refuse_grad("paged_attention", None, w.detach())
    with torch.no_grad():
        _build.refuse_grad("paged_attention", w)
    with pytest.raises(RuntimeError, match="paged_attention: the CUDA "
                                           "kernel has no backward"):
        _build.refuse_grad("paged_attention", None, w)


def test_guarded_kernels_differentiate_their_plain_versions_on_the_cpu():
    """On the CPU the kernels without a Function run their plain
    versions, which autograd differentiates: the guard is the card's."""
    rng = np.random.default_rng(6)
    x = _leaf(rng, (3, 8))
    qw = torch.tensor(rng.integers(-127, 128, (8, 5)), dtype=torch.int8)
    scales = _leaf(rng, (5,), 0.01)
    swap_linear_q(x, qw, scales, act="silu").sum().backward()
    assert x.grad is not None and scales.grad is not None
    s2 = _leaf(rng, (5,), 0.01)
    dequant_int8(qw, s2).sum().backward()
    assert s2.grad is not None
