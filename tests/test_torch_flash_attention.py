"""flash_attention (prefill self-attention) in the port against the JAX
package, and the prefill that now runs it: the Pallas kernel in interpret
mode (blocks of 128, K/V heads repeated for it, as its ``ops`` wrapper
does), its oracle ``flash_attention_ref`` at ragged S and head_dim 256,
the port's own ``online_attention`` under GQA and explicit positions, and
the prefill logits of reduced qwen2.5-3b and gemma2-9b against the JAX
``Model``.

Tolerances, with their reasons:
  * float32: rtol = atol = 1e-5 (dense against online softmax: the sums
    run in another order);
  * bf16 inputs: 2e-2 (one bf16 rounding of the output);
  * swapped vs unswapped inside the port on mmap: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, S, KV, hd)) * 0.5).astype(np.float32)
    return q, k, v


def _to_bh(a, G):
    """[B, S, n, hd] -> [B * n * G, S, hd], each head repeated G times."""
    a = np.repeat(a, G, axis=2)
    B, S, H, hd = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


def _from_bh(a, B, H):
    BH, S, hd = a.shape
    return np.asarray(a).reshape(B, H, S, hd).transpose(0, 2, 1, 3)


def _port(q, k, v, dtype, **kw):
    B, S = q.shape[:2]
    pos = torch.arange(S).expand(B, S)
    t = [torch.from_numpy(a).to(TORCH[dtype]) for a in (q, k, v)]
    out = fa.flash_attention(*t, pos, **kw)
    assert out.dtype == TORCH[dtype] and tuple(out.shape) == q.shape
    return out.float().numpy()


def _jax(fn, q, k, v, dtype, G, **kw):
    B, S, H, hd = q.shape
    args = [jnp.asarray(_to_bh(a, g)).astype(JNP[dtype])
            for a, g in ((q, 1), (k, G), (v, G))]
    out = fn(*args, **kw)
    return _from_bh(np.asarray(out.astype(jnp.float32)), B, H)


@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 128, None), (True, None, 50.0),
    (False, None, None), (True, 64, 30.0)])
def test_plain_matches_pallas_interpret(hd, dtype, causal, window, softcap):
    B, S, H, KV = 1, 256, 4, 2
    q, k, v = _qkv(B, S, H, KV, hd, seed=hd)
    scale = hd ** -0.5
    got = _port(q, k, v, dtype, scale=scale, causal=causal, window=window,
                softcap=softcap)
    want = _jax(ref_flash, q, k, v, dtype, H // KV, scale=scale,
                causal=causal, window=window, softcap=softcap, block_q=128,
                block_k=128, interpret=True)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("S,hd", [(37, 64), (129, 128), (37, 256),
                                  (129, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_oracle_at_ragged_s(S, hd, dtype):
    """S = 37 and 129 are the port's prompt lengths the TPU kernel's
    S % 256 assert refuses; gemma's head_dim 256 and query scale 224^-0.5,
    window and softcap."""
    B, H, KV = 2, 4, 2
    q, k, v = _qkv(B, S, H, KV, hd, seed=S + hd)
    kw = dict(scale=224.0 ** -0.5, causal=True, window=16, softcap=50.0)
    got = _port(q, k, v, dtype, **kw)
    want = _jax(kref.flash_attention_ref, q, k, v, dtype, H // KV, **kw)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (16, 2)])
def test_plain_matches_online_attention_gqa_and_positions(H, KV):
    """Query head h reads KV head h // (H / KV); q_pos is not an arange
    (a shifted, shuffled set of positions, each with a key to attend to);
    window and softcap as gemma's local layer, scan in chunks of 16."""
    B, S, hd = 2, 50, 32
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, S, H, KV, hd, seed=H))
    rng = np.random.default_rng(KV)
    pos = torch.from_numpy(np.stack([rng.permutation(S), np.arange(S) // 2
                                     + 10]))
    for window, softcap in ((None, None), (7, 50.0), (fa.LARGE_WINDOW, 30.0)):
        for causal in (True, False):
            kw = dict(causal=causal, window=window, scale=0.3)
            if not causal and window == 7:
                # the kernel refuses this pair: online_attention drops the
                # window here, the TPU kernel applies it
                with pytest.raises(ValueError, match="non-causal"):
                    fa.flash_attention(q, k, v, pos, softcap=softcap, **kw)
                continue
            got = fa.flash_attention(q, k, v, pos, softcap=softcap, **kw)
            want = attention.online_attention(q, k, v, pos, None,
                                              logit_cap=softcap, chunk=16,
                                              **kw)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       **TOL["float32"])


def test_window_none_and_large_window_agree_and_args_checked():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 20, 2, 1, 16, seed=7))
    pos = torch.arange(20)[None]
    a = fa.flash_attention(q, k, v, pos, scale=0.25, window=None)
    b = fa.flash_attention(q, k, v, pos, scale=0.25, window=fa.LARGE_WINDOW)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(torch.zeros(1, 20, 3, 16), torch.zeros(1, 20, 2, 16),
                           torch.zeros(1, 20, 2, 16), pos, scale=1.0)
    with pytest.raises(ValueError, match="Sq == Skv"):
        fa.flash_attention(q, k[:, :10], v[:, :10], pos, scale=1.0)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, pos, scale=1.0, window=0)
    with pytest.raises(ValueError, match="q_pos"):
        fa.flash_attention(q, k, v, pos[:, :5], scale=1.0)


@pytest.mark.parametrize("window", [1, 7, 4096, fa.LARGE_WINDOW - 1])
def test_non_causal_call_refuses_a_window(window):
    """A non-causal call with a finite window raises on the plain path
    (and so on every CPU tensor); LARGE_WINDOW and None still run and give
    the unwindowed result."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 20, 4, 2, 16, seed=9))
    pos = torch.arange(20).expand(2, 20)
    with pytest.raises(ValueError, match="non-causal"):
        fa.flash_attention(q, k, v, pos, scale=0.25, causal=False,
                           window=window)
    with pytest.raises(ValueError, match="non-causal"):
        fa.flash_attention_plain(q, k, v, pos, scale=0.25, causal=False,
                                 window=window)
    a = fa.flash_attention(q, k, v, pos, scale=0.25, causal=False,
                           window=None)
    b = fa.flash_attention(q, k, v, pos, scale=0.25, causal=False,
                           window=fa.LARGE_WINDOW)
    assert torch.equal(a, b)
    want = attention.online_attention(q, k, v, pos, None, causal=False,
                                      window=None, scale=0.25,
                                      logit_cap=None, chunk=16)
    np.testing.assert_allclose(a.numpy(), want.numpy(), **TOL["float32"])


# ------------------------------------------------------------ model level
def _pair(arch, window=None):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    if window is not None:
        ref_cfg = dataclasses.replace(ref_cfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def _spy(monkeypatch):
    calls = []
    real = attention.flash_attention

    def spy(q, k, v, q_pos, **kw):
        calls.append((tuple(q.shape), kw["window"], kw["softcap"],
                      kw["scale"]))
        return real(q, k, v, q_pos, **kw)
    monkeypatch.setattr(attention, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-9b"])
def test_prefill_runs_flash_attention_and_matches_jax(arch, monkeypatch):
    """Prefill logits against the JAX ``Model`` (gemma with a 24-token
    window on its local layer, shorter than the 45-token prompt); every
    layer's prefill attention went through ``flash_attention`` with the
    layer's window, the config's softcap and query scale."""
    ref_model, ref_params, model, params = _pair(
        arch, window=24 if arch == "gemma2-9b" else None)
    tokens = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (2, 45)).astype(np.int32)
    want, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    calls = _spy(monkeypatch)
    got, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    cfg = model.cfg
    assert len(calls) == cfg.n_layers
    if arch == "gemma2-9b":
        assert [c[1] for c in calls] == [24, attention.LARGE_WINDOW]
        assert {c[2] for c in calls} == {50.0}
        assert {c[3] for c in calls} == {cfg.query_pre_attn_scalar ** -0.5}
    else:
        assert {c[1:3] for c in calls} == {(None, None)}


def test_gemma_swapped_equals_unswapped(tmp_path, monkeypatch):
    """Within the port, gemma2-9b (reduced, window 24 < S) swapped on
    mmap equals the in-memory forward bitwise, each pass running the
    prefill kernel once per layer."""
    _, _, model, params = _pair("gemma2-9b", window=24)
    tokens = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (2, 45)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    calls = _spy(monkeypatch)
    sm = SwappedModel(model, params, str(tmp_path), device="cpu")
    try:
        sm.partition(6 * 1024 * 1024, DelayModel(), 2, 45)
        assert sm.plan.n_blocks >= 2
        logits, _ = sm.forward(batch)
        n_swapped = len(calls)
        direct = sm.forward_unswapped(batch)
    finally:
        sm.close()
    assert torch.equal(logits, direct)
    assert n_swapped == len(calls) - n_swapped == model.cfg.n_layers
