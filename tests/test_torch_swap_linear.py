"""swap_linear (the full-precision weight-streaming matmul) in the port
against the JAX package: the Pallas kernel in interpret mode (blocks of
128, as tests/test_kernels.py runs it) and its oracle ``swap_linear_ref``,
on the same numpy inputs.

Tolerances, with their reasons:
  * float32: rtol = atol = 1e-5 (fp32 accumulation on both sides; the
    sums run in another order);
  * bf16 inputs: 2e-2 (one bf16 rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as kref  # noqa: E402
from repro.kernels.swap_linear import swap_linear as ref_swap_linear  # noqa: E402
from repro_torch.core.runtime import kernel_smem_working_set  # noqa: E402
from repro_torch.kernels import swap_linear as sl  # noqa: E402
from repro_torch.kernels.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (M, K, N): ragged in every extent against the 128 blocks and the port's
# tiles, a single row (decode), and one even shape
SHAPES = [(3, 129, 67), (130, 200, 150), (1, 7, 3), (128, 256, 128)]


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return x, w, b


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_oracle(dtype, act):
    for i, (M, K, N) in enumerate(SHAPES):
        x, w, b = _inputs(M, K, N, seed=i)
        jx, jw, jb = (jnp.asarray(a).astype(JNP[dtype]) for a in (x, w, b))
        tx, tw, tb = (torch.from_numpy(a).to(TORCH[dtype]) for a in (x, w, b))
        got = sl.swap_linear(tx, tw, tb, act=act)
        assert got.dtype == TORCH[dtype] and tuple(got.shape) == (M, N)
        got = got.float().numpy()
        pallas = ref_swap_linear(jx, jw, jb, act=act, block_m=128,
                                 block_n=128, block_k=128, interpret=True)
        oracle = kref.swap_linear_ref(jx, jw, jb, act=act)
        np.testing.assert_allclose(got, _f32(pallas), **TOL[dtype])
        np.testing.assert_allclose(got, _f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_without_bias_matches_oracle(dtype):
    for i, (M, K, N) in enumerate(SHAPES):
        x, w, _ = _inputs(M, K, N, seed=10 + i)
        jx, jw = (jnp.asarray(a).astype(JNP[dtype]) for a in (x, w))
        got = sl.swap_linear(torch.from_numpy(x).to(TORCH[dtype]),
                             torch.from_numpy(w).to(TORCH[dtype]), act="silu")
        np.testing.assert_allclose(
            got.float().numpy(),
            _f32(ref_swap_linear(jx, jw, None, act="silu", block_m=128,
                                 block_n=128, block_k=128, interpret=True)),
            **TOL[dtype])
        np.testing.assert_allclose(
            got.float().numpy(),
            _f32(kref.swap_linear_ref(jx, jw, None, act="silu")),
            **TOL[dtype])


def test_fp32_plain_is_the_plain_matmul():
    """On the CPU the fp32 path is bitwise ``x @ w + b``: the fp32 upcast
    is a no-op, so the routing changed no fp32 result of the port."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(130, 200, 150, seed=3))
    assert torch.equal(sl.swap_linear(x, w, b), x @ w + b)
    assert torch.equal(sl.swap_linear(x, w), x @ w)


def test_bad_arguments_raise():
    x, w, b = (torch.from_numpy(a) for a in _inputs(4, 8, 5, seed=4))
    with pytest.raises(ValueError, match="rows"):
        sl.swap_linear(x, w[:7])
    with pytest.raises(ValueError, match="bias"):
        sl.swap_linear(x, w, b[:4])
    with pytest.raises(ValueError, match="act"):
        sl.swap_linear(x, w, act="relu")
    with pytest.raises(ValueError, match="2-D"):
        sl.swap_linear(x[None], w)


def test_smem_bytes_ordering_and_weight_stream():
    """Mirrors tests/test_fused_quant.py's VMEM ordering on the port's
    shared-memory figures: the fp block holds at least what the int8 one
    holds (bf16: the int8 ring plus the tiles it is widened into), which
    holds more than the int4 one; all fit the 227 KB a block may use."""
    for dt in ("bfloat16", "float32"):
        fp, i8, i4 = (kernel_smem_working_set(p, dt)
                      for p in ("fp", "int8", "int4"))
        assert fp >= i8 > i4 > 0
        assert fp <= 227 * 1024
    assert kernel_smem_working_set("fp", "bfloat16") == sl.smem_bytes(2)
    assert kernel_smem_working_set("fp", "float32") == sl.smem_bytes(4)
    # one weight read per row tile of x (bf16: 64 rows, 128 once those
    # tiles fill the card; fp32: 8 for M <= 8, else 64), ragged rows
    # included
    assert sl.weight_stream_bytes(1, 2048, 256) == 2048 * 256 * 2
    assert sl.weight_stream_bytes(64, 2048, 256) == 2048 * 256 * 2
    assert sl.weight_stream_bytes(128, 2048, 256) == 2 * 2048 * 256 * 2
    assert sl.weight_stream_bytes(65, 2048, 256, 4) == 2 * 2048 * 256 * 4
    assert (sl.weight_stream_bytes(4200, 3584, 14336)
            == 33 * 3584 * 14336 * 2)


def test_linear_sends_plain_weights_through_swap_linear(monkeypatch):
    """A plain-tensor weight goes through ``swap_linear`` with the leading
    axes of x flattened (and restored after); a quantized one does not."""
    calls = []
    real = layers.swap_linear

    def spy(x2d, w, b=None, *, act="none"):
        calls.append((tuple(x2d.shape), tuple(w.shape), b is not None, act))
        return real(x2d, w, b, act=act)
    monkeypatch.setattr(layers, "swap_linear", spy)
    x, w, b = (torch.from_numpy(a) for a in _inputs(6, 16, 12, seed=5))
    x3 = x.reshape(2, 3, 16)
    y = layers.linear(x3, w, b, act="gelu")
    assert calls == [((6, 16), (16, 12), True, "gelu")]
    assert tuple(y.shape) == (2, 3, 12)
    assert torch.equal(y.reshape(6, 12),
                       sl.swap_linear_plain(x, w, b, act="gelu"))
    from repro_torch.kernels.dequant import quantize_int8
    q, s = quantize_int8(w.numpy())
    qt = QuantizedTensor(torch.from_numpy(q), torch.from_numpy(s),
                         tuple(w.shape), "float32", bits=8)
    layers.linear(x3, qt)
    assert len(calls) == 1
