"""Quantizers and the plain versions of the two kernels against the JAX
package (the kernels themselves are held to these plain versions on a GPU
by tests/test_torch_cuda.py).

Tolerances, with their reasons:
  * host quantizers, int4 pack/unpack: byte-identical (same numpy code);
  * dequant (int8, int4): bitwise, one fp32 multiply per element on both
    sides (bf16 output: the same round-to-nearest-even of that product);
  * swap_linear_q, fp32 x: 1e-5 (the fp32 sums run in another order);
  * swap_linear_q, bf16 x: 2e-2 (one bf16 rounding of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import dequant as ref_dq  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.kernels.swap_linear_q import swap_linear_q as ref_swap_linear_q  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import dequant as dq  # noqa: E402
from repro_torch.kernels.qtensor import (QuantizedTensor,  # noqa: E402
                                         cast_unit_params, materialize_tree)
from repro_torch.kernels.swap_linear_q import smem_bytes, swap_linear_q  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _jnp_dtype(name):
    return jnp.float32 if name == "float32" else jnp.bfloat16


def _torch_dtype(name):
    return torch.float32 if name == "float32" else torch.bfloat16


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ quantizers
@pytest.mark.parametrize("shape", [(7, 5), (64, 32), (3, 4, 6), (1, 9)])
def test_host_quantizers_byte_identical(shape):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    x[..., 0] = 0.0                           # a zero channel: scale 1.0
    for ours, theirs in ((dq.quantize_int8, ref_dq.quantize_int8),
                         (dq.quantize_int4, ref_dq.quantize_int4)):
        q1, s1 = ours(x)
        q2, s2 = theirs(x)
        assert q1.dtype == q2.dtype and s1.dtype == s2.dtype
        assert q1.tobytes() == q2.tobytes() and s1.tobytes() == s2.tobytes()


@pytest.mark.parametrize("R", [1, 2, 7, 64])
def test_pack_unpack_int4_byte_identical(R):
    rng = np.random.default_rng(3)
    q = rng.integers(-7, 8, (R, 5)).astype(np.int8)
    packed = dq.pack_int4(q)
    assert packed.tobytes() == ref_dq.pack_int4(q).tobytes()
    assert (dq.unpack_int4(packed, R).tobytes()
            == ref_dq.unpack_int4(packed, R).tobytes())
    np.testing.assert_array_equal(
        dq.unpack_int4_tensor(torch.from_numpy(packed), R).numpy(), q)


# ------------------------------------------------------------ dequant
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_plain_matches_pallas_interpret(bits, out):
    """Ragged R (300 rows against the 256-row Pallas blocks)."""
    rng = np.random.default_rng(5)
    R, C = 300, 70
    w = rng.standard_normal((R, C)).astype(np.float32)
    q, s = (dq.quantize_int8 if bits == 8 else dq.quantize_int4)(w)
    vals = jnp.asarray(q)
    if bits == 4:
        vals = ref_oracles.unpack_int4_ref(vals, R)
    want = ref_dq.dequant_int8(vals, jnp.asarray(s), _jnp_dtype(out),
                               interpret=True)
    got = dq.dequant_int8(torch.from_numpy(q), torch.from_numpy(s),
                          _torch_dtype(out), bits=bits, rows=R)
    assert got.dtype == _torch_dtype(out) and tuple(got.shape) == (R, C)
    np.testing.assert_array_equal(_np32(got), _np32(want))


def test_dequant_rejects_bad_rows():
    q = torch.zeros((3, 4), dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(ValueError):
        dq.dequant_int8(q, s, bits=4, rows=7)
    with pytest.raises(ValueError):
        dq.dequant_int8(q, s, bits=8, rows=2)


# ------------------------------------------------------------ swap_linear_q
def _case(bits, M, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    wf = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    qw, s = (dq.quantize_int8 if bits == 8 else dq.quantize_int4)(wf)
    x = rng.normal(0, 0.5, (M, K)).astype(np.float32)
    b = rng.normal(0, 0.1, (N,)).astype(np.float32)
    jx = jnp.asarray(x, _jnp_dtype(dtype))
    jb = jnp.asarray(b, _jnp_dtype(dtype))
    tx = params_from_jax(np.asarray(jx))
    tb = params_from_jax(np.asarray(jb))
    return jx, jb, tx, tb, qw, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
@pytest.mark.parametrize("bits", [8, 4])
def test_swap_linear_q_plain_matches_pallas(bits, act, dtype):
    """Ragged M/K/N against 64-wide Pallas blocks."""
    M, K, N = 50, 130, 70
    jx, jb, tx, tb, qw, s = _case(bits, M, K, N, dtype)
    got = swap_linear_q(tx, torch.from_numpy(qw), torch.from_numpy(s), tb,
                        bits=bits, act=act)
    assert got.dtype == _torch_dtype(dtype) and tuple(got.shape) == (M, N)
    want = ref_swap_linear_q(jx, jnp.asarray(qw), jnp.asarray(s), jb,
                             bits=bits, act=act, block_m=64, block_n=64,
                             block_k=64, interpret=True)
    np.testing.assert_allclose(_np32(got), _np32(want), **TOL[dtype])
    oracle = ref_oracles.swap_linear_q_ref(jx, jnp.asarray(qw), jnp.asarray(s),
                                           jb, act=act, bits=bits)
    np.testing.assert_allclose(_np32(got), _np32(oracle), **TOL[dtype])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(3, 129, 67), (1, 7, 3), (2, 2048, 5)])
def test_swap_linear_q_plain_odd_shapes(bits, M, K, N):
    jx, jb, tx, tb, qw, s = _case(bits, M, K, N, "float32", seed=M + K)
    got = swap_linear_q(tx, torch.from_numpy(qw), torch.from_numpy(s), None,
                        bits=bits, act="gelu")
    want = ref_oracles.swap_linear_q_ref(jx, jnp.asarray(qw), jnp.asarray(s),
                                         None, act="gelu", bits=bits)
    np.testing.assert_allclose(_np32(got), _np32(want), **TOL["float32"])


def test_swap_linear_q_rejects_bad_shapes():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        swap_linear_q(x, torch.zeros((8, 3), dtype=torch.int8), torch.ones(3),
                      bits=4)
    with pytest.raises(ValueError):
        swap_linear_q(x, torch.zeros((8, 3), dtype=torch.int8), torch.ones(4))
    with pytest.raises(ValueError):
        swap_linear_q(x, torch.zeros((8, 3), dtype=torch.int8), torch.ones(3),
                      act="relu")


def test_smem_bytes_shrinks_with_bits():
    for x_itemsize in (2, 4):
        assert smem_bytes(8, x_itemsize) > smem_bytes(4, x_itemsize) > 0
        assert smem_bytes(8, x_itemsize) <= 227 * 1024


# ------------------------------------------------------------ QuantizedTensor
def test_cast_unit_params_keeps_fused_weights_quantized():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    q, s = dq.quantize_int8(w)
    qt = QuantizedTensor(torch.from_numpy(q), torch.from_numpy(s), (16, 8),
                         "float32", 8)
    conv = QuantizedTensor(torch.from_numpy(q), torch.from_numpy(s), (16, 8),
                           "float32", 8)
    unit = {"ffn": {"wo": qt}, "conv": conv, "ln": torch.ones(8)}
    out = cast_unit_params(unit, torch.bfloat16)
    assert out["ffn"]["wo"] is qt
    assert out["conv"].dtype == torch.bfloat16
    assert out["ln"].dtype == torch.bfloat16
    full = materialize_tree(unit)
    np.testing.assert_array_equal(
        full["conv"].numpy(), q.astype(np.float32) * s[None, :])
