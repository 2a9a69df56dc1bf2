"""The arithmetic of the port's fp32 routes on the tensor cores, on the CPU.

``swap_linear`` (B5) and ``flash_attention`` (B4) run fp32 through
``mma.sync`` in three-pass TF32 (``csrc/sm90_common.cuh``: ``split_tf32``,
``mma_3xtf32``). ``kernels/tf32.py`` models that arithmetic in plain torch;
no card is needed to hold what the design rests on:

  * ``round_tf32`` gives ``cvt.rna.tf32.f32``'s bits: round to nearest,
    ties away from zero, at the 13th bit, subnormals at the same bit, the
    sign kept, inf and NaN passed through;
  * ``hi + lo`` of the split holds x to 22 significant bits, and lo is
    exactly representable in TF32;
  * three passes land within 1e-5 of the float64 product (relative to its
    largest value, chip_smoke.py's ``TOL["float32"]``) at the K of the
    main paths' linears (2,048 qwen, 2,560 rwkv6, 3,840 h2o-danube, 10,240
    its ffn wo), and one pass lands outside it: why the routes take three;
  * the module imports neither JAX nor the JAX package.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import tf32  # noqa: E402

TOL_FP32 = 1e-5            # chip_smoke.py's TOL["float32"]
MAIN_K = (2048, 2560, 3840, 10240)


def _f(bits):
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(
        torch.float32)


def _bits(x):
    return [int(b) & 0xFFFFFFFF for b in x.view(torch.int32).tolist()]


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),      # 1.0 is TF32
    (0x3F800FFF, 0x3F800000),      # below the tie: down
    (0x3F801000, 0x3F802000),      # 1 + 2^-11, a tie: away from zero
    (0x3F801001, 0x3F802000),      # above the tie: up
    (0x3F803000, 0x3F804000),      # a tie from an odd last bit: away too
    (0x3F7FF000, 0x3F800000),      # a carry into the exponent
    (0xBF801000, 0xBF802000),      # -(1 + 2^-11): away from zero, negative
    (0xBF800FFF, 0xBF800000),
    (0x80000000, 0x80000000),      # -0 keeps its sign
    (0x00000000, 0x00000000),
    (0x00000FFF, 0x00000000),      # a subnormal below the tie: 0
    (0x00001000, 0x00002000),      # a subnormal tie: away from zero
    (0x80001000, 0x80002000),      # its negative
    (0x007FF000, 0x00800000),      # the largest subnormals round up to normal
    (0x7F800000, 0x7F800000),      # inf
    (0xFF800000, 0xFF800000),      # -inf
    (0x7F7FF000, 0x7F800000),      # past the largest TF32: inf
])
def test_round_tf32_bits(bits, want):
    assert _bits(tf32.round_tf32(_f([bits]))) == [want]


def test_round_tf32_passes_nan_and_keeps_13_zero_bits():
    nan = tf32.round_tf32(_f([0x7FC00001, 0xFFC12345]))
    assert torch.isnan(nan).all()
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(10000)
                          * 10.0 ** rng.integers(-30, 30, 10000))
                         .astype(np.float32))
    r = tf32.round_tf32(x)
    assert all(b & 0x1FFF == 0 for b in _bits(r))
    # the nearest: within half a TF32 unit, and the sign kept
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 11)
    assert bool(((r - x).abs() <= ulp / 2).all())
    assert bool((torch.sign(r) == torch.sign(x)).all())


def test_split_holds_22_bits():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(20000)
                          * 2.0 ** rng.integers(-20, 21, 20000))
                         .astype(np.float32))
    hi, lo = tf32.split_tf32(x)
    assert torch.equal(tf32.round_tf32(hi), hi)
    assert torch.equal(tf32.round_tf32(lo), lo)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -21).all())
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("K", MAIN_K)
def test_three_passes_hold_fp32_parity_and_one_does_not(K):
    """x ~ 0.5 N(0, 1) and w ~ N(0, 1) / sqrt(K), as chip_smoke.py draws a
    linear's inputs, at M 16 (one m16 tile) and N 64."""
    rng = np.random.default_rng(K)
    x = torch.from_numpy((rng.standard_normal((16, K)) * 0.5)
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, 64)) * K ** -0.5)
                         .astype(np.float32))
    want = x.double() @ w.double()
    three = _rel(tf32.matmul_3xtf32(x, w), want)
    one = _rel(tf32.matmul_3xtf32(x, w, passes=1), want)
    assert three <= TOL_FP32 / 3, three
    assert one > TOL_FP32, one
    assert one > 30 * three


def test_three_passes_where_lo_matters():
    """Values spanning 2^-20 .. 2^20 in both operands, K not a multiple of
    8: the lo terms carry what hi drops at every magnitude."""
    rng = np.random.default_rng(7)
    K = 1001
    x = torch.from_numpy((rng.standard_normal((16, K))
                          * 2.0 ** rng.integers(-20, 21, (16, K)))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, 24))
                          * 2.0 ** rng.integers(-20, 21, (K, 24)))
                         .astype(np.float32))
    want = x.double() @ w.double()
    assert _rel(tf32.matmul_3xtf32(x, w), want) <= TOL_FP32 / 3
    assert _rel(tf32.matmul_3xtf32(x, w, passes=1), want) > TOL_FP32


def test_module_imports_no_jax():
    src = Path(tf32.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "torch"}
    assert "jax" not in src and "repro." not in src
