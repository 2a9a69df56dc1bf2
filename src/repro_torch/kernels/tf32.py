"""Three-pass TF32 on the CPU: a plain-torch model of the arithmetic of the
fp32 routes of ``swap_linear`` and ``flash_attention`` on the tensor cores.

No main path calls this module. It states, where a test can run it, what
the kernels do with an fp32 operand (``csrc/sm90_common.cuh``:
``split_tf32`` and ``mma_3xtf32``): each value is split as
``hi = round_tf32(x)``, ``lo = round_tf32(x - hi)`` (the subtraction is
exact in fp32), and every k8 step sums ``hi lo``, then ``lo hi``, then
``hi hi`` from zero on the tensor cores and adds that partial to an fp32
accumulator with one rounded fp32 add. The model takes a k8 step's
products exactly (two 11-bit significands), rounds their sum to fp32 and
adds it to the accumulator, rounding to nearest; how the tensor cores
round inside the partial (relative to the partial, never to the running
sum) is not modelled.

What it shows: three passes stay within 1e-5 of float64 (relative to the
largest output) at the main paths' K, where one pass (``hi hi`` alone, or
raw fp32 bits read as TF32) does not: the reason the fp32 routes take
three.
"""
from __future__ import annotations

import torch

_HALF_ULP = 0x1000           # half of the 13 dropped mantissa bits' unit
_KEEP = -0x2000              # 0xFFFFE000: sign, exponent, 10 mantissa bits
_EXP = 0x7F800000
K_STEP = 8                   # mma.sync.m16n8k8's k


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with 10 mantissa bits, ties away from zero, the result
    an fp32 whose low 13 bits are zero. Subnormals round at the same bit;
    inf and NaN pass through; a value that rounds past the largest TF32
    becomes inf."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    r = (b + _HALF_ULP) & _KEEP      # sign-magnitude: away from zero
    return torch.where((b & _EXP) == _EXP, b, r).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple:
    """(hi, lo): ``hi = round_tf32(x)``, ``lo = round_tf32(x - hi)``."""
    x = x.to(torch.float32)
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor,
                  passes: int = 3) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` in fp32 as the kernels compute it: K cut
    into k8 steps (zero-padded), and at each step the passes' exact sum,
    rounded to fp32, added to an fp32 accumulator. ``passes`` 3: ``hi
    lo``, ``lo hi``, ``hi hi``; 1: ``hi hi`` alone (one TF32 pass)."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    M, K = a.shape
    N = b.shape[1]
    pad = -K % K_STEP
    a = torch.nn.functional.pad(a.to(torch.float32), (0, pad))
    b = torch.nn.functional.pad(b.to(torch.float32), (0, 0, 0, pad))
    S = (K + pad) // K_STEP
    ah, al = (t.double().reshape(M, S, K_STEP) for t in split_tf32(a))
    bh, bl = (t.double().reshape(S, K_STEP, N) for t in split_tf32(b))
    terms = [(ah, bh)] if passes == 1 else [(ah, bl), (al, bh), (ah, bh)]
    # a k8 step's partial: products of 11-bit significands and their sum
    # of 24 are exact in float64 (to far below fp32's unit)
    part = sum(torch.einsum("msk,skn->smn", x, y) for x, y in terms).float()
    acc = torch.zeros((M, N), dtype=torch.float32)
    for s in range(S):
        acc = acc + part[s]
    return acc
