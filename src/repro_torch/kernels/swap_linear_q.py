"""swap_linear_q: fused dequant-matmul over a quantized-resident weight.

``y = act(x @ (qw * scales) + b)`` with the weight kept int8 (or int4,
packed two rows per carrier byte) in device memory: each weight tile is
sign-extended inside the k-loop of the kernel, the per-channel scale is
applied ONCE to the fp32 accumulator at the flush (it factors out of the
k-sum), and bias and the silu / tanh-gelu activation ride the same flush.
fp for the weight never exists in device memory.

The CUDA kernel is ``csrc/swap_linear_q.cu`` over the shared core of
``csrc/sm90_gemm.cuh``: bf16 x on the tensor cores (TMA brings the
quantized tile, which is widened to bf16 in shared memory for ``wgmma``),
fp32 x on the CUDA cores in fp32 (the tile widened in registers). K is
split by a count that depends on (N, K, dtype) only
(``kernels/gemm_plan.py``), so rows do not depend on M; ragged or
misaligned shapes take masked plain loads into the same tiles.
:func:`swap_linear_q_plain` is the plain PyTorch version: unpack,
dequantize the whole weight, fp32 matmul, epilogue. It is what a CPU tensor
runs, and what the kernel is held to on the card: about 1e-5 relative for
fp32 x (accumulation order: the kernel scales once at the flush), about
2e-2 for bf16 x (one bf16 rounding of the output).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import gemm_plan
from repro_torch.kernels._build import (LaunchCounter, check, library,
                                        refuse_grad)
from repro_torch.kernels.dequant import unpack_int4_tensor

ACTS = {"none": 0, "silu": 1, "gelu": 2}
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_X_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

launches = LaunchCounter()


def smem_bytes(bits: int = 8, x_itemsize: int = 2) -> int:
    """Shared memory one block of the kernel holds: the stages of x tiles
    and still-quantized weight tiles (half the carrier rows at int4), plus,
    for bf16 x, the two bf16 tiles the weight is widened into; for fp32 x
    the larger of the CUDA-core rings."""
    weight = f"int{bits}"
    if x_itemsize == 2:
        return gemm_plan.smem_bytes("wgmma", weight, gemm_plan.TC_BLOCK_M)
    return max(gemm_plan.smem_bytes("simt", weight, bm)
               for bm in gemm_plan.SIMT_TILES)


def bias_arg(b: Optional[torch.Tensor]):
    """The bias as the kernels read it, and its dtype code: fp32 and bf16
    as they are (the kernel widens bf16 exactly), anything else cast to
    fp32."""
    if b is None:
        return None, 0
    if b.dtype not in X_DTYPES:
        b = b.to(torch.float32)
    return b.contiguous(), X_DTYPES[b.dtype]


# (device, stream) -> the per-tile arrival counts of the "blocks" combine
_TILE_COUNTERS: dict = {}


def launch_plan(x: torch.Tensor, w: torch.Tensor, weight: str):
    """The kernel's launch plan for x [M, K] times w (``weight`` "bf16",
    "fp32", "int8" or "int4"), and the buffers its combine needs (None
    where it needs none): fp32 scratch for the partial sums of the
    "blocks" and "pass" combines, from ``torch.empty`` per call, and the
    per-tile arrival counts of "blocks". Those are zero between calls (the
    last block of each tile resets its count), so one buffer serves every
    call on a stream, whose calls run in order."""
    M, K = x.shape
    p = gemm_plan.plan(M, w.shape[1], K, _X_NAMES[x.dtype], weight,
                       x.data_ptr(), w.data_ptr())
    if not p.scratch_bytes:
        return p, None, None
    scratch = torch.empty(p.scratch_bytes // 4, dtype=torch.float32,
                          device=x.device)
    if p.combine != "blocks":
        return p, scratch, None
    key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
    counters = _TILE_COUNTERS.get(key)
    if counters is None:
        counters = _TILE_COUNTERS[key] = torch.zeros(
            gemm_plan.NUM_SMS, dtype=torch.int32, device=x.device)
    return p, scratch, counters


def data_ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def activation(r: torch.Tensor, act: str) -> torch.Tensor:
    """The epilogue's activation: silu (``r * sigmoid(r)``) or tanh-gelu."""
    if act == "silu":
        return r * torch.sigmoid(r)
    if act == "gelu":
        return F.gelu(r, approximate="tanh")
    return r


def _check_shapes(x, qw, scales, bits: int, act: str):
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if x.ndim != 2 or qw.ndim != 2:
        raise ValueError(f"x and qw must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(qw.shape)}")
    M, K = x.shape
    Kq, N = qw.shape
    if Kq != -(-K // (2 if bits == 4 else 1)):
        raise ValueError(f"qw {tuple(qw.shape)} does not hold K={K} rows "
                         f"at {bits} bits")
    if tuple(scales.shape) != (N,):
        raise ValueError(f"scales {tuple(scales.shape)} != ({N},)")
    return M, K, N


def swap_linear_q_plain(x: torch.Tensor, qw: torch.Tensor,
                        scales: torch.Tensor, b: Optional[torch.Tensor] = None,
                        *, bits: int = 8, act: str = "none") -> torch.Tensor:
    """Plain PyTorch version: dequantize the whole weight, fp32 matmul,
    then the epilogue; the result in x's dtype."""
    _, K, _ = _check_shapes(x, qw, scales, bits, act)
    vals = unpack_int4_tensor(qw, K) if bits == 4 else qw
    w = vals.to(torch.float32) * scales.to(torch.float32)[None, :]
    r = x.to(torch.float32) @ w
    if b is not None:
        r = r + b.to(torch.float32)
    return activation(r, act).to(x.dtype)


def swap_linear_q(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *, bits: int = 8,
                  act: str = "none") -> torch.Tensor:
    """x [M, K]; qw [K, N] int8 (``bits=8``) or the [ceil(K/2), N] carrier
    (``bits=4``); scales [N] fp32; b [N] or None -> [M, N] in x's dtype.

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    :func:`swap_linear_q_plain`."""
    M, K, N = _check_shapes(x, qw, scales, bits, act)
    if x.device.type == "cpu":
        return swap_linear_q_plain(x, qw, scales, b, bits=bits, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"swap_linear_q: unsupported device {x.device}")
    refuse_grad("swap_linear_q", x, scales, b)
    if x.dtype not in X_DTYPES:
        raise TypeError(f"swap_linear_q takes fp32 or bf16 x, got {x.dtype}")
    if qw.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"swap_linear_q takes an int8 weight and fp32 "
                        f"scales, got {qw.dtype} and {scales.dtype}")
    if qw.device != x.device or scales.device != x.device:
        raise ValueError("x, qw and scales lie on different devices")
    if not (x.is_contiguous() and qw.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("swap_linear_q takes contiguous x, qw and scales")
    if b is not None and (tuple(b.shape) != (N,) or b.device != x.device):
        raise ValueError(f"bias {tuple(b.shape)} on {b.device} does not "
                         f"match ({N},) on {x.device}")
    bias, bias_dtype = bias_arg(b)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p, scratch, counters = launch_plan(x, qw, f"int{bits}")
    err = library().repro_swap_linear_q(
        x.data_ptr(), qw.data_ptr(), scales.data_ptr(), data_ptr(bias),
        out.data_ptr(), data_ptr(scratch), data_ptr(counters),
        M, N, K, X_DTYPES[x.dtype], bits, ACTS[act],
        bias_dtype, p.splits, p.block_m, p.combine_code, p.route_code,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "swap_linear_q kernel launch")
    launches.bump((M, K, N, bits, str(x.dtype).replace("torch.", ""), act))
    return out
