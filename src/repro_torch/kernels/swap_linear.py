"""swap_linear: the full-precision weight-streaming matmul.

``y = act(x @ w + b)`` with an fp32 accumulator, bias and the silu /
tanh-gelu activation applied once at the flush, in fp32: the function of
the JAX package's ``kernels/swap_linear.py``, whose oracle is
``kernels/ref.py:swap_linear_ref``. It carries every full-precision
:func:`repro_torch.models.layers.linear` of the port; quantized weights
take ``swap_linear_q`` (same tiling, dequant in the k-loop).

The CUDA kernel is ``csrc/swap_linear.cu`` (one 64x64 output tile per
block, k-steps of 32, x and w tiles staged in shared memory in the input
dtype, fp32 accumulators in registers; ragged M, N and K masked in the
kernel, no padded copies; no split-K and no atomics, and one tile shape
for every M, so row i of an M-row call equals the 1-row call on that row
bitwise). :func:`swap_linear_plain` is the plain PyTorch version,
``swap_linear_ref``'s arithmetic: it is what a CPU tensor runs, and what
the kernel is held to on the card: about 1e-5 relative for fp32 (the sums
run in another order), about 2e-2 for bf16 x (one bf16 rounding of the
output).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCounter, check, library
from repro_torch.kernels.swap_linear_q import ACTS, X_DTYPES, activation

# tile config of csrc/swap_linear.cu (BM, BN, BK there)
BLOCK_M, BLOCK_N, BLOCK_K = 64, 64, 32

launches = LaunchCounter()


def smem_bytes(itemsize: int = 2) -> int:
    """Shared memory one block of the kernel holds: the x tile and the w
    tile in the input dtype (the Hopper counterpart of the reference's
    ``vmem_bytes``: one buffer, no double buffering yet)."""
    return (BLOCK_M * BLOCK_K + BLOCK_K * BLOCK_N) * itemsize


def weight_stream_bytes(M: int, K: int, N: int, w_itemsize: int = 2) -> int:
    """Device-memory weight traffic of one call at the kernel's tiles:
    every (BLOCK_K, BLOCK_N) weight tile is read once per BLOCK_M-row block
    of x, and the masked edge reads nothing, so the stream moves
    ``ceil(M / BLOCK_M) * K * N * w_itemsize`` bytes (the L2 cache may
    serve some of them)."""
    return -(-M // BLOCK_M) * K * N * w_itemsize


def _check_shapes(x, w, b, act: str):
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x and w must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    M, K = x.shape
    if w.shape[0] != K:
        raise ValueError(f"w {tuple(w.shape)} does not hold K={K} rows")
    N = w.shape[1]
    if b is not None and tuple(b.shape) != (N,):
        raise ValueError(f"bias {tuple(b.shape)} != ({N},)")
    return M, K, N


def swap_linear_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None, *,
                      act: str = "none") -> torch.Tensor:
    """Plain PyTorch version: fp32 matmul, bias, activation, then the
    result in x's dtype."""
    _check_shapes(x, w, b, act)
    r = x.to(torch.float32) @ w.to(torch.float32)
    if b is not None:
        r = r + b.to(torch.float32)
    return activation(r, act).to(x.dtype)


def swap_linear(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *,
                act: str = "none") -> torch.Tensor:
    """x [M, K], w [K, N]; b [N] or None -> [M, N] in x's dtype.

    A CUDA tensor launches the kernel (x and w both fp32 or both bf16) or
    raises; a CPU tensor takes :func:`swap_linear_plain`."""
    M, K, N = _check_shapes(x, w, b, act)
    if x.device.type == "cpu":
        return swap_linear_plain(x, w, b, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"swap_linear: unsupported device {x.device}")
    if x.dtype not in X_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"swap_linear takes x and w of one dtype, fp32 or "
                        f"bf16; got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError("x and w lie on different devices")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("swap_linear takes contiguous x and w")
    bias = None
    if b is not None:
        if b.device != x.device:
            raise ValueError(f"bias on {b.device}, x on {x.device}")
        bias = b.to(torch.float32).contiguous()   # exact for bf16 and fp32
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = library().repro_swap_linear(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), M, N, K, X_DTYPES[x.dtype], ACTS[act],
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "swap_linear kernel launch")
    launches.bump((M, K, N, str(x.dtype).replace("torch.", ""), act))
    return out
