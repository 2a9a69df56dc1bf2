"""swap_linear: the full-precision weight-streaming matmul.

``y = act(x @ w + b)`` with an fp32 accumulator, bias and the silu /
tanh-gelu activation applied once at the flush, in fp32: the function of
the JAX package's ``kernels/swap_linear.py``, whose oracle is
``kernels/ref.py:swap_linear_ref``. It carries every full-precision
:func:`repro_torch.models.layers.linear` of the port; quantized weights
take ``swap_linear_q`` (the same core, the weight widened in the k-loop).

The CUDA kernel is ``csrc/swap_linear.cu`` over the shared core of
``csrc/sm90_gemm.cuh``: bf16 on the tensor cores (``wgmma`` fed by a TMA
ring), fp32 on the CUDA cores in fp32 (a ``cp.async`` ring, the row tile
sized to M). K is split where the output tiles alone leave SMs idle, by a
count that depends on (N, K, dtype) only (``kernels/gemm_plan.py``), so
row i of an M-row call equals the 1-row call on that row bitwise; ragged
or misaligned shapes take masked plain loads into the same tiles.
:func:`swap_linear_plain` is the plain PyTorch version,
``swap_linear_ref``'s arithmetic: it is what a CPU tensor runs, and what
the kernel is held to on the card: about 1e-5 relative for fp32 (the sums
run in another order), about 2e-2 for bf16 x (one bf16 rounding of the
output).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import gemm_plan
from repro_torch.kernels._build import LaunchCounter, check, library
from repro_torch.kernels.swap_linear_q import (ACTS, X_DTYPES, activation,
                                               bias_arg, data_ptr,
                                               launch_plan)

launches = LaunchCounter()
_DTYPE_NAMES = {2: ("bfloat16", "bf16"), 4: ("float32", "fp32")}


def smem_bytes(itemsize: int = 2) -> int:
    """Shared memory one block of the kernel holds (the Hopper counterpart
    of the reference's ``vmem_bytes``): for bf16 the TMA ring's 4 stages of
    x and w tiles, for fp32 the larger of the CUDA-core rings."""
    if itemsize == 2:
        return gemm_plan.smem_bytes("wgmma", "bf16", gemm_plan.TC_BLOCK_M)
    return max(gemm_plan.smem_bytes("simt", "fp32", bm)
               for bm in gemm_plan.SIMT_TILES)


def weight_stream_bytes(M: int, K: int, N: int, w_itemsize: int = 2) -> int:
    """Device-memory weight traffic of one call: every weight tile is read
    once per row tile of x (bf16: 64 rows, 128 once such tiles fill the
    card; fp32: 8 or 64), so one row tile streams ``K * N * w_itemsize``
    bytes (the L2 cache may serve some of the re-reads)."""
    x_dtype, weight = _DTYPE_NAMES[w_itemsize]
    return gemm_plan.weight_stream_bytes(M, K, N, x_dtype, weight)


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
    if b is not None and b.device != x.device:
        raise ValueError(f"bias on {b.device}, x on {x.device}")
    bias, bias_dtype = bias_arg(b)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p, scratch, counters = launch_plan(
        x, w, "bf16" if x.dtype == torch.bfloat16 else "fp32")
    err = library().repro_swap_linear(
        x.data_ptr(), w.data_ptr(), data_ptr(bias), out.data_ptr(),
        data_ptr(scratch), data_ptr(counters), M, N, K,
        X_DTYPES[x.dtype], ACTS[act], bias_dtype,
        p.splits, p.block_m, p.combine_code, p.route_code,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "swap_linear kernel launch")
    launches.bump((M, K, N, str(x.dtype).replace("torch.", ""), act))
    return out
