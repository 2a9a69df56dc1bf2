"""swap_linear: the full-precision weight-streaming matmul.

``y = act(x @ w + b)`` with an fp32 accumulator, bias and the silu /
tanh-gelu activation applied once at the flush, in fp32: the function of
the JAX package's ``kernels/swap_linear.py``, whose oracle is
``kernels/ref.py:swap_linear_ref``. It carries every full-precision
:func:`repro_torch.models.layers.linear` of the port; quantized weights
take ``swap_linear_q`` (the same core, the weight widened in the k-loop).

The CUDA kernel is ``csrc/swap_linear.cu`` over the shared core of
``csrc/sm90_gemm.cuh``: bf16 on the tensor cores (``wgmma`` fed by a TMA
ring), fp32 on the tensor cores in three-pass TF32 (``mma.sync`` fed by a
``cp.async`` ring, each operand split into TF32 hi and lo in registers,
``hi lo + lo hi + hi hi`` into fp32 accumulators, the row tile 16, 64 or
128).
K is split where the output tiles alone leave SMs idle, by a
count that depends on (N, K, dtype) only (``kernels/gemm_plan.py``), so
row i of an M-row call equals the 1-row call on that row bitwise; ragged
or misaligned shapes take masked plain loads into the same tiles. A
launch is counted under a key that ends with the plan's core ("wgmma" or
"tf32x3"), so a run shows which route each call took.
:func:`swap_linear_plain` is the plain PyTorch version,
``swap_linear_ref``'s arithmetic: it is what a CPU tensor runs, and what
the kernel is held to on the card: about 1e-5 relative for fp32 (the sums
run in another order, and three TF32 passes leave about 1e-6), about 2e-2
for bf16 x (one bf16 rounding of the output).

Training: where autograd records the call (grad mode on and x, w or b
requiring grad) :func:`swap_linear` runs through :class:`SwapLinearFn`,
whose forward is the same launch (the plain version on the CPU). The TPU
kernel has no ``custom_vjp``: the JAX package's gradient of ``x @ w + b``
is XLA's autodiff, two dot products. So the backward is not a kernel
either: it recomputes the pre-activation ``z = x @ w + b`` with one more
launch at ``act="none"`` where an activation was fused (the forward keeps
no [M, N] intermediate), takes ``dz = dy * act'(z)`` in fp32, and runs
``dx = dz @ w^T`` and ``dw = x^T @ dz`` as ``torch.matmul`` in x's dtype
(the reference's dot products), ``db = dz.sum(0)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import gemm_plan
from repro_torch.kernels._build import (LaunchCounter, check, library,
                                        needs_grad)
from repro_torch.kernels.swap_linear_q import (ACTS, X_DTYPES, activation,
                                               bias_arg, data_ptr,
                                               launch_plan)

launches = LaunchCounter()
_DTYPE_NAMES = {2: ("bfloat16", "bf16"), 4: ("float32", "fp32")}


def smem_bytes(itemsize: int = 2) -> int:
    """Shared memory one block of the kernel holds (the Hopper counterpart
    of the reference's ``vmem_bytes``): for bf16 the TMA ring's 4 stages of
    x and w tiles, for fp32 the TF32 core's ring at its larger row tile."""
    if itemsize == 2:
        return gemm_plan.smem_bytes("wgmma", "bf16", gemm_plan.TC_BLOCK_M)
    return gemm_plan.smem_bytes("tf32x3", "fp32",
                                max(gemm_plan.TF32_BLOCK_MS))


def weight_stream_bytes(M: int, K: int, N: int, w_itemsize: int = 2) -> int:
    """Device-memory weight traffic of one call: every weight tile is read
    once per row tile of x (bf16: 64 rows, 128 once such tiles fill the
    card; fp32: 16, 64 or 128), so one row tile streams ``K * N * w_itemsize``
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


def activation_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    """d act / dz at the fp32 pre-activation z, for the activations of
    ``swap_linear_q.activation``: silu ``z * sigmoid(z)`` and tanh-gelu
    ``0.5 z (1 + tanh(c (z + 0.044715 z^3)))``, c = sqrt(2 / pi)."""
    if act == "silu":
        s = torch.sigmoid(z)
        return s * (1.0 + z * (1.0 - s))
    if act == "gelu":
        c = (2.0 / torch.pi) ** 0.5
        t = torch.tanh(c * (z + 0.044715 * z * z * z))
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * c * (
            1.0 + 3 * 0.044715 * z * z)
    raise ValueError(f"no derivative for act {act!r}")


class SwapLinearFn(torch.autograd.Function):
    """:func:`swap_linear` under autograd: the forward is the kernel (the
    plain version on the CPU), the backward the reference's XLA autodiff in
    torch ops (module docstring)."""

    @staticmethod
    def forward(ctx, x, w, b, act):
        ctx.save_for_backward(x, w, b)
        ctx.act = act
        return _swap_linear(x, w, b, act)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dz = dy.to(torch.float32)
        if ctx.act != "none":
            z = _swap_linear(x, w, b, "none").to(torch.float32)
            dz = dz * activation_grad(z, ctx.act)
        dzx = dz.to(x.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dzx, w.t())
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.t(), dzx)
        if b is not None and ctx.needs_input_grad[2]:
            db = dz.sum(0).to(b.dtype)
        return dx, dw, db, None


def swap_linear(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *,
                act: str = "none") -> torch.Tensor:
    """x [M, K], w [K, N]; b [N] or None -> [M, N] in x's dtype.

    A CUDA tensor launches the kernel (x and w both fp32 or both bf16) or
    raises; a CPU tensor takes :func:`swap_linear_plain`. Where autograd
    records the call, it runs through :class:`SwapLinearFn`."""
    if needs_grad(x, w, b):
        return SwapLinearFn.apply(x, w, b, act)
    return _swap_linear(x, w, b, act)


def _swap_linear(x, w, b, act: str) -> torch.Tensor:
    """The launch (the plain version for a CPU tensor), outside autograd."""
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
    launches.bump((M, K, N, str(x.dtype).replace("torch.", ""), act, p.core))
    return out
