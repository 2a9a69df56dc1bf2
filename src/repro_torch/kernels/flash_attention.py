"""flash_attention: prefill self-attention with an online softmax.

The function of the JAX package's ``kernels/flash_attention.py`` (oracle
``kernels/ref.py:flash_attention_ref``) with the generality the port's
prefill needs: q [B, S, H, hd], k [B, S, KV, hd] and v [B, S, KV, dv] in
the projections' layout, grouped-query heads read in place (query head h
reads KV head ``h // (H / KV)``), explicit query positions and any S. The
value head dim ``dv`` may differ from the query-key one: deepseek-v2's
Multi-head Latent Attention scores at 192 (128 + a 64-wide RoPE part) and
reads values of 128, and the output is [B, S, H, dv]. The semantics are
those of :func:`repro_torch.models.attention.online_attention` with no
``kv_valid_len``, on the calls that function and the TPU kernel agree on:
key j (its index) attends to a query at position ``q_pos[b, i]`` iff,
when causal, ``j <= q_pos`` and ``q_pos - j < window``; a non-causal call
attends to every key. A score is ``q.k * scale``, then the softcap, then
the mask (the finite ``NEG_INF``). ``window=None`` and ``LARGE_WINDOW``
both mean no window. A non-causal call with a window raises
``ValueError``: the TPU kernel windows it, ``online_attention`` does not,
and no model makes that call.

``chunk`` is llama4's block-local (iRoPE) mask, which the TPU kernel
lacks: a causal key j also needs ``q_pos // chunk == j // chunk``, the
``block_local`` test of ``online_attention``. ``None`` and any chunk of
``LARGE_WINDOW`` or more mean none; a non-causal call refuses a chunk as
it refuses a window. The kernels start a block's KV scan at the first key
of the chunk holding its smallest position, so a local layer visits at
most its own chunk's tiles (two chunks' for a block across a boundary).

The CUDA kernels are in ``csrc/flash_attention.cuh``, each instantiation
compiled in a source of its own and dispatched by
``csrc/flash_attention.cu``; :func:`path` picks
one from (dtype, hd, dv) on the host, never as a reaction to a failure.
bf16 takes the tensor cores wherever hd and dv are multiples of 8 (TMA's
16-byte row stride), at most 256, and their widths rounded up to 64
(:func:`tc_widths`) are one of :data:`TC_HEAD_DIMS`, the kernel's
instantiations: every bf16 prefill of the port's configs (hd 64, 80,
112, 120, 128, 256 and MLA's (192, 128)), and the reduced configs'
pairs. A block of 128 query rows of one head, TMA loads of Q and of a
ring of 64-key K / V tiles at the real hd and dv, zero-filled up to the
padded widths (nothing padded or copied in device memory; the scale is
the caller's), ``wgmma`` for ``Q K^T`` over ``ceil(hd / 16)`` k16 steps
and ``P V`` at the padded dv, with P rounded to bf16 in registers; the
dv real columns are stored. fp32 takes the tensor cores in three-pass
TF32 (``tf32x3``) wherever hd and dv are multiples of 4 and their widths
rounded up to 64 are one of :data:`TF32_HEAD_DIMS`: qwen's and
granite-20b's 128, h2o-danube's 120, zamba2's 112 and the reduced
configs' 64. Each operand of ``Q K^T`` and ``P V`` is split into TF32
hi and lo, and ``hi lo + lo hi + hi hi`` is summed into fp32
accumulators by ``mma.sync.m16n8k8``, which keeps fp32 parity (one
TF32 pass would not); a block of 128 query rows of one head, 16 a warp,
64-key K / V tiles by ``cp.async``, P never leaving registers. fp32 at
any other pair (deepseek's (192, 128), hd 256) and bf16 outside its
rule take the CUDA cores in fp32: a block of 32 (query, head)
rows of one KV head's G heads, so each K / V tile is staged once for all
of them. All visit only the KV tiles
that hold a key some of the block's rows may attend to (the TPU kernel's
block skip, taken from q_pos). :func:`flash_attention_plain` is the plain
PyTorch version, ``flash_attention_ref`` with GQA, q_pos and dv: one dense
fp32 softmax. It is what a CPU tensor runs, and what the kernels are held
to on the card: about 1e-5 relative for fp32 (the online softmax sums in
another order, and three TF32 passes leave about 1e-6), about 2e-2 for
bf16 (P and the output rounded to bf16). A launch is counted under a key
that ends with the path, so a run shows which kernel each call took.

Training: where autograd records the call (grad mode on and q, k or v
requiring grad) :func:`flash_attention` runs through
:class:`FlashAttentionFn`, whose forward is the same launch. The TPU kernel
has no ``custom_vjp``: the JAX package trains through XLA's autodiff of
its ``online_attention``. The backward is therefore torch ops too,
:func:`flash_attention_grad`: an explicit gradient over blocks of query
rows, each recomputing its scores, softcap, mask and P against every key,
so it holds O(S x block) scores and never the [S, S] matrix. It is its own
function, not autograd through :func:`flash_attention_plain`, which stays
off the training path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import (LaunchCounter, check, library,
                                        needs_grad)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
LARGE_WINDOW = 1 << 30           # models/attention.py's "no window"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# the tensor-core kernel's instantiations (HD, HDV), the widths a bf16
# (hd, dv) rounds up to: equal ones, and MLA's 192 / 128. The dispatch of
# csrc/flash_attention.cu's repro_flash_attention takes the same pairs,
# each compiled in csrc/flash_attention_tc<HD>.cu
TC_HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))
TC_ALIGN = 8                     # hd, dv multiples of 8: 16-byte TMA rows
# the three-pass TF32 kernel's instantiations (HD, HDV), the widths an fp32
# (hd, dv) rounds up to, each compiled in csrc/flash_attention_tf32_<HD>.cu
TF32_HEAD_DIMS = ((64, 64), (128, 128))
TF32_ALIGN = 4                   # hd, dv multiples of 4: 16-byte cp.async rows
PATHS = {"tc": 0, "simt": 1, "tf32x3": 2}
GRAD_BLOCK = 256                 # query rows a block of the backward

launches = LaunchCounter()


def _check_args(q, k, v, q_pos, causal, window, softcap, chunk):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q must be [B, S, H, hd], k [B, S, KV, hd] and v "
                         f"[B, S, KV, dv], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV, dv = k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape[:3]) != (B, S, KV):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (prefill: Sq == Skv; q "
                         f"and k share hd)")
    if not 1 <= dv <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a value head_dim (dv) of "
                         f"1 to {MAX_HEAD_DIM}, got {dv}")
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if tuple(q_pos.shape) != (B, S):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} != {(B, S)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1 or None, got {chunk}")
    window = None if window is None or window >= LARGE_WINDOW else int(window)
    chunk = None if chunk is None or chunk >= LARGE_WINDOW else int(chunk)
    if not causal and window is not None:
        raise ValueError(f"a non-causal call takes no window (got {window}):"
                         f" the TPU kernel would window it, online_attention"
                         f" would not")
    if not causal and chunk is not None:
        raise ValueError(f"a non-causal call takes no chunk (got {chunk}): "
                         f"block-local masking is a causal decoder's")
    return B, S, H, KV, hd, dv, window, chunk


def tc_widths(hd: int, dv: int) -> tuple:
    """(hd, dv) each rounded up to a multiple of 64: the tensor-core
    kernel's template widths for the pair (its 64-column TMA boxes)."""
    return (-(-hd // 64) * 64, -(-dv // 64) * 64)


def path(dtype: torch.dtype, hd: int, dv: Optional[int] = None) -> str:
    """The kernel a CUDA call runs (``dv`` None: ``hd``): "tc" (tensor
    cores) for bf16 where hd and dv are multiples of :data:`TC_ALIGN` and
    :func:`tc_widths` is one of :data:`TC_HEAD_DIMS` (so both are at most
    256); "tf32x3" (tensor cores, three-pass TF32) for fp32 where hd and
    dv are multiples of :data:`TF32_ALIGN` and :func:`tc_widths` is one of
    :data:`TF32_HEAD_DIMS`; "simt" (CUDA cores, fp32) otherwise."""
    dv = hd if dv is None else dv
    if dtype == torch.bfloat16:
        ok = (hd % TC_ALIGN == 0 and dv % TC_ALIGN == 0
              and tc_widths(hd, dv) in TC_HEAD_DIMS)
        return "tc" if ok else "simt"
    ok = (hd % TF32_ALIGN == 0 and dv % TF32_ALIGN == 0
          and tc_widths(hd, dv) in TF32_HEAD_DIMS)
    return "tf32x3" if ok else "simt"


def _mask(q_pos: torch.Tensor, S: int, window: Optional[int],
          chunk: Optional[int]) -> torch.Tensor:
    """The causal mask of queries at ``q_pos`` [B, n] over keys 0..S-1, with
    the window and block-local chunk: [B, 1, 1, n, S] booleans."""
    qp = q_pos.long()[:, None, None, :, None]
    j = torch.arange(S, device=q_pos.device)[None, None, None, None, :]
    mask = j <= qp
    if window is not None:
        mask = mask & ((qp - j) < window)
    if chunk is not None:
        mask = mask & (torch.div(qp, chunk, rounding_mode="floor")
                       == torch.div(j, chunk, rounding_mode="floor"))
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, *, scale: float,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: dense fp32 scores over the whole sequence,
    softcap, mask, softmax, ``P V`` at v's head dim; the result in q's
    dtype."""
    B, S, H, KV, hd, dv, window, chunk = _check_args(
        q, k, v, q_pos, causal, window, softcap, chunk)
    G = H // KV
    qf = q.reshape(B, S, KV, G, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bckh->bkgqc", qf, k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        s = s.masked_fill(~_mask(q_pos, S, window, chunk), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p, v.to(torch.float32))
    return out.reshape(B, S, H, dv).to(q.dtype)


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, out: torch.Tensor,
                         dout: torch.Tensor, *, scale: float,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         chunk: Optional[int] = None,
                         block: int = GRAD_BLOCK):
    """The gradient of :func:`flash_attention` at (q, k, v), given its
    output ``out`` [B, S, H, dv] and the output's gradient ``dout``:
    (dq, dk, dv) in the inputs' dtypes, computed in fp32. For each block of
    ``block`` query rows: the scores against every key, the softcap, the
    mask and P again; ``dV += P^T dO``, ``dP = dO V^T``,
    ``dS = P * (dP - rowsum(dO * O))``, times the softcap's chain factor
    ``1 - tanh^2(s / cap)``; ``dQ = dS K * scale``, ``dK += dS^T Q * scale``.
    dK and dV sum over the G query heads of each KV head; v's head dim may
    differ from q's (MLA)."""
    B, S, H, KV, hd, dv, window, chunk = _check_args(
        q, k, v, q_pos, causal, window, softcap, chunk)
    G = H // KV
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    # *_like: on a mesh the buffers are DTensors laid out as the inputs
    cf = torch.contiguous_format
    dq = torch.empty_like(q, dtype=f32, memory_format=cf).reshape(
        B, S, KV, G, hd)
    dk = torch.zeros_like(kf, memory_format=cf)
    dvv = torch.zeros_like(vf, memory_format=cf)
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        n = i1 - i0
        qb = q[:, i0:i1].reshape(B, n, KV, G, hd).to(f32)
        dob = dout[:, i0:i1].reshape(B, n, KV, G, dv).to(f32)
        ob = out[:, i0:i1].reshape(B, n, KV, G, dv).to(f32)
        s = torch.einsum("bqkgh,bckh->bkgqc", qb, kf) * scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        if causal:
            s = s.masked_fill(~_mask(q_pos[:, i0:i1], S, window, chunk),
                              NEG_INF)
        p = torch.softmax(s, dim=-1)                     # [B,KV,G,n,S]
        dvv += torch.einsum("bkgqc,bqkgh->bckh", p, dob)
        dp = torch.einsum("bqkgh,bckh->bkgqc", dob, vf)
        di = (dob * ob).sum(-1).permute(0, 2, 3, 1)      # [B,KV,G,n]
        ds = p * (dp - di[..., None])
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        dq[:, i0:i1] = torch.einsum("bkgqc,bckh->bqkgh", ds, kf) * scale
        dk += torch.einsum("bkgqc,bqkgh->bckh", ds, qb) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` under autograd: the forward is the kernel
    (the plain version on the CPU), the backward
    :func:`flash_attention_grad`."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, scale, causal, window, softcap, chunk):
        out = _flash_attention(q, k, v, q_pos, scale, causal, window,
                               softcap, chunk)
        ctx.save_for_backward(q, k, v, q_pos, out)
        ctx.opts = dict(scale=scale, causal=causal, window=window,
                        softcap=softcap, chunk=chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_grad(q, k, v, q_pos, out, dout,
                                          **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, *, scale: float, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """q [B, S, H, hd]; k [B, S, KV, hd]; v [B, S, KV, dv], q's dtype (fp32
    or bf16); q_pos [B, S] integer positions -> [B, S, H, dv] in q's dtype.

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    :func:`flash_attention_plain`. Where autograd records the call, it
    runs through :class:`FlashAttentionFn`."""
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, q_pos, scale, causal, window,
                                      softcap, chunk)
    return _flash_attention(q, k, v, q_pos, scale, causal, window, softcap,
                            chunk)


def _flash_attention(q, k, v, q_pos, scale, causal, window, softcap,
                     chunk) -> torch.Tensor:
    """The launch (the plain version for a CPU tensor), outside autograd."""
    B, S, H, KV, hd, dv, window, chunk = _check_args(
        q, k, v, q_pos, causal, window, softcap, chunk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, scale=scale,
                                     causal=causal, window=window,
                                     softcap=softcap, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one dtype, fp32 "
                        f"or bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q_pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"flash_attention takes integer q_pos, got "
                        f"{q_pos.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head_dim <= {MAX_HEAD_DIM}, "
                         f"got {hd}")
    if any(t.device != q.device for t in (k, v, q_pos)):
        raise ValueError("flash_attention inputs lie on different devices")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous q, k and v")
    kernel = path(q.dtype, hd, dv)
    if kernel == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's tensor-core kernel reads q, k "
                         "and v by TMA: they must be 16-byte aligned")
    out = q.new_empty((B, S, H, dv))
    if out.numel() == 0:
        return out
    pos = q_pos.to(torch.int32).contiguous()     # [B, S]: a few KB
    err = library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, S, H, KV, hd, dv, float(scale), int(bool(causal)),
        0 if window is None else window, 0 if chunk is None else chunk,
        0.0 if softcap is None else float(softcap), DTYPES[q.dtype],
        PATHS[kernel],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention kernel launch")
    launches.bump((B, S, H, KV, hd, dv, str(q.dtype).replace("torch.", ""),
                   bool(causal), window, softcap, chunk, kernel))
    return out
