"""flash_attention: prefill self-attention with an online softmax.

The function of the JAX package's ``kernels/flash_attention.py`` (oracle
``kernels/ref.py:flash_attention_ref``) with the generality the port's
prefill needs: q [B, S, H, hd] and k, v [B, S, KV, hd] in the projections'
layout, grouped-query heads read in place (query head h reads KV head
``h // (H / KV)``), explicit query positions and any S. The semantics are
those of :func:`repro_torch.models.attention.online_attention` with no
``kv_valid_len``: key j (its index) attends to a query at position
``q_pos[b, i]`` iff, when causal, ``j <= q_pos`` and ``q_pos - j < window``;
a score is ``q.k * scale``, then the softcap, then the mask (the finite
``NEG_INF``). ``window=None`` and ``LARGE_WINDOW`` both mean no window.

The CUDA kernel is ``csrc/flash_attention.cu``: one block per (32 query
rows, head, batch) walks the KV tiles of 32 keys that hold a key some of
its rows may attend to (the TPU kernel's block skip, taken from q_pos),
with the running (m, l, acc) in fp32. :func:`flash_attention_plain` is the
plain PyTorch version, ``flash_attention_ref`` with GQA and q_pos: one
dense fp32 softmax. It is what a CPU tensor runs, and what the kernel is
held to on the card: about 1e-5 relative for fp32 (the online softmax
sums in another order), about 2e-2 for bf16 (one bf16 rounding of the
output).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCounter, check, library

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
LARGE_WINDOW = 1 << 30           # models/attention.py's "no window"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

launches = LaunchCounter()


def _check_args(q, k, v, q_pos, window, softcap):
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be [B, S, H, hd] and k, v [B, S, KV, hd], "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (prefill: Sq == Skv)")
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if tuple(q_pos.shape) != (B, S):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} != {(B, S)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    window = None if window is None or window >= LARGE_WINDOW else int(window)
    return B, S, H, KV, hd, window


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, *, scale: float,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: dense fp32 scores over the whole sequence,
    softcap, mask, softmax; the result in q's dtype."""
    B, S, H, KV, hd, window = _check_args(q, k, v, q_pos, window, softcap)
    G = H // KV
    qf = q.reshape(B, S, KV, G, hd).to(torch.float32)
    s = torch.einsum("bqkgh,bckh->bkgqc", qf, k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        qp = q_pos.long()[:, None, None, :, None]           # [B,1,1,S,1]
        j = torch.arange(S, device=q.device)[None, None, None, None, :]
        mask = j <= qp
        if window is not None:
            mask = mask & ((qp - j) < window)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, *, scale: float, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [B, S, H, hd]; k, v [B, S, KV, hd], q's dtype (fp32 or bf16);
    q_pos [B, S] integer positions -> [B, S, H, hd] in q's dtype.

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    :func:`flash_attention_plain`."""
    B, S, H, KV, hd, window = _check_args(q, k, v, q_pos, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, scale=scale,
                                     causal=causal, window=window,
                                     softcap=softcap)
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    pos = q_pos.to(torch.int32).contiguous()     # [B, S]: a few KB
    err = library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, S, H, KV, hd, float(scale), int(bool(causal)),
        0 if window is None else window,
        0.0 if softcap is None else float(softcap), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention kernel launch")
    launches.bump((B, S, H, KV, hd, str(q.dtype).replace("torch.", ""),
                   bool(causal), window, softcap))
    return out
