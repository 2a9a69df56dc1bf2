"""paged_attention: single-token decode attention through a page table.

K/V live in a pool of fixed-size token pages, ``[P, T, KV, hd]`` per layer
(see ``serving/paged_kv.py``), and each sequence owns an ordered page
list. One query token per sequence (decode): the query sits at position
``seq_len - 1``, slots at or beyond ``seq_len`` are masked, sliding windows
mask ``q_pos - tok >= window``, and the gemma-style logit softcap is applied
before the mask. The page table is padded with page 0 past a sequence's
pages; those columns are never read.

The CUDA kernel is ``csrc/paged_attention.cu``: one block per (sequence,
KV head) walks the sequence's live, in-window pages with an fp32 online
softmax and skips the rest, loading the next 16-token chunk of K and V
while it computes the current one. :func:`paged_attention_plain` is the plain
PyTorch version, gather-then-attend as the JAX package's oracle
(``kernels/ref.py:paged_attention_ref``): it materializes each sequence's
pages contiguously and runs one masked softmax. It is what a CPU tensor
runs, and what the kernel is held to on the card: about 1e-5 relative for
fp32 (the online softmax sums in another order), about 2e-2 for bf16 (one
bf16 rounding of the output).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCounter, check, library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8            # query heads per KV head (MAX_G in the kernel)

launches = LaunchCounter()


def _check_shapes(q, k_pages, v_pages, page_table, seq_lens):
    if q.ndim != 3 or k_pages.ndim != 4:
        raise ValueError(f"q must be [B, H, hd] and the pools [P, T, KV, hd], "
                         f"got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, hd = q.shape
    P, T, KV, hd_k = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or hd_k != hd:
        raise ValueError(f"pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % KV != 0:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} and seq_lens "
                         f"{tuple(seq_lens.shape)} do not match B={B}")
    return B, H, hd, T, KV, page_table.shape[1]


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          seq_lens: torch.Tensor, *,
                          scale: Optional[float] = None,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: gather each sequence's pages into
    [B, NP*T, KV, hd], masked single-query softmax in fp32; the result in
    q's dtype."""
    B, H, hd, T, KV, NP = _check_shapes(q, k_pages, v_pages, page_table,
                                        seq_lens)
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    idx = page_table.long()
    k = k_pages[idx].reshape(B, NP * T, KV, hd).to(torch.float32)
    v = v_pages[idx].reshape(B, NP * T, KV, hd).to(torch.float32)
    qf = q.reshape(B, KV, G, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qf, k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    sl = seq_lens.long()[:, None]
    tok = torch.arange(NP * T, device=q.device)[None, :]
    mask = tok < sl                                  # causal: q is the last
    if window is not None:
        mask = mask & ((sl - 1 - tok) < window)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v)
    return out.reshape(B, H, hd).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *, scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [B, H, hd]; k/v_pages [P, T, KV, hd]; page_table [B, NP] int32
    (padded with page 0); seq_lens [B] int32, the query token included
    -> [B, H, hd] in q's dtype.

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    :func:`paged_attention_plain`. Every page id in a row's first
    ``ceil(seq_len / T)`` columns must lie in ``[0, P)``."""
    B, H, hd, T, KV, NP = _check_shapes(q, k_pages, v_pages, page_table,
                                        seq_lens)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     seq_lens, scale=scale, window=window,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention takes q and pools of one dtype, "
                        f"fp32 or bf16; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"paged_attention takes int32 page_table and "
                        f"seq_lens, got {page_table.dtype} and "
                        f"{seq_lens.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"paged_attention takes at most {MAX_GROUP} query "
                         f"heads per KV head, got {H // KV}")
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention takes contiguous inputs")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention reads the pools in 16-byte "
                         "vectors: they must be 16-byte aligned")
    if NP == 0:
        raise ValueError("paged_attention needs at least one page column")
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = hd ** -0.5 if scale is None else float(scale)
    err = library().repro_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, H, KV, hd, T, NP, scale, 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "paged_attention kernel launch")
    launches.bump((B, H, KV, hd, T, NP, str(q.dtype).replace("torch.", ""),
                   window, softcap))
    return out
