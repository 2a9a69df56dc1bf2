"""paged_attention: single-token decode attention through a page table.

K/V live in a pool of fixed-size token pages, ``[P, T, KV, hd]`` per layer
(see ``serving/paged_kv.py``), and each sequence owns an ordered page
list. One query token per sequence (decode): the query sits at position
``seq_len - 1``, slots at or beyond ``seq_len`` are masked, sliding windows
mask ``q_pos - tok >= window``, and the gemma-style logit softcap is applied
before the mask. The page table is padded with page 0 past a sequence's
pages; those columns are never read.

The CUDA kernel is ``csrc/paged_attention.cu`` (flash-decoding): a
sequence's live, in-window tokens are cut into splits of
:func:`split_len` tokens, one block per (split, KV head, group of up to
:data:`GROUP` query heads, sequence) reads its split's K/V rows once for
the group's heads through a ring of ``cp.async`` stages, and a second
kernel adds the splits of each sequence in split order. A sequence with
one split is written by its block directly. Any head dim that is a
multiple of 8 up to 256 runs, at the kernel's row width
:func:`padded_head_dim` with the columns past hd zero-filled in shared
memory (h2o-danube's 120 at 128), and any number of query heads a KV
head (granite-20b's MQA: 48, in 6 groups of 8). The host plans from
shapes alone (:func:`split_len`, :func:`max_splits`,
:func:`scratch_floats`) and never reads ``seq_lens`` back;
:func:`split_bounds` is the split rule the kernel applies.
:func:`paged_attention_plain` is the plain PyTorch version, gather-then-
attend as the JAX package's oracle (``kernels/ref.py:paged_attention_ref``):
it materializes each sequence's pages contiguously and runs one masked
softmax. It is what a CPU tensor runs, and what the kernel is held to on the
card: about 1e-5 relative for fp32 (the online softmax sums in another
order), about 2e-2 for bf16 (one bf16 rounding of the output).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels._build import (LaunchCounter, check, library,
                                        refuse_grad)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_WIDTHS = (64, 128, 256)  # the kernel's compiled row widths
GROUP = 8                # query heads a block (MAX_G in the kernel)
# About the tokens a split takes, by head_dim (see split_len): measured on
# an H100 with tools/torch_attention_sweep.py (PERF.md), a split of 64
# tokens at qwen2.5-3b's head_dim 128 and of 128 at gemma2-9b's 256 gave
# the shortest decode step; longer splits leave SMs idle, shorter ones
# make the second pass dominate. No model decodes at head_dim 64: its
# entry is head_dim 128's, not measured; h2o-danube's 120 runs at the row
# width 128 and takes its entry, not measured either. Any other head dim
# takes its row width's.
SPLIT_TOKENS = {64: 64, 120: 64, 128: 64, 256: 128}
STAGE_BYTES = 16384      # K bytes a stage of the kernel's ring holds


def padded_head_dim(hd: int) -> int:
    """The kernel's row width for head dim ``hd`` (a multiple of 8 up to
    256): the smallest of :data:`ROW_WIDTHS` that holds it."""
    if hd <= 0 or hd % 8 or hd > ROW_WIDTHS[-1]:
        raise ValueError(f"paged_attention takes a head_dim that is a "
                         f"multiple of 8 up to {ROW_WIDTHS[-1]}, got {hd}")
    return next(w for w in ROW_WIDTHS if hd <= w)


def groups(G: int) -> int:
    """Blocks a KV head's G query heads take: groups of up to
    :data:`GROUP`, each re-reading the split's K/V rows."""
    return -(-G // GROUP)


def chunk_tokens(hd: int, dtype: torch.dtype) -> int:
    """Tokens a stage of the kernel's ring holds (``Paged::CHUNK``): 64,
    or fewer where 64 rows of K at the padded row width would pass 16 KB."""
    return min(64, STAGE_BYTES // (padded_head_dim(hd)
                                   * (torch.finfo(dtype).bits // 8)))


def split_len(hd: int, dtype: torch.dtype, T: int) -> int:
    """L, the tokens a split covers: a multiple of the page size T and of
    the chunk, as near ``SPLIT_TOKENS[hd]`` (its row width's where hd has
    no entry) as such a multiple gets (at least one). A constant of (hd,
    dtype, T): gemma2-9b's 4,201-token context (hd 256, bf16, T 16) makes
    33 splits of 128."""
    base = math.lcm(T, chunk_tokens(hd, dtype))
    want = SPLIT_TOKENS.get(hd, SPLIT_TOKENS[padded_head_dim(hd)])
    return base * max(1, round(want / base))


def max_splits(NP: int, T: int, L: int) -> int:
    """Splits the widest sequence a page table of NP columns can hold may
    need: the grid's split dimension, and the scratch's."""
    return -(-NP * T // L)


def scratch_floats(B: int, KV: int, G: int, hd: int, NP: int, T: int,
                   L: int) -> int:
    """fp32 scratch for the splits' (acc, m, l): none when one split is
    all a sequence of the page table can need, since each sequence with one
    split writes its output directly. From the shapes alone (NP, not the
    sequence lengths)."""
    n = max_splits(NP, T, L)
    return 0 if n <= 1 else B * KV * n * G * (hd + 2)


def split_bounds(seq_len: int, window: Optional[int], L: int,
                 capacity: int) -> List[Tuple[int, int]]:
    """The [start, end) token ranges of a sequence's splits, as the kernel
    cuts them: its live, in-window tokens [lo, hi), lo = seq_len - window
    (0 without a window), hi = min(seq_len, capacity) with capacity the
    page table's NP * T, in pieces of L from lo. They depend on the
    sequence alone, never on the batch. A copy of the kernel's
    ``live_range`` (``csrc/paged_attention.cu``): a change to one must be
    made to the other; :func:`kernel_split_bounds` reads the kernel's."""
    hi = min(seq_len, capacity)
    lo = max(0, seq_len - window) if window is not None else 0
    return [(s, min(s + L, hi)) for s in range(lo, hi, L)]


def kernel_split_bounds(seq_lens: torch.Tensor, window: Optional[int],
                        L: int, capacity: int) -> List[List[Tuple[int, int]]]:
    """:func:`split_bounds` of each of ``seq_lens`` (int32 on the card) as
    the kernel's ``live_range`` computes them, for the tests that hold the
    two together. Not a launch of the attention kernel: no count."""
    if seq_lens.device.type != "cuda" or seq_lens.dtype != torch.int32:
        raise ValueError("kernel_split_bounds takes int32 seq_lens on the "
                         "card")
    seq_lens = seq_lens.contiguous()
    out = torch.empty((seq_lens.numel(), 3), dtype=torch.int32,
                      device=seq_lens.device)
    check(library().repro_paged_split_plan(
        seq_lens.data_ptr(), seq_lens.numel(),
        0 if window is None else int(window), capacity, L, out.data_ptr(),
        torch.cuda.current_stream(seq_lens.device).cuda_stream),
        "paged split plan launch")
    return [[(lo + s * L, min(lo + (s + 1) * L, hi)) for s in range(n)]
            for lo, hi, n in out.tolist()]

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
    refuse_grad("paged_attention", q, k_pages, v_pages)
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention takes q and pools of one dtype, "
                        f"fp32 or bf16; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"paged_attention takes int32 page_table and "
                        f"seq_lens, got {page_table.dtype} and "
                        f"{seq_lens.dtype}")
    padded_head_dim(hd)                  # raises for a width it lacks
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
    L = split_len(hd, q.dtype, T)
    n = scratch_floats(B, KV, H // KV, hd, NP, T, L)
    scratch = torch.empty(n, dtype=torch.float32, device=q.device) \
        if n else None
    err = library().repro_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        B, H, KV, hd, T, NP, L, scale, 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "paged_attention kernel launch")
    launches.bump((B, H, KV, hd, T, NP, str(q.dtype).replace("torch.", ""),
                   window, softcap))
    return out
