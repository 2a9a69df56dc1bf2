"""Paged KV cache: fixed-size token pages charged to the shared MemoryLedger.

Instead of one contiguous [B, max_len, KV, hd] allocation per batch slot,
K/V live in a shared pool of PAGES of ``page_tokens`` tokens each, and
every sequence owns an ordered page list. A page spans ALL layers (one
alloc decision per ``page_tokens`` of context), so

    page_bytes = 2 (K+V) * n_layers * page_tokens * KV * hd * itemsize.

Pages are charged to the same :class:`~repro_torch.core.swap_engine.
MemoryLedger` as the weight blocks, under one key per sequence whose value
is re-charged with delta semantics as the sequence grows: KV pages and
weight-block residency compete under ONE budget. ``alloc``/``extend``
never block and never commit in part: a rejection (pool exhausted or
ledger over budget) leaves the free list and the ledger as they were, and
the batch engine answers it with preemption by recomputation.

The page arithmetic is the JAX package's (``repro.serving.paged_kv``), so
page tables and ledger totals compare across the two packages. What
differs is where the pools live: the JAX package keeps host numpy pools
and uploads every written layer's pool each step; here ``k_pools`` and
``v_pools`` are device tensors of [max_pages + 1, T, KV, hd] in the model
dtype, written in place by index scatters on the device. The ledger
charges the LOGICALLY allocated pages, as the weight ledger charges
resident blocks, while the device holds the whole pool from construction
(:attr:`PagedKVCache.pool_bytes`).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.skeleton import torch_dtype
from repro_torch.core.swap_engine import MemoryLedger
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import paged_attention

__all__ = ["PagedKVCache", "PagedBatchView", "page_bytes_for"]


def page_bytes_for(cfg: ModelConfig, page_tokens: int) -> int:
    """Ledger cost of one page: K+V for every layer's slice of the page."""
    itemsize = torch_dtype(cfg.dtype).itemsize
    return (2 * cfg.n_layers * page_tokens
            * cfg.n_kv_heads * cfg.resolved_head_dim * itemsize)


class PagedKVCache:
    """Page-table KV cache for one model, accounted on a shared ledger.

    Thread-safe: pages are allocated and freed under one lock.
    """

    def __init__(self, cfg: ModelConfig, ledger: MemoryLedger, *,
                 page_tokens: int = 16, max_pages: int = 64,
                 name: str = "kv", device="cuda"):
        if cfg.mla is not None or any(
                k not in ("dense", "moe") for k in cfg.layer_kinds()):
            raise ValueError(
                f"{cfg.name}: paged KV serving covers uniform GQA/MHA "
                f"attention stacks (MLA and SSM/shift state layers keep the "
                f"contiguous legacy path)")
        self.cfg = cfg
        self.ledger = ledger
        self.page_tokens = int(page_tokens)
        self.max_pages = int(max_pages)
        self.name = name
        self.device = resolve_device(device)
        self.page_bytes = page_bytes_for(cfg, self.page_tokens)
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        dt = torch_dtype(cfg.dtype)
        # page 0 is a permanently-zero SENTINEL: page tables are padded with
        # it past a sequence's pages
        shape = (self.max_pages + 1, self.page_tokens, KV, hd)
        self.k_pools = [torch.zeros(shape, dtype=dt, device=self.device)
                        for _ in range(cfg.n_layers)]
        self.v_pools = [torch.zeros(shape, dtype=dt, device=self.device)
                        for _ in range(cfg.n_layers)]
        self._free: List[int] = list(range(self.max_pages, 0, -1))
        self._pages: Dict[object, List[int]] = {}
        self._len: Dict[object, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def for_budget(cls, cfg: ModelConfig, ledger: MemoryLedger,
                   kv_bytes: int, *, page_tokens: int = 16,
                   name: str = "kv", device="cuda") -> "PagedKVCache":
        """Size the pool so its pages exactly fill ``kv_bytes`` when all
        allocated (the ledger still arbitrates: weight blocks can squeeze
        the usable page count below capacity at run time)."""
        pb = page_bytes_for(cfg, page_tokens)
        max_pages = max(int(kv_bytes) // pb, 1)
        return cls(cfg, ledger, page_tokens=page_tokens, max_pages=max_pages,
                   name=name, device=device)

    # ------------------------------------------------------------ pages
    def _pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_tokens)

    def _key(self, seq_id) -> tuple:
        return ("kv", self.name, seq_id)

    def alloc(self, seq_id, n_tokens: int) -> bool:
        """Admit a new sequence with ``n_tokens`` of context. False (and no
        state change) if the pool or the ledger cannot take its pages."""
        need = self._pages_for(n_tokens)
        with self._lock:
            if seq_id in self._pages:
                raise ValueError(f"sequence {seq_id!r} is live")
            if need > len(self._free):
                return False
            if not self.ledger.try_add(self._key(seq_id),
                                       need * self.page_bytes):
                return False
            self._pages[seq_id] = [self._free.pop() for _ in range(need)]
            self._len[seq_id] = n_tokens
        return True

    def extend(self, seq_id, n_new: int = 1) -> bool:
        """Grow a sequence by ``n_new`` tokens, taking a page at each
        boundary crossing (ledger re-charged with delta semantics). False
        leaves the sequence exactly as it was."""
        with self._lock:
            pages = self._pages[seq_id]
            new_len = self._len[seq_id] + n_new
            need = self._pages_for(new_len) - len(pages)
            if need > 0:
                if need > len(self._free):
                    return False
                if not self.ledger.try_add(
                        self._key(seq_id),
                        (len(pages) + need) * self.page_bytes):
                    return False
                pages.extend(self._free.pop() for _ in range(need))
            self._len[seq_id] = new_len
        return True

    def free(self, seq_id) -> None:
        """Retire a sequence: pages to the free list, ledger released."""
        with self._lock:
            pages = self._pages.pop(seq_id, None)
            if pages is None:
                return
            del self._len[seq_id]
            self._free.extend(reversed(pages))
            self.ledger.drop(self._key(seq_id))

    # ------------------------------------------------------------ tokens
    def slots(self, seq_id, positions: Sequence[int]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(page ids, slots) on the device for token positions of a live
        sequence (the positions must be allocated): the addressing
        ``write_rows`` scatters to, e.g. a prefill's ``range(S)``."""
        T = self.page_tokens
        with self._lock:
            pages = self._pages[seq_id]
            n = self._len[seq_id]
        pos = np.asarray(positions, np.int64)
        if pos.size and (pos.min() < 0 or pos.max() >= n):
            raise ValueError(f"positions {pos.min()}..{pos.max()} outside "
                             f"sequence {seq_id!r} of {n} tokens")
        pids = np.asarray(pages, np.int64)[pos // T]
        return (torch.from_numpy(pids).to(self.device),
                torch.from_numpy(pos % T).to(self.device))

    def last_slots(self, seq_ids: Sequence) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        """(page_ids [B], slots [B]) on the device addressing each
        sequence's LAST token: the decode-step write position, computed
        once and reused by every layer's scatter (``write_rows``)."""
        T = self.page_tokens
        with self._lock:
            pos = [self._len[s] - 1 for s in seq_ids]
            pids = [self._pages[s][p // T] for s, p in zip(seq_ids, pos)]
        return (torch.tensor(pids, dtype=torch.long, device=self.device),
                torch.tensor([p % T for p in pos], dtype=torch.long,
                             device=self.device))

    def write_rows(self, layer: int, pids: torch.Tensor, slots: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor) -> None:
        """Scatter ``k``/``v`` [N, KV, hd] into the N pool rows that
        ``slots`` or ``last_slots`` addressed, in place on the device (one
        index scatter per pool)."""
        kp, vp = self.k_pools[layer], self.v_pools[layer]
        kp[pids, slots] = k.to(device=kp.device, dtype=kp.dtype)
        vp[pids, slots] = v.to(device=vp.device, dtype=vp.dtype)

    # ------------------------------------------------------------ views
    def page_table(self, seq_ids: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        """(page_table [B, NP] int32 padded with the zero page, seq_lens [B]
        int32) on the host for a batch of live sequences."""
        with self._lock:
            lists = [self._pages[s] for s in seq_ids]
            lens = [self._len[s] for s in seq_ids]
        NP = max((len(p) for p in lists), default=1) or 1
        pt = np.zeros((len(lists), NP), np.int32)
        for i, p in enumerate(lists):
            pt[i, :len(p)] = p
        return pt, np.asarray(lens, np.int32)

    # ------------------------------------------------------------ stats
    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._pages.values())

    @property
    def pool_bytes(self) -> int:
        """Device bytes the pools hold: every page and the sentinel, for
        every layer, allocated or not."""
        return sum(t.numel() * t.element_size()
                   for t in self.k_pools + self.v_pools)

    def live_sequences(self) -> List:
        with self._lock:
            return list(self._pages)


class _LayerBoundView:
    """``PagedBatchView`` narrowed to one layer: the ``paged`` hook
    ``models.transformer.apply_layer`` hands to ``gqa_apply_paged``."""

    __slots__ = ("_view", "_layer")

    def __init__(self, view: "PagedBatchView", layer: int):
        self._view = view
        self._layer = layer

    def attend(self, q, k_new, v_new, **kw):
        return self._view.attend(self._layer, q, k_new, v_new, **kw)


class PagedBatchView:
    """One decode step's batch, frozen as a page-table snapshot.

    The batch engine extends every active sequence by one token FIRST, then
    builds the view: ``seq_lens`` already counts the token being decoded, so
    each layer's new K/V lands at position ``seq_lens[i] - 1`` and the
    kernel's mask (``q_pos = seq_len - 1``) covers exactly the live
    context. The (page_table, seq_lens) device tensors are uploaded once
    and shared by all layers of the step.
    """

    def __init__(self, kv: PagedKVCache, seq_ids: Sequence):
        self.kv = kv
        self.seq_ids = list(seq_ids)
        pt, sl = kv.page_table(self.seq_ids)
        self.host_seq_lens = sl
        # every layer writes the SAME (page, slot) per sequence this step:
        # resolve the addressing once, scatter per layer
        self._w_pids, self._w_slots = kv.last_slots(self.seq_ids)
        self.page_table = torch.from_numpy(pt).to(kv.device)
        self.seq_lens = torch.from_numpy(sl).to(kv.device)

    def attend(self, layer: int, q: torch.Tensor, k_new: torch.Tensor,
               v_new: torch.Tensor, *, scale: Optional[float] = None,
               window: Optional[int] = None,
               softcap: Optional[float] = None) -> torch.Tensor:
        """Append this layer's new K/V ([B, KV, hd]) to each sequence's
        pages, then attend q ([B, H, hd]) through the page table."""
        self.kv.write_rows(layer, self._w_pids, self._w_slots, k_new, v_new)
        return paged_attention(q.contiguous(), self.kv.k_pools[layer],
                               self.kv.v_pools[layer], self.page_table,
                               self.seq_lens, scale=scale, window=window,
                               softcap=softcap)

    def bind(self, layer: int) -> _LayerBoundView:
        return _LayerBoundView(self, layer)
