"""KV cache helpers of the contiguous serving path.

``pad_prefill_cache`` embeds a prefill cache into one contiguous
``[n, B, max_len, KV, hd]`` decode cache per segment (the layout of
``Model.alloc_cache``): simple and exact, but the whole padded allocation
lives for the whole batch. :class:`~repro_torch.serving.engine.
ServingEngine` keeps this path (it is the in-memory reference the swapped
paths are held to) and uses ``gather_cache_rows`` to shrink the batch as
requests retire. The swap-aware serving path stores K/V in pages instead
(``serving/paged_kv.py``, ``serving/batch_engine.py``).

The port's model is dense only, so every cache leaf is a stacked K or V
with the batch on axis 1 and the sequence on axis 2.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.skeleton import torch_dtype
from repro_torch.models.transformer import Model
from repro_torch.tree import tree_map


def _decode_shape(model: Model, n: int, batch: int, max_len: int) -> tuple:
    cfg = model.cfg
    return (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)


def pad_prefill_cache(model: Model, prefill_cache: list, max_len: int,
                      batch: int) -> list:
    """Embed a length-S prefill cache into a zero-padded length-``max_len``
    decode cache (the sequence axis padded at the end)."""
    dt = torch_dtype(model.cfg.dtype)

    def place(pc):
        want = _decode_shape(model, pc.shape[0], batch, max_len)
        if pc.shape[:2] != want[:2] or pc.shape[3:] != want[3:] \
                or pc.shape[2] > max_len:
            raise ValueError(f"prefill cache {tuple(pc.shape)} does not fit "
                             f"a decode cache {want}")
        out = torch.zeros(want, dtype=dt, device=pc.device)
        out[:, :, :pc.shape[2]] = pc
        return out

    return tree_map(place, prefill_cache)


def gather_cache_rows(model: Model, cache: list, rows: Sequence[int],
                      max_len: int, batch: int) -> list:
    """Shrink a ``batch``-row decode cache to the surviving ``rows`` (in
    order): how the contiguous engine retires finished requests mid-batch
    instead of decoding padding until the longest request completes."""

    def take(leaf):
        want = _decode_shape(model, leaf.shape[0], batch, max_len)
        if tuple(leaf.shape) != want:
            raise ValueError(f"cache leaf {tuple(leaf.shape)} != {want}")
        idx = torch.tensor(list(rows), dtype=torch.long, device=leaf.device)
        return leaf.index_select(1, idx)

    return tree_map(take, cache)
