"""KV cache helpers of the contiguous serving path.

``pad_prefill_cache`` embeds a prefill cache into one contiguous decode
cache per segment (the layout of ``Model.alloc_cache``): simple and exact,
but the whole padded allocation lives for the whole batch.
:class:`~repro_torch.serving.engine.ServingEngine` keeps this path (it is
the in-memory reference the swapped paths are held to) and uses
``gather_cache_rows`` to shrink the batch as requests retire. The
swap-aware serving path stores K/V in pages instead
(``serving/paged_kv.py``, ``serving/batch_engine.py``).

Sequence-indexed leaves (K/V) are padded to ``max_len``; state leaves
(an rwkv6 layer's WKV state and token shifts, a mamba2 layer's SSM state
and conv tail) are carried as they are. The batch axis of a leaf is found
by comparing the cache structure at two batch sizes
(``Model.cache_struct``), as in the JAX package, so no leaf layout is
assumed here: a scanned segment's leaves carry their layer axis in front,
a shared attention block's occurrence (zamba2) none.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models.transformer import Model


def pad_prefill_cache(model: Model, prefill_cache: list, max_len: int,
                      batch: int) -> list:
    """Embed a length-S prefill cache into a zero-padded length-``max_len``
    decode cache (``Model.cache_struct``): sequence-indexed leaves are
    padded at the end, state leaves carried as they are (in the decode
    cache's dtype)."""
    target = model.cache_struct(batch, max_len)
    if len(prefill_cache) != len(target):
        raise ValueError(f"{len(prefill_cache)} cache segments, the model "
                         f"has {len(target)}")

    def place(pc, shape, dt):
        if pc.ndim != len(shape) or any(s > t for s, t in zip(pc.shape,
                                                              shape)):
            raise ValueError(f"prefill cache {tuple(pc.shape)} does not fit "
                             f"a decode cache {shape}")
        if tuple(pc.shape) == shape:
            return pc.to(dt)
        out = torch.zeros(shape, dtype=dt, device=pc.device)
        out[tuple(slice(0, s) for s in pc.shape)] = pc
        return out

    return [{name: place(seg[name], *tgt[name]) for name in tgt}
            for seg, tgt in zip(prefill_cache, target)]


def gather_cache_rows(model: Model, cache: list, rows: Sequence[int],
                      max_len: int, batch: int) -> list:
    """Shrink a ``batch``-row decode cache to the surviving ``rows`` (in
    order): how the contiguous engine retires finished requests mid-batch
    instead of decoding padding until the longest request completes."""
    old = model.cache_struct(batch, max_len)
    new = model.cache_struct(len(rows), max_len)

    def take(leaf, o, n):
        if tuple(leaf.shape) != o:
            raise ValueError(f"cache leaf {tuple(leaf.shape)} != {o}")
        diffs = [i for i, (a, b) in enumerate(zip(o, n)) if a != b]
        if len(diffs) != 1:
            raise ValueError(f"expected exactly the batch axis to differ: "
                             f"{o} -> {n}")
        idx = torch.tensor(list(rows), dtype=torch.long, device=leaf.device)
        return leaf.index_select(diffs[0], idx)

    return [{name: take(seg[name], old_seg[name][0], new_seg[name][0])
             for name in seg}
            for seg, old_seg, new_seg in zip(cache, old, new)]
