"""Synthetic data pipeline: deterministic, host-side, prefetching.

The JAX package's ``data/pipeline.py``: the same ``numpy`` draws from
``default_rng((seed, step))`` in the same order, so a batch is bitwise the
reference's. The LM stream mixes a learnable affine next-token rule over a
small active symbol set with noise, so the training loss visibly falls;
the vlm and audio variants bring the frontend stubs' inputs. Tensors are
made on the host; the trainer moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.skeleton import torch_dtype


def _floats(a: np.ndarray, dtype: str) -> torch.Tensor:
    """float64 draws as the config's dtype: through fp32, as the reference's
    ``jnp.asarray`` converts them."""
    return torch.from_numpy(a.astype(np.float32)).to(torch_dtype(dtype))


@dataclass
class SyntheticLM:
    cfg: ModelConfig
    seq_len: int
    batch: int
    seed: int = 0
    pattern_frac: float = 0.85   # fraction of learnable transitions

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, step))

    def sample(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch ``step``: ``tokens`` and ``targets`` int32 [B, S] (the
        targets the tokens shifted by one); with ``vision_embeds``
        [B, n_vision_tokens, d_frontend] and ``positions`` [B, S, 3] for a
        vlm; for audio (no token inputs) ``features`` [B, S, d_frontend],
        the boolean ``mask`` and random ``targets`` instead."""
        cfg = self.cfg
        rng = self._rng(step)
        B, S, V = self.batch, self.seq_len, cfg.vocab_size
        # an affine rule (mod A) over a SMALL active symbol set: a
        # full-vocab permutation would need V memorized transitions
        A = min(V, 256)
        a, c = 31, 17                      # gcd(a, A) = 1
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, A, B)
        noise = rng.random((B, S)) > self.pattern_frac
        rand = rng.integers(0, A, (B, S))
        for t in range(S):
            nxt = (toks[:, t] * a + c) % A
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
                 "targets": torch.from_numpy(toks[:, 1:].astype(np.int32))}
        if cfg.family == "vlm":
            batch["vision_embeds"] = _floats(
                rng.normal(0, 0.5, (B, cfg.n_vision_tokens, cfg.d_frontend)),
                cfg.dtype)
            pos = np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3))
            batch["positions"] = torch.from_numpy(pos.astype(np.int32))
        if not cfg.embed_inputs:           # audio: features + mask
            feats = rng.normal(0, 0.5, (B, S, cfg.d_frontend))
            batch = {"features": _floats(feats, cfg.dtype),
                     "mask": torch.from_numpy(rng.random((B, S)) < 0.3),
                     "targets": torch.from_numpy(
                         rng.integers(0, V, (B, S)).astype(np.int32))}
        return batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.sample(step)
            step += 1

    def prefetch(self, depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches drawn ``depth`` ahead on a background thread (the data
        pipeline's counterpart of the double-buffered swap-in). The thread
        is a daemon: it ends with the process, blocked on a full queue."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)

        def worker():
            for b in self:
                q.put(b)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            yield q.get()


def make_batch_for(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
    """One batch for ``shape``'s mode: batch 0 of the stream for "train";
    without targets and mask for "prefill"; for "decode" the first token,
    zero positions (and zero M-RoPE positions [B, 1, 3])."""
    ds = SyntheticLM(cfg, shape.seq_len, shape.global_batch, seed)
    b = ds.sample(0)
    if shape.mode == "train":
        return b
    if shape.mode == "prefill":
        b.pop("targets", None)
        b.pop("mask", None)
        return b
    B = shape.global_batch
    tokens = b.get("tokens", torch.zeros((B, 1), dtype=torch.int32))
    out = {"token": tokens[:, :1], "pos": torch.zeros((B,), dtype=torch.int32)}
    if cfg.rope_type == "mrope":
        out["positions"] = torch.zeros((B, 1, 3), dtype=torch.int32)
    return out
