"""The in-memory serving engine: request queue -> padded batch -> prefill
-> greedy decode, every weight resident on the device.

:class:`ServingEngine` is the solo reference the swapped paged engine
(``serving/batch_engine.py``) is held to: greedy decode is deterministic,
so a request's tokens must come out the same either way.
:class:`MultiModelServingEngine` serves tagged requests over a planned
multi-model runtime, one at a time (serve's round-robin ``--multi`` mode).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serving.kv_cache import gather_cache_rows, pad_prefill_cache
from repro_torch.tree import tree_map


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos: Optional[int] = None
    output: List[int] = field(default_factory=list)
    # urgency: the batch engine evicts the lowest priority first under page
    # pressure; the in-memory engine serves in arrival order
    priority: float = 1.0
    # terminal failure (SwapError): set by the batch engine when the
    # sequence is EVICTED on an unrecoverable swap failure instead of
    # retired cleanly; the retire callback fires either way
    error: Optional[BaseException] = None


def pad_prompts(cfg, reqs: Sequence[Request]) -> Dict[str, torch.Tensor]:
    """Left-pad a request batch into a prefill input dict (host tensors);
    with M-RoPE the three position streams are the padded index."""
    B = len(reqs)
    L = max(len(r.prompt) for r in reqs)
    toks = np.zeros((B, L), np.int32)
    for i, r in enumerate(reqs):
        toks[i, L - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks)}
    if cfg.rope_type == "mrope":
        pos = np.broadcast_to(np.arange(L)[None, :, None], (B, L, 3))
        batch["positions"] = torch.from_numpy(pos.astype(np.int32))
    return batch


class ServingEngine:
    """Greedy generation on the in-memory model. ``params`` are moved to
    ``device`` once (no copy if they are there already)."""

    def __init__(self, model: Model, params: dict, max_len: int = 512,
                 device="cuda"):
        self.model = model
        self.device = resolve_device(device)
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.max_len = max_len

    def generate(self, reqs: Sequence[Request]) -> Dict[str, float]:
        """Greedy generation for a batch of requests (in place).

        Each request retires at ITS OWN ``max_new_tokens`` / EOS: finished
        rows are gathered out of the decode cache (``gather_cache_rows``),
        so a ragged batch never decodes padding for requests that are
        already done."""
        if not self.model.cfg.supports_decode():
            raise ValueError(f"{self.model.cfg.name} is encoder-only")
        model, dev = self.model, self.device
        B = len(reqs)
        t0 = time.perf_counter()
        batch = {k: v.to(dev) for k, v in pad_prompts(model.cfg,
                                                      reqs).items()}
        L = batch["tokens"].shape[1]
        logits, cache = model.prefill(self.params, batch)
        cache = pad_prefill_cache(model, cache, self.max_len, B)
        tok = logits[:, -1].argmax(dim=-1)
        toks = tok.tolist()                   # waits for the device
        t_prefill = time.perf_counter() - t0

        active = list(range(B))         # request index per live cache row
        n_steps = 0
        decoded = 0
        for step in range(self.max_len):
            keep: List[int] = []
            for row, i in enumerate(active):
                r = reqs[i]
                t = int(toks[row])
                r.output.append(t)
                finished = (r.eos is not None and t == r.eos) \
                    or len(r.output) >= r.max_new_tokens
                if not finished:
                    keep.append(row)
            if not keep or L + step >= self.max_len:
                break
            if len(keep) < len(active):         # retire finished rows
                cache = gather_cache_rows(model, cache, keep, self.max_len,
                                          len(active))
                tok = tok[torch.tensor(keep, device=dev)]
                active = [active[row] for row in keep]
            db = {"token": tok[:, None],
                  "pos": torch.full((len(active),), L + step,
                                    dtype=torch.long, device=dev)}
            if model.cfg.rope_type == "mrope":
                db["positions"] = torch.full((len(active), 1, 3), L + step,
                                             dtype=torch.long, device=dev)
            logits, cache = model.decode_step(self.params, cache, db)
            tok = logits[:, -1].argmax(dim=-1)
            toks = tok.tolist()
            n_steps += 1
            decoded += len(active)
        total = time.perf_counter() - t0
        return {"prefill_s": t_prefill, "total_s": total,
                "decode_steps": n_steps,
                "tok_per_s": decoded / max(total - t_prefill, 1e-9)}


class MultiModelServingEngine:
    """Interleaved multi-tenant serving under one shared weight budget.

    Wraps a planned :class:`~repro_torch.core.multi_model.MultiModelRuntime`:
    requests name the model they target and are served in arrival order,
    one at a time (the single-executor edge-device model; for K concurrent
    executors see :class:`repro_torch.core.serving_scheduler
    .ServingScheduler`). Every forward streams the target model's blocks
    through the shared ledger; hot units of recently served models stay in
    the shared cache.
    """

    def __init__(self, runtime):
        self.runtime = runtime

    def prefill(self, name: str, reqs: Sequence[Request]) -> torch.Tensor:
        """Swapped prefill of a same-model request batch; returns the
        last-position logits."""
        sm = self.runtime.models[name]
        logits, _ = self.runtime.forward(name, pad_prompts(sm.cfg, reqs))
        return logits

    def generate(self, tagged_reqs: Sequence[Tuple[str, Request]],
                 max_len: int = 128) -> Dict[str, float]:
        """Serve (model_name, request) pairs in order, greedy decoding each
        under the shared budget. Outputs land in ``request.output``."""
        t0 = time.perf_counter()
        for name, req in tagged_reqs:
            prompt = torch.as_tensor([req.prompt], dtype=torch.int32)
            gen, _ = self.runtime.decode(name, prompt,
                                         max_new_tokens=req.max_new_tokens,
                                         max_len=max_len)
            req.output.extend(int(t) for t in gen[0].tolist())
        st = self.runtime.stats()
        st["total_s"] = time.perf_counter() - t0
        st["requests"] = len(tagged_reqs)
        return st
