"""Continuous-batching decode over the paged KV cache, composed with
SwapNet weight streaming.

The unit of work is one BATCHED decode step
(:meth:`~repro_torch.core.runtime.SwappedModel.decode_step_paged`): the
weight blocks stream through the memory window once per step and their
cost amortizes over every active sequence, while the resident set stays
m weight blocks plus the KV page pool.

Batch membership is re-decided EVERY step:

  * admission: pending requests join whenever a batch slot and their KV
    pages are available; a request's prompt is prefilled through the
    swapped pipeline (``forward_partial(collect_cache=True)``), its K/V
    written into the page pool, and the prefill argmax is its first token;
  * retirement: a sequence leaves the instant it hits its own
    ``max_new_tokens`` or EOS, returning its pages to the pool mid-flight;
  * preemption by recomputation: when the pool or the shared ledger cannot
    grow a sequence (weight blocks and KV pages compete under ONE budget),
    the lowest-priority / youngest sequences are evicted: their pages are
    freed and the request re-queued carrying (prompt, output). Greedy
    decode is deterministic, so re-admission prefills prompt + output and
    continues with the same tokens.

``run_until`` steps the whole batch until one sequence retires, yielding
only at decode-step boundaries. The step arithmetic (admission, eviction
order, trace) is the JAX package's (``repro.serving.batch_engine``), so
step traces compare across the two packages.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.runtime import SwappedModel
from repro_torch.errors import SwapError
from repro_torch.serving.engine import Request
from repro_torch.serving.paged_kv import PagedBatchView, PagedKVCache

__all__ = ["BatchDecodeEngine", "StepTrace"]


@dataclass
class StepTrace:
    """What one engine step did: the serving log the tests assert on."""
    step: int
    batch: List[int]                 # rids decoded this step
    admitted: List[int]              # rids admitted (prefilled) this step
    retired: List[int]               # rids retired this step
    preempted: List[int]             # rids evicted (recompute later)
    kv_pages: int                    # pool pages in use after the step
    occupancy: float                 # len(batch) / max_batch
    failed: List[int] = field(default_factory=list)   # rids evicted on an
    #                                  unrecoverable swap failure


@dataclass
class _Active:
    req: Request
    admit_step: int

    def sort_key(self, rid_order):
        # eviction victims come from the BACK of this order: lowest
        # priority first, then youngest admission
        return (-self.req.priority, self.admit_step, rid_order)


class BatchDecodeEngine:
    """Swap-aware continuous-batching decode for ONE model.

    ``sm`` must be partitioned; ``kv`` must be built on the same ledger as
    ``sm.engine`` for the weights-vs-KV budget arbitration to mean anything
    (``PagedKVCache.for_budget(cfg, sm.engine.ledger, ...)``), and on the
    same device.
    """

    def __init__(self, sm: SwappedModel, kv: PagedKVCache, *,
                 max_batch: int = 8):
        if kv.device != sm.device:
            raise ValueError(f"KV pool on {kv.device}, model on {sm.device}")
        self.sm = sm
        self.kv = kv
        self.max_batch = int(max_batch)
        self.trace: List[StepTrace] = []
        self.tokens_emitted = 0
        self.preemptions = 0
        self.failures = 0            # sequences evicted on swap failure
        self.decode_s = 0.0          # wall time inside batched decode steps
        self.prefill_s = 0.0
        self._pending: deque = deque()
        self._active: List[_Active] = []
        self._done: set = set()
        self._known: set = set()
        self._on_retire: Dict[int, Optional[Callable]] = {}
        self._step_no = 0
        self._lock = threading.Lock()        # pending / done / callbacks
        self._drive = threading.Lock()       # one step() at a time

    # ------------------------------------------------------------ intake
    def submit(self, req: Request,
               on_retire: Optional[Callable[[Request], None]] = None) -> None:
        with self._lock:
            if req.rid in self._known:
                raise ValueError(f"rid {req.rid} already known")
            self._known.add(req.rid)
            self._on_retire[req.rid] = on_retire
            self._pending.append(req)

    def cancel(self, rid: int) -> bool:
        """Un-submit a still-PENDING request (its retire callback never
        fires; the caller owns completion signalling). False once the
        request was admitted: an active sequence holds KV pages and a batch
        slot that must unwind through retire / evict, not removal."""
        with self._lock:
            for i, req in enumerate(self._pending):
                if req.rid == rid:
                    del self._pending[i]
                    self._known.discard(rid)
                    self._on_retire.pop(rid, None)
                    return True
        return False

    def is_done(self, rid: int) -> bool:
        with self._lock:
            return rid in self._done

    # ------------------------------------------------------------ helpers
    def _emit(self, req: Request, tok: int) -> bool:
        """Record one generated token; True when the request just finished."""
        req.output.append(tok)
        self.tokens_emitted += 1
        if req.eos is not None and tok == req.eos:
            return True
        return len(req.output) >= req.max_new_tokens

    def _retire(self, req: Request) -> None:
        self.kv.free(req.rid)
        with self._lock:
            self._done.add(req.rid)
            cb = self._on_retire.pop(req.rid, None)
        if cb is not None:
            cb(req)

    def _prefill(self, req: Request) -> int:
        """Swapped prefill over prompt + already-emitted output (the
        recompute path), K/V written into the page pool. Returns the argmax
        token, always a new one: a recomputed request replays its emitted
        tokens teacher-forced, so the last position is one past them."""
        tokens = list(req.prompt) + list(req.output)
        batch = {"tokens": torch.tensor([tokens], dtype=torch.int32)}
        state, _ = self.sm.forward_partial(batch, collect_cache=True)
        pids, slots = self.kv.slots(req.rid, range(len(tokens)))
        for lid, c in state.caches.items():
            self.kv.write_rows(lid, pids, slots, c["k"][0], c["v"][0])
        return int(state.logits[0, -1].argmax())

    # ------------------------------------------------------------ stepping
    def step(self) -> Optional[StepTrace]:
        """One continuous-batching iteration: admit, (maybe) preempt, decode
        one token for every active sequence, retire finishers. Returns the
        step's trace, or None when there was nothing at all to do."""
        with self._drive:
            return self._step_locked()

    def _step_locked(self) -> Optional[StepTrace]:
        admitted: List[int] = []
        retired: List[int] = []
        preempted: List[int] = []
        failed: List[int] = []

        # -- admission: fill free batch slots while pages are available
        while len(self._active) < self.max_batch:
            with self._lock:
                if not self._pending:
                    break
                req = self._pending.popleft()
            n_ctx = len(req.prompt) + len(req.output)
            if not self.kv.alloc(req.rid, n_ctx):
                with self._lock:
                    self._pending.appendleft(req)
                if not self._active and self.kv.pages_in_use == 0:
                    raise MemoryError(
                        f"request {req.rid}: {n_ctx}-token context needs "
                        f"more KV pages than the budget ever provides "
                        f"({self.kv.max_pages} x {self.kv.page_tokens} tok)")
                break
            t0 = time.perf_counter()
            try:
                tok = self._prefill(req)
            except SwapError as e:
                # unrecoverable prefill failure (the loader's retries are
                # spent): evict THIS sequence, free its pages, surface the
                # error through its retire callback, keep admitting
                self.prefill_s += time.perf_counter() - t0
                if e.model is None:
                    e.model = self.sm.name
                req.error = e
                self.failures += 1
                failed.append(req.rid)
                self._retire(req)
                continue
            self.prefill_s += time.perf_counter() - t0
            admitted.append(req.rid)
            if self._emit(req, tok):
                self._retire(req)
                retired.append(req.rid)
            else:
                self._active.append(_Active(req, self._step_no))

        if not self._active:
            if not admitted and not failed:
                with self._lock:
                    if not self._pending:
                        return None
            tr = StepTrace(self._step_no, [], admitted, retired, [],
                           self.kv.pages_in_use, 0.0, failed=failed)
            self.trace.append(tr)
            self._step_no += 1
            return tr

        # -- grow every sequence by one token; evict from the back of the
        #    priority order when pages / ledger budget run out
        order = sorted(range(len(self._active)),
                       key=lambda i: self._active[i].sort_key(i))
        ranked = [self._active[i] for i in order]
        survivors: List[_Active] = []
        i = 0
        while i < len(ranked):
            a = ranked[i]
            if self.kv.extend(a.req.rid, 1):
                survivors.append(a)
                i += 1
                continue
            if len(ranked) > i + 1:          # evict the weakest victim
                victim = ranked.pop()
            else:                            # alone and stuck: evict self
                victim = ranked.pop(i)
            self.kv.free(victim.req.rid)
            self.preemptions += 1
            preempted.append(victim.req.rid)
            with self._lock:
                self._pending.appendleft(victim.req)
        self._active = survivors

        # -- one batched decode step for the survivors
        if self._active:
            t0 = time.perf_counter()
            rids = [a.req.rid for a in self._active]
            view = PagedBatchView(self.kv, rids)
            batch = {"token": torch.tensor(
                         [[a.req.output[-1]] for a in self._active],
                         dtype=torch.int32),
                     "pos": torch.from_numpy(
                         view.host_seq_lens.astype(np.int64) - 1)}
            if self.sm.cfg.rope_type == "mrope":
                batch["positions"] = batch["pos"][:, None, None].expand(
                    len(rids), 1, 3)
            logits = self.sm.decode_step_paged(batch, view)
            toks = logits[:, -1].argmax(dim=-1).tolist()
            self.decode_s += time.perf_counter() - t0
            still: List[_Active] = []
            for a, tok in zip(self._active, toks):
                if self._emit(a.req, int(tok)):
                    self._retire(a.req)
                    retired.append(a.req.rid)
                else:
                    still.append(a)
            self._active = still
        else:
            rids = []

        tr = StepTrace(self._step_no, rids, admitted, retired, preempted,
                       self.kv.pages_in_use, len(rids) / self.max_batch,
                       failed=failed)
        self.trace.append(tr)
        self._step_no += 1
        return tr

    # ------------------------------------------------------------ driving
    def run_until(self, rid: int,
                  should_yield: Optional[Callable[[], bool]] = None) -> bool:
        """Step the WHOLE batch until sequence ``rid`` retires (True) or
        ``should_yield()`` fires at a decode-step boundary (False: the
        caller re-enters later; the batch keeps its state either way)."""
        with self._lock:
            if rid not in self._known:
                raise KeyError(f"rid {rid} was never submitted")
        while True:
            if self.is_done(rid):
                return True
            if should_yield is not None and should_yield():
                return False
            if self.step() is None:
                return self.is_done(rid)

    def run_all(self) -> None:
        """Drain everything."""
        while self.step() is not None:
            pass

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        decoded = [t for t in self.trace if t.batch]
        occ = [t.occupancy for t in decoded]
        return {
            "steps": float(self._step_no),
            "decode_steps": float(len(decoded)),
            "tokens_emitted": float(self.tokens_emitted),
            "preemptions": float(self.preemptions),
            "failures": float(self.failures),
            "mean_occupancy": float(np.mean(occ)) if occ else 0.0,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "tok_per_s": (self.tokens_emitted
                          / max(self.prefill_s + self.decode_s, 1e-9)),
            "kv_pages_peak": float(max((t.kv_pages for t in self.trace),
                                       default=0)),
        }
