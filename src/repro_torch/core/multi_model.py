"""Multi-model swap runtime (paper §6 multi-DNN scheduling, end to end).

Several models co-reside under ONE memory budget:

  * a single shared :class:`MemoryLedger` spans every engine: the sum of
    all models' resident blocks, the shared cache and the KV pages is what
    must fit ``budget``;
  * a shared LRU :class:`BlockCache` keeps hot units assembled across
    requests, so repeat swap-ins of a recently served model skip the I/O
    and assembly path;
  * each model keeps its own depth-m prefetch pipeline.

The partition step reserves the cache, the pinned units and the KV pages
off the top and sizes every model's blocks against the remainder, so the
ledger can never exceed the budget however requests interleave.

With ``executors=K > 1`` the runtime supports K concurrent passes (one per
model at a time: the serving scheduler serializes same-model requests).
Each model's blocks are planned against a 1/K slice of the block budget
so any K co-running pipelines co-fit, engines switch to the ledger's
blocking ``reserve()`` (priority wakeup), and :meth:`replan_budgets`
re-splits the block budget with :class:`MultiDNNScheduler` (Eq. 1,
urgency-weighted) when the live queue mix shifts.

Streams under K executors. Every executor thread computes on the
device's default stream (a thread's current stream unless it picks
another, and no code here picks one), so the executors' device work runs
one kernel at a time in submission order while their host work, the
loaders and the copies overlap. That is the simple design, chosen because
it is correct without cross-stream bookkeeping: each loader copies on its
engine's own copy stream and waits for the copy before the unit is
handed over, and ``swap_schedule`` waits for the default stream before a
block is swapped out or a cached unit's lease is released. So when the
caching allocator may hand a block's memory out again, or the cache may
evict a unit another tenant read, no kernel of any executor still reads
it. A compute stream per executor would let two tenants' kernels run
side by side, but a tensor one stream allocated and another reads (a
cache entry made on tenant A's copy stream and read by tenant B) would
then need ``record_stream`` or an event; it is not done here.

With ``precision="mixed"`` on the quant store, :meth:`add_model` runs the
calibration pass (``repro_torch/calibrate``) on the arriving model against
the runtime's ``fidelity`` target and builds the store from the plan;
:meth:`MultiModelRuntime.from_config` builds the runtime from a resolved
``repro_torch.config.ServeConfig``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.core.cost_model import DelayModel
from repro_torch.core.partition import BlockPlan
from repro_torch.core.runtime import PassState, SwappedModel
from repro_torch.core.scheduler import MultiDNNScheduler, ScheduledModel
from repro_torch.core.swap_engine import (BlockCache, MemoryLedger,
                                          size_aware_policy)
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model


class MultiModelRuntime:
    """Owner of the shared ledger + cache and the per-model swapped
    runtimes.

    Usage::

        rt = MultiModelRuntime(budget=64e6, cache_frac=0.25)
        rt.add_model("qwen", model_a, params_a, workdir)
        rt.add_model("gemma", model_b, params_b, workdir)
        rt.plan(batch=2, seq=32)
        logits, stats = rt.forward("qwen", batch)       # interleave freely
    """

    def __init__(self, budget: int, mode: str = "snet",
                 prefetch_depth: int = 2, cache_frac: float = 0.25,
                 dm: Optional[DelayModel] = None, delta: float = 0.05,
                 store_backend: Optional[str] = None,
                 precision: Optional[str] = None,
                 executors: int = 1,
                 reserve_timeout: Optional[float] = 30.0,
                 kv_frac: float = 0.0, page_tokens: int = 16,
                 max_batch: int = 8,
                 fidelity: Optional[float] = None,
                 calib_method: str = "output",
                 calib_seed: int = 0,
                 device="cuda"):
        if not 0.0 <= cache_frac < 1.0:
            raise ValueError(f"cache_frac {cache_frac} outside [0, 1)")
        if not (0.0 <= kv_frac < 1.0 and cache_frac + kv_frac < 1.0):
            raise ValueError(f"kv_frac {kv_frac} with cache_frac "
                             f"{cache_frac} leaves no block budget")
        self.device = resolve_device(device)
        self.budget = int(budget)
        # paged-KV serving reserve: kv_frac of the budget is carved out for
        # KV pages before blocks are planned, so weight streaming and
        # decode batches co-fit under ONE ledger
        self.kv_frac = float(kv_frac)
        self.page_tokens = int(page_tokens)
        self.max_batch = int(max_batch)
        self._batch_engines: Dict[str, Any] = {}
        self.mode = mode
        self.store_backend = store_backend
        self.precision = precision
        # mixed-precision knobs: the fidelity target the calibration in
        # add_model solves against, and the profiler's method and seed
        self.fidelity = fidelity
        self.calib_method = calib_method
        self.calib_seed = int(calib_seed)
        self.prefetch_depth = max(prefetch_depth, 1)
        self.delta = delta
        self.executors = max(int(executors), 1)
        self.reserve_timeout = reserve_timeout
        self.dm = dm if dm is not None else DelayModel()
        self.cache_frac = float(cache_frac)
        self.ledger = MemoryLedger(self.budget)
        self.cache = BlockCache(int(self.budget * cache_frac), self.ledger)
        self.models: Dict[str, SwappedModel] = {}
        self._planned = False

    @classmethod
    def from_config(cls, cfg, device="cuda") -> "MultiModelRuntime":
        """Construct from a resolved :class:`repro_torch.config.ServeConfig`:
        every knob comes off its ``runtime`` section. Requires
        ``runtime.budget_mb``; the KV reserve is carved only when paging
        is on."""
        rt_cfg = cfg.runtime
        if rt_cfg.budget_mb is None:
            raise ValueError("runtime.budget_mb is required to build a "
                             "MultiModelRuntime (unswapped serving has no "
                             "shared ledger)")
        return cls(int(rt_cfg.budget_mb * 1e6),
                   prefetch_depth=rt_cfg.prefetch_depth,
                   cache_frac=rt_cfg.cache_frac,
                   store_backend=rt_cfg.store,
                   precision=rt_cfg.precision,
                   executors=rt_cfg.executors,
                   kv_frac=rt_cfg.kv_frac if rt_cfg.paged else 0.0,
                   page_tokens=rt_cfg.page_tokens,
                   max_batch=rt_cfg.max_batch,
                   fidelity=rt_cfg.fidelity,
                   device=device)

    # ------------------------------------------------------------ registry
    def add_model(self, name: str, model: Model, params: dict,
                  workdir: str,
                  store_backend: Optional[str] = None,
                  precision: Optional[str] = None,
                  store_options: Optional[dict] = None) -> SwappedModel:
        """``store_backend`` overrides the runtime default per model (a
        quant-ineligible config falls back to mmap either way);
        ``precision`` overrides the config's per-model swap precision
        (int8 | int4) for the quant backend; ``store_options`` passes extra
        backend build options through (the faulty backend's ``inner`` /
        ``p`` / ``seed``: how fault injection is wired into ONE tenant of
        a shared-ledger runtime).

        With ``precision='mixed'`` (per model or runtime-wide) and no
        ``plan`` in ``store_options``, registration runs the calibration
        pass HERE on the runtime's device: profile the arriving model on
        a synthetic batch, solve the assignment against ``self.fidelity``
        and build the quant store from the plan."""
        if name in self.models:
            raise ValueError(f"duplicate model name {name!r}")
        backend = store_backend or self.store_backend
        eff_precision = precision or self.precision
        if (backend == "quant" and eff_precision == "mixed"
                and model.cfg.quant_eligible
                and (store_options or {}).get("plan") is None):
            if self.fidelity is None:
                raise ValueError(
                    "precision='mixed' needs a fidelity target: construct "
                    "the runtime with fidelity=... (runtime.fidelity)")
            from repro_torch.calibrate import calibrate_model
            _, plan = calibrate_model(
                model, params, fidelity=self.fidelity,
                method=self.calib_method, seed=self.calib_seed, name=name,
                prefetch_depth=self.prefetch_depth, device=self.device)
            store_options = dict(store_options or {})
            store_options["plan"] = plan
        sm = SwappedModel(model, params, os.path.join(workdir, name),
                          mode=self.mode, prefetch_depth=self.prefetch_depth,
                          ledger=self.ledger, cache=self.cache, name=name,
                          store_backend=backend, precision=eff_precision,
                          store_options=store_options, device=self.device)
        if self.executors > 1:
            # concurrent passes: a transiently full ledger means WAIT for
            # another tenant's swap-out (priority wakeup), not fail
            sm.engine.reserve_blocking = True
            sm.engine.reserve_timeout = self.reserve_timeout
        self.models[name] = sm
        self._planned = False
        return sm

    def _pinned_bytes(self) -> int:
        """Bytes the engines pin into the cache regardless of capacity,
        at their RESIDENT cost through the engine's (mode-resolved) store."""
        total = 0
        for sm in self.models.values():
            total += sum(sm.engine.store.resident_nbytes(n)
                         for n in sm.engine.pinned
                         if n in sm.store.skeletons)
        return total

    def kv_reserve(self) -> int:
        """Bytes carved out of the budget for paged-KV decode batches."""
        return int(self.budget * self.kv_frac)

    def block_budget(self) -> int:
        """What is left for the models' resident blocks after the shared
        cache, the pinned units and the KV-page reserve take their cut."""
        return (self.budget - self.cache.capacity - self._pinned_bytes()
                - self.kv_reserve())

    # ------------------------------------------------------------ planning
    def plan(self, batch: int, seq: int) -> Dict[str, BlockPlan]:
        """Partition every registered model against the shared budget.

        Call after ALL models are registered: the cache + pinned reserve
        depends on the full co-resident set. With ``executors=K`` each model
        is planned against a 1/K slice of the block budget, so ANY K
        concurrently running pipelines co-fit."""
        b = self.block_budget()
        if b <= 0:
            raise ValueError(
                f"budget {self.budget/1e6:.1f} MB leaves no room for blocks "
                f"after cache {self.cache.capacity/1e6:.1f} MB + pinned "
                f"{self._pinned_bytes()/1e6:.1f} MB")
        per_exec = b // min(self.executors, max(len(self.models), 1))
        if per_exec <= 0:
            raise ValueError(
                f"block budget {b/1e6:.1f} MB split across "
                f"{self.executors} executors leaves none per pipeline")
        plans = {}
        for name, sm in self.models.items():
            plans[name] = sm.partition(per_exec, self.dm, batch, seq,
                                       delta=self.delta)
        # cache admission by the partition tables' per-unit sizes, costed
        # at their resident bytes through the mode-resolved reader
        sizes = {n: sm.engine.store.resident_nbytes(n)
                 for sm in self.models.values() for n in sm.store.order}
        self.cache.set_policy(size_aware_policy(sizes, self.cache.capacity))
        self._planned = True
        return plans

    def _require_planned(self) -> None:
        if not self._planned:
            raise RuntimeError("call plan() after registering all models")

    def replan_budgets(self, urgencies: Mapping[str, float]) -> Dict[str, float]:
        """React to the live queue mix: re-split the block budget across
        models with :class:`MultiDNNScheduler` (Eq. 1) instead of the
        uniform 1/K slice, weighting each model by the urgency of its
        queued work. Per-model budgets sum to the block budget, so ANY
        subset of models running concurrently still co-fits. Passes in
        flight keep their snapshotted block list (``PassState.blocks``).
        Returns the new per-model budgets."""
        self._require_planned()
        scheduled = [ScheduledModel(name, sm.planner,
                                    urgency=max(float(urgencies.get(name, 1.0)),
                                                1e-6))
                     for name, sm in self.models.items()]
        reserved = float(self.cache.capacity + self._pinned_bytes()
                         + self.kv_reserve())
        sched = MultiDNNScheduler(scheduled, available=float(self.budget),
                                  delta=self.delta, reserved=reserved)
        for s in sched.models:
            sm = self.models[s.name]
            sm.plan, sm.table = s.plan, s.table
        return {s.name: s.budget for s in sched.models}

    # ------------------------------------------------------------ serving
    def forward(self, name: str, batch: dict) -> Tuple[Any, Dict]:
        self._require_planned()
        return self.models[name].forward(batch)

    def forward_partial(self, name: str, batch: dict,
                        state: Optional[PassState] = None,
                        should_yield=None,
                        priority: float = 0.0) -> Tuple[PassState, Optional[Dict]]:
        """Resumable swapped pass for one model (the serving scheduler's
        entry point): ``priority`` tags the engine so its swap-ins get
        priority wakeup on the shared ledger; ``should_yield`` is consulted
        at every block boundary. Same-model calls must be serialized by
        the caller."""
        self._require_planned()
        sm = self.models[name]
        sm.engine.set_priority(priority)
        return sm.forward_partial(batch, state=state, should_yield=should_yield)

    def batch_engine(self, name: str):
        """The model's continuous-batching decode engine, built lazily on
        first use: its KV page pool is sized from an equal split of the KV
        reserve, on the runtime's device, and charged to the SHARED ledger,
        so one tenant's decode batches squeeze against every tenant's
        weight blocks. Requires ``kv_frac > 0``."""
        self._require_planned()
        if name not in self._batch_engines:
            if self.kv_reserve() <= 0:
                raise ValueError(
                    "paged decode needs a KV reserve: construct the runtime "
                    "with kv_frac > 0")
            from repro_torch.serving.batch_engine import BatchDecodeEngine
            from repro_torch.serving.paged_kv import PagedKVCache
            sm = self.models[name]
            kv = PagedKVCache.for_budget(
                sm.cfg, self.ledger,
                self.kv_reserve() // max(len(self.models), 1),
                page_tokens=self.page_tokens, name=name, device=self.device)
            self._batch_engines[name] = BatchDecodeEngine(
                sm, kv, max_batch=self.max_batch)
        return self._batch_engines[name]

    def decode(self, name: str, prompt_tokens, max_new_tokens: int = 8,
               max_len: int = 128) -> Tuple[Any, Dict]:
        self._require_planned()
        return self.models[name].decode_loop(prompt_tokens, max_new_tokens,
                                             max_len)

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        per_model = {}
        for name, sm in self.models.items():
            st = sm.engine.stats
            per_model[name] = {
                "n_blocks": sm.plan.n_blocks if sm.plan else None,
                "m": sm.plan.m if sm.plan else None,
                "overlap_efficiency": st.overlap_efficiency(),
                "cache_hit_rate": st.cache_hit_rate(),
                "bytes_swapped_mb": st.bytes_swapped / 1e6,
                "bytes_logical_mb": st.bytes_logical / 1e6,
                "bytes_resident_quantized_mb":
                    st.bytes_resident_quantized / 1e6,
                "bytes_by_precision_mb": {
                    p: b / 1e6 for p, b in st.bytes_by_precision.items()},
                "smem_working_set_mb": st.smem_working_set / 1e6,
                "store_backend": sm.store_backend,
                "precision": sm.precision,
                "retries": st.retries,
                "faults": dict(st.faults),
            }
        return {
            "budget_mb": self.budget / 1e6,
            "peak_resident_mb": self.ledger.peak / 1e6,
            "cache_capacity_mb": self.cache.capacity / 1e6,
            "cache_resident_mb": self.cache.resident_bytes / 1e6,
            "cache_hit_rate": self.cache.hit_rate(),
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "models": per_model,
        }

    def close(self) -> None:
        for sm in self.models.values():
            sm.close()
        self.cache.clear()
