"""Block swapping controller (paper §4): swap-in / swap-out executor.

Storage is a pluggable tier (``repro_torch.store``): the engine asks its
:class:`~repro_torch.store.base.BlockStore` for each unit and does the
bookkeeping: wall-clock (t_in split into I/O + assembly, t_out, and the
stall time the executor spends waiting on prefetch futures), actual
storage->host traffic (``SwapStats.bytes_swapped``), and a resident-bytes
ledger (peak is what the paper's Figs. 11-13 report).

The paper's ablation arms (Fig. 15) are the engine's ``mode`` flag,
resolved against the store (:func:`repro_torch.store.base.as_reader`):
  * "snet"      — read the store through its own backend;
  * "copy_in"   — w/o-uni-add: reinterpret a raw store through RawIOStore
                  (read() page-cache copy + staging copy + device copy, +
                  the dispatch copy with ``gpu_dispatch``);
  * "dummy_asm" — w/o-mod-ske: zero-copy I/O but framework-default dummy
                  assembly (one copy per tensor, 2x resident).

The ledger may be PRIVATE (one model) or SHARED across several engines
(co-resident models under one budget). Prefetch runs on a single loader
thread: one swap-in channel, matching the paper's pipeline model, at any
queue depth m >= 1. On a CUDA device the loader issues every device copy
(and the eager dequant) on a dedicated copy stream, and each read waits
for its work on that stream before the future resolves, so the executor
only ever receives a finished unit.

An optional LRU BlockCache keeps hot units resident across requests;
cached bytes are charged to the shared ledger exactly once.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from repro_torch.errors import SwapError, SwapIOError, SwapTimeoutError
from repro_torch.kernels.qtensor import QuantizedTensor
from repro_torch.store.base import BlockStore, as_reader
from repro_torch.tree import tree_leaves

__all__ = ["MemoryLedger", "BlockCache", "size_aware_policy", "BlockHandle",
           "SwapStats", "SwapEngine"]


# ------------------------------------------------------------------ ledger
class MemoryLedger:
    """Resident-bytes accounting, optionally shared by several SwapEngines.

    One ledger == one memory budget: when co-resident models each hold blocks
    (plus the shared block cache), the SUM of their bytes is what must stay
    under budget — per-engine ledgers cannot see each other's residency.
    Thread-safe: loader threads add while executor threads drop; a running
    total keeps every operation O(1) so the lock is held for nanoseconds
    (concurrent executors contend on it at every block boundary).

    Two admission paths:

      * :meth:`add` — immediate: over budget raises ``MemoryError`` (the
        single-tenant semantics: a plan whose blocks don't fit is a
        scheduling bug, fail loudly);
      * :meth:`reserve` — blocking: over budget WAITS until other tenants
        drop bytes, with PRIORITY WAKEUP — when bytes free, the
        highest-priority waiter is admitted first (FIFO within one priority
        class), so a high-urgency request's swap-ins never queue behind a
        batch tenant's. Used by concurrent serving (``executors > 1``).
    """

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget
        self._entries: Dict[object, int] = {}
        self._total = 0
        self._cond = threading.Condition()
        # active reserve() tickets, ordered by (-priority, seq): the minimum
        # ticket is the next waiter allowed to admit (anti-inversion barrier)
        self._waiting: List[tuple] = []
        self._seq = 0
        self.peak = 0

    @property
    def resident(self) -> int:
        with self._cond:
            return self._total

    def _admit_locked(self, key: object, nbytes: int) -> bool:
        """Try to charge under the lock; False if it would exceed budget."""
        delta = nbytes - self._entries.get(key, 0)
        if self.budget is not None and self._total + delta > self.budget:
            return False
        self._entries[key] = nbytes
        self._total += delta
        self.peak = max(self.peak, self._total)
        return True

    def add(self, key: object, nbytes: int, what: str = "block") -> int:
        """Charge ``nbytes``; returns the post-add resident total. Over
        budget: nothing is recorded before raising, so one rejected request
        cannot permanently inflate a ledger other tenants share."""
        with self._cond:
            if self._admit_locked(key, nbytes):
                return self._total
            total = self._total + nbytes
        # The paper treats this as a scheduling bug: blocks must fit b.
        raise MemoryError(
            f"resident {total/1e6:.1f} MB exceeds budget "
            f"{self.budget/1e6:.1f} MB (while adding {what})")

    def try_add(self, key: object, nbytes: int) -> bool:
        """Non-raising add: False (and no charge) if over budget. The cache
        insertion path — under concurrency a transiently full ledger means
        "don't cache this unit", not "kill the request"."""
        with self._cond:
            return self._admit_locked(key, nbytes)

    def reserve(self, key: object, nbytes: int, what: str = "block",
                priority: float = 0.0,
                timeout: Optional[float] = None) -> int:
        """Blocking add: wait until ``nbytes`` fit under the budget.

        Waiters are admitted highest-priority-first (ties FIFO); while a
        higher-priority waiter is pending, later lower-priority arrivals
        queue behind it even if they would fit — admitting them could eat
        the bytes the urgent request is waiting for (priority inversion).
        ``timeout`` bounds the wait (None = forever); on expiry, or when
        ``nbytes`` alone exceed the budget, raises ``MemoryError``.
        """
        if self.budget is not None and nbytes > self.budget:
            raise MemoryError(
                f"{what}: {nbytes/1e6:.1f} MB can never fit budget "
                f"{self.budget/1e6:.1f} MB")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._seq += 1
            ticket = (-float(priority), self._seq)
            self._waiting.append(ticket)
            try:
                while True:
                    if (min(self._waiting) == ticket
                            and self._admit_locked(key, nbytes)):
                        return self._total
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise MemoryError(
                                f"reserve timeout: {nbytes/1e6:.1f} MB for "
                                f"{what} did not fit budget "
                                f"{(self.budget or 0)/1e6:.1f} MB within "
                                f"{timeout:.1f}s "
                                f"(resident {self._total/1e6:.1f} MB)")
                        self._cond.wait(remaining)
                    else:
                        self._cond.wait()
            finally:
                self._waiting.remove(ticket)
                # our departure may unblock the next-best waiter
                self._cond.notify_all()

    def drop(self, key: object) -> None:
        with self._cond:
            nbytes = self._entries.pop(key, None)
            if nbytes is not None:
                self._total -= nbytes
                self._cond.notify_all()


# ------------------------------------------------------------------ cache
def size_aware_policy(unit_sizes: Mapping[str, int],
                      capacity: int) -> Callable[[str, int], bool]:
    """Admission informed by the partition table's per-unit sizes: admit
    exactly the units small enough that the whole admitted set provably
    co-fits in ``capacity``.

    The threshold is the largest size s such that EVERY unit of size <= s
    fits in ``capacity`` together (distinct sizes ascending, whole size
    classes at a time: admitting some but not all units of one size would
    let the marginal ones thrash the cyclic block scan). Unknown names
    fall back to their observed size.
    """
    sizes = sorted(s for s in unit_sizes.values() if s > 0)
    cum, threshold, i = 0, 0, 0
    while i < len(sizes):
        j = i
        while j < len(sizes) and sizes[j] == sizes[i]:
            j += 1
        group = sizes[i] * (j - i)
        if cum + group > capacity:
            break
        cum += group
        threshold = sizes[i]
        i = j

    def policy(name: str, nbytes: int) -> bool:
        size = unit_sizes.get(name, nbytes)
        return 0 < size <= threshold

    return policy


class BlockCache:
    """LRU cache of assembled units, shared across engines and requests.

    Entries are charged to the ledger once under a per-name key — a unit
    shared by two models (or referenced by several in-flight handles) never
    double-counts. Entries pinned via :meth:`pin` are never evicted (the
    engine's ``pinned=``); other entries are evicted LRU-first once
    ``capacity`` bytes are exceeded, but only when no handle still references
    them (refcounted, so the ledger never loses sight of live bytes).

    Admission is a pluggable ``policy`` (``(name, nbytes) -> bool``). The
    default (None) is thresholded: only units no larger than ``admit_frac``
    of capacity enter. A block traversal is a cyclic scan, so
    admit-everything LRU would evict each unit just before its next use and
    hit 0%. :func:`size_aware_policy` upgrades this with the partition
    table's per-unit sizes (installed by ``MultiModelRuntime.plan``)."""

    def __init__(self, capacity: int, ledger: MemoryLedger,
                 admit_frac: float = 0.25,
                 policy: Optional[Callable[[str, int], bool]] = None):
        self.capacity = capacity
        self.admit_frac = admit_frac
        self.policy = policy
        self.ledger = ledger
        self._lock = threading.RLock()
        # name -> [params, ledger_bytes, refcount]
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        self._pinned: set = set()
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------ policy
    def pin(self, names: Sequence[str]) -> None:
        with self._lock:
            self._pinned.update(names)

    @property
    def pinned(self) -> frozenset:
        with self._lock:
            return frozenset(self._pinned)

    def set_policy(self,
                   policy: Optional[Callable[[str, int], bool]]) -> None:
        with self._lock:
            self.policy = policy

    def admits(self, name: str, nbytes: int) -> bool:
        """Pinned units always enter; others through the admission policy
        (per-unit-size aware when installed, else ``admit_frac`` of
        capacity). ``nbytes`` is the unit's RESIDENT cost when cached."""
        with self._lock:
            if name in self._pinned:
                return True
            if self.policy is not None:
                return self.policy(name, nbytes)
            return 0 < nbytes <= self.capacity * self.admit_frac

    # ------------------------------------------------------------ lookup
    def acquire(self, name: str, count: bool = True):
        """Return cached params (bumping LRU + refcount) or None."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                if count:
                    self.misses += 1
                return None
            self._entries.move_to_end(name)
            e[2] += 1
            if count:
                self.hits += 1
            return e[0]

    def release(self, name: str) -> None:
        with self._lock:
            e = self._entries.get(name)
            if e is not None:
                e[2] = max(e[2] - 1, 0)

    def put(self, name: str, params, ledger_bytes: int) -> bool:
        """Insert (idempotent) and evict LRU unpinned idle entries to fit.
        Returns whether the unit is cache-resident afterwards: a transiently
        full shared ledger declines the insert (False) instead of raising —
        under concurrency "can't cache right now" must not kill the request
        (the caller charges its own handle instead)."""
        with self._lock:
            if name in self._entries:
                return True
            # charge first: if the ledger declines (budget), nothing inserted
            if not self.ledger.try_add(("cache", name), ledger_bytes):
                return False
            self._entries[name] = [params, ledger_bytes, 0]
            self._evict_to_capacity()
            return name in self._entries

    def _evict_to_capacity(self) -> None:
        over = self._unpinned_bytes() - self.capacity
        if over <= 0:
            return
        for name in list(self._entries):
            if over <= 0:
                break
            e = self._entries[name]
            if name in self._pinned or e[2] > 0:
                continue
            over -= e[1]
            del self._entries[name]
            self.ledger.drop(("cache", name))

    def _unpinned_bytes(self) -> int:
        return sum(e[1] for n, e in self._entries.items()
                   if n not in self._pinned)

    # ------------------------------------------------------------ stats
    def active_leases(self) -> Dict[str, int]:
        """Entries some in-flight handle still references (name ->
        refcount). Outside a pass this must be EMPTY — a non-zero refcount
        with no live handle is a leaked lease that makes the entry
        unevictable forever; the fault-path regression tests assert on it."""
        with self._lock:
            return {n: e[2] for n, e in self._entries.items() if e[2] > 0}

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e[1] for e in self._entries.values())

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def clear(self) -> None:
        with self._lock:
            for name in list(self._entries):
                self.ledger.drop(("cache", name))
            self._entries.clear()


# ------------------------------------------------------------------ handles
def device_bytes(trees) -> int:
    """Bytes of the storages behind the tensors of ``trees``, each storage
    counted once: a unit cut out of one swapped-in buffer counts that
    buffer; a ``QuantizedTensor`` counts its payload and scales."""
    storages: Dict[int, int] = {}
    for leaf in tree_leaves(list(trees)):
        parts = ((leaf.q, leaf.scales) if isinstance(leaf, QuantizedTensor)
                 else (leaf,))
        for t in parts:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


@dataclass
class BlockHandle:
    names: List[str]
    params: List[dict]           # assembled (by reference) param trees
    nbytes: int                  # logical (dequantized) block bytes
    resident_bytes: int          # what the block charges the ledger
    io_s: float = 0.0
    asm_s: float = 0.0
    cached_names: List[str] = field(default_factory=list)
    device_bytes: int = 0        # storage its own (uncached) tensors occupy


@dataclass
class SwapStats:
    """Wall-clock + byte accounting of one engine. The three byte currencies
    the ledger report distinguishes:

      * ``bytes_logical``            — LOGICAL (dequantized) bytes the
                                       swap-ins delivered;
      * ``bytes_swapped``            — STREAMED: actual storage->host I/O
                                       traffic (quantized backends move
                                       4-8x less than logical);
      * ``bytes_resident_quantized`` — RESIDENT-quantized: payload bytes
                                       delivered still in quantized form
                                       (``QuantizedTensor`` leaves, the
                                       fused path) — these stay quantized
                                       in device memory and in the
                                       kernel's weight stream.

    ``smem_working_set`` is the per-kernel figure: shared memory one block
    of the weight-stream matmul holds at this engine's store precision
    (set by the runtime from ``kernels.swap_linear.smem_bytes`` for fp
    units and ``kernels.swap_linear_q.smem_bytes`` for quantized ones; 0
    until the runtime sets it).

    ``timeline`` is the per-stage event log the overlap analysis runs on:
    ``(stage, start, end)`` tuples in ``time.perf_counter`` absolute
    seconds. Loader-side stages come from each :class:`UnitRead` ("read" =
    storage -> host, "unpack" = dequant/assembly, "dispatch" = host ->
    device incl. the on-device flush); the engine adds executor-side
    events ("wait" = stall on a prefetch future, "exec" = block compute).
    A healthy depth-m pipeline shows block i+1's "read" span INSIDE block
    i's "exec" span — :meth:`overlap_seconds` measures exactly that, so a
    serialization point is attributable to the stage that caused it
    instead of disappearing into an aggregate latency."""
    t_in: List[float] = field(default_factory=list)
    t_in_io: List[float] = field(default_factory=list)
    t_in_asm: List[float] = field(default_factory=list)
    t_ex: List[float] = field(default_factory=list)
    t_out: List[float] = field(default_factory=list)
    t_wait: List[float] = field(default_factory=list)   # executor stalls
    timeline: List[tuple] = field(default_factory=list)
    peak_resident: int = 0
    # peak of the bytes the resident blocks' own tensors occupy on the
    # device (:func:`device_bytes`, cache entries excluded): what the
    # ledger's charge stands for. Eager quant charges the stored payload
    # while it holds the dequantized leaves, so there this runs ~4x over.
    peak_device_weights: int = 0
    bytes_swapped: int = 0       # actual storage->host I/O traffic
    bytes_logical: int = 0       # dequantized bytes those swap-ins delivered
    bytes_resident_quantized: int = 0   # delivered still-quantized (fused)
    smem_working_set: int = 0    # per-kernel shared memory at this precision
    cache_hits: int = 0
    cache_misses: int = 0
    # fault accounting: ``retries`` counts re-read attempts the loader
    # burned recovering; ``faults`` tallies
    # every failed read attempt by taxonomy class (SwapIOError /
    # SwapCorruptionError / SwapTimeoutError) INCLUDING the ones retries
    # absorbed — a healthy-looking pass over flaky storage is visible here.
    # The timeline gains "retry" spans covering each backoff sleep.
    retries: int = 0
    faults: Dict[str, int] = field(default_factory=dict)
    # streamed I/O split by STORED precision ({"fp"|"int8"|"int4": bytes},
    # summing to ``bytes_swapped``): under a mixed-precision plan this is
    # the realized per-precision byte breakdown; uniform stores report one
    # bucket (their precision, "fp" for exact backends).
    bytes_by_precision: Dict[str, int] = field(default_factory=dict)

    # ------------------------------------------------------------ timeline
    def stage_spans(self, stage: str) -> List[tuple]:
        """All ``(start, end)`` spans recorded for ``stage``, in log order."""
        return [(s, e) for st, s, e in self.timeline if st == stage]

    def stage_seconds(self, stage: str) -> float:
        """Total wall-clock spent in ``stage`` across the log."""
        return sum(e - s for _, s, e in
                   (ev for ev in self.timeline if ev[0] == stage))

    def overlap_seconds(self, stage_a: str, stage_b: str) -> float:
        """Wall-clock during which ``stage_a`` and ``stage_b`` ran
        CONCURRENTLY (intersection of their merged span sets) — e.g.
        ``overlap_seconds("read", "exec")`` is the host-read time genuinely
        hidden behind compute, the quantity the fused-path fix targets."""

        def merged(stage):
            spans = sorted(self.stage_spans(stage))
            out: List[List[float]] = []
            for s, e in spans:
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            return out

        a, b = merged(stage_a), merged(stage_b)
        total, i, j = 0.0, 0, 0
        while i < len(a) and j < len(b):
            lo = max(a[i][0], b[j][0])
            hi = min(a[i][1], b[j][1])
            if hi > lo:
                total += hi - lo
            if a[i][1] < b[j][1]:
                i += 1
            else:
                j += 1
        return total

    def overlap_efficiency(self) -> float:
        """Fraction of total swap-in time hidden behind execution: 1.0 means
        the executor never stalled on a prefetch (paper Fig. 10's ideal);
        0.0 means every swap-in was fully visible (serial)."""
        total_in = sum(self.t_in)
        if total_in <= 0.0:
            return 1.0
        return max(0.0, 1.0 - sum(self.t_wait) / total_in)

    def cache_hit_rate(self) -> float:
        n = self.cache_hits + self.cache_misses
        return self.cache_hits / n if n else 0.0


class SwapEngine:
    """One model's swap-in/swap-out executor over a pluggable BlockStore.

    ``ledger`` and ``cache`` may be shared with other engines (multi-model
    serving under one budget); by default each engine gets a private ledger
    seeded from ``budget`` and a pin-only cache (capacity 0: only ``pinned``
    units are retained). ``mode`` selects the paper's ablation arms against
    a raw-format store (see the module docstring)."""

    def __init__(self, store: BlockStore, mode: str = "snet",
                 budget: Optional[int] = None, gpu_dispatch: bool = False,
                 pinned: Sequence[str] = (),
                 ledger: Optional[MemoryLedger] = None,
                 cache: Optional[BlockCache] = None):
        self.store = as_reader(store, mode=mode, gpu_dispatch=gpu_dispatch)
        self.mode = mode
        self.gpu_dispatch = gpu_dispatch
        self.device = store.device
        self.ledger = ledger if ledger is not None else MemoryLedger(budget)
        self.cache = cache if cache is not None else BlockCache(0, self.ledger)
        self.cache.pin(pinned)
        self.stats = SwapStats()
        self._weights_lock = threading.Lock()
        self._device_weights = 0     # device_bytes of the live handles
        # per-kernel shared-memory working set of the fused dequant-matmul
        # at this store's precision; the runtime sets it and swap_in
        # republishes it into stats so resets don't lose it
        self.smem_working_set = 0
        # concurrent serving (set by MultiModelRuntime when executors > 1):
        # reserve_blocking makes an over-budget swap-in WAIT for other
        # tenants to free bytes (priority wakeup) instead of raising;
        # priority is the urgency of the request this engine serves (one
        # pass per engine at a time); the timeout turns a cross-tenant
        # deadlock into a loud MemoryError
        self.reserve_blocking = False
        self.reserve_timeout: Optional[float] = 30.0
        self.priority = 0.0
        # fault tolerance: a failed unit read is retried up to
        # ``read_retries`` times with exponential backoff from
        # ``retry_backoff_s``; ``read_deadline_s`` bounds one read attempt
        # (a late read is discarded as SwapTimeoutError, retryable)
        self.read_retries = 2
        self.retry_backoff_s = 0.01
        self.read_deadline_s: Optional[float] = None
        # the loader's own CUDA stream: swap-in copies overlap the compute
        # stream's work instead of queueing behind it
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._loader = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="swapnet-loader")

    def _on_copy_stream(self):
        if self.copy_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.copy_stream)

    # -------------------------------------------------------------- ledger
    @property
    def pinned(self) -> frozenset:
        """The cache is the single source of truth for pinned-ness (a shared
        cache may pin units for several engines; callers filter by store)."""
        return self.cache.pinned

    @property
    def budget(self) -> Optional[int]:
        return self.ledger.budget

    @property
    def resident_bytes(self) -> int:
        return self.ledger.resident

    def set_priority(self, priority: float) -> None:
        """Urgency of the request this engine is currently serving; swap-ins
        issued on the loader thread inherit it for ledger priority wakeup."""
        self.priority = float(priority)

    def _ledger_add(self, handle: BlockHandle) -> None:
        what = (f"block[{','.join(handle.names[:3])}...]"
                if len(handle.names) > 3
                else f"block[{','.join(handle.names)}]")
        if self.reserve_blocking:
            total = self.ledger.reserve(id(handle), handle.resident_bytes,
                                        what, priority=self.priority,
                                        timeout=self.reserve_timeout)
        else:
            total = self.ledger.add(id(handle), handle.resident_bytes, what)
        # per-engine peak = residency observed while THIS engine was adding;
        # resettable via stats.__init__() (the ledger's .peak is the
        # monotone lifetime number the multi-model stats report).
        self.stats.peak_resident = max(self.stats.peak_resident, total)

    # -------------------------------------------------------------- swap-in
    def _read_with_retry(self, name: str):
        """One unit read through the fault-tolerance tier: normalize store
        exceptions to the SwapError taxonomy, enforce the per-read deadline,
        retry with exponential backoff. Returns the clean ``UnitRead``; what
        escapes the retries carries ``unit``/``attempts`` context for the
        scheduler tier. Runs on the loader thread (like the read itself)."""
        delay = self.retry_backoff_s
        attempt = 0
        while True:
            attempt += 1
            t0 = time.perf_counter()
            try:
                r = self.store.read_unit(name)
            except SwapError as e:
                err = e
            except OSError as e:
                err = SwapIOError(f"unit {name!r}: {e}", unit=name)
                err.__cause__ = e
            else:
                took = time.perf_counter() - t0
                if (self.read_deadline_s is None
                        or took <= self.read_deadline_s):
                    return r
                # late data is failed data: keeping it would let one slow
                # read stretch the pipeline unboundedly — discard and retry
                err = SwapTimeoutError(
                    f"unit {name!r}: read took {took * 1e3:.1f} ms, "
                    f"deadline {self.read_deadline_s * 1e3:.1f} ms",
                    unit=name)
            kind = type(err).__name__
            self.stats.faults[kind] = self.stats.faults.get(kind, 0) + 1
            if attempt > self.read_retries:
                err.attempts = attempt
                raise err
            self.stats.retries += 1
            s0 = time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            self.stats.timeline.append(("retry", s0, time.perf_counter()))
            delay *= 2

    def swap_in(self, names: Sequence[str]) -> BlockHandle:
        params: List[dict] = []
        cached: List[str] = []
        total, ledger, loaded, io_s, asm_s = 0, 0, 0, 0.0, 0.0
        try:
            with self._on_copy_stream():
                for name in names:
                    hit = self.cache.acquire(name)
                    if hit is not None:
                        params.append(hit)
                        cached.append(name)
                        self.stats.cache_hits += 1
                        continue
                    r = self._read_with_retry(name)
                    n = self.store.nbytes(name)
                    params.append(r.params)
                    io_s += r.io_s
                    asm_s += r.asm_s
                    loaded += r.io_bytes
                    self.stats.timeline.extend(r.stages)
                    self.stats.bytes_logical += n
                    self.stats.bytes_resident_quantized += r.quantized_bytes
                    # per-precision I/O split: mixed stores report it per read;
                    # single-precision backends bucket the whole read under the
                    # store's precision ("fp" for exact ones)
                    pb = r.precision_bytes
                    if pb is None:
                        pb = {getattr(self.store, "precision", "fp"): r.io_bytes}
                    for prec, b in pb.items():
                        if b:
                            self.stats.bytes_by_precision[prec] = \
                                self.stats.bytes_by_precision.get(prec, 0) + b
                    self.stats.cache_misses += 1
                    # admission reasons in the unit's RESIDENT cost, exactly
                    # what the cache entry will charge the ledger (the
                    # quantized payload for quant): sizing by stored bytes
                    # would admit sets that overflow capacity and thrash
                    # the cyclic scan to a 0% hit rate.
                    if (n and self.cache.admits(name, r.ledger_bytes)
                            and self.cache.put(name, r.params, r.ledger_bytes)):
                        # hot unit: retained across requests, charged to the
                        # ledger once under the cache's key — not this handle's.
                        if self.cache.acquire(name, count=False) is not None:
                            cached.append(name)
                        else:           # raced out by eviction: charge the handle
                            total += n
                            ledger += r.ledger_bytes
                    else:
                        total += n
                        ledger += r.ledger_bytes
                handle = BlockHandle(list(names), params, total, ledger,
                                     io_s, asm_s, cached_names=cached)
                self._ledger_add(handle)
                handle.device_bytes = device_bytes(
                    p for n, p in zip(names, params) if n not in cached)
                with self._weights_lock:
                    self._device_weights += handle.device_bytes
                    self.stats.peak_device_weights = max(
                        self.stats.peak_device_weights, self._device_weights)
        except BaseException:
            # failed partway (I/O error, ledger rejection): no handle will
            # ever be swapped out, so drop the cache leases taken above:
            # a leaked refcount would make those entries unevictable forever.
            for name in cached:
                self.cache.release(name)
            raise
        self.stats.t_in.append(io_s + asm_s)
        self.stats.t_in_io.append(io_s)
        self.stats.t_in_asm.append(asm_s)
        self.stats.smem_working_set = self.smem_working_set
        self.stats.bytes_swapped += loaded   # actual I/O traffic: cache hits
        return handle                        # skip it, admitted loads count

    def prefetch(self, names: Sequence[str]) -> Future:
        """Pipelined prefetch: the loader thread fetches upcoming blocks while
        the executor runs the current one (paper Fig. 10). A single loader
        thread = one swap-in channel; queue depth is the caller's m-1."""
        return self._loader.submit(self.swap_in, list(names))

    def wait(self, fut: Future) -> BlockHandle:
        """Block on a prefetch future, recording the stall as visible t_in."""
        t0 = time.perf_counter()
        handle = fut.result()
        t1 = time.perf_counter()
        self.stats.t_wait.append(t1 - t0)
        self.stats.timeline.append(("wait", t0, t1))
        return handle

    # -------------------------------------------------------------- swap-out
    def swap_out(self, handle: BlockHandle) -> float:
        """Write-back-free: parameters are immutable, drop references, GC.
        Cache-resident units merely drop their lease. Returns t_out.

        The caller must have waited for the compute stream's work on the
        block first (the runtime synchronizes at every block boundary):
        the ledger then says "freed" only once nothing reads the memory,
        and the caching allocator may hand it to the next swap-in."""
        t0 = time.perf_counter()
        handle.params = []
        with self._weights_lock:
            self._device_weights -= handle.device_bytes
        handle.device_bytes = 0
        for name in handle.cached_names:
            self.cache.release(name)
        handle.cached_names = []
        self.ledger.drop(id(handle))
        gc.collect(0)
        dt = time.perf_counter() - t0
        self.stats.t_out.append(dt)
        return dt

    def record_exec(self, seconds: float) -> None:
        """Executor-side compute accounting: called right after a block's
        forward with its wall-clock, so the "exec" timeline span is the
        interval ending now."""
        now = time.perf_counter()
        self.stats.t_ex.append(seconds)
        self.stats.timeline.append(("exec", now - seconds, now))

    def close(self) -> None:
        self._loader.shutdown(wait=True)
