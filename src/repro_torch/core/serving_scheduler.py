"""Priority/urgency-aware concurrent request scheduling (paper §6, grown
into an actual serving system).

A single executor serializes every request: a high-urgency request queued
behind a batch tenant's full pass eats that pass's whole latency. This
module adds the serving layer the multi-DNN showcase implies:

  * :class:`ServingRequest`  — one unit of work (model, batch, priority,
    optional deadline); admission order is the urgency-weighted deadline
    ``arrival + slack / priority`` (weighted EDF: urgency divides the slack,
    so a priority-8 request with the same slack sorts like one whose
    deadline is 8x nearer; aging via ``arrival`` prevents starvation —
    preempted or passed-over requests keep their original arrival and
    eventually become the most urgent work in the queue);
  * :class:`RequestQueue`    — thread-safe admission queue over that order,
    with model-busy filtering (same-model passes must serialize: one
    engine, one prefetch pipeline per model);
  * :class:`ServingScheduler` — K executor threads over one planned
    :class:`~repro_torch.core.multi_model.MultiModelRuntime`. Different models
    run truly concurrently (the runtime plans 1/K block-budget slices so
    K pipelines co-fit; the shared ledger's blocking ``reserve()`` with
    priority wakeup covers transients). A running pass is PREEMPTED at
    block boundaries: when strictly-higher-priority work is waiting, the
    executor parks the pass (its :class:`~repro_torch.core.runtime.PassState`
    carries the activation + next block; in-flight prefetches are drained,
    so only cache-resident bytes stay charged), requeues it, and takes the
    urgent request — a high-urgency arrival never waits for a whole foreign
    model pass, only for the current block.

Optionally (``auto_rebalance=True``) the scheduler feeds the live queue
mix's per-model urgencies into ``MultiModelRuntime.replan_budgets`` (Eq. 1
via :class:`~repro_torch.core.scheduler.MultiDNNScheduler` with the cache +
pinned bytes reserved), so block plans track WHO is actually asking for
service, not just who is registered.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.multi_model import MultiModelRuntime
from repro_torch.core.runtime import PassState
from repro_torch.errors import RequestCancelled, SwapError, SwapTimeoutError

__all__ = ["ServingRequest", "RequestQueue", "ServingScheduler"]


@dataclass
class ServingRequest:
    """One prefill request against a named model of the runtime.

    ``priority`` is the paper's urgency u (higher = more urgent);
    ``deadline`` is a relative slack in seconds (None = the queue's default).
    The scheduler fills ``arrival`` on submit and ``logits`` / ``stats`` /
    ``latency_s`` on completion; ``error`` carries a failed pass's exception
    instead of losing it on an executor thread.

    ``kind="generate"`` requests (``submit_generate``) carry a decode
    request ``gen`` (:class:`repro_torch.serving.engine.Request`) instead of a
    prefill batch: the executor drives the model's continuous-batching
    engine until that sequence retires, yielding at decode-step boundaries
    the way prefill passes yield at block boundaries."""
    model: str
    batch: dict
    priority: float = 1.0
    deadline: Optional[float] = None
    rid: int = 0
    arrival: float = 0.0
    state: Optional[PassState] = None
    logits: Any = None
    stats: Optional[Dict] = None
    error: Optional[BaseException] = None
    latency_s: float = 0.0
    kind: str = "prefill"
    gen: Any = None
    done: threading.Event = field(default_factory=threading.Event, repr=False)

    def urgency_key(self, default_slack: float) -> Tuple[float, float, int]:
        """Urgency-weighted deadline (weighted EDF): smaller sorts first."""
        slack = self.deadline if self.deadline is not None else default_slack
        virtual_deadline = self.arrival + slack / max(self.priority, 1e-9)
        return (virtual_deadline, self.arrival, self.rid)

    def wait(self, timeout: Optional[float] = None) -> "ServingRequest":
        """Block until served; re-raises the pass's exception, if any."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.rid} ({self.model}) not "
                               f"served within {timeout}s")
        if self.error is not None:
            raise self.error
        return self


class RequestQueue:
    """Thread-safe admission queue ordered by urgency-weighted deadline."""

    def __init__(self, default_slack: float = 1.0):
        self.default_slack = default_slack
        self._cond = threading.Condition()
        self._heap: List[Tuple[Tuple[float, float, int], ServingRequest]] = []
        self._closed = False

    def submit(self, req: ServingRequest) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("queue closed")
            heapq.heappush(self._heap,
                           (req.urgency_key(self.default_slack), req))
            self._cond.notify_all()

    def requeue(self, req: ServingRequest) -> None:
        """Re-admit a preempted (or pop-raced) request. Unlike submit this
        tolerates a closed queue — a pass preempted during shutdown must
        land back in the heap to be drained, not raise on an executor
        thread. The request keeps its ORIGINAL arrival, so its virtual
        deadline keeps aging: preemption can delay it, never starve it."""
        with self._cond:
            heapq.heappush(self._heap,
                           (req.urgency_key(self.default_slack), req))
            self._cond.notify_all()

    def pop_ready(self, busy: Sequence[str] = (),
                  timeout: Optional[float] = None) -> Optional[ServingRequest]:
        """Most urgent request whose model is not in ``busy`` (same-model
        passes serialize on one engine). None on timeout; None with the
        queue closed AND drained means "executor may exit" (check
        :attr:`closed`)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        busy = set(busy)
        with self._cond:
            while True:
                skipped = []
                found = None
                while self._heap:
                    key, req = heapq.heappop(self._heap)
                    if req.model in busy:
                        skipped.append((key, req))
                    else:
                        found = req
                        break
                for item in skipped:
                    heapq.heappush(self._heap, item)
                if found is not None:
                    return found
                if self._closed and not self._heap:
                    return None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
                else:
                    self._cond.wait()

    def remove(self, rid: int) -> Optional[ServingRequest]:
        """Remove (and return) the queued request with this rid; None if it
        is not in the heap (already popped by an executor, or unknown).
        O(n) scan + re-heapify — cancellation is rare, the queue is small."""
        with self._cond:
            for i, (_, req) in enumerate(self._heap):
                if req.rid == rid:
                    last = self._heap.pop()
                    if i < len(self._heap):
                        self._heap[i] = last
                        heapq.heapify(self._heap)
                    return req
            return None

    def max_waiting_priority(self) -> float:
        """Highest priority among queued (not yet running) requests."""
        with self._cond:
            return max((req.priority for _, req in self._heap),
                       default=float("-inf"))

    def max_runnable_priority(self, busy: Sequence[str] = ()) -> float:
        """Highest priority among queued requests that could actually run
        if one more executor freed up — a request whose model is being
        served ELSEWHERE can't (same-model passes serialize), so a pass
        yielding for it would drain its prefetches for nothing."""
        busy = set(busy)
        with self._cond:
            return max((req.priority for _, req in self._heap
                        if req.model not in busy),
                       default=float("-inf"))

    def kick(self) -> None:
        """Wake executors blocked in pop_ready: a model just left the busy
        set, so a request skipped as same-model-busy may now be runnable
        (without this, the handoff waits out the poll timeout)."""
        with self._cond:
            self._cond.notify_all()

    def urgency_mix(self) -> Dict[str, float]:
        """Per-model max queued priority — the live demand signal
        ``MultiModelRuntime.replan_budgets`` reacts to."""
        with self._cond:
            mix: Dict[str, float] = {}
            for _, req in self._heap:
                mix[req.model] = max(mix.get(req.model, 0.0), req.priority)
            return mix

    def __len__(self) -> int:
        with self._cond:
            return len(self._heap)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class ServingScheduler:
    """K concurrent executors + preemptive priority scheduling over one
    planned :class:`MultiModelRuntime`.

    Usage::

        rt = MultiModelRuntime(budget, executors=2)
        rt.add_model("qwen", ...); rt.add_model("gemma", ...)
        rt.plan(batch=2, seq=32)
        with ServingScheduler(rt) as sched:
            hi = sched.submit("qwen", batch, priority=8.0)
            lo = sched.submit("gemma", batch)        # priority 1.0
            hi.wait(); lo.wait()

    ``preempt=False`` degrades to run-to-completion (still priority-ordered
    admission); ``executors=1, preempt=False`` with uniform priorities is
    exactly the old serialized engine — the bench's baseline arm.
    """

    def __init__(self, runtime: MultiModelRuntime,
                 executors: Optional[int] = None, preempt: bool = True,
                 default_slack: float = 1.0, auto_rebalance: bool = False,
                 fail_fast_after: int = 3, shed_deadlines: bool = False):
        self.runtime = runtime
        self.executors = int(executors if executors is not None
                             else runtime.executors)
        if self.executors < 1:
            raise ValueError(f"executors {self.executors} < 1")
        self.preempt = preempt
        self.auto_rebalance = auto_rebalance
        # Graceful degradation knobs (docs/ARCHITECTURE.md "Failure
        # handling"): ``fail_fast_after`` consecutive SwapError passes mark
        # a model DOWN — its queued and future requests fail immediately
        # with a structured error of the same class instead of each burning
        # a full retry ladder, while co-tenant models keep serving
        # (``reset_model`` re-admits after the operator fixes the storage).
        # ``shed_deadlines=True`` rejects a request whose deadline already
        # passed while it queued (SwapTimeoutError) rather than running it
        # late — opt-in: shedding is a policy choice, not a default.
        if fail_fast_after < 1:
            raise ValueError(f"fail_fast_after {fail_fast_after} < 1")
        self.fail_fast_after = int(fail_fast_after)
        self.shed_deadlines = bool(shed_deadlines)
        self.queue = RequestQueue(default_slack)
        self.completed: List[ServingRequest] = []
        self.preemptions = 0
        self.shed = 0
        self.failed_fast = 0
        self._rid = itertools.count()
        self._lock = threading.Lock()          # busy set + counters + mix
        self._busy: set = set()
        self._model_failures: Dict[str, int] = {}   # consecutive SwapErrors
        self._model_down: Dict[str, BaseException] = {}
        self._last_mix: Dict[str, float] = {}
        self._threads = [
            threading.Thread(target=self._worker, name=f"swapnet-exec-{i}",
                             daemon=True)
            for i in range(self.executors)]
        for t in self._threads:
            t.start()

    @classmethod
    def from_config(cls, runtime: MultiModelRuntime, cfg) -> "ServingScheduler":
        """Construct from a resolved :class:`repro_torch.config.ServeConfig`'s
        ``scheduler`` section (the runtime carries the executor count)."""
        s = cfg.scheduler
        return cls(runtime, preempt=s.preempt, default_slack=s.default_slack,
                   auto_rebalance=s.rebalance,
                   fail_fast_after=s.fail_fast_after,
                   shed_deadlines=s.shed_deadlines)

    # ---------------------------------------------------------- submission
    def submit(self, model: str, batch: dict, priority: float = 1.0,
               deadline: Optional[float] = None) -> ServingRequest:
        req = ServingRequest(model=model, batch=batch,
                             priority=float(priority), deadline=deadline,
                             rid=next(self._rid),
                             arrival=time.perf_counter())
        self.queue.submit(req)
        if self.auto_rebalance:
            self._maybe_rebalance()
        return req

    def submit_generate(self, model: str, gen_request,
                        priority: float = 1.0,
                        deadline: Optional[float] = None) -> ServingRequest:
        """Queue a GENERATION (prefill + multi-token decode) against the
        model's continuous-batching engine (``runtime.batch_engine``).

        One driver ServingRequest is queued per generation; the busy set
        serializes same-model drivers, so whichever driver holds the model
        steps the WHOLE decode batch — its stepping serves every admitted
        sequence, and each driver exits as soon as ITS OWN sequence retires
        (possibly without ever stepping, if another driver already carried
        it to completion). Completion is signalled from the engine's retire
        callback, so ``req.wait()`` returns the moment the sequence
        finishes, whichever driver ran the final step."""
        engine = self.runtime.batch_engine(model)     # build early: raises
        req = ServingRequest(model=model, batch={},   # surface on submit
                             priority=float(priority), deadline=deadline,
                             rid=next(self._rid),
                             arrival=time.perf_counter(),
                             kind="generate", gen=gen_request)

        def on_retire(_gen, _req=req):
            _req.latency_s = time.perf_counter() - _req.arrival
            _req.error = getattr(_gen, "error", None)
            if _req.error is None:
                with self._lock:
                    self.completed.append(_req)
            else:       # a failed sequence (evicted by the batch engine)
                # surfaces through wait() and counts against the breaker
                self._note_failure(_req.model, _req.error)
            _req.done.set()

        engine.submit(gen_request, on_retire=on_retire)
        self.queue.submit(req)
        if self.auto_rebalance:
            self._maybe_rebalance()
        return req

    def cancel(self, rid: int) -> bool:
        """Remove a still-queued request (e.g. after the caller's own
        ``wait(timeout)`` expired) so it never becomes a ghost entry that
        executes later against a caller who stopped listening.

        Returns True when the request was cancelled: it completes
        immediately with :class:`RequestCancelled` (``wait`` re-raises it).
        Returns False — cleanly, no side effects — when the request is
        already running on an executor, already completed, or unknown:
        cancellation is queue-removal, never pass-abortion (a running pass
        holds ledger bytes and cache leases that must unwind through its
        own drain path)."""
        req = self.queue.remove(rid)
        if req is None:
            return False
        if req.kind == "generate" and req.gen is not None:
            # un-submit the sequence from the batch engine too (pending-only
            # there as well; if another driver already admitted it, the
            # engine keeps it and the retire callback still fires)
            try:
                self.runtime.batch_engine(req.model).cancel(req.gen.rid)
            except Exception:       # noqa: BLE001 — best-effort cleanup
                pass
        req.error = RequestCancelled(
            f"request {rid} ({req.model}) cancelled before dispatch")
        req.done.set()
        return True

    def reset_model(self, model: str) -> None:
        """Clear the fail-fast breaker for ``model`` (storage was repaired /
        remounted): its requests are served normally again."""
        with self._lock:
            self._model_failures.pop(model, None)
            self._model_down.pop(model, None)

    def model_down(self, model: str) -> Optional[BaseException]:
        """The SwapError that tripped the model's breaker, or None."""
        with self._lock:
            return self._model_down.get(model)

    def _maybe_rebalance(self) -> None:
        """Re-split the block budget when the queued demand mix changes."""
        mix = self.queue.urgency_mix()
        with self._lock:
            if mix == self._last_mix or not mix:
                return
            self._last_mix = dict(mix)
        try:
            self.runtime.replan_budgets(mix)
        except ValueError:
            pass          # infeasible mix (floors don't fit): keep old plans

    # ---------------------------------------------------------- executors
    def _busy_snapshot(self) -> frozenset:
        with self._lock:
            return frozenset(self._busy)

    def _worker(self) -> None:
        rt = self.runtime
        while True:
            req = self.queue.pop_ready(busy=self._busy_snapshot(),
                                       timeout=0.05)
            if req is None:
                if self.queue.closed and not len(self.queue):
                    return
                continue
            if self._degrade(req):      # breaker tripped / deadline shed:
                continue                # completed with a structured error
            with self._lock:
                if req.model in self._busy:
                    # raced with another executor picking the same model:
                    # put it back and try again
                    self.queue.requeue(req)
                    continue
                self._busy.add(req.model)
            try:
                if req.kind == "generate":
                    self._drive_generate(req)
                else:
                    state, stats = rt.forward_partial(
                        req.model, req.batch, state=req.state,
                        should_yield=self._make_yield(req),
                        priority=req.priority)
                    if stats is None:                   # preempted
                        req.state = state
                        with self._lock:
                            self.preemptions += 1
                        self.queue.requeue(req)
                    else:
                        req.logits, req.stats = state.logits, stats
                        req.latency_s = time.perf_counter() - req.arrival
                        with self._lock:
                            self.completed.append(req)
                        req.done.set()
            except BaseException as e:                  # noqa: BLE001
                req.error = e
                self._note_failure(req.model, e)
                req.done.set()
            else:
                with self._lock:    # clean pass: the breaker counts
                    self._model_failures.pop(req.model, None)   # CONSECUTIVE
            finally:                                            # failures
                with self._lock:
                    self._busy.discard(req.model)
                self.queue.kick()

    def _degrade(self, req: ServingRequest) -> bool:
        """Scheduler-tier degradation, decided BEFORE the request takes an
        executor slot: fail fast against a down model; shed a request whose
        deadline already passed while queued. True = request completed
        (with a structured error) and must not run."""
        with self._lock:
            down = self._model_down.get(req.model)
        if down is not None:
            # same exception CLASS as the tripping error, so callers'
            # isinstance handling (SwapIOError vs SwapCorruptionError)
            # works identically for fast-failed requests
            req.error = type(down)(
                f"model {req.model!r} is marked failed "
                f"({self.fail_fast_after} consecutive swap errors; "
                f"last: {down}) — failing fast; reset_model() re-admits",
                model=req.model)
            with self._lock:
                self.failed_fast += 1
            self._finish_degraded(req)
            return True
        if (self.shed_deadlines and req.deadline is not None
                and time.perf_counter() - req.arrival > req.deadline):
            req.error = SwapTimeoutError(
                f"request {req.rid} ({req.model}) shed: queued "
                f"{time.perf_counter() - req.arrival:.2f}s past its "
                f"{req.deadline:.2f}s deadline", model=req.model)
            with self._lock:
                self.shed += 1
            self._finish_degraded(req)
            return True
        return False

    def _finish_degraded(self, req: ServingRequest) -> None:
        if req.kind == "generate" and req.gen is not None:
            try:        # un-submit from the batch engine (pending-only)
                self.runtime.batch_engine(req.model).cancel(req.gen.rid)
            except Exception:       # noqa: BLE001 — best-effort cleanup
                pass
        req.done.set()

    def _note_failure(self, model: str, err: BaseException) -> None:
        """Per-model circuit breaker: only SwapErrors count (a cancelled
        request or a caller bug must not poison the model), and only
        CONSECUTIVE ones trip it."""
        if not isinstance(err, SwapError):
            return
        if err.model is None:
            err.model = model
        with self._lock:
            n = self._model_failures.get(model, 0) + 1
            self._model_failures[model] = n
            if n >= self.fail_fast_after:
                self._model_down.setdefault(model, err)

    def _drive_generate(self, req: ServingRequest) -> None:
        """Drive the model's continuous-batching engine until ``req``'s own
        sequence retires or a higher-priority runnable request appears at a
        decode-step boundary (the decode analogue of block-boundary
        preemption). Completion bookkeeping lives in the engine's retire
        callback (``submit_generate``), so the driver only decides whether
        to requeue itself."""
        engine = self.runtime.batch_engine(req.model)
        self.runtime.models[req.model].engine.set_priority(req.priority)
        finished = engine.run_until(req.gen.rid,
                                    should_yield=self._make_gen_yield(req))
        if not finished:
            with self._lock:
                self.preemptions += 1
            self.queue.requeue(req)

    def _make_gen_yield(self, req: ServingRequest):
        if not self.preempt:
            return None

        def should_yield() -> bool:
            # same policy as prefill passes, consulted between decode steps
            with self._lock:
                others_busy = self._busy - {req.model}
            return self.queue.max_runnable_priority(others_busy) > req.priority
        return should_yield

    def _make_yield(self, req: ServingRequest):
        if not self.preempt:
            return None

        def should_yield(state: PassState) -> bool:
            # Yield only for strictly-higher-priority work that could take
            # this slot: my own model frees when I park, so requests for it
            # count; requests for models busy on OTHER executors don't —
            # yielding for those would re-buy my prefetches for nothing.
            # Strict inequality: equal-priority tenants never churn.
            with self._lock:
                others_busy = self._busy - {req.model}
            return self.queue.max_runnable_priority(others_busy) > req.priority
        return should_yield

    # ---------------------------------------------------------- reporting
    def latency_by_class(self) -> Dict[float, List[float]]:
        """Completed-request latencies grouped by priority class."""
        with self._lock:
            out: Dict[float, List[float]] = {}
            for r in self.completed:
                out.setdefault(r.priority, []).append(r.latency_s)
            return out

    # ---------------------------------------------------------- lifecycle
    def shutdown(self, wait: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Close the queue; with ``wait``, join the executors (each within
        ``timeout`` seconds when given) and raise if one is still alive."""
        self.queue.close()
        if wait:
            for t in self._threads:
                t.join(timeout)
            alive = [t.name for t in self._threads if t.is_alive()]
            if alive:
                raise TimeoutError(f"executors {alive} still running "
                                   f"after {timeout}s")

    def __enter__(self) -> "ServingScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True)
