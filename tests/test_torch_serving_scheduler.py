"""The serving scheduler of the port: admission order against the JAX
package's ``RequestQueue``, then K executors over a shared-budget runtime
on the CPU (preemption, cancel, shedding, the circuit breaker, a failed
tenant beside a healthy one, paged generation).

qwen2.5-3b and gemma2-9b ``reduced()``, float32, weights from a seed.
Tolerances: the queue pops the reference's request ids in the reference's
order; every served prefill equals its tenant's unswapped forward bitwise
(the same ops on the same bytes, whichever executor ran it and however
often it was preempted); generated tokens equal those served alone.
Every wait and join takes a timeout, so a hang fails the test.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.serving_scheduler import \
    RequestQueue as RefRequestQueue  # noqa: E402
from repro.core.serving_scheduler import \
    ServingRequest as RefServingRequest  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.multi_model import MultiModelRuntime  # noqa: E402
from repro_torch.core.runtime import PassState  # noqa: E402
from repro_torch.core.serving_scheduler import (RequestQueue,  # noqa: E402
                                                ServingRequest,
                                                ServingScheduler)
from repro_torch.errors import (RequestCancelled, SwapIOError,  # noqa: E402
                                SwapTimeoutError)
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402

Q, G = "qwen2.5-3b", "gemma2-9b"
BUDGET = 48 * 1024 * 1024
WAIT = 60.0


# ------------------------------------------------------------ the queue
def _submissions(seed, n=12):
    rng = np.random.default_rng(seed)
    return [(str(rng.choice(["a", "b", "c"])),
             float(rng.choice([1.0, 2.0, 8.0])),
             None if rng.random() < 0.5 else float(rng.uniform(0.1, 3.0)),
             float(rng.uniform(0.0, 2.0)))
            for _ in range(n)]


def _fill(queue_cls, req_cls, subs):
    q = queue_cls(default_slack=1.0)
    for rid, (model, prio, deadline, arrival) in enumerate(subs):
        q.submit(req_cls(model=model, batch={}, priority=prio,
                         deadline=deadline, rid=rid, arrival=arrival))
    return q


@pytest.mark.parametrize("seed", range(6))
def test_queue_pops_in_reference_order(seed):
    """The same submissions pop in the reference's order, with busy models
    skipped the same way; the waiting-priority views agree."""
    subs = _submissions(seed)
    mine = _fill(RequestQueue, ServingRequest, subs)
    ref = _fill(RefRequestQueue, RefServingRequest, subs)
    assert mine.urgency_mix() == ref.urgency_mix()
    busy_seq = [(), ("a",), ("b", "c"), ()] * 4
    got, want = [], []
    for busy in busy_seq:
        assert mine.max_runnable_priority(busy) == \
            ref.max_runnable_priority(busy)
        assert mine.max_waiting_priority() == ref.max_waiting_priority()
        a = mine.pop_ready(busy, timeout=0.0)
        b = ref.pop_ready(busy, timeout=0.0)
        got.append(None if a is None else a.rid)
        want.append(None if b is None else b.rid)
    assert got == want
    assert len(mine) == len(ref)


def test_queue_remove_requeue_and_close():
    q = _fill(RequestQueue, ServingRequest, _submissions(0, 4))
    assert q.remove(2).rid == 2 and q.remove(2) is None
    r = q.pop_ready(timeout=0.0)
    q.close()
    with pytest.raises(RuntimeError):
        q.submit(ServingRequest("a", {}))
    q.requeue(r)                    # a preempted pass lands back after close
    assert len(q) == 3 and q.closed
    while q.pop_ready(timeout=0.0) is not None:
        pass
    assert q.pop_ready(timeout=0.0) is None and len(q) == 0


# ------------------------------------------------------------ the scheduler
@pytest.fixture(scope="module")
def tenants():
    out = {}
    for i, arch in enumerate((Q, G)):
        model = Model(dataclasses.replace(get_arch(arch).reduced(),
                                          dtype="float32"))
        params = model.init(i, device="cpu")
        rng = np.random.default_rng(10 + i)
        batches = [{"tokens": torch.as_tensor(
            rng.integers(0, model.cfg.vocab_size, (1, 16)),
            dtype=torch.int32)} for _ in range(3)]
        out[arch] = (model, params, batches)
    return out


@pytest.fixture
def runtime(tenants, tmp_path):
    def make(executors=2, store="mmap", **kw):
        rt = MultiModelRuntime(BUDGET, executors=executors, cache_frac=0.2,
                               kv_frac=0.2, prefetch_depth=3,
                               store_backend=store, device="cpu", **kw)
        for arch, (model, params, _) in tenants.items():
            rt.add_model(arch, model, params, str(tmp_path))
        rt.plan(batch=1, seq=16)
        made.append(rt)
        return rt
    made = []
    yield make
    for rt in made:
        rt.close()


def _refs(rt, tenants):
    out = {}
    for arch, (_, _, batches) in tenants.items():
        res = rt.models[arch].resident_units()
        out[arch] = [rt.models[arch].forward_unswapped(b, resident=res)
                     for b in batches]
    return out


def _gate(engine):
    """Hold the executor after a block's exec span until released:
    ``seen`` is set when the first block has run, ``go`` lets it on."""
    seen, go = threading.Event(), threading.Event()
    orig = engine.record_exec

    def held(seconds):
        orig(seconds)
        if not seen.is_set():
            seen.set()
            go.wait(WAIT)
    engine.record_exec = held
    return seen, go


@pytest.mark.parametrize("store", ["mmap", "directio"])
def test_two_executors_bitwise_and_within_budget(runtime, tenants, store):
    rt = runtime(store=store)
    refs = _refs(rt, tenants)
    sched = ServingScheduler(rt)
    try:
        reqs = [(arch, i, sched.submit(arch, tenants[arch][2][i],
                                       priority=p))
                for i in range(3) for arch, p in ((Q, 1.0), (G, 8.0))]
        for _, _, r in reqs:
            r.wait(WAIT)
    finally:
        sched.shutdown(timeout=WAIT)
    for arch, i, r in reqs:
        assert torch.equal(r.logits, refs[arch][i]), (arch, i)
    assert rt.ledger.peak <= BUDGET
    assert rt.ledger.resident == rt.cache.resident_bytes
    assert rt.cache.active_leases() == {}
    assert sorted(sched.latency_by_class()) == [1.0, 8.0]
    assert not any(t.is_alive() for t in sched._threads)


def test_priority_8_arrival_preempts_a_running_pass(runtime, tenants):
    """A priority-8 request for the same tenant arrives while a priority-1
    pass runs: the pass yields at its next block boundary, the urgent one
    runs, and the preempted pass resumes to the same logits."""
    rt = runtime()
    refs = _refs(rt, tenants)
    assert rt.models[Q].plan.n_blocks >= 3
    seen, go = _gate(rt.models[Q].engine)
    sched = ServingScheduler(rt)
    try:
        lo = sched.submit(Q, tenants[Q][2][0], priority=1.0)
        assert seen.wait(WAIT)
        hi = sched.submit(Q, tenants[Q][2][1], priority=8.0)
        go.set()
        hi.wait(WAIT)
        lo.wait(WAIT)
    finally:
        go.set()
        sched.shutdown(timeout=WAIT)
    assert sched.preemptions >= 1 and lo.stats["preemptions"] >= 1
    assert torch.equal(lo.logits, refs[Q][0])
    assert torch.equal(hi.logits, refs[Q][1])


def test_preempted_pass_resumes_bitwise(runtime, tenants):
    rt = runtime(executors=1)
    batch = tenants[Q][2][0]
    whole, _ = rt.forward(Q, batch)
    state, stats = rt.forward_partial(Q, batch,
                                      should_yield=lambda s: True)
    assert stats is None and isinstance(state, PassState)
    while stats is None:
        state, stats = rt.forward_partial(Q, batch, state=state,
                                          should_yield=lambda s: True)
    assert state.preemptions == rt.models[Q].plan.n_blocks - 1
    assert torch.equal(state.logits, whole)


def test_cancel_and_shed_while_queued(runtime, tenants):
    rt = runtime(executors=1)
    seen, go = _gate(rt.models[Q].engine)
    sched = ServingScheduler(rt, shed_deadlines=True)
    try:
        running = sched.submit(Q, tenants[Q][2][0])
        assert seen.wait(WAIT)
        queued = sched.submit(G, tenants[G][2][0])
        late = sched.submit(G, tenants[G][2][1], deadline=0.0)
        assert sched.cancel(queued.rid)
        assert not sched.cancel(running.rid)    # running: not aborted
        assert not sched.cancel(12345)
        go.set()
        with pytest.raises(RequestCancelled):
            queued.wait(WAIT)
        with pytest.raises(SwapTimeoutError):
            late.wait(WAIT)
        running.wait(WAIT)
    finally:
        go.set()
        sched.shutdown(timeout=WAIT)
    assert sched.shed == 1


def test_failed_tenant_trips_breaker_cotenant_exact(runtime, tenants,
                                                    tmp_path):
    """A tenant whose reads fail past their retries fails its requests
    with SwapIOError and no ledger bytes left; after ``fail_fast_after``
    failures it fails fast; the co-tenant stays bitwise exact; a reset
    re-admits it."""
    rt = MultiModelRuntime(BUDGET, executors=2, cache_frac=0.2,
                           prefetch_depth=3, device="cpu")
    try:
        for arch, (model, params, _) in tenants.items():
            opts = ({"inner": "directio", "p": 0.0} if arch == G else None)
            rt.add_model(arch, model, params, str(tmp_path),
                         store_backend="faulty" if arch == G else "mmap",
                         store_options=opts)
        rt.plan(batch=1, seq=16)
        refs = _refs(rt, tenants)
        gsm = rt.models[G]
        gsm.engine.retry_backoff_s = 0.001
        sched = ServingScheduler(rt, fail_fast_after=2)
        try:
            for i in range(2):
                gsm.store.force(*["io"] * (gsm.engine.read_retries + 1))
                bad = sched.submit(G, tenants[G][2][i])
                good = sched.submit(Q, tenants[Q][2][i])
                with pytest.raises(SwapIOError) as ei:
                    bad.wait(WAIT)
                assert ei.value.model == G
                good.wait(WAIT)
                assert torch.equal(good.logits, refs[Q][i])
            assert isinstance(sched.model_down(G), SwapIOError)
            fast = sched.submit(G, tenants[G][2][2])
            with pytest.raises(SwapIOError):
                fast.wait(WAIT)
            assert sched.failed_fast == 1
            sched.reset_model(G)
            assert sched.model_down(G) is None
            ok = sched.submit(G, tenants[G][2][2])
            ok.wait(WAIT)
            assert torch.equal(ok.logits, refs[G][2])
        finally:
            sched.shutdown(timeout=WAIT)
        assert rt.ledger.resident == rt.cache.resident_bytes
        assert rt.cache.active_leases() == {}
    finally:
        rt.close()


def test_generate_equals_served_alone(runtime, tenants):
    """Two generations through the scheduler's paged decode beside
    prefills of the other tenant; tokens equal each prompt served alone
    through the tenant's own batch engine."""
    rt = runtime()
    model = tenants[Q][0]
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, model.cfg.vocab_size, 16)))
               for _ in range(2)]
    sched = ServingScheduler(rt, auto_rebalance=True)
    try:
        gens = [Request(100 + i, p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        reqs = [sched.submit_generate(Q, g) for g in gens]
        reqs.append(sched.submit(G, tenants[G][2][0], priority=8.0))
        for r in reqs:
            r.wait(WAIT)
    finally:
        sched.shutdown(timeout=WAIT)
    be = rt.batch_engine(Q)
    for i, (g, p) in enumerate(zip(gens, prompts)):
        alone = Request(200 + i, p, max_new_tokens=4)
        be.submit(alone)
        be.run_all()
        assert g.output == alone.output and len(g.output) == 4
    assert rt.ledger.resident == rt.cache.resident_bytes


def test_batch_engine_cancel_is_pending_only(runtime, tenants):
    rt = runtime(executors=1)
    be = rt.batch_engine(Q)
    fired = []
    a = Request(1, [1, 2, 3, 4], max_new_tokens=2)
    b = Request(2, [5, 6, 7, 8], max_new_tokens=2)
    be.submit(a, on_retire=fired.append)
    be.submit(b, on_retire=fired.append)
    assert be.cancel(2)                 # still pending: removed
    assert not be.cancel(2)             # unknown now
    be.step()                           # admits a
    assert not be.cancel(1)             # admitted: retire / evict only
    be.run_all()
    assert [r.rid for r in fired] == [1] and len(a.output) == 2
    be.submit(Request(2, [5, 6, 7, 8], max_new_tokens=1))   # rid free again
    be.run_all()
