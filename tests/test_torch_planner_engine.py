"""Planner and swap-engine parity and invariants.

Tolerance: exact. The planner is the same numpy code on the same rows, so
plans, lookup tables and simulated makespans must be equal; the ledger and
the pipeline are held to their invariants (never above budget, at most m
blocks resident), and every swap stage leaves its timeline span.
"""
import random
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core import partition as ref_part  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import partition as part  # noqa: E402
from repro_torch.core.runtime import swap_schedule  # noqa: E402
from repro_torch.core.swap_engine import (BlockCache, MemoryLedger,  # noqa: E402
                                          SwapEngine)
from repro_torch.store import build_store  # noqa: E402


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 40, n) * 1_000_000
    depths = rng.integers(1, 12, n)
    flops = rng.uniform(1e8, 5e10, n)
    port = [cm.LayerInfo(f"u{i}", int(s), int(d), float(f))
            for i, (s, d, f) in enumerate(zip(sizes, depths, flops))]
    ref = [ref_cm.LayerInfo(r.name, r.size, r.depth, r.flops) for r in port]
    return port, ref


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("seed,n,budget_mb", [(0, 8, 60), (1, 12, 90),
                                              (2, 10, 100)])
def test_same_plan_and_lookup_table(seed, n, budget_mb, m):
    port_rows, ref_rows = _rows(seed, n)
    budget = budget_mb * 1e6
    dm, ref_dm = cm.DelayModel(), ref_cm.DelayModel()
    pp = part.PartitionPlanner(port_rows, dm, m=m)
    rp = ref_part.PartitionPlanner(ref_rows, ref_dm, m=m)
    plan, table = pp.best_partition(budget)
    ref_plan, ref_table = rp.best_partition(budget)
    assert (plan.points, plan.n_layers, plan.m) == \
        (ref_plan.points, ref_plan.n_layers, ref_plan.m)
    assert [(r.points, r.max_memory, r.latency) for r in table] == \
        [(r.points, r.max_memory, r.latency) for r in ref_table]
    assert pp.min_feasible_budget() == rp.min_feasible_budget()


def test_infeasible_budget_raises_like_reference():
    port_rows, ref_rows = _rows(3, 6)
    with pytest.raises(ValueError, match="no feasible partition"):
        part.PartitionPlanner(port_rows, cm.DelayModel()).best_partition(1e6)
    with pytest.raises(ValueError, match="no feasible partition"):
        ref_part.PartitionPlanner(ref_rows, ref_cm.DelayModel()) \
            .best_partition(1e6)


def test_delay_model_fit_matches_reference():
    rng = np.random.default_rng(4)
    s_in = [(float(s), float(d), float(1e-9 * s + 5e-5 * d + 3e-4))
            for s, d in zip(rng.integers(1e5, 1e8, 20), rng.integers(1, 30, 20))]
    s_ex = [(float(f), 2e-11 * f) for f in rng.uniform(1e8, 1e11, 10)]
    s_out = [(float(d), 1.5e-5 * d) for d in rng.integers(1, 30, 10)]
    a = cm.DelayModel.fit(s_in, s_ex, s_out)
    b = ref_cm.DelayModel.fit(s_in, s_ex, s_out)
    assert (a.alpha, a.beta, a.gamma, a.eta, a.kappa) == \
        (b.alpha, b.beta, b.gamma, b.eta, b.kappa)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b"])
def test_layer_flops_matches_reference(arch):
    """One layer's FLOPs row at the published widths (shape-only leaves)."""
    from repro.configs import get_arch as ref_get_arch
    from repro_torch.configs import get_arch
    from repro_torch.models.params import is_def
    from repro_torch.models.transformer import layer_defs
    from repro_torch.tree import tree_map
    cfg = get_arch(arch)
    kind = cfg.layer_kinds()[0]
    defs = layer_defs(cfg, kind)
    port = tree_map(lambda d: torch.empty(d.shape, device="meta"), defs,
                    is_leaf=is_def)
    ref = tree_map(lambda d: np.broadcast_to(np.float32(0), d.shape), defs,
                   is_leaf=is_def)
    for batch, seq in ((1, 1), (2, 512), (4, 4096)):
        assert cm.layer_flops(cfg, kind, port, batch, seq) == \
            ref_cm.layer_flops(ref_get_arch(arch), kind, ref, batch, seq)


def test_simulate_pipeline_matches_reference():
    rng = np.random.default_rng(5)
    s, d, f = rng.uniform(1e6, 1e8, 9), rng.uniform(1, 20, 9), \
        rng.uniform(1e9, 1e11, 9)
    for m in (1, 2, 4):
        assert part.simulate_pipeline(s, d, f, cm.DelayModel(), m) == \
            ref_part.simulate_pipeline(s, d, f, ref_cm.DelayModel(), m)


# ------------------------------------------------------------ ledger
def test_ledger_never_exceeds_budget_adversarial():
    """Threads hammer add / try_add / reserve / drop with a short switch
    interval; the running total may never pass the budget and no update
    may be lost."""
    budget = 1000
    ledger = MemoryLedger(budget)
    over = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker(tid):
        rnd = random.Random(tid)
        for i in range(300):
            key = (tid, i % 4)
            n = rnd.randint(1, 400)
            op = rnd.random()
            try:
                if op < 0.3:
                    ledger.add(key, n)
                elif op < 0.5:
                    ledger.try_add(key, n)
                elif op < 0.6:
                    ledger.reserve(key, n, timeout=0.001)
                else:
                    ledger.drop(key)
            except MemoryError:
                pass
            if ledger.resident > budget:
                over.append(ledger.resident)

    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not over and ledger.peak <= budget
    for tid in range(12):
        for j in range(4):
            ledger.drop((tid, j))
    assert ledger.resident == 0


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_ledger_reserve_waits_and_wakes_by_priority(impl):
    """Three reserves that do not fit wait; as bytes free, the
    priority-8 one is admitted first, then the priority-1 ones in arrival
    order, the same in the port as in the JAX package."""
    import time
    if impl == "port":
        ledger = MemoryLedger(100)
    else:
        from repro.core.swap_engine import MemoryLedger as RefLedger
        ledger = RefLedger(100)
    ledger.add("holder", 90)
    admitted = []

    def waiter(tag, priority):
        ledger.reserve(tag, 60, priority=priority, timeout=60)
        admitted.append(tag)
        ledger.drop(tag)

    threads = []
    for k, (tag, priority) in enumerate([("first-1", 1.0), ("urgent-8", 8.0),
                                         ("second-1", 1.0)]):
        t = threading.Thread(target=waiter, args=(tag, priority))
        t.start()
        threads.append(t)
        t_end = time.monotonic() + 30
        while len(ledger._waiting) < k + 1:     # queued before the next
            assert time.monotonic() < t_end
            time.sleep(0.001)
    assert admitted == [] and ledger.resident == 90
    ledger.drop("holder")
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert admitted == ["urgent-8", "first-1", "second-1"]
    assert ledger.resident == 0 and ledger.peak == 90


def test_ledger_add_over_budget_records_nothing():
    ledger = MemoryLedger(100)
    ledger.add("a", 60)
    with pytest.raises(MemoryError):
        ledger.add("b", 50)
    assert ledger.resident == 60 and ledger.peak == 60


def test_block_cache_charges_once_and_pins():
    ledger = MemoryLedger(1000)
    cache = BlockCache(100, ledger, admit_frac=1.0)
    cache.pin(["p"])
    assert cache.put("p", {}, 80) and cache.put("x", {}, 60)
    assert cache.put("x", {}, 60)           # idempotent: charged once
    assert ledger.resident == 140
    assert cache.acquire("x") is not None
    cache.put("y", {}, 70)                  # x leased: not evicted
    assert "x" in cache.active_leases()
    cache.release("x")
    cache.clear()
    assert ledger.resident == 0


# ------------------------------------------------------------ engine
@pytest.fixture
def engine(tmp_path):
    rng = np.random.default_rng(0)
    units = [(f"u{i}", {"w": torch.from_numpy(
        rng.standard_normal((64, 32)).astype(np.float32)),
        "b": torch.zeros(32)}) for i in range(7)]
    store = build_store(units, str(tmp_path), backend="mmap", device="cpu")
    eng = SwapEngine(store)
    yield eng, [n for n, _ in units]
    eng.close()


@pytest.mark.parametrize("m", [1, 2, 3])
def test_swap_schedule_keeps_at_most_m_blocks(engine, m):
    eng, names = engine
    blocks = [(0, 1), (1, 3), (3, 4), (4, 6), (6, 7)]
    seen = []
    for bi, lo, hi, handle in swap_schedule(eng, blocks, names, m):
        assert handle.names == names[lo:hi]
        # blocks the ledger holds right now: the current one + prefetched
        seen.append(len(eng.ledger._entries))
        assert len(eng.ledger._entries) <= m
    assert max(seen) <= m
    assert eng.ledger.resident == 0
    block_bytes = [sum(eng.store.resident_nbytes(n) for n in names[lo:hi])
                   for lo, hi in blocks]
    assert eng.stats.peak_resident <= max(
        sum(block_bytes[i:i + m]) for i in range(len(blocks)))


def test_swap_schedule_drains_on_early_exit(engine):
    eng, names = engine
    gen = swap_schedule(eng, [(0, 2), (2, 4), (4, 7)], names, 2)
    next(gen)
    gen.close()
    assert eng.ledger.resident == 0 and not eng.cache.active_leases()


def test_stage_spans_recorded(engine):
    eng, names = engine
    blocks = [(0, 3), (3, 5), (5, 7)]
    for _, lo, hi, _ in swap_schedule(eng, blocks, names, 2):
        eng.record_exec(1e-4)
    st = eng.stats
    for stage in ("read", "unpack", "dispatch"):
        spans = st.stage_spans(stage)
        assert len(spans) == len(names)
        assert all(e >= s for s, e in spans)
    assert len(st.stage_spans("wait")) == len(blocks)
    assert len(st.stage_spans("exec")) == len(blocks)
    assert 0.0 <= st.overlap_efficiency() <= 1.0
    assert st.bytes_swapped == sum(eng.store.nbytes(n) for n in names)
    assert st.bytes_by_precision == {"fp": st.bytes_swapped}


def test_overlap_accounting_matches_reference():
    from repro.core.swap_engine import SwapStats as RefStats
    from repro_torch.core.swap_engine import SwapStats
    rng = np.random.default_rng(6)
    timeline = []
    for stage in ("read", "exec", "wait"):
        for s in rng.uniform(0, 10, 12):
            timeline.append((stage, float(s), float(s + rng.uniform(0, 2))))
    ours, ref = SwapStats(timeline=list(timeline)), RefStats(timeline=list(timeline))
    ours.t_in, ref.t_in = [3.0, 4.0], [3.0, 4.0]
    ours.t_wait, ref.t_wait = [1.0, 0.5], [1.0, 0.5]
    for a, b in (("read", "exec"), ("exec", "wait"), ("read", "read")):
        assert ours.overlap_seconds(a, b) == ref.overlap_seconds(a, b)
    assert ours.stage_seconds("read") == ref.stage_seconds("read")
    assert ours.overlap_efficiency() == ref.overlap_efficiency()


def test_read_retry_ladder_recovers(engine):
    eng, names = engine
    real = eng.store.read_unit
    fails = {"n": 2}

    def flaky(name):
        if fails["n"]:
            fails["n"] -= 1
            raise OSError("injected")
        return real(name)

    eng.store.read_unit = flaky
    eng.retry_backoff_s = 0.0
    h = eng.swap_in(names[:1])
    eng.swap_out(h)
    assert eng.stats.retries == 2 and eng.stats.faults == {"SwapIOError": 2}
