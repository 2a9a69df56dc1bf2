"""Multi-tenant planning and serving of the port against the JAX package's:
``allocate_budgets`` (Eq. 1), ``lift_to_floors``,
``MultiDNNScheduler.summary()``, ``MultiModelRuntime.plan`` and
``replan_budgets`` per tenant, and each tenant's logits.

qwen2.5-3b and gemma2-9b ``reduced()``, float32, params from JAX
``Model.init`` (tenant i from key i) handed over as numpy. Tolerances:
budgets, block points, pipeline depths and the planner's predicted
latencies are the same numbers (the same float arithmetic in numpy);
logits within 1e-5 of the reference's (float32, the sums run in another
order); the port's repeated passes bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.budget import ModelDemand as RefModelDemand  # noqa: E402
from repro.core.budget import allocate_budgets as ref_allocate  # noqa: E402
from repro.core.cost_model import DelayModel as RefDelayModel  # noqa: E402
from repro.core.cost_model import LayerInfo as RefLayerInfo  # noqa: E402
from repro.core.multi_model import \
    MultiModelRuntime as RefMultiModelRuntime  # noqa: E402
from repro.core.partition import \
    PartitionPlanner as RefPartitionPlanner  # noqa: E402
from repro.core.scheduler import \
    MultiDNNScheduler as RefMultiDNNScheduler  # noqa: E402
from repro.core.scheduler import \
    ScheduledModel as RefScheduledModel  # noqa: E402
from repro.core.scheduler import lift_to_floors as ref_lift  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.budget import (ModelDemand, allocate_budgets,  # noqa: E402
                                     performance_score)
from repro_torch.core.cost_model import DelayModel, LayerInfo  # noqa: E402
from repro_torch.core.multi_model import MultiModelRuntime  # noqa: E402
from repro_torch.core.partition import PartitionPlanner  # noqa: E402
from repro_torch.core.scheduler import (MultiDNNScheduler,  # noqa: E402
                                        ScheduledModel, lift_to_floors)
from repro_torch.models.transformer import Model  # noqa: E402

ARCHS = ("qwen2.5-3b", "gemma2-9b")
BUDGET = 48 * 1024 * 1024
TOL = dict(rtol=1e-5, atol=1e-5)

DEMANDS = {
    "fits": ([("a", 10.0, 1.0, 1.0), ("b", 20.0, 2.0, 1.0)], 100.0),
    "tight": ([("a", 60.0, 1.0, 1.0), ("b", 80.0, 3.0, 1.0)], 100.0),
    "urgent": ([("a", 60.0, 1.0, 8.0), ("b", 60.0, 1.0, 1.0),
                ("c", 30.0, 0.5, 2.0)], 90.0),
    "zero-latency": ([("a", 50.0, 0.0, 1.0), ("b", 50.0, 0.0, 1.0)], 40.0),
}


@pytest.mark.parametrize("case", sorted(DEMANDS))
def test_allocate_budgets_matches_reference(case):
    rows, available = DEMANDS[case]
    mine = [ModelDemand(*r) for r in rows]
    ref = [RefModelDemand(*r) for r in rows]
    assert allocate_budgets(mine, available) == ref_allocate(ref, available)
    assert [performance_score(d) for d in mine] == \
        [d.urgency * d.latency / max(d.memory, 1.0) for d in ref]


FLOORS = {
    "no-lift": ([50.0, 50.0], [10.0, 10.0], 100.0),
    "one-lift": ([5.0, 95.0], [20.0, 10.0], 100.0),
    "clamped-donor": ([5.0, 30.0, 65.0], [30.0, 28.0, 20.0], 100.0),
    "exact-floors": ([1.0, 1.0], [40.0, 60.0], 100.0),
}


@pytest.mark.parametrize("case", sorted(FLOORS))
def test_lift_to_floors_matches_reference(case):
    budgets, floors, usable = FLOORS[case]
    got = lift_to_floors(budgets, floors, usable)
    assert got == ref_lift(budgets, floors, usable)
    assert all(b >= f - 1e-9 for b, f in zip(got, floors))


def test_lift_to_floors_refuses_like_reference():
    with pytest.raises(ValueError):
        ref_lift([1.0], [200.0], 100.0)
    with pytest.raises(ValueError):
        lift_to_floors([1.0], [200.0], 100.0)


def _planners(seed, m):
    rng = np.random.default_rng(seed)
    out = []
    for name, n in (("a", 6), ("b", 8)):
        rows = [(f"{name}{i}", int(rng.integers(1, 40) * 1e6),
                 int(rng.integers(1, 9)), float(rng.uniform(1e9, 5e10)))
                for i in range(n)]
        out.append((name,
                    PartitionPlanner([LayerInfo(*r) for r in rows],
                                     DelayModel(), m=m),
                    RefPartitionPlanner([RefLayerInfo(*r) for r in rows],
                                        RefDelayModel(), m=m)))
    return out


@pytest.mark.parametrize("seed,m,available", [(0, 2, 300e6), (1, 3, 200e6),
                                              (2, 1, 150e6)])
def test_scheduler_summary_and_adapt_match_reference(seed, m, available):
    planners = _planners(seed, m)
    mine = MultiDNNScheduler([ScheduledModel(n, p, urgency=1.0 + i * 3)
                              for i, (n, p, _) in enumerate(planners)],
                             available, reserved=10e6)
    ref = RefMultiDNNScheduler([RefScheduledModel(n, r, urgency=1.0 + i * 3)
                                for i, (n, _, r) in enumerate(planners)],
                               available, reserved=10e6)
    assert mine.summary() == ref.summary()
    mine.adapt(available * 0.8)
    ref.adapt(available * 0.8)
    assert mine.summary() == ref.summary()


# ------------------------------------------------------------ the runtime
@pytest.fixture(scope="module")
def tenants():
    out = {}
    for i, arch in enumerate(ARCHS):
        ref_model = RefModel(dataclasses.replace(ref_get_arch(arch).reduced(),
                                                 dtype="float32"))
        ref_params = ref_model.init(jax.random.key(i))
        model = Model(dataclasses.replace(get_arch(arch).reduced(),
                                          dtype="float32"))
        params = params_from_jax(jax.tree.map(np.asarray, ref_params))
        tokens = np.random.default_rng(i).integers(
            0, model.cfg.vocab_size, (2, 16)).astype(np.int32)
        out[arch] = (ref_model, ref_params, model, params, tokens)
    return out


def _runtimes(tenants, tmp_path, **kw):
    ref = RefMultiModelRuntime(BUDGET, **kw)
    port = MultiModelRuntime(BUDGET, device="cpu", **kw)
    for arch, (ref_model, ref_params, model, params, _) in tenants.items():
        ref.add_model(arch, ref_model, ref_params, str(tmp_path / "ref"))
        port.add_model(arch, model, params, str(tmp_path / "port"))
    return ref, port


@pytest.mark.parametrize("store", ["mmap", "directio", "quant"])
@pytest.mark.parametrize("executors", [1, 2])
def test_plan_per_tenant_matches_reference(tenants, tmp_path, store,
                                           executors):
    kw = dict(cache_frac=0.2, kv_frac=0.2, prefetch_depth=3,
              store_backend=store, executors=executors)
    ref, port = _runtimes(tenants, tmp_path, **kw)
    try:
        want = ref.plan(batch=2, seq=16)
        got = port.plan(batch=2, seq=16)
        assert port.block_budget() == ref.block_budget()
        assert port.kv_reserve() == ref.kv_reserve()
        assert port.cache.capacity == ref.cache.capacity
        for arch in ARCHS:
            assert got[arch].points == want[arch].points, arch
            assert got[arch].m == want[arch].m, arch
            assert port.models[arch].engine.reserve_blocking == \
                ref.models[arch].engine.reserve_blocking == (executors > 1)
            for name in port.models[arch].store.order:
                size = port.models[arch].store.resident_nbytes(name)
                assert port.cache.admits(name, size) == \
                    ref.cache.admits(name, size), name
        urg = {"qwen2.5-3b": 8.0, "gemma2-9b": 1.0}
        assert port.replan_budgets(urg) == ref.replan_budgets(urg)
        for arch in ARCHS:
            assert port.models[arch].plan.points == \
                ref.models[arch].plan.points
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("store", ["mmap", "directio"])
def test_tenant_logits_match_reference(tenants, tmp_path, store):
    """Two rounds interleaved: each tenant's logits within 1e-5 of the JAX
    runtime's, the second round bitwise the first (cache hits included),
    the shared ledger never over the budget."""
    ref, port = _runtimes(tenants, tmp_path, cache_frac=0.25,
                          store_backend=store)
    try:
        ref.plan(batch=2, seq=16)
        port.plan(batch=2, seq=16)
        first = {}
        for rnd in range(2):
            for arch, (*_, tokens) in tenants.items():
                got, _ = port.forward(arch, {"tokens": torch.as_tensor(tokens)})
                if rnd == 0:
                    want, _ = ref.forward(arch, {"tokens": jnp.asarray(tokens)})
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               **TOL)
                    first[arch] = got
                else:
                    assert torch.equal(got, first[arch])
        st = port.stats()
        assert st["peak_resident_mb"] * 1e6 <= BUDGET
        assert st["cache_hits"] > 0
        assert set(st["models"]) == set(ARCHS)
        assert port.ledger.resident == port.cache.resident_bytes
    finally:
        port.close()
        ref.close()


def test_units_are_namespaced_per_tenant(tenants, tmp_path):
    """Two instances of one arch share the store directory and the cache
    without colliding; different weights give different logits."""
    _, _, model, params, tokens = tenants["qwen2.5-3b"]
    rt = MultiModelRuntime(BUDGET, device="cpu")
    try:
        rt.add_model("a", model, params, str(tmp_path))
        rt.add_model("b", model, model.init(5, device="cpu"), str(tmp_path))
        rt.plan(batch=2, seq=16)
        assert rt.models["a"].store.order[0] == "a/embed"
        assert rt.models["b"].name == "b"
        la, _ = rt.forward("a", {"tokens": torch.as_tensor(tokens)})
        lb, _ = rt.forward("b", {"tokens": torch.as_tensor(tokens)})
        assert not torch.allclose(la, lb)
        with pytest.raises(ValueError):
            rt.add_model("a", model, params, str(tmp_path))
    finally:
        rt.close()


def test_mixed_without_fidelity_and_config_without_budget_raise(
        tenants, tmp_path):
    """As the reference: a mixed-precision tenant needs the runtime's
    fidelity target, and from_config needs runtime.budget_mb; both are
    ValueErrors with the reference's messages."""
    from repro.config import resolve_config as ref_resolve
    from repro_torch.config import resolve_config
    ref_model, ref_params, model, params, _ = tenants["qwen2.5-3b"]
    kw = dict(store_backend="quant", precision="mixed")
    ref = RefMultiModelRuntime(BUDGET, **kw)
    with pytest.raises(ValueError, match="fidelity") as want:
        ref.add_model("q", ref_model, ref_params, str(tmp_path / "ref"))
    rt = MultiModelRuntime(BUDGET, device="cpu", **kw)
    with pytest.raises(ValueError, match="fidelity") as got:
        rt.add_model("q", model, params, str(tmp_path / "port"))
    assert str(got.value) == str(want.value) and not rt.models
    rt.close()
    cli = {"arch": "qwen2.5-3b"}
    with pytest.raises(ValueError, match="budget_mb") as want:
        RefMultiModelRuntime.from_config(ref_resolve(env={}, cli=cli))
    with pytest.raises(ValueError, match="budget_mb") as got:
        MultiModelRuntime.from_config(resolve_config(env={}, cli=cli),
                                      device="cpu")
    assert str(got.value) == str(want.value)


def test_abandoned_pass_releases_the_shared_ledger(tenants, tmp_path):
    from repro_torch.core.runtime import swap_schedule
    _, _, model, params, tokens = tenants["qwen2.5-3b"]
    rt = MultiModelRuntime(BUDGET, cache_frac=0.25, device="cpu")
    try:
        sm = rt.add_model("q", model, params, str(tmp_path))
        rt.plan(batch=2, seq=16)
        assert sm.plan.n_blocks >= 2
        gen = swap_schedule(sm.engine, sm.plan.blocks(),
                            [u.name for u in sm.units], sm.plan.m)
        next(gen)            # block 0 resident, block 1 prefetching
        gen.close()          # the request is abandoned mid-run
        assert rt.ledger.resident == rt.cache.resident_bytes
        assert rt.cache.active_leases() == {}
        logits, _ = rt.forward("q", {"tokens": torch.as_tensor(tokens)})
        assert logits.shape[0] == 2
    finally:
        rt.close()


def test_plan_rejects_a_hopeless_budget(tenants, tmp_path):
    rt = MultiModelRuntime(4096, cache_frac=0.25, device="cpu")
    try:
        for arch, (_, _, model, params, _) in tenants.items():
            rt.add_model(arch, model, params, str(tmp_path))
        with pytest.raises(ValueError):
            rt.plan(batch=2, seq=16)
        with pytest.raises(RuntimeError):
            rt.forward("qwen2.5-3b", {})
    finally:
        rt.close()
