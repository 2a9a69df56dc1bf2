"""``SwappedSequential`` of the port, its planner helpers and the conv
workloads' calibration against the JAX package's.

vgg_sim and yolo_sim at their own layer lists, batch 2, float32; params
(at ``init_convnet``'s shapes and scale, non-zero biases) and inputs drawn
from a numpy seed, the port's through ``params_from_jax`` (the JAX init
itself is held in ``test_torch_vision.py``). Tolerances: swapped == unswapped bitwise on mmap and after retried
faults (the same ops on the same bytes); the quant store's files and CRCs,
plans, stats' byte counts, ``DelayModel.calibrated`` (a fake store on a
fake clock), ``r2_in``, ``packing_density``, ``paper_objective``,
``prewarm``'s tables and the ``weight`` profile exact; quantized and mixed
forwards within 1e-5 (rtol and atol) of the reference's, and the
``output`` profile's errors within 1e-5 absolute, since the two packages'
convolutions sum in another order.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.calibrate import calibrate_sequential as ref_calibrate_sequential  # noqa: E402
from repro.core import cost_model as ref_cost_model  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.core.runtime import SwappedSequential as RefSwappedSequential  # noqa: E402
from repro.kernels.qtensor import QuantizedTensor as RefQuantizedTensor  # noqa: E402
from repro.models import vision as ref_vision  # noqa: E402
from repro_torch.calibrate import calibrate_sequential  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import cost_model, partition  # noqa: E402
from repro_torch.core.runtime import SwappedSequential  # noqa: E402
from repro_torch.kernels.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.models import vision  # noqa: E402
from repro_torch.store.quantized_store import roundtrip  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 2
SEEDS = {"vgg": 0, "yolo": 1}


def _draw_params(layers, rng) -> list:
    """A sim's params drawn with numpy at ``init_convnet``'s shapes and
    scale, with non-zero biases, as the reference's list of dicts."""
    out = []
    for l in layers:
        if l.kind not in ("conv", "res", "fc"):
            out.append({})
            continue
        shape = ((l.k, l.k, l.cin, l.cout) if l.kind != "fc"
                 else (l.cin, l.cout))
        w = rng.standard_normal(shape, np.float32)
        w *= np.float32(np.prod(shape[:-1]) ** -0.5)
        b = rng.standard_normal(l.cout, np.float32) * np.float32(0.1)
        out.append({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    return out


class Net:
    """One sim in both packages: layers, params, units and info rows."""

    def __init__(self, kind: str):
        seed = SEEDS[kind]
        _, self.layers, self.hw = vision.MODELS[kind]()
        _, self.rlayers, _ = ref_vision.MODELS[kind]()
        self.rparams = _draw_params(self.rlayers,
                                    np.random.default_rng(seed))
        self.params = params_from_jax(jax.tree.map(np.asarray, self.rparams))
        self.units = [(f"{kind}{i:02d}", p) for i, p in enumerate(self.params)]
        self.runits = [(f"{kind}{i:02d}", p)
                       for i, p in enumerate(self.rparams)]
        self.x = np.random.default_rng(seed + 99).standard_normal(
            (BATCH, self.hw, self.hw, 3)).astype(np.float32)

    def infos(self, mod):
        """Info rows (``benchmarks/common.py::vision_infos``'s) as the
        LayerInfo of ``mod`` (either package's cost_model)."""
        hws = ref_vision.trace_hw(self.rlayers, self.hw)
        rows = []
        for i, (l, p) in enumerate(zip(self.rlayers, self.rparams)):
            leaves = jax.tree.leaves(p)
            rows.append(mod.LayerInfo(
                f"{l.kind}{i:02d}", int(sum(np.asarray(a).nbytes
                                            for a in leaves)),
                max(len(leaves), 1),
                ref_vision.layer_flops_conv(l, hws[i], BATCH)))
        return rows

    def port(self, workdir, **kw):
        return SwappedSequential(
            self.units, lambda i, p, xx: vision.apply_layer(
                self.layers[i], p, xx),
            str(workdir), device="cpu", **kw)

    def ref(self, workdir, **kw):
        return RefSwappedSequential(
            self.runits, lambda i, p, xx: ref_vision.apply_layer(
                self.rlayers[i], p, xx), str(workdir), **kw)

    def unswapped(self, params=None):
        return vision.apply_convnet(self.layers, params or self.params,
                                    torch.from_numpy(self.x))


@pytest.fixture(scope="module")
def vgg():
    return Net("vgg")


@pytest.fixture(scope="module")
def yolo():
    return Net("yolo")


def _plan_pair(net, tmp_path, budget, **kw):
    port = net.port(tmp_path / "port", **kw)
    ref = net.ref(tmp_path / "ref", **kw)
    port.partition_with(net.infos(cost_model), budget,
                        cost_model.DelayModel())
    ref.partition_with(net.infos(ref_cost_model), budget,
                       ref_cost_model.DelayModel())
    return port, ref


@pytest.mark.parametrize("kind,frac", [("vgg", 0.9), ("yolo", 0.9)])
def test_swapped_equals_unswapped_bitwise(vgg, yolo, tmp_path, kind, frac):
    """At least 3 blocks on mmap: the swapped pass equals the in-memory
    forward bitwise, the plan equals the reference's on the same rows, and
    the output the reference's swapped output within 1e-5."""
    net = {"vgg": vgg, "yolo": yolo}[kind]
    total = sum(r.size for r in net.infos(cost_model))
    port, ref = _plan_pair(net, tmp_path, int(total * frac))
    try:
        assert port.plan.n_blocks >= 3
        assert port.plan.points == ref.plan.points
        assert port.plan.m == ref.plan.m
        got, st = port.forward(net.x)
        assert torch.equal(got, net.unswapped())
        want, rst = ref.forward(jnp.asarray(net.x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("bytes_swapped", "bytes_logical", "bytes_by_precision",
                  "store_backend", "precision", "retries", "faults"):
            assert st[k] == rst[k], k
        assert (set(st) - {"smem_working_set", "peak_device_weights_mb"}
                == set(rst) - {"vmem_working_set"})
        assert st["peak_resident_mb"] * 1e6 <= int(total * frac)
        assert port.engine.ledger.resident == 0
    finally:
        port.close()
        ref.close()


def test_m1_degraded_plan_respected_at_runtime(vgg, tmp_path):
    """A budget between the largest layer and the largest adjacent pair
    forces an m = 1 plan; the executor then runs serially and the peak
    stays at or under the budget (``tests/test_swap_runtime.py``)."""
    sizes = [r.size for r in vgg.infos(cost_model)]
    budget = int(max(sizes) * 1.3)
    infos = [cost_model.LayerInfo(f"l{i}", s, r.depth, 1e6)
             for i, (s, r) in enumerate(zip(sizes, vgg.infos(cost_model)))]
    rinfos = [ref_cost_model.LayerInfo(r.name, r.size, r.depth, r.flops)
              for r in infos]
    plan, _ = partition.PartitionPlanner(
        infos, cost_model.DelayModel()).best_partition(budget)
    rplan, _ = ref_partition.PartitionPlanner(
        rinfos, ref_cost_model.DelayModel()).best_partition(budget)
    assert plan.m == 1 and (plan.points, plan.m) == (rplan.points, rplan.m)
    sw = vgg.port(tmp_path, budget=budget)
    try:
        sw.plan = plan
        out, st = sw.forward(vgg.x)     # MemoryError if m = 2 leaked
        assert torch.equal(out, vgg.unswapped())
        assert st["peak_resident_mb"] * 1e6 <= budget
    finally:
        sw.close()


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quant_store_files_match_reference(vgg, tmp_path, precision):
    port = vgg.port(tmp_path / "port", store_backend="quant",
                    precision=precision)
    ref = vgg.ref(tmp_path / "ref", store_backend="quant",
                  precision=precision)
    try:
        assert port.store.digests == ref.store.digests
        for name, _ in vgg.units:
            assert (port.store.resident_nbytes(name)
                    == ref.store.resident_nbytes(name))
            rp, pp = ref.store._path(name), port.store._path(name)
            assert os.path.basename(pp) == os.path.basename(rp)
            if os.path.exists(rp):
                with open(rp, "rb") as a, open(pp, "rb") as b:
                    assert a.read() == b.read(), name
            else:
                assert not os.path.exists(pp)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quant_forward_matches_reference(vgg, tmp_path, precision, fused):
    """Eager (widened at swap-in) and fused (fc weights stay quantized)
    forwards against the reference's quantized forward, and against the
    port's in-memory forward on the round-tripped weights."""
    port, ref = _plan_pair(vgg, tmp_path, 12 << 20, store_backend="quant",
                           precision=precision, fused=fused)
    try:
        assert port.plan.points == ref.plan.points
        assert port.store.eager is (not fused)
        seen = []
        apply = port.apply_fn
        port.apply_fn = lambda i, p, xx: (seen.extend(
            type(a) for a in tree_leaves(p)), apply(i, p, xx))[1]
        got, st = port.forward(vgg.x)
        want, rst = ref.forward(jnp.asarray(vgg.x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        bits = 8 if precision == "int8" else 4
        rt = [roundtrip(p, bits) for p in vgg.params]
        np.testing.assert_allclose(got.numpy(), vgg.unswapped(rt).numpy(),
                                   **TOL)
        for k in ("bytes_swapped", "bytes_logical", "bytes_by_precision",
                  "bytes_resident_quantized"):
            assert st[k] == rst[k], k
        # fused: the three fc weights arrive quantized, every conv widened
        assert seen.count(QuantizedTensor) == (3 if fused else 0)
        assert st["peak_resident_mb"] * 1e6 <= 12 << 20
    finally:
        port.close()
        ref.close()


def test_mixed_precision_forward_matches_reference(vgg, tmp_path):
    plan = {n: b for (n, _), b in zip(vgg.units, [8, 4, 0, 4, 8] * 4)}
    kw = dict(store_backend="quant", precision="mixed", fused=True,
              store_options={"plan": plan})
    with pytest.raises(ValueError, match="calibration plan"):
        vgg.port(tmp_path / "bad", store_backend="quant", precision="mixed")
    port, ref = _plan_pair(vgg, tmp_path, 12 << 20, **kw)
    try:
        assert port.store.digests == ref.store.digests
        got, st = port.forward(vgg.x)
        want, rst = ref.forward(jnp.asarray(vgg.x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert st["bytes_by_precision"] == rst["bytes_by_precision"]
    finally:
        port.close()
        ref.close()


def test_retried_faults_keep_the_output_bitwise(vgg, tmp_path):
    sw = vgg.port(tmp_path, store_backend="faulty",
                  store_options={"inner": "mmap", "p": 0.0,
                                 "latency_s": 0.001})
    try:
        sw.engine.retry_backoff_s = 0.001
        sw.partition_with(vgg.infos(cost_model), 20 << 20,
                          cost_model.DelayModel())
        sw.store.force("io", "corrupt", None, "torn")
        out, st = sw.forward(vgg.x)
        assert st["retries"] == 3
        assert st["faults"] == {"SwapIOError": 2, "SwapCorruptionError": 1}
        assert torch.equal(out, vgg.unswapped())
        assert sw.engine.ledger.resident == 0
    finally:
        sw.close()


# ------------------------------------------------------------ planner helpers
class _FakeStore:
    """Units with fixed read times on a fake clock: ``calibrated`` then
    sees the same seconds in both packages, whatever the host does."""

    device = torch.device("cpu")

    def __init__(self, units, clock, read_s):
        self.order = [n for n, _, _ in units]
        self._units = {n: (p, r) for n, p, r in units}
        self.skeletons = {n: type("S", (), {"nbytes": r})()
                          for n, _, r in units}
        self.clock, self.read_s = clock, read_s

    def read_unit(self, name):
        self.clock[0] += self.read_s[name]
        return type("R", (), {"params": self._units[name][0]})()

    def resident_nbytes(self, name):
        return self._units[name][1]


def test_calibrated_matches_reference(monkeypatch):
    rng = np.random.default_rng(0)
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    q8 = rng.integers(-127, 128, (64, 32)).astype(np.int8)
    s8 = rng.random(32).astype(np.float32)
    read_s = {"a": 0.004, "b": 0.0125, "c": 0.0, "d": 0.0007}
    sizes = {"a": 1 << 20, "b": 3 << 20, "c": 0, "d": 64 << 10}

    def units(qt, arr):
        return [("a", {"w": arr(q8), "b": arr(s8)}, sizes["a"]),
                ("b", {"w": qt, "b": arr(s8)}, sizes["b"]),
                ("c", {}, sizes["c"]),
                ("d", {"x": [arr(s8), arr(s8), arr(s8)]}, sizes["d"])]
    port_qt = QuantizedTensor(torch.from_numpy(q8), torch.from_numpy(s8),
                              (64, 32), "float32", 8)
    ref_qt = RefQuantizedTensor(jnp.asarray(q8), jnp.asarray(s8), (64, 32),
                                "float32", 8)
    for dm, rdm in [(cost_model.DelayModel(), ref_cost_model.DelayModel()),
                    (cost_model.DelayModel(beta=1e-3, kappa=1e-2),
                     ref_cost_model.DelayModel(beta=1e-3, kappa=1e-2))]:
        got = dm.calibrated(_FakeStore(units(port_qt, torch.from_numpy),
                                       clock, read_s))
        want = rdm.calibrated(_FakeStore(units(ref_qt, jnp.asarray),
                                         clock, read_s))
        assert (got.alpha, got.beta, got.gamma, got.eta, got.kappa) == (
            want.alpha, want.beta, want.gamma, want.eta, want.kappa)
        sub = dm.calibrated(_FakeStore(units(port_qt, torch.from_numpy),
                                       clock, read_s), ["b", "d"])
        rsub = rdm.calibrated(_FakeStore(units(ref_qt, jnp.asarray),
                                         clock, read_s), ["b", "d"])
        assert sub.alpha == rsub.alpha
    empty = cost_model.DelayModel()
    assert empty.calibrated(_FakeStore([("c", {}, 0)], clock,
                                       {"c": 1.0})) is empty


def test_r2_packing_and_paper_objective_match_reference():
    rng = np.random.default_rng(1)
    samples = [(float(s), float(d), float(t)) for s, d, t in zip(
        rng.integers(1 << 10, 1 << 24, 12), rng.integers(1, 9, 12),
        rng.random(12) * 1e-2)]
    dm = cost_model.DelayModel.fit(samples, [(1e9, 0.02)], [(4, 1e-4)])
    rdm = ref_cost_model.DelayModel.fit(samples, [(1e9, 0.02)], [(4, 1e-4)])
    assert dm.r2_in(samples) == rdm.r2_in(samples)
    assert cost_model.DelayModel().r2_in(samples) == \
        ref_cost_model.DelayModel().r2_in(samples)
    for pts, n, m in [((3, 7), 12, 2), ((1, 2, 3, 4), 5, 1), ((), 4, 2)]:
        assert cost_model.packing_density(
            partition.BlockPlan(pts, n, m=m)) == ref_cost_model.packing_density(
                ref_partition.BlockPlan(pts, n, m=m))
    s = rng.integers(1 << 10, 1 << 24, 9).astype(float)
    d = rng.integers(1, 9, 9).astype(float)
    f = rng.random(9) * 1e9
    for a, b in [(cost_model.DelayModel(), ref_cost_model.DelayModel()),
                 (dm, rdm)]:
        assert partition.paper_objective(s, d, f, a) == \
            ref_partition.paper_objective(s, d, f, b)


def test_prewarm_builds_the_reference_tables(vgg, yolo):
    for net in (vgg, yolo):
        port = partition.PartitionPlanner(net.infos(cost_model),
                                          cost_model.DelayModel())
        ref = ref_partition.PartitionPlanner(net.infos(ref_cost_model),
                                             ref_cost_model.DelayModel())
        total = sum(r.size for r in net.infos(cost_model))
        budgets = [total * f for f in (0.3, 0.6, 1.2)]
        port.prewarm(budgets)
        ref.prewarm(budgets)
        assert sorted(port._rows_cache) == sorted(ref._rows_cache)
        for key, rows in ref._rows_cache.items():
            assert port._rows_cache[key] == rows


# ------------------------------------------------------------ calibration
def test_weight_profile_and_plan_byte_identical(vgg, tmp_path):
    port = vgg.port(tmp_path / "port")
    ref = vgg.ref(tmp_path / "ref")
    try:
        port.set_plan(range(1, len(vgg.units)))
        ref.set_plan(range(1, len(vgg.units)))
        for fidelity in (2e-2, 1e-3):
            prof, plan = calibrate_sequential(port, vgg.x, fidelity,
                                              method="weight")
            rprof, rplan = ref_calibrate_sequential(
                ref, jnp.asarray(vgg.x), fidelity, method="weight")
            assert prof.to_json() == rprof.to_json()
            assert plan.to_json() == rplan.to_json()
    finally:
        port.close()
        ref.close()


def test_output_profile_and_plan_match_reference(vgg, tmp_path):
    """The swapped sweep through ``param_override`` (1 + 2q passes): the
    same signature, unit rows and byte counts, errors within 1e-5, the
    same assignments; repeated, the port's plan JSON byte for byte."""
    port, ref = _plan_pair(vgg, tmp_path, 20 << 20)
    try:
        prof, plan = calibrate_sequential(port, vgg.x, 2e-2)
        rprof, rplan = ref_calibrate_sequential(ref, jnp.asarray(vgg.x), 2e-2)
        assert (prof.arch, prof.signature, prof.batch_shape) == (
            rprof.arch, rprof.signature, rprof.batch_shape)
        assert sorted(prof.units) == sorted(rprof.units)
        for name, row in rprof.units.items():
            got = prof.units[name]
            assert sorted(got) == sorted(row)
            for k, v in row.items():
                if k.startswith("bytes_"):
                    assert got[k] == v
                else:
                    assert abs(got[k] - v) <= 1e-5, (name, k)
        assert plan.assignments == rplan.assignments
        assert plan.stored_bytes == rplan.stored_bytes
        assert abs(plan.predicted_err - rplan.predicted_err) <= 1e-5
        again = calibrate_sequential(port, vgg.x, 2e-2)[1]
        assert again.to_json() == plan.to_json()
        assert port.param_override is None
    finally:
        port.close()
        ref.close()
