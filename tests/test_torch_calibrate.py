"""The calibration pass and the mixed-precision store of the port against
the JAX package's: sensitivity profiles, precision plans, the stored-bytes
model, mixed-store files and CRCs, swapped mixed logits, the runtime's
auto-calibration and the CLI's artifacts.

qwen2.5-3b ``reduced()``, float32, params from JAX ``Model.init`` handed
over as numpy. Tolerances: the ``weight`` profile, every plan solved from
one profile, unit byte counts, store files and CRCs are byte-identical;
the ``output`` profile's errors within rtol 1e-4 (atol 1e-7), since each
is a rel-L2 of two forward passes whose float sums run in another order
in each package; swapped logits within 1e-5.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.calibrate as ref_calibrate  # noqa: E402
from repro.calibrate import calibrate_model as ref_calibrate_model  # noqa: E402
from repro.calibrate import calibration_batch as ref_batch  # noqa: E402
from repro.calibrate import quantize_roundtrip as ref_roundtrip  # noqa: E402
from repro.calibrate.policy import PrecisionPlan as RefPlan  # noqa: E402
from repro.calibrate.policy import \
    assign_precisions as ref_assign  # noqa: E402
from repro.calibrate.profiler import \
    SensitivityProfile as RefProfile  # noqa: E402
from repro.calibrate.profiler import _weight_err as ref_weight_err  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.multi_model import \
    MultiModelRuntime as RefMultiModelRuntime  # noqa: E402
from repro.core.runtime import SwappedModel as RefSwappedModel  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.store.quantized_store import \
    QuantizedStore as RefQuantizedStore  # noqa: E402
from repro.store.quantized_store import \
    unit_stored_nbytes as ref_unit_stored_nbytes  # noqa: E402
import repro_torch.calibrate as port_calibrate  # noqa: E402
from repro_torch.calibrate import (PRECISION_LADDER, PrecisionPlan,  # noqa: E402
                                   SensitivityProfile, assign_precisions,
                                   calibrate_model, calibration_batch)
from repro_torch.calibrate.__main__ import main as calibrate_main  # noqa: E402
from repro_torch.calibrate.profiler import _weight_err  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.multi_model import MultiModelRuntime  # noqa: E402
from repro_torch.core.runtime import SwappedModel, split_units  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.store.quantized_store import (QuantizedStore,  # noqa: E402
                                               roundtrip_leaf,
                                               unit_stored_nbytes)

ARCH = "qwen2.5-3b"
TOL = dict(rtol=1e-5, atol=1e-5)
RANK = {p: i for i, p in enumerate(PRECISION_LADDER)}


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(ref_get_arch(ARCH).reduced(), dtype="float32")
    ref_model = RefModel(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    model = Model(dataclasses.replace(get_arch(ARCH).reduced(),
                                      dtype="float32"))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


@pytest.fixture(scope="module")
def profiles(pair):
    """(reference, port) output-method profiles on the same params and
    batch, each package's calibrate_model at fidelity 2e-2."""
    ref_model, ref_params, model, params = pair
    ref = ref_calibrate_model(ref_model, ref_params, fidelity=2e-2)
    port = calibrate_model(model, params, fidelity=2e-2, device="cpu")
    return ref, port


def test_calibration_batch_matches_reference(pair):
    ref_model, _, model, _ = pair
    for seed in (0, 3):
        a = calibration_batch(model.cfg, seed=seed)["tokens"]
        b = np.asarray(ref_batch(ref_model.cfg, seed=seed)["tokens"])
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roundtrip_leaf_matches_reference(bits, dtype):
    x = jax.random.normal(jax.random.key(bits), (96, 80)).astype(dtype)
    got = roundtrip_leaf(params_from_jax(np.asarray(x)), bits)
    want = params_from_jax(ref_roundtrip(np.asarray(x), bits))
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_weight_err_skips_bfloat16_leaves_like_reference():
    """The reference's weight proxy counts only numpy-floating leaves, so
    a bfloat16 leaf adds to neither sum; the port does the same."""
    tree = {"w": np.asarray(jax.random.normal(jax.random.key(1), (64, 48))
                            .astype("bfloat16")),
            "v": np.asarray(jax.random.normal(jax.random.key(2), (64, 32))),
            "b": np.asarray(jax.random.normal(jax.random.key(3), (48,)))}
    port = params_from_jax(tree)
    for bits in (8, 4):
        assert _weight_err(port, bits, 1024) == ref_weight_err(tree, bits,
                                                               1024)


def test_weight_profile_and_plans_byte_identical(pair):
    ref_model, ref_params, model, params = pair
    for fidelity in (2e-2, 1e-3):
        ref_prof, ref_plan = ref_calibrate_model(
            ref_model, ref_params, fidelity=fidelity, method="weight")
        prof, plan = calibrate_model(model, params, fidelity=fidelity,
                                     method="weight", device="cpu")
        assert prof.to_json() == ref_prof.to_json()
        assert plan.to_json() == ref_plan.to_json()


def test_output_profile_matches_reference(profiles):
    (ref_prof, _), (prof, _) = profiles
    assert prof.signature == ref_prof.signature
    assert (prof.arch, prof.method, prof.seed, prof.batch_shape) == \
        (ref_prof.arch, ref_prof.method, ref_prof.seed,
         tuple(ref_prof.batch_shape))
    assert sorted(prof.units) == sorted(ref_prof.units)
    for name, row in ref_prof.units.items():
        for k, v in row.items():
            if k.startswith("bytes_"):
                assert prof.units[name][k] == v, (name, k)
            else:
                np.testing.assert_allclose(prof.units[name][k], v,
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"{name} {k}")
    assert any(v > 0 for u in prof.units.values()
               for k, v in u.items() if k.startswith("err_"))


TARGETS = [float("inf"), 1e-1, 2e-2, 5e-3, 1e-3, 1e-9]


@pytest.mark.parametrize("fidelity", TARGETS, ids=str)
def test_plan_from_reference_profile_byte_identical(profiles, fidelity):
    """One profile, two solvers: the port's plan JSON is the reference's
    byte for byte, from no-op (inf) to a target that forces fp."""
    (ref_prof, _), _ = profiles
    mine = assign_precisions(SensitivityProfile.from_json(ref_prof.to_json()),
                             fidelity)
    assert mine.to_json() == ref_assign(ref_prof, fidelity).to_json()
    if fidelity == 1e-9:
        assert "fp" in mine.histogram() and mine.histogram()["fp"] > 0


def test_plan_precision_monotone_in_target(profiles):
    """Tightening the target never demotes a unit."""
    _, (prof, _) = profiles
    prev = None
    for t in sorted(TARGETS, reverse=True):
        cur = assign_precisions(prof, t).assignments
        if prev is not None:
            assert all(RANK[cur[u]] >= RANK[prev[u]] for u in cur), t
        prev = cur


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_unit_stored_nbytes_matches_store_and_reference(pair, tmp_path, bits):
    _, _, model, params = pair
    units = [(u.name, u.params) for u in split_units(model, params)]
    store = QuantizedStore.build(units, str(tmp_path),
                                 plan={n: bits for n, _ in units})
    try:
        for name, p in units:
            got = unit_stored_nbytes(p, bits)
            assert got == store.stored_nbytes(name)
            assert got == ref_unit_stored_nbytes(
                jax.tree.map(lambda t: t.numpy(), p), bits)
    finally:
        store.close()


def _mixed_plan(units):
    """A plan with every precision: embed fp, layers int8 / int4, head int4."""
    names = [n for n, _ in units]
    return {n: (0 if i == 0 else 8 if i % 2 else 4)
            for i, n in enumerate(names)}


def test_mixed_store_files_and_crcs_match_reference(pair, tmp_path):
    from repro.core.runtime import split_units as ref_split_units
    ref_model, ref_params, model, params = pair
    ref_units = [(u.name, u.params) for u in ref_split_units(ref_model,
                                                              ref_params)]
    units = [(u.name, u.params) for u in split_units(model, params)]
    bits = _mixed_plan(units)
    plan = PrecisionPlan({n: {0: "fp", 8: "int8", 4: "int4"}[b]
                          for n, b in bits.items()}, 1e-2, 0.0)
    ref = RefQuantizedStore.build(ref_units, str(tmp_path / "ref"),
                                  plan=RefPlan.from_json(plan.to_json()))
    port = QuantizedStore.build(units, str(tmp_path / "port"), plan=plan)
    try:
        assert port.plan == ref.plan == bits
        assert port.suffix == ref.suffix == ".qm"
        for name in ref.order:
            with open(ref._path(name), "rb") as a, \
                    open(port._path(name), "rb") as b:
                assert a.read() == b.read(), name
            assert port.stored_nbytes(name) == ref.stored_nbytes(name)
            assert port.resident_nbytes(name) == ref.resident_nbytes(name)
            assert (port._qmeta[name].precision_bytes
                    == ref._qmeta[name].precision_bytes)
        assert port.digests == ref.digests
    finally:
        port.close()


def test_mixed_swapped_logits_match_reference(pair, tmp_path):
    ref_model, ref_params, model, params = pair
    units = [(u.name, u.params) for u in split_units(model, params)]
    bits = _mixed_plan(units)
    batch = calibration_batch(model.cfg, seed=1)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"),
                          store_backend="quant", precision="mixed",
                          store_options={"plan": bits})
    ref.set_plan(tuple(range(1, len(ref.units))))
    want, ref_st = ref.forward(batch)
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"),
                      store_backend="quant", precision="mixed",
                      store_options={"plan": bits}, device="cpu")
    try:
        sm.set_plan(tuple(range(1, len(sm.units))))
        got, st = sm.forward(batch)
        again, _ = sm.forward(batch)
    finally:
        sm.close()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, again)
    bp = st["bytes_by_precision"]
    assert set(bp) == {"fp", "int8", "int4"}
    assert sum(bp.values()) == st["bytes_swapped"]
    assert bp == ref_st["bytes_by_precision"]


def test_param_override_substitutes_one_unit_off_the_ledger(pair, tmp_path):
    """The seam the profiler drives: the substituted unit's params run on
    the model's device in the unit's dtype, the ledger sees only the
    swapped blocks, and without the override the pass is unchanged."""
    _, _, model, params = pair
    sm = SwappedModel(model, params, str(tmp_path), store_backend="mmap",
                      device="cpu")
    try:
        sm.set_plan(tuple(range(1, len(sm.units))))
        batch = calibration_batch(model.cfg)
        base, _ = sm.forward(batch)
        peak = sm.engine.stats.peak_resident
        head = sm.units[-1]
        zero = {k: np.zeros(tuple(v.shape), np.float64)
                for k, v in head.params.items()}
        seen = []

        def override(u, p):
            if u.name != head.name:
                return p
            return zero

        sm.param_override = override
        got, _ = sm.forward(batch)
        sm.param_override = lambda u, p: seen.append(u.name) or p
        again, _ = sm.forward(batch)
        sm.param_override = None
    finally:
        sm.close()
    assert torch.count_nonzero(got) == 0 and got.dtype == torch.float32
    assert torch.equal(again, base)
    assert seen == [u.name for u in sm.units]
    assert sm.engine.stats.peak_resident == peak


def test_runtime_auto_calibrates_to_reference_plan(pair, tmp_path,
                                                   monkeypatch):
    """MultiModelRuntime(precision='mixed', fidelity=...) calibrates in
    add_model (the weight method) to the reference's plan byte for byte,
    and builds the store from it."""
    ref_model, ref_params, model, params = pair
    plans = {}

    def spy(key, fn):
        def wrapped(*a, **kw):
            prof, plan = fn(*a, **kw)
            plans[key] = plan
            return prof, plan
        return wrapped
    monkeypatch.setattr(ref_calibrate, "calibrate_model",
                        spy("ref", ref_calibrate.calibrate_model))
    monkeypatch.setattr(port_calibrate, "calibrate_model",
                        spy("port", port_calibrate.calibrate_model))
    kw = dict(store_backend="quant", precision="mixed", fidelity=1e-2,
              calib_method="weight", prefetch_depth=1, cache_frac=0.1)
    ref = RefMultiModelRuntime(int(8e6), **kw)
    ref.add_model(ARCH, ref_model, ref_params, str(tmp_path / "ref"))
    rt = MultiModelRuntime(int(8e6), device="cpu", **kw)
    try:
        sm = rt.add_model(ARCH, model, params, str(tmp_path / "port"))
        assert plans["port"].to_json() == plans["ref"].to_json()
        assert sm.store.plan == ref.models[ARCH].store.plan \
            == plans["port"].bits_map()
        assert plans["port"].histogram()["int8"] > 0
        assert all(k.startswith(f"{ARCH}/") for k in sm.store.plan)
    finally:
        rt.close()
        ref.close()


def test_calibrate_cli_artifacts_load_in_both_packages(pair, tmp_path,
                                                       capsys):
    out, plan_out = tmp_path / "prof.json", tmp_path / "plan.json"
    assert calibrate_main(["--arch", ARCH, "--method", "weight",
                           "--fidelity", "1e-2", "--device", "cpu",
                           "--out", str(out), "--plan-out",
                           str(plan_out)]) == 0
    assert "plan @ fidelity 0.01" in capsys.readouterr().out
    ref_prof = RefProfile.load(str(out))
    ref_plan = RefPlan.load(str(plan_out))
    assert ref_prof.to_json() == out.read_text().strip()
    assert ref_plan.to_json() == plan_out.read_text().strip()
    assert ref_assign(ref_prof, 1e-2).to_json() == ref_plan.to_json()
    # and the reference's artifacts load in the port
    ref_model, ref_params, _, _ = pair
    rp, rplan = ref_calibrate_model(ref_model, ref_params, fidelity=1e-2,
                                    method="weight")
    rp.save(str(tmp_path / "r_prof.json"))
    rplan.save(str(tmp_path / "r_plan.json"))
    assert SensitivityProfile.load(
        str(tmp_path / "r_prof.json")).to_json() == rp.to_json()
    assert PrecisionPlan.load(
        str(tmp_path / "r_plan.json")).bits_map() == rplan.bits_map()
    doctored = json.loads(rplan.to_json())
    doctored["version"] = 99
    with pytest.raises(ValueError, match="version"):
        PrecisionPlan.from_json(json.dumps(doctored))
