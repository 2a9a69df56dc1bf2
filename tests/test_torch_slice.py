"""The slice as a whole: the port's SwappedModel against the JAX package's
on the same weights, and the port's own guarantees.

qwen2.5-3b ``reduced()``, float32, params from JAX ``Model.init`` handed
over as numpy. Tolerances, with their reasons:
  * port vs JAX, every store: 1e-5 (float32; the sums run in another
    order);
  * swapped vs unswapped inside the port on mmap, and a preempted pass vs
    an uninterrupted one: bitwise (the same ops on the same bytes);
  * swapped vs unswapped on the quantized stores: 1e-5 (the fused path
    scales once at the flush, the unswapped one multiplies dequantized
    weights);
  * greedy decode tokens: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.cost_model import DelayModel as RefDelayModel  # noqa: E402
from repro.core.runtime import SwappedModel as RefSwappedModel  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel, split_units  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.store import build_store  # noqa: E402
from repro_torch.store.quantized_store import roundtrip  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BUDGET = 8 * 1024 * 1024
STORES = {
    "mmap": dict(store_backend="mmap"),
    "int8-lazy": dict(store_backend="quant", precision="int8"),
    "int4-lazy": dict(store_backend="quant", precision="int4"),
    "int8-eager": dict(store_backend="quant", precision="int8",
                       store_options={"eager": True}),
}


@pytest.fixture(scope="module")
def setup():
    arch = "qwen2.5-3b"
    ref_model = RefModel(dataclasses.replace(ref_get_arch(arch).reduced(),
                                             dtype="float32"))
    ref_params = ref_model.init(jax.random.key(0))
    model = Model(dataclasses.replace(get_arch(arch).reduced(),
                                      dtype="float32"))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, model.cfg.vocab_size, (2, 32)).astype(np.int32)
    return ref_model, ref_params, model, params, tokens


def _port(setup, tmp_path, kind, **kw):
    _, _, model, params, _ = setup
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu",
                      **STORES[kind], **kw)
    sm.partition(BUDGET, DelayModel(), 2, 32)
    return sm


@pytest.mark.parametrize("kind", sorted(STORES))
def test_forward_matches_jax_swapped_model(setup, tmp_path, kind):
    ref_model, ref_params, _, _, tokens = setup
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"),
                          **STORES[kind])
    ref.partition(BUDGET, RefDelayModel(), 2, 32)
    want, ref_stats = ref.forward({"tokens": jnp.asarray(tokens)})
    ref.close()
    sm = _port(setup, tmp_path, kind)
    try:
        assert sm.plan.points == ref.plan.points and sm.plan.m == ref.plan.m
        assert sm.plan.n_blocks >= 2
        got, stats = sm.forward({"tokens": torch.from_numpy(tokens)})
    finally:
        sm.close()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("bytes_swapped", "bytes_logical", "bytes_resident_quantized",
                "bytes_by_precision", "precision", "store_backend"):
        assert stats[key] == ref_stats[key], key
    # the observed peak races at m >= 2 (when the loader charges block i+1
    # against when the executor drops block i), in both packages: hold it
    # to the plan's peak window instead of to the reference's reading
    planned = next(r.max_memory for r in sm.table
                   if r.points == sm.plan.points)
    assert 0 < stats["peak_resident_mb"] * 1e6 <= planned <= BUDGET


def test_mmap_swapped_equals_unswapped_bitwise(setup, tmp_path):
    _, _, model, params, tokens = setup
    sm = _port(setup, tmp_path, "mmap")
    try:
        got, stats = sm.forward({"tokens": torch.from_numpy(tokens)})
        direct = sm.forward_unswapped({"tokens": torch.from_numpy(tokens)})
    finally:
        sm.close()
    assert torch.equal(got, direct)
    # and the whole-model prefill computes the same logits
    ref, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    assert stats["peak_resident_mb"] * 1e6 <= BUDGET


@pytest.mark.parametrize("kind", ["int8-lazy", "int4-lazy", "int8-eager"])
def test_quant_swapped_matches_dequantized_unswapped(setup, tmp_path, kind):
    _, _, _, _, tokens = setup
    sm = _port(setup, tmp_path, kind)
    try:
        got, stats = sm.forward({"tokens": torch.from_numpy(tokens)})
        bits = 4 if kind.startswith("int4") else 8
        deq = [roundtrip(u.params, bits) for u in sm.units]
        direct = sm.forward_unswapped({"tokens": torch.from_numpy(tokens)},
                                      unit_params=deq)
    finally:
        sm.close()
    np.testing.assert_allclose(got.numpy(), direct.numpy(), **TOL)
    assert stats["peak_resident_mb"] * 1e6 <= BUDGET
    assert stats["smem_working_set"] > 0


def test_budget_enforced(setup, tmp_path):
    _, _, model, params, tokens = setup
    sm = SwappedModel(model, params, str(tmp_path / "b"), budget=1024,
                      device="cpu")
    try:
        sm.set_plan((len(sm.units) // 2,))
        with pytest.raises(MemoryError):
            sm.forward({"tokens": torch.from_numpy(tokens)})
        assert sm.engine.ledger.resident == 0
    finally:
        sm.close()


@pytest.mark.parametrize("kind", list(STORES))
def test_device_weight_bytes_beside_ledger(setup, tmp_path, kind):
    """The device bytes of the resident weights against the ledger's
    charge: equal on mmap and on the lazy quant stores (at most the
    128-byte alignment padding apart: 1%); about 4x over on eager quant,
    which charges the stored int8 payload while it holds the dequantized
    fp32 leaves (the JAX package's convention, a known parity fault)."""
    _, _, _, _, tokens = setup
    sm = _port(setup, tmp_path, kind)
    try:
        _, stats = sm.forward({"tokens": torch.from_numpy(tokens)})
    finally:
        sm.close()
    ledger, dev = stats["peak_resident_mb"], stats["peak_device_weights_mb"]
    if kind == "int8-eager":
        assert dev > 3 * ledger
    else:
        assert ledger <= dev <= 1.01 * ledger


@pytest.mark.parametrize("kind", ["mmap", "int8-lazy"])
def test_preempted_pass_is_bitwise_uninterrupted(setup, tmp_path, kind):
    _, _, _, _, tokens = setup
    batch = {"tokens": torch.from_numpy(tokens)}
    sm = _port(setup, tmp_path, kind)
    try:
        sm.set_plan(tuple(range(1, len(sm.units))))      # one unit a block
        want, _ = sm.forward(batch)
        state, stats = sm.forward_partial(batch, should_yield=lambda s: True)
        pauses = 0
        while stats is None:
            assert sm.engine.ledger.resident == 0        # drained at pause
            pauses += 1
            state, stats = sm.forward_partial(batch, state,
                                              should_yield=lambda s: True)
    finally:
        sm.close()
    assert pauses == len(sm.units) - 1 and state.preemptions == pauses
    assert torch.equal(state.logits, want)


@pytest.mark.parametrize("kind", ["mmap", "int8-lazy"])
def test_decode_loop_tokens_match_jax(setup, tmp_path, kind):
    ref_model, ref_params, _, _, tokens = setup
    prompt = tokens[:, :6]
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"),
                          **STORES[kind])
    ref.partition(BUDGET, RefDelayModel(), 2, 6)
    want, _ = ref.decode_loop(jnp.asarray(prompt), max_new_tokens=4,
                              max_len=16)
    ref.close()
    sm = _port(setup, tmp_path, kind)
    try:
        got, stats = sm.decode_loop(torch.from_numpy(prompt),
                                    max_new_tokens=4, max_len=16)
    finally:
        sm.close()
    assert got.tolist() == np.asarray(want).tolist()
    assert stats["peak_resident_mb"] * 1e6 <= BUDGET


@pytest.mark.parametrize("store", ["mmap", "quant"])
def test_serve_entry_runs_on_cpu(capsys, store):
    out = serve.main(["--arch", "qwen2.5-3b", "--reduce", "smoke",
                      "--budget-mb", "8", "--requests", "2",
                      "--prompt-len", "8", "--new-tokens", "2",
                      "--store", store, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[serve] swapped prefill" in text and "device=cpu" in text
    assert tuple(out["tokens"].shape) == (2, 2)
    assert torch.isfinite(out["logits"]).all()


def test_default_device_raises_without_cuda(setup, tmp_path, monkeypatch):
    _, _, model, params, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SwappedModel(model, params, str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.alloc_cache(2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_store(split_units(model, params)[:1], str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen2.5-3b", "--budget-mb", "8"])
