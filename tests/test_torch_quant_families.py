"""The int8 lazy store in bf16 for deepseek-v2-lite, zamba2-7b and
qwen2-vl-72b: the families ``chip_smoke.py`` phases 11-13 run on the card
in an int8-lazy arm. Their fp32 parity with the JAX package's quantized
store is in ``tests/test_torch_mla.py``, ``test_torch_zamba2.py`` and
``test_torch_vlm.py``; here the compute dtype is the one the card runs.

Each config is ``reduced()`` in bfloat16 (deepseek: 2 MLA + MoE layers;
zamba2: mamba2, shared, mamba2, shared; qwen2-vl: 2 dense layers with 16
vision tokens on a 4 x 4 grid), params from the JAX ``Model.init`` handed
over as numpy, a 2 x 32 prompt. Tolerances, with their reasons:
  * the port's swapped logits against the reference's quantized swapped
    logits, bf16: 2e-2 of the largest |logit|, or the reference's own
    bf16 distance from its fp32 logits where that is larger: bf16 rounds
    at other places in the two frameworks (the int8 bytes are equal), and
    two bf16 runs can lie no closer than bf16 moves one. Reduced zamba2's
    bf16 stack lies 3.1% of its largest logit from fp32 (the others
    0.9-1.4%), and the two packages 2.03% apart;
  * swapped against ``forward_unswapped`` over the store's own lazy leaves
    (each unit's ``read_unit`` tree, QuantizedTensors kept): bitwise (the
    same ops on the same bytes);
  * swapped against the unswapped forward over those leaves widened
    (``swap_linear`` on bf16 copies, where ``swap_linear_q`` scales the
    int8 weight in its fp32 accumulator): the same bound, against the
    port's fp32 run (the widened weights' bf16 rounding and the
    activations' at other places).

llama4-scout's arm (phase 9) is counted here too: the kernels one swapped
int8-lazy pass calls on the reduced config, exact counts, and the pass
bitwise the forward over the lazy leaves. Its logits are not held to the
reference's here: quantized llama4 strays from fp in both packages, and
``tests/test_torch_moe.py`` holds its quantized logits to the reference's
in fp32.
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
from repro_torch.core.cost_model import (DelayModel,  # noqa: E402
                                         resident_infos)
from repro_torch.core.partition import PartitionPlanner  # noqa: E402
from repro_torch.core.runtime import SwappedModel, unit_infos  # noqa: E402
from repro_torch.kernels import dequant as dq  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import swap_linear as sl  # noqa: E402
from repro_torch.kernels import swap_linear_q as slq  # noqa: E402
from repro_torch.kernels.qtensor import (QuantizedTensor,  # noqa: E402
                                         materialize_tree)
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

FAMILIES = ["deepseek-v2-lite-16b", "zamba2-7b", "qwen2-vl-72b"]
BF16_TOL = 2e-2
BUDGET = 8 * 1024 * 1024
B, S = 2, 32


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(reference model, its params, port model, the same params) of one
    family's reduced config in bfloat16."""
    name = request.param
    ref_model = RefModel(dataclasses.replace(ref_get_arch(name).reduced(),
                                             dtype="bfloat16"))
    ref_params = jax.jit(ref_model.init)(jax.random.key(0))
    model = Model(dataclasses.replace(get_arch(name).reduced(),
                                      dtype="bfloat16"))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def _fp32(model_cls, model):
    return model_cls(dataclasses.replace(model.cfg, dtype="float32"))


def _within_bf16(got, want, want32) -> None:
    """max |got - want| <= 2e-2 of the largest |want|, or want's own
    distance from its fp32 run where that is larger."""
    got, want, want32 = (np.asarray(a, np.float32)
                         for a in (got, want, want32))
    gap = np.abs(got - want).max()
    bound = max(BF16_TOL * np.abs(want).max(), np.abs(want - want32).max())
    assert gap <= bound, (gap, bound)


def _batch(cfg, seed=3):
    """A B x S prompt as numpy; qwen2-vl's first ``n_vision_tokens``
    positions seeded vision embeddings on a square patch grid (the
    temporal stream the index)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.rope_type == "mrope":
        nv = cfg.n_vision_tokens
        side = int(nv ** 0.5)
        i = np.arange(S)
        pos = np.stack([i, np.where(i < nv, i // side, i),
                        np.where(i < nv, i % side, i)], axis=-1)
        batch["vision_embeds"] = rng.standard_normal(
            (B, nv, cfg.d_frontend)).astype(np.float32)
        batch["positions"] = np.broadcast_to(pos, (B, S, 3)).astype(
            np.int32).copy()
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _b1_per_pass(cfg) -> int:
    """swap_linear_q calls of one swapped prefill on the int8 lazy store:
    a dense or MoE layer's 7 or 5 (wq, wo and the shared expert's three:
    MLA's latent projections and the routed stacks are widened), a Mamba2
    layer's wo, the shared block's 7, and the head."""
    per = {"dense": 7, "moe": 5 if cfg.mla is not None else 7,
           "mamba2": 1, "shared_attn": 7}
    return sum(per[k] for k in cfg.layer_kinds()) + 1


def _lazy_units(sm):
    """Each unit as the store hands it over (QuantizedTensors kept), one
    read a stored unit."""
    stored = {n: sm.store.read_unit(n).params
              for n in dict.fromkeys(u.name for u in sm.units)}
    return [stored[u.name] for u in sm.units]


def _int8_lazy(model, params, workdir, budget=BUDGET):
    sm = SwappedModel(model, params, str(workdir), device="cpu",
                      store_backend="quant", precision="int8")
    sm.partition(budget, DelayModel(), B, S)
    return sm


def test_bf16_int8_lazy_prefill_matches_the_reference(family, tmp_path):
    """The swapped bf16 prefill on the int8 lazy store against the JAX
    package's quantized swapped model on the same weights: the same plan,
    logits within the bf16 tolerance."""
    ref_model, ref_params, model, params = family
    batch = _batch(model.cfg)
    refs = {}
    for dt, m in (("bf16", ref_model), ("fp32", _fp32(RefModel, ref_model))):
        ref = RefSwappedModel(m, ref_params, str(tmp_path / f"ref{dt}"),
                              store_backend="quant", precision="int8")
        try:
            ref.partition(BUDGET, RefDelayModel(), B, S)
            refs[dt], _ = ref.forward({k: jnp.asarray(v)
                                       for k, v in batch.items()})
        finally:
            ref.close()
    sm = _int8_lazy(model, params, tmp_path / "port")
    try:
        assert sm.plan.points == ref.plan.points
        got, st = sm.forward(_t(batch))
    finally:
        sm.close()
    assert st["precision"] == "int8" and st["store_backend"] == "quant"
    assert got.dtype == torch.float32 and tuple(got.shape) == (
        B, 1, model.cfg.vocab_size)
    _within_bf16(got.numpy(), refs["bf16"], refs["fp32"])


def test_swapped_equals_the_forward_over_the_lazy_leaves(family, tmp_path):
    """The arm's first identity: the swapped pass is bitwise the
    unswapped forward over the store's own lazy leaves, and both stream
    every fusable weight through swap_linear_q (none through
    swap_linear)."""
    _, _, model, params = family
    batch = _t(_batch(model.cfg, seed=4))
    calls = {"q": 0, "fp": 0}
    plain_q, plain_fp = slq.swap_linear_q_plain, sl.swap_linear_plain

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    sm = _int8_lazy(model, params, tmp_path / "port")
    try:
        slq.swap_linear_q_plain = count("q", plain_q)
        sl.swap_linear_plain = count("fp", plain_fp)
        got, _ = sm.forward(batch)
        swapped = dict(calls)
        lazy = _lazy_units(sm)
        assert any(isinstance(x, QuantizedTensor) for p in lazy
                   for x in tree_leaves(p, is_leaf=lambda y: isinstance(
                       y, QuantizedTensor)))
        want = sm.forward_unswapped(batch, resident=lazy)
    finally:
        slq.swap_linear_q_plain, sl.swap_linear_plain = plain_q, plain_fp
        sm.close()
    n = _b1_per_pass(model.cfg)
    assert swapped == {"q": n, "fp": 0}
    assert calls == {"q": 2 * n, "fp": 0}
    assert torch.equal(got, want)


def test_swapped_near_the_forward_over_widened_leaves(family, tmp_path):
    """The arm's second identity: the lazy leaves widened (the store's
    round trip) through swap_linear on bf16 copies give logits within the
    bf16 bound of the swapped pass's (the swapped pass's own distance from
    its fp32 run)."""
    _, _, model, params = family
    batch = _t(_batch(model.cfg, seed=5))
    sm = _int8_lazy(model, params, tmp_path / "port")
    try:
        got, _ = sm.forward(batch)
        widened = [materialize_tree(p) for p in _lazy_units(sm)]
        assert not any(isinstance(x, QuantizedTensor)
                       for p in widened for x in tree_leaves(p))
        want = sm.forward_unswapped(batch, resident=widened)
    finally:
        sm.close()
    sm = _int8_lazy(_fp32(Model, model), params, tmp_path / "port32")
    try:
        got32, _ = sm.forward(batch)
    finally:
        sm.close()
    assert not torch.equal(got, want)
    _within_bf16(got.numpy(), want.numpy(), got32.numpy())


def test_zamba2_pinned_quant_unit_charged_its_lazy_bytes(tmp_path):
    """zamba2's shared block on the int8 lazy store, planned as the arm
    plans (1.1x the smallest budget at m = 2): the pinned unit stays
    charged after the pass at its lazy resident bytes (its quantized
    linears' payload and scales, its norms raw), not its logical bytes,
    and the ledger's peak stays within the plan budget plus them."""
    model = Model(dataclasses.replace(get_arch("zamba2-7b").reduced(),
                                      dtype="bfloat16"))
    params = model.init(0, device="cpu")
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu",
                      store_backend="quant", precision="int8")
    try:
        store = sm.store
        shared = store.resident_nbytes("shared_attn")
        assert sorted(sm.engine.pinned) == ["shared_attn"]
        assert shared < store.nbytes("shared_attn")
        names = [u.name for u in sm.units]
        pp = PartitionPlanner(resident_infos(
            unit_infos(model, sm.units, B, S), store, names), DelayModel(),
            m=2)
        floor = int(max(pp.sizes))
        while True:
            try:
                pp.best_partition(floor, 0.05, allow_degrade=False)
                break
            except ValueError:
                floor += 1024
        budget = int(1.1 * floor)
        sm.partition(budget, DelayModel(), B, S)
        assert sm.plan.m == 2 and sm.plan.n_blocks >= 3
        sm.engine.ledger.budget = budget + shared
        got, st = sm.forward(_t(_batch(model.cfg, seed=6)))
        ledger = sm.engine.ledger
        assert ledger.resident == shared
        assert ledger.peak <= budget + shared
        assert sm.engine.stats.peak_resident <= budget + shared
        assert st["cache_hit_rate"] > 0      # its second occurrence
        assert bool(torch.isfinite(got).all())
    finally:
        sm.close()


@pytest.mark.parametrize("n_layers", [1, 2])
def test_llama4_int8_lazy_pass_launches(monkeypatch, tmp_path, n_layers):
    """llama4-scout's int8-lazy arm as ``chip_smoke.py`` phase 9 runs it
    (``quant_arm``'s expected launches), on the reduced config in bf16 cut
    to ``n_layers``: one swapped pass calls swap_linear_q 7 times a moe
    layer (wq, wk, wv, wo and the shared expert's three) and once for the
    head, flash_attention once a layer at the block-local chunk of a local
    layer, and neither swap_linear nor dequant_int8 (the routed stacks,
    the router and the embedding widen on the host); the pass equals the
    forward over the store's lazy leaves bitwise. Counted on the CPU,
    where each wrapper runs its plain version."""
    cfg = dataclasses.replace(get_arch("llama4-scout-17b-a16e").reduced(),
                              dtype="bfloat16", n_layers=n_layers)
    assert cfg.layer_kinds() == ("moe",) * n_layers
    calls = {"swap_linear_q": 0, "swap_linear": 0, "dequant_int8": 0}
    chunks = []

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def attention(*a, **kw):
        chunks.append(kw["chunk"])
        return plain_fa(*a, **kw)
    plain_fa = fa.flash_attention_plain
    monkeypatch.setattr(slq, "swap_linear_q_plain",
                        count("swap_linear_q", slq.swap_linear_q_plain))
    monkeypatch.setattr(sl, "swap_linear_plain",
                        count("swap_linear", sl.swap_linear_plain))
    monkeypatch.setattr(dq, "dequant_int8_plain",
                        count("dequant_int8", dq.dequant_int8_plain))
    monkeypatch.setattr(fa, "flash_attention_plain", attention)
    model = Model(cfg)
    sm = _int8_lazy(model, model.init(0, device="cpu"), tmp_path / "port")
    try:
        got, _ = sm.forward(_t(_batch(cfg, seed=7)))
        swapped, swapped_chunks = dict(calls), list(chunks)
        want = sm.forward_unswapped(_t(_batch(cfg, seed=7)),
                                    resident=_lazy_units(sm))
    finally:
        sm.close()
    assert swapped == {"swap_linear_q": 7 * n_layers + 1, "swap_linear": 0,
                       "dequant_int8": 0}
    assert S > cfg.attn_chunk and swapped_chunks == [
        cfg.attn_chunk if cfg.is_local_layer(i) else None
        for i in range(n_layers)]
    assert torch.equal(got, want)
