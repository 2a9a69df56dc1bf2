"""granite-20b and h2o-danube-3-4b against the JAX package, at narrow widths
that keep each config's attention geometry.

``reduced()`` sets every config to head dim 64 and at most 4 heads, which
hides what these two configs ask of the paged decode kernel. So the
reduced configs get their published head geometry back: granite-20b 48
query heads of 128 on one KV head (multi-query attention), its int4
``swap_precision`` and its non-gated GELU MLP; h2o-danube-3-4b 32 query
heads of 120 on 8 KV heads, its sliding window at the reduced 64 tokens on
every layer. Params from the JAX ``Model.init`` handed over as numpy,
float32. Tolerances:
  * prefill logits and the int4 lazy store's swapped logits: 1e-5
    (float32; the sums run in another order); the prefill's K cache: 1e-5
    of its largest value (the second layer's K rows carry the first's
    rounding);
  * paged continuous-batching decode: equal tokens, to each request served
    alone in memory and to the JAX package's ``BatchDecodeEngine``, and
    the same step trace (batch, admissions, retirements, preemptions,
    pages per step).
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
from repro.core.swap_engine import MemoryLedger as RefLedger  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.serving.batch_engine import \
    BatchDecodeEngine as RefBatchDecodeEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.paged_kv import PagedKVCache as RefPagedKVCache  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel  # noqa: E402
from repro_torch.core.swap_engine import MemoryLedger  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.batch_engine import BatchDecodeEngine  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.paged_kv import PagedKVCache  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MB = 1024 * 1024
# a layer at these geometries holds 11.6 (danube) to 13.6 MB (granite)
BUDGET = 20 * MB
BIG_LEDGER = 1 << 30
GEOMETRY = {
    "granite-20b": dict(n_heads=48, n_kv_heads=1, head_dim=128),
    "h2o-danube-3-4b": dict(n_heads=32, n_kv_heads=8, head_dim=120,
                            sliding_window=64),
}
# (prompt lengths, page tokens, pages): danube's 70-token prompt on pages
# of 4 passes its 64-token window, so its decode steps skip whole pages
PAGED = {
    "granite-20b": ((8, 13, 5, 8, 8), 4, 24),
    "h2o-danube-3-4b": ((70, 8, 13, 8, 8), 4, 40),
}
MAX_NEW = [2, 6, 3, 5, 4]


def _cfg(get, arch):
    return dataclasses.replace(get(arch).reduced(), dtype="float32",
                               **GEOMETRY[arch])


class _Pair:
    """One arch in both packages on the same weights: a swapped mmap model
    each (planned alike), the port's in-memory engine for solo runs."""

    def __init__(self, arch, tmp):
        self.cfg = _cfg(get_arch, arch)
        self.ref_model = RefModel(_cfg(ref_get_arch, arch))
        self.ref_params = self.ref_model.init(jax.random.key(0))
        self.model = Model(self.cfg)
        self.params = params_from_jax(jax.tree.map(np.asarray,
                                                   self.ref_params))
        self.tmp = tmp
        self.ref_sm = RefSwappedModel(self.ref_model, self.ref_params,
                                      str(tmp / "ref"), mode="snet")
        self.ref_sm.partition(budget=BUDGET, dm=RefDelayModel(), batch=2,
                              seq=16)
        self.sm = SwappedModel(self.model, self.params, str(tmp / "port"),
                               device="cpu")
        self.sm.partition(BUDGET, DelayModel(), 2, 16)
        assert self.sm.plan.points == self.ref_sm.plan.points
        assert self.sm.plan.n_blocks >= 2
        self.solo_engine = ServingEngine(self.model, self.params,
                                         max_len=128, device="cpu")

    def close(self):
        self.sm.close()
        self.ref_sm.close()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = _Pair(arch, tmp_path_factory.mktemp(arch))
        return made[arch]
    yield get
    for p in made.values():
        p.close()


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("seq", [24, 96])
@pytest.mark.parametrize("arch", sorted(GEOMETRY))
def test_prefill_logits_match_reference(pairs, arch, seq):
    """The in-memory prefill at the published head geometry: logits and
    the cache's K rows (danube's 96 tokens pass its 64-token window)."""
    pair = pairs(arch)
    tokens = _tokens(pair.cfg, (2, seq), 1)
    want, ref_cache = pair.ref_model.prefill(
        pair.ref_params, {"tokens": jnp.asarray(tokens)})
    got, cache = pair.model.prefill(pair.params,
                                    {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    H, KV, hd = (pair.cfg.n_heads, pair.cfg.n_kv_heads,
                 pair.cfg.resolved_head_dim)
    assert (H, KV, hd) == {"granite-20b": (48, 1, 128),
                           "h2o-danube-3-4b": (32, 8, 120)}[arch]
    assert tuple(cache[0]["k"].shape) == (pair.cfg.n_layers, 2, seq, KV, hd)
    k_ref = np.asarray(ref_cache[0]["k"])
    err = np.abs(cache[0]["k"].numpy() - k_ref).max()
    assert err <= 1e-5 * np.abs(k_ref).max()


def test_granite_int4_lazy_store_matches_reference(pairs, tmp_path):
    """granite's quantized store is int4 by its ``swap_precision`` when no
    precision is named, in both packages: the same files' bytes swapped,
    the same plan, and logits within 1e-5 of the reference's quantized
    swapped forward."""
    pair = pairs("granite-20b")
    tokens = _tokens(pair.cfg, (2, 16), 2)
    ref = RefSwappedModel(pair.ref_model, pair.ref_params,
                          str(tmp_path / "ref"), store_backend="quant")
    ref.partition(BUDGET, RefDelayModel(), 2, 16)
    want, ref_stats = ref.forward({"tokens": jnp.asarray(tokens)})
    ref.close()
    sm = SwappedModel(pair.model, pair.params, str(tmp_path / "port"),
                      device="cpu", store_backend="quant")
    try:
        sm.partition(BUDGET, DelayModel(), 2, 16)
        assert sm.plan.points == ref.plan.points and sm.plan.n_blocks >= 2
        got, stats = sm.forward({"tokens": torch.from_numpy(tokens)})
    finally:
        sm.close()
    assert stats["precision"] == ref_stats["precision"] == "int4"
    for key in ("bytes_swapped", "bytes_resident_quantized",
                "bytes_by_precision"):
        assert stats[key] == ref_stats[key], key
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ledger, dev = stats["peak_resident_mb"], stats["peak_device_weights_mb"]
    assert ledger <= dev <= 1.01 * ledger


@pytest.mark.parametrize("arch", sorted(GEOMETRY))
def test_paged_decode_exact_with_step_trace(pairs, arch):
    """Five requests through the paged batch engine, two at a time, on
    the swapped mmap model: every request's tokens equal it served alone
    in memory and the JAX package's engine's, with the same step trace;
    every decode step ran paged attention at the config's geometry."""
    pair = pairs(arch)
    lens, page_tokens, max_pages = PAGED[arch]
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, pair.cfg.vocab_size, n)))
               for n in lens]
    want = []
    for p, n in zip(prompts, MAX_NEW):
        r = Request(0, list(p), max_new_tokens=n)
        pair.solo_engine.generate([r])
        want.append(list(r.output))
    reqs = [Request(i, list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, MAX_NEW))]
    ref_reqs = [RefRequest(**dataclasses.asdict(r)) for r in reqs]
    ref_be = RefBatchDecodeEngine(
        pair.ref_sm, RefPagedKVCache(pair.ref_model.cfg, RefLedger(BIG_LEDGER),
                                     page_tokens=page_tokens,
                                     max_pages=max_pages), max_batch=2)
    kv = PagedKVCache(pair.cfg, MemoryLedger(BIG_LEDGER),
                      page_tokens=page_tokens, max_pages=max_pages,
                      device="cpu")
    be = BatchDecodeEngine(pair.sm, kv, max_batch=2)
    for r, rr in zip(reqs, ref_reqs):
        be.submit(r)
        ref_be.submit(rr)
    ref_be.run_all()
    calls = []
    inner = pa.paged_attention_plain

    def spy(q, k_pages, *a, **kw):
        calls.append((tuple(q.shape), tuple(k_pages.shape), kw["window"]))
        return inner(q, k_pages, *a, **kw)
    pa.paged_attention_plain = spy
    try:
        be.run_all()
    finally:
        pa.paged_attention_plain = inner
    assert [r.output for r in reqs] == want
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert [dataclasses.asdict(t) for t in be.trace] == \
        [dataclasses.asdict(t) for t in ref_be.trace]
    assert kv.pages_in_use == 0 and kv.ledger.resident == 0
    steps = sum(1 for t in be.trace if t.batch)
    H, KV, hd = (pair.cfg.n_heads, pair.cfg.n_kv_heads,
                 pair.cfg.resolved_head_dim)
    window = pair.cfg.sliding_window
    assert len(calls) == pair.cfg.n_layers * steps > 0
    assert {(q[1:], k[1:], w) for q, k, w in calls} == {
        ((H, hd), (page_tokens, KV, hd), window)}
