"""The port's continuous-batching decode engine against the JAX package's.

Greedy decode is deterministic, so batching, paging and preemption must be
invisible in the outputs: every request's tokens equal a solo in-memory
run, and equal the JAX package's BatchDecodeEngine on the same params,
while the step traces (batch, admissions, retirements, preemptions, pages
per step) are the same list in both packages.

qwen2.5-3b and gemma2-9b ``reduced()``, float32, params from JAX
``Model.init`` handed over as numpy. gemma's reduced sliding window is 64
tokens: a 70-token prompt on 4-token pages makes the local layer skip
whole pages. Tolerance for the prefill K/V: 1e-5 (float32; the sums run
in another order).
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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.batch_engine import BatchDecodeEngine  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.paged_kv import PagedKVCache  # noqa: E402

MB = 1024 * 1024
BIG_LEDGER = 1 << 30


class _Pair:
    """One arch in both packages on the same weights: a partitioned
    swapped model each (reused across tests, so JAX compiles once) and the
    port's in-memory engine for solo runs."""

    def __init__(self, arch, tmp):
        ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(),
                                      dtype="float32")
        self.cfg = dataclasses.replace(get_arch(arch).reduced(),
                                       dtype="float32")
        self.ref_model = RefModel(ref_cfg)
        self.ref_params = self.ref_model.init(jax.random.key(0))
        self.model = Model(self.cfg)
        self.params = params_from_jax(jax.tree.map(np.asarray,
                                                   self.ref_params))
        self.ref_sm = RefSwappedModel(self.ref_model, self.ref_params,
                                      str(tmp / "ref"), mode="snet")
        self.ref_sm.partition(budget=8 * MB, dm=RefDelayModel(), batch=2,
                              seq=16)
        self.sm = SwappedModel(self.model, self.params, str(tmp / "port"),
                               device="cpu")
        self.sm.partition(8 * MB, DelayModel(), 2, 16)
        assert self.sm.plan.points == self.ref_sm.plan.points
        self.solo_engine = ServingEngine(self.model, self.params, max_len=128,
                                         device="cpu")

    def solo(self, prompt, max_new, eos=None):
        r = Request(0, list(prompt), max_new_tokens=max_new, eos=eos)
        self.solo_engine.generate([r])
        return list(r.output)

    def run(self, reqs, *, page_tokens, max_pages, max_batch):
        """The same requests through both packages' batch engines; returns
        (port requests, port engine, JAX requests, JAX engine)."""
        ref_kv = RefPagedKVCache(self.ref_model.cfg, RefLedger(BIG_LEDGER),
                                 page_tokens=page_tokens, max_pages=max_pages)
        ref_be = RefBatchDecodeEngine(self.ref_sm, ref_kv,
                                      max_batch=max_batch)
        kv = PagedKVCache(self.cfg, MemoryLedger(BIG_LEDGER),
                          page_tokens=page_tokens, max_pages=max_pages,
                          device="cpu")
        be = BatchDecodeEngine(self.sm, kv, max_batch=max_batch)
        ref_reqs = [RefRequest(**dataclasses.asdict(r)) for r in reqs]
        for r, rr in zip(reqs, ref_reqs):
            be.submit(r)
            ref_be.submit(rr)
        ref_be.run_all()
        be.run_all()
        return reqs, be, ref_reqs, ref_be

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


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in lens]


def _same_as_jax(reqs, be, ref_reqs, ref_be):
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert [dataclasses.asdict(t) for t in be.trace] == \
        [dataclasses.asdict(t) for t in ref_be.trace]
    assert be.stats()["tokens_emitted"] == ref_be.stats()["tokens_emitted"]
    assert be.kv.pages_in_use == 0 and be.kv.ledger.resident == 0


@pytest.mark.parametrize("arch,lens,page_tokens,max_pages", [
    ("qwen2.5-3b", (8,) * 5, 4, 8),
    ("gemma2-9b", (70, 8, 8, 8, 8), 4, 40),
])
def test_continuous_batching_exact_with_step_trace(pairs, arch, lens,
                                                   page_tokens, max_pages):
    pair = pairs(arch)
    prompts = _prompts(pair.cfg, lens)
    max_new = [2, 6, 3, 5, 4]
    want = [pair.solo(prompts[i], max_new[i]) for i in range(5)]
    reqs = [Request(i, list(prompts[i]), max_new_tokens=max_new[i])
            for i in range(5)]
    reqs, be, ref_reqs, ref_be = pair.run(reqs, page_tokens=page_tokens,
                                          max_pages=max_pages, max_batch=2)
    assert [r.output for r in reqs] == want
    _same_as_jax(reqs, be, ref_reqs, ref_be)

    # the trace is a real continuous-batching log
    tr = be.trace
    assert sorted(r for t in tr for r in t.retired) == [0, 1, 2, 3, 4]
    assert sorted(r for t in tr for r in t.admitted) == [0, 1, 2, 3, 4]
    assert all(len(t.batch) <= 2 for t in tr)
    retire_step = {r: t.step for t in tr for r in t.retired}
    assert retire_step[0] < retire_step[1]
    assert [t for t in tr if t.admitted and t.batch], \
        "no admission ever joined a running batch"
    assert len({t.step for t in tr if t.admitted}) >= 3
    pages = [t.kv_pages for t in tr]
    assert any(b < a for a, b in zip(pages, pages[1:]))
    st = be.stats()
    assert st["tokens_emitted"] == sum(max_new)
    assert 0 < st["mean_occupancy"] <= 1.0


def test_preemption_by_recomputation_exact(pairs):
    """Page pressure evicts the lowest-priority sequence mid-decode; it is
    re-admitted (prompt + emitted output recomputed) and still produces
    exactly the solo outputs, in the same steps as the JAX package."""
    pair = pairs("qwen2.5-3b")
    prompts = _prompts(pair.cfg, (8, 8))
    want_hi, want_lo = pair.solo(prompts[0], 5), pair.solo(prompts[1], 4)
    hi = Request(0, list(prompts[0]), max_new_tokens=5, priority=2.0)
    lo = Request(1, list(prompts[1]), max_new_tokens=4, priority=1.0)
    # 8-token prompts = 2 pages of 4; 5 pages leave ONE spare page, so the
    # first boundary crossing evicts
    reqs, be, ref_reqs, ref_be = pair.run([hi, lo], page_tokens=4,
                                          max_pages=5, max_batch=2)
    assert hi.output == want_hi and lo.output == want_lo
    _same_as_jax(reqs, be, ref_reqs, ref_be)
    assert be.preemptions >= 1
    preempted = [r for t in be.trace for r in t.preempted]
    assert 1 in preempted and 0 not in preempted
    assert sum(t.admitted.count(1) for t in be.trace) == 2
    hi_steps = [t.step for t in be.trace if 0 in t.batch or 0 in t.retired]
    assert hi_steps == list(range(min(hi_steps), max(hi_steps) + 1))


def test_eos_retires_early(pairs):
    pair = pairs("qwen2.5-3b")
    full = eos_at = prompt = None
    for p in _prompts(pair.cfg, (8,) * 5):
        full = pair.solo(p, 6)
        ks = [k for k in range(1, len(full)) if full[k] not in full[:k]]
        if ks:
            prompt, eos_at = p, ks[0]
            break
    assert eos_at is not None, "all sample generations are constant"
    r = Request(0, list(prompt), max_new_tokens=6, eos=full[eos_at])
    reqs, be, ref_reqs, ref_be = pair.run([r], page_tokens=4, max_pages=8,
                                          max_batch=2)
    assert r.output == full[:eos_at + 1]
    _same_as_jax(reqs, be, ref_reqs, ref_be)


def test_oversized_prompt_raises(pairs):
    pair = pairs("qwen2.5-3b")
    kv = PagedKVCache(pair.cfg, MemoryLedger(BIG_LEDGER), page_tokens=4,
                      max_pages=1, device="cpu")  # 4-token pool, 8-token prompt
    be = BatchDecodeEngine(pair.sm, kv, max_batch=2)
    be.submit(Request(0, _prompts(pair.cfg, (8,))[0], max_new_tokens=2))
    with pytest.raises(MemoryError):
        be.run_all()


def test_run_until_yields_at_step_boundaries(pairs):
    """``run_until`` steps the whole batch until ITS sequence retires, and
    a ``should_yield`` that fires returns at a step boundary with the batch
    intact; the drained engine's tokens are the solo ones."""
    pair = pairs("qwen2.5-3b")
    prompts = _prompts(pair.cfg, (8, 8, 8), seed=7)
    max_new = [2, 5, 3]
    want = [pair.solo(p, n) for p, n in zip(prompts, max_new)]
    kv = PagedKVCache(pair.cfg, MemoryLedger(BIG_LEDGER), page_tokens=4,
                      max_pages=16, device="cpu")
    be = BatchDecodeEngine(pair.sm, kv, max_batch=2)
    reqs = [Request(i, list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    retired = []
    for r in reqs:
        be.submit(r, on_retire=lambda req: retired.append(req.rid))
    assert be.run_until(0) and be.is_done(0) and not be.is_done(1)
    assert len(reqs[1].output) < max_new[1]          # still mid-flight
    steps = len(be.trace)
    assert not be.run_until(1, should_yield=lambda: True)
    assert len(be.trace) == steps                    # yielded before a step
    assert be.run_until(2) and be.run_until(1)
    assert [r.output for r in reqs] == want
    assert sorted(retired) == [0, 1, 2] and kv.pages_in_use == 0
    with pytest.raises(KeyError):
        be.run_until(99)
    with pytest.raises(ValueError):
        be.submit(Request(0, list(prompts[0])))      # rid already known


def test_swap_failure_evicts_only_that_sequence(pairs, monkeypatch):
    """A prefill that raises a SwapError past the loader's retries evicts
    its sequence (pages freed, error on the request, retire callback
    fired) while the other sequences decode to their solo tokens."""
    from repro_torch.errors import SwapIOError
    pair = pairs("qwen2.5-3b")
    prompts = _prompts(pair.cfg, (8, 9, 8), seed=11)
    want = [pair.solo(prompts[0], 3), pair.solo(prompts[2], 2)]
    kv = PagedKVCache(pair.cfg, MemoryLedger(BIG_LEDGER), page_tokens=4,
                      max_pages=16, device="cpu")
    be = BatchDecodeEngine(pair.sm, kv, max_batch=2)
    real = pair.sm.forward_partial

    def flaky(batch, *a, **kw):
        if batch["tokens"].shape[1] == 9:            # request 1's prompt
            raise SwapIOError("injected", unit="layer000_dense")
        return real(batch, *a, **kw)
    monkeypatch.setattr(pair.sm, "forward_partial", flaky)
    reqs = [Request(i, list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, (3, 4, 2)))]
    failed = []
    for r in reqs:
        be.submit(r, on_retire=lambda req: failed.append(req.rid)
                  if req.error is not None else None)
    be.run_all()
    assert [reqs[0].output, reqs[2].output] == want
    assert reqs[1].output == [] and isinstance(reqs[1].error, SwapIOError)
    assert reqs[1].error.model == pair.cfg.name
    assert failed == [1] and be.failures == 1
    assert [r for t in be.trace for r in t.failed] == [1]
    assert kv.pages_in_use == 0 and kv.ledger.resident == 0


def test_collected_prefill_cache_matches_jax(pairs):
    """``forward_partial(collect_cache=True)`` keeps each layer's prefill
    K/V, the bytes a serving admit writes into the page pool."""
    pair = pairs("gemma2-9b")
    tokens = np.asarray(_prompts(pair.cfg, (70,), seed=5), np.int32)
    ref_state, _ = pair.ref_sm.forward_partial(
        {"tokens": jnp.asarray(tokens)}, collect_cache=True)
    state, _ = pair.sm.forward_partial({"tokens": torch.from_numpy(tokens)},
                                       collect_cache=True)
    assert sorted(state.caches) == sorted(ref_state.caches) \
        == list(range(pair.cfg.n_layers))
    for lid, c in state.caches.items():
        for key in ("k", "v"):
            np.testing.assert_allclose(c[key].numpy(),
                                       np.asarray(ref_state.caches[lid][key]),
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.logits.numpy(),
                               np.asarray(ref_state.logits), rtol=1e-5,
                               atol=1e-5)
    # without the flag nothing is kept
    plain, _ = pair.sm.forward_partial({"tokens": torch.from_numpy(tokens)})
    assert plain.caches is None


def test_prefill_head_projects_last_position_only(pairs, monkeypatch):
    """An admission reads the last position's logits only, so the head
    never holds [B, S, vocab] logits of the whole prompt."""
    pair = pairs("qwen2.5-3b")
    tokens = np.asarray(_prompts(pair.cfg, (40, 40), seed=6), np.int32)
    seen = []
    head = pair.sm._head_logits

    def spy(uparams, h):
        seen.append(tuple(h.shape))
        return head(uparams, h)
    monkeypatch.setattr(pair.sm, "_head_logits", spy)
    state, _ = pair.sm.forward_partial({"tokens": torch.from_numpy(tokens)},
                                       collect_cache=True)
    assert seen == [(2, 1, pair.cfg.d_model)]
    assert tuple(state.logits.shape) == (2, 1, pair.cfg.vocab_size)


def test_in_memory_engine_matches_jax(pairs):
    from repro.serving.engine import ServingEngine as RefServingEngine
    pair = pairs("qwen2.5-3b")
    prompts = _prompts(pair.cfg, (8, 8, 8), seed=3)
    max_new = [3, 5, 2]
    ref_eng = RefServingEngine(pair.ref_model, pair.ref_params, max_len=64)
    ref_reqs = [RefRequest(i, p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
    ref_eng.generate(ref_reqs)
    eng = ServingEngine(pair.model, pair.params, max_len=64, device="cpu")
    reqs = [Request(i, p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    stats = eng.generate(reqs)       # a ragged batch: rows retire early
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert [len(r.output) for r in reqs] == max_new
    assert stats["decode_steps"] == max(max_new) - 1


def test_serve_paged_entry_runs_on_cpu(capsys):
    out = serve.main(["--arch", "qwen2.5-3b", "--reduce", "smoke",
                      "--budget-mb", "24", "--paged", "--kv-frac", "0.3",
                      "--page-tokens", "16", "--max-batch", "4",
                      "--requests", "3", "--prompt-len", "8",
                      "--new-tokens", "3", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[serve-paged] 3 requests x 3 new tokens" in text
    assert "(OK)" in text and "[serve-paged] sample output" in text
    assert [len(r.output) for r in out["requests"]] == [3, 3, 3]
    assert out["peak"] <= out["budget"]
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen2.5-3b", "--paged", "--device", "cpu"])


def test_serve_in_memory_entry_runs_on_cpu(capsys):
    out = serve.main(["--arch", "qwen2.5-3b", "--reduce", "smoke",
                      "--requests", "2", "--prompt-len", "8",
                      "--new-tokens", "3", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[serve] 2 requests x 3 new tokens" in text
    assert [len(r.output) for r in out["requests"]] == [3, 3]
