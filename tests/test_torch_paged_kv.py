"""The port's paged KV cache and paged attention against the JAX package's.

The kernel property: attention gathered through an ARBITRARY page table
matches contiguous attention on the same context (paging is a memory
layout, not a math change). The cache property: pages are charged to the
shared MemoryLedger, the ledger never exceeds its budget, and the page
arithmetic is the JAX package's, so page tables and ledger totals agree
across the two packages.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, with their reasons:
  * float32: 1e-5 (the sums run in another order);
  * bfloat16: 2e-2 (one bf16 rounding of the output, taken at different
    places by the two frameworks).
"""
import dataclasses
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.core.swap_engine import MemoryLedger as RefLedger  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.paged_attention import \
    paged_attention as pallas_paged_attention  # noqa: E402
from repro.serving.paged_kv import PagedKVCache as RefPagedKVCache  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.swap_engine import MemoryLedger  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_plain)
from repro_torch.models.attention import online_attention  # noqa: E402
from repro_torch.serving.paged_kv import (PagedBatchView,  # noqa: E402
                                          PagedKVCache, page_bytes_for)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _random_paged(seed, B, H, KV, hd, T, max_pages, seq_lens):
    """Random q + page pools (page 0 the zero sentinel) + a SHUFFLED page
    table covering seq_lens, as fp32 numpy."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, hd)) * 0.5).astype(np.float32)
    shape = (max_pages + 1, T, KV, hd)
    kp = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    vp = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    kp[0] = 0
    vp[0] = 0
    NP = max(-(-int(s) // T) for s in seq_lens)
    ids = rng.permutation(np.arange(1, max_pages + 1))
    pt = np.zeros((B, NP), np.int32)
    used = 0
    for b, s in enumerate(seq_lens):
        n = -(-int(s) // T)
        pt[b, :n] = ids[used:used + n]
        used += n
    assert used <= max_pages
    return q, kp, vp, pt, np.asarray(seq_lens, np.int32)


def _to_torch(arrays, dtype):
    q, kp, vp, pt, sl = arrays
    dt = TORCH_DT[dtype]
    return (torch.from_numpy(q).to(dt), torch.from_numpy(kp).to(dt),
            torch.from_numpy(vp).to(dt), torch.from_numpy(pt),
            torch.from_numpy(sl))


def _to_jax(arrays, dtype):
    q, kp, vp, pt, sl = arrays
    dt = jnp.dtype(dtype)
    return (jnp.asarray(q, dt), jnp.asarray(kp, dt), jnp.asarray(vp, dt),
            jnp.asarray(pt), jnp.asarray(sl))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [
    (None, None), (7, None), (None, 30.0), (5, 30.0)])
def test_plain_matches_jax_ref_and_pallas_kernel(dtype, window, softcap):
    arrays = _random_paged(0, 3, 8, 2, 64, 8, 16, [5, 23, 16])
    got = paged_attention_plain(*_to_torch(arrays, dtype), window=window,
                                softcap=softcap)
    assert got.dtype == TORCH_DT[dtype] and tuple(got.shape) == (3, 8, 64)
    jx = _to_jax(arrays, dtype)
    want_ref = ref.paged_attention_ref(*jx, window=window, softcap=softcap)
    want_kernel = pallas_paged_attention(*jx, window=window, softcap=softcap,
                                         interpret=True)
    got = got.float().numpy()
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **TOL[dtype])
    # and the wrapper takes the plain version for CPU tensors
    wrapped = paged_attention(*_to_torch(arrays, dtype), window=window,
                              softcap=softcap)
    np.testing.assert_array_equal(wrapped.float().numpy(), got)


@pytest.mark.parametrize("seq_len", [1, 8, 17, 40])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_matches_contiguous_online_attention(seq_len, window):
    """Scattering a context across shuffled pages changes NOTHING against
    the port's contiguous attention over the same context."""
    H, KV, hd, T = 4, 2, 64, 8
    q, kp, vp, pt, sl = _random_paged(1, 1, H, KV, hd, T, 8, [seq_len])
    got = paged_attention(*_to_torch((q, kp, vp, pt, sl), "float32"),
                          window=window)[0]                       # [H, hd]
    ctx_k = kp[pt[0]].reshape(-1, KV, hd)[:seq_len]
    ctx_v = vp[pt[0]].reshape(-1, KV, hd)[:seq_len]
    want = online_attention(
        torch.from_numpy(q)[:, None], torch.from_numpy(ctx_k)[None],
        torch.from_numpy(ctx_v)[None],
        torch.tensor([[seq_len - 1]]), None, causal=True, window=window,
        scale=hd ** -0.5, logit_cap=None, chunk=16)[0, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_rejects_mismatched_shapes():
    q, kp, vp, pt, sl = _to_torch(
        _random_paged(2, 2, 4, 2, 64, 4, 4, [3, 6]), "float32")
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp[:, :, :1], pt, sl)          # pools differ
    with pytest.raises(ValueError):
        paged_attention(q[:, :3], kp, vp, pt, sl)             # 3 % 2 heads
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, pt[:1], sl)                # B mismatch
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, pt, sl, window=0)


# --------------------------------------------------------------- cache
def _cfg(arch="qwen2.5-3b"):
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32")


def _kv(cfg, ledger, **kw):
    return PagedKVCache(cfg, ledger, device="cpu", **kw)


def test_page_accounting_delta_semantics():
    cfg = _cfg()
    pb = page_bytes_for(cfg, 4)
    assert pb == 2 * cfg.n_layers * 4 * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 4
    led = MemoryLedger(budget=10 * pb)
    kv = _kv(cfg, led, page_tokens=4, max_pages=16)
    assert kv.alloc("a", 6)                 # 2 pages
    assert led.resident == 2 * pb
    assert kv.extend("a", 1)                # 7 tokens: still 2 pages
    assert led.resident == 2 * pb
    assert kv.extend("a", 2)                # 9 tokens: 3rd page, delta-charge
    assert led.resident == 3 * pb
    assert kv.alloc("b", 20)                # 5 pages
    assert led.resident == 8 * pb
    assert not kv.alloc("c", 12)            # 3 pages > 2 left in budget
    assert led.resident == 8 * pb           # rejection left no residue
    kv.free("a")
    assert led.resident == 5 * pb
    assert kv.alloc("c", 12)
    kv.free("b"), kv.free("c")
    assert led.resident == 0 and kv.pages_in_use == 0
    assert len(kv._free) == 16
    assert kv.alloc("d", 1)
    with pytest.raises(ValueError):
        kv.alloc("d", 1)                    # already live


def test_pool_exhaustion_independent_of_ledger():
    cfg = _cfg()
    kv = _kv(cfg, MemoryLedger(budget=None), page_tokens=4, max_pages=3)
    assert kv.alloc("a", 12)                # all 3 pages
    assert not kv.alloc("b", 1)             # pool, not ledger, says no
    assert not kv.extend("a", 1)
    kv.free("a")
    assert kv.alloc("b", 1)


def test_write_page_table_roundtrip_and_sentinel():
    cfg = _cfg()
    kv = _kv(cfg, MemoryLedger(None), page_tokens=4, max_pages=8)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(0)
    kv.alloc("a", 6)
    k = rng.standard_normal((6, KV, hd)).astype(np.float32)
    v = rng.standard_normal((6, KV, hd)).astype(np.float32)
    kv.write_rows(0, *kv.slots("a", range(6)), torch.from_numpy(k),
                  torch.from_numpy(v))
    pt, sl = kv.page_table(["a"])
    assert sl.tolist() == [6] and pt.shape == (1, 2)
    idx = torch.from_numpy(pt[0]).long()
    np.testing.assert_array_equal(
        kv.k_pools[0][idx].reshape(-1, KV, hd)[:6].numpy(), k)
    np.testing.assert_array_equal(
        kv.v_pools[0][idx].reshape(-1, KV, hd)[:6].numpy(), v)
    # sentinel page 0 is never handed out and never written
    assert 0 not in pt[0]
    assert not kv.k_pools[0][0].any() and not kv.v_pools[0][0].any()
    # a second, longer sequence pads the FIRST one's table row with 0s
    kv.alloc("b", 16)
    pt2, _ = kv.page_table(["a", "b"])
    assert pt2.shape == (2, 4)
    assert (pt2[0, 2:] == 0).all()
    with pytest.raises(ValueError):         # positions 4..6 of a 6-token seq
        kv.slots("a", range(4, 7))


def test_rejects_non_uniform_attention():
    for arch in ("deepseek-v2-lite-16b", "rwkv6-3b"):
        with pytest.raises(ValueError):
            _kv(_cfg(arch), MemoryLedger(None))


def test_for_budget_sizing_and_pool_bytes():
    cfg = _cfg()
    pb = page_bytes_for(cfg, 8)
    kv = PagedKVCache.for_budget(cfg, MemoryLedger(None), 10 * pb + 5,
                                 page_tokens=8, device="cpu")
    assert kv.max_pages == 10
    # the device holds every page and the sentinel from construction on;
    # the ledger charges only what is allocated
    assert kv.pool_bytes == 11 * pb and kv.ledger.resident == 0


def test_ledger_never_exceeds_budget_concurrent():
    """Adversarial: admit/extend/retire hammered from several threads while
    a weight-block tenant charges the same ledger. The ledger's peak must
    stay under budget and the final state must be clean."""
    cfg = _cfg()
    pb = page_bytes_for(cfg, 4)
    budget = 12 * pb
    led = MemoryLedger(budget=budget)
    led.add("weights", 4 * pb)              # a co-resident weight block
    kv = _kv(cfg, led, page_tokens=4, max_pages=64)
    errors = []

    def worker(tid):
        rng = np.random.default_rng(tid)
        try:
            for it in range(60):
                sid = (tid, it)
                if not kv.alloc(sid, int(rng.integers(1, 12))):
                    continue
                for _ in range(int(rng.integers(0, 6))):
                    if not kv.extend(sid, 1):
                        break
                kv.free(sid)
        except Exception as e:              # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)             # interleave the threads finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert led.peak <= budget
    assert kv.pages_in_use == 0
    assert led.resident == 4 * pb           # only the weight block remains
    assert sorted(kv._free) == list(range(1, 65))


def test_batch_view_write_position():
    """PagedBatchView writes each sequence's new K/V at seq_len-1 and
    attends over exactly the live context."""
    cfg = _cfg()
    kv = _kv(cfg, MemoryLedger(None), page_tokens=4, max_pages=8)
    KV, hd, H = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    rng = np.random.default_rng(3)
    kv.alloc("a", 5)
    k0 = rng.standard_normal((5, KV, hd)).astype(np.float32)
    v0 = rng.standard_normal((5, KV, hd)).astype(np.float32)
    kv.write_rows(0, *kv.slots("a", range(5)), torch.from_numpy(k0),
                  torch.from_numpy(v0))
    assert kv.extend("a", 1)
    view = PagedBatchView(kv, ["a"])
    q = rng.standard_normal((1, H, hd)).astype(np.float32)
    kn = rng.standard_normal((1, KV, hd)).astype(np.float32)
    vn = rng.standard_normal((1, KV, hd)).astype(np.float32)
    out = view.attend(0, torch.from_numpy(q), torch.from_numpy(kn),
                      torch.from_numpy(vn))
    pt, sl = kv.page_table(["a"])
    assert sl.tolist() == [6]
    np.testing.assert_array_equal(
        kv.k_pools[0][torch.from_numpy(pt[0]).long()]
        .reshape(-1, KV, hd)[5].numpy(), kn[0])
    # and the output equals the JAX oracle over the 6-token context
    want = ref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kv.k_pools[0].numpy()),
        jnp.asarray(kv.v_pools[0].numpy()), jnp.asarray(pt), jnp.asarray(sl))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_page_arithmetic_matches_jax_package():
    """One alloc/extend/free script on both packages' caches: equal page
    tables, seq_lens and ledger totals after every operation, including
    the rejected ones."""
    cfg = _cfg()
    ref_cfg = dataclasses.replace(REF_ARCHS["qwen2.5-3b"].reduced(),
                                  dtype="float32")
    pb = page_bytes_for(cfg, 4)
    led, ref_led = MemoryLedger(budget=9 * pb), RefLedger(budget=9 * pb)
    kv = _kv(cfg, led, page_tokens=4, max_pages=10)
    ref_kv = RefPagedKVCache(ref_cfg, ref_led, page_tokens=4, max_pages=10)
    script = [("alloc", "a", 6), ("alloc", "b", 9), ("extend", "a", 3),
              ("alloc", "c", 13), ("extend", "b", 1), ("free", "a", 0),
              ("alloc", "c", 13), ("extend", "c", 4), ("alloc", "d", 2),
              ("extend", "b", 8), ("free", "b", 0), ("extend", "d", 7),
              ("alloc", "e", 1)]
    for op, sid, n in script:
        if op == "free":
            kv.free(sid), ref_kv.free(sid)
        else:
            assert getattr(kv, op)(sid, n) == getattr(ref_kv, op)(sid, n), \
                (op, sid, n)
        live = ref_kv.live_sequences()
        assert kv.live_sequences() == live
        if live:
            pt, sl = kv.page_table(live)
            ref_pt, ref_sl = ref_kv.page_table(live)
            np.testing.assert_array_equal(pt, ref_pt)
            np.testing.assert_array_equal(sl, ref_sl)
        assert led.resident == ref_led.resident
        assert led.peak == ref_led.peak
        assert kv._free == ref_kv._free
