"""The fault-tolerance tier of the port against the JAX package's:
``FaultInjector`` (seeded fault classes in the reference's order, scripted
faults, tamper-and-restore over every inner backend), the directio probe's
buffered fallback, the loader's retry / deadline ladder and the zero-leak
ledger after a failed pass.

Tolerance: exact. The same seed and the same reads give the same fault
classes in the same order and the same counters as the reference; a pass
whose faults were retried returns logits bitwise equal to the unswapped
forward (float32, qwen2.5-3b ``reduced()``).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.errors import SwapError as RefSwapError  # noqa: E402
from repro.store import build_store as ref_build_store  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel  # noqa: E402
from repro_torch.core.swap_engine import (BlockCache, MemoryLedger,  # noqa: E402
                                          SwapEngine)
from repro_torch.errors import (SwapCorruptionError, SwapError,  # noqa: E402
                                SwapIOError, SwapTimeoutError)
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.store import STORE_BACKENDS, FaultInjector, build_store  # noqa: E402
from repro_torch.store.base import as_reader  # noqa: E402
from repro_torch.store.directio_store import DirectIOStore  # noqa: E402


def _units(n=4, rows=16, cols=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"u{i}", {"w": rng.normal(0, 1, (rows, cols))
                       .astype(np.float32)})
            for i in range(n)]


def _outcomes(store, n, error_cls):
    """The outcome of ``n`` reads cycling over the units, in order."""
    out = []
    for i in range(n):
        try:
            store.read_unit(f"u{i % 4}")
            out.append("ok")
        except error_cls as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("inner", ["mmap", "directio", "rawio"])
@pytest.mark.parametrize("seed", [0, 7, 99])
def test_seeded_fault_sequence_matches_reference(tmp_path, inner, seed):
    """One ``random.Random(seed)`` drawn in call order: the same classes,
    in the same order, and the same counters as the JAX package's."""
    kw = dict(inner=inner, p=0.5, seed=seed, latency_s=0.001)
    ref = ref_build_store(_units(), str(tmp_path / "ref"), backend="faulty",
                          **kw)
    port = build_store(_units(), str(tmp_path / "port"), backend="faulty",
                       device="cpu", **kw)
    try:
        want = _outcomes(ref, 24, RefSwapError)
        assert _outcomes(port, 24, SwapError) == want
        assert any(o != "ok" for o in want)
        assert port.injected == ref.injected
        assert port.reads == ref.reads == 24
        assert port.integrity_failures == ref.integrity_failures
    finally:
        port.close()


def test_forced_script_counters_and_restore(tmp_path):
    st = build_store(_units(), str(tmp_path), backend="faulty", inner="mmap",
                     p=0.0, seed=0, device="cpu")
    assert STORE_BACKENDS["faulty"] is FaultInjector
    before = open(st.inner._path("u2"), "rb").read()
    st.force("io", "torn", "corrupt", None)
    with pytest.raises(SwapIOError):
        st.read_unit("u2")
    with pytest.raises(SwapIOError):            # torn normalizes to IO
        st.read_unit("u2")
    with pytest.raises(SwapCorruptionError):
        st.read_unit("u2")
    st.read_unit("u2")                          # forced-clean read
    assert open(st.inner._path("u2"), "rb").read() == before
    assert st.injected == {"io": 1, "latency": 0, "torn": 1, "corrupt": 1}
    assert st.reads == 4 and st.total_injected == 3
    with pytest.raises(ValueError):
        st.force("bitrot")


@pytest.mark.parametrize("inner,opts", [
    ("mmap", {}), ("rawio", {}), ("quant", {"bits": 4}), ("directio", {}),
    ("directio", {"queue_depth": 1})])
def test_wraps_every_backend(tmp_path, inner, opts):
    st = build_store(_units(), str(tmp_path), backend="faulty", inner=inner,
                     inner_opts=opts, p=0.0, seed=0, device="cpu")
    try:
        assert st.inner.verify and st.device == st.inner.device
        for kind, err in (("corrupt", SwapCorruptionError),
                          ("torn", SwapIOError)):
            st.force(kind)
            with pytest.raises(err):
                st.read_unit("u1")
            r = st.read_unit("u1")          # restored
            want = _units()[1][1]["w"]
            if inner != "quant":
                assert np.array_equal(r.params["w"].numpy(), want)
        assert st.stored_nbytes("u1") == st.inner.stored_nbytes("u1")
        assert st.resident_nbytes("u1") == st.inner.resident_nbytes("u1")
        assert st.meta_bytes() == st.inner.meta_bytes()
    finally:
        st.close()


def test_refuses_self_wrap_and_raw_reinterpretation(tmp_path):
    with pytest.raises(ValueError):
        build_store(_units(), str(tmp_path / "a"), backend="faulty",
                    inner="faulty", device="cpu")
    with pytest.raises(TypeError):
        FaultInjector(str(tmp_path))
    st = build_store(_units(), str(tmp_path / "b"), backend="faulty",
                     device="cpu")
    with pytest.raises(TypeError):              # would bypass the injector
        as_reader(st, mode="copy_in")


# ----------------------------------------------------------- directio probe
@pytest.mark.parametrize("where", ["open", "read"])
def test_directio_probe_falls_back_to_buffered(tmp_path, monkeypatch, where):
    """A filesystem that refuses O_DIRECT at open(), or at the first read,
    demotes the store to buffered reads into the same arena."""
    st = DirectIOStore.build(_units(), str(tmp_path), queue_depth=2)
    if where == "open":
        real_open = os.open

        def deny(path, flags, *a, **kw):
            if flags & getattr(os, "O_DIRECT", 0):
                raise OSError(22, "O_DIRECT not supported here")
            return real_open(path, flags, *a, **kw)
        monkeypatch.setattr(os, "open", deny)
    else:
        real_preadv = os.preadv
        calls = {"n": 0}

        def deny(fd, bufs, off):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError(22, "Invalid argument")
            return real_preadv(fd, bufs, off)
        monkeypatch.setattr(os, "preadv", deny)
    st.direct_io = None             # re-probe through the patch
    st.open()
    assert st.direct_io is False
    r = st.read_unit("u3")
    assert np.array_equal(r.params["w"].numpy(), _units()[3][1]["w"])
    st.close()


# ----------------------------------------------------------------- retries
def _engine(tmp_path, ledger=None, cache=None, **opts):
    store = build_store(_units(6), str(tmp_path), backend="faulty",
                        device="cpu", p=0.0, seed=0, **opts)
    eng = SwapEngine(store, ledger=ledger, cache=cache)
    eng.retry_backoff_s = 0.001
    return store, eng


def test_retry_budget_exhaustion_raises_with_attempts(tmp_path):
    store, eng = _engine(tmp_path)
    eng.read_retries = 2
    store.force("io", "io", "io")           # one more than the budget
    with pytest.raises(SwapIOError) as ei:
        eng.swap_in(["u0", "u1"])
    assert ei.value.attempts == 3 and ei.value.unit == "u0"
    assert eng.stats.faults == {"SwapIOError": 3}
    assert eng.stats.retries == 2 and eng.ledger.resident == 0
    eng.close()


def test_read_deadline_counts_as_timeout(tmp_path):
    store, eng = _engine(tmp_path, latency_s=0.2)
    eng.read_deadline_s = 0.05
    eng.read_retries = 1
    store.force("latency", "latency")       # both attempts blow the deadline
    with pytest.raises(SwapTimeoutError) as ei:
        eng.swap_in(["u0"])
    assert ei.value.attempts == 2
    assert eng.stats.faults == {"SwapTimeoutError": 2}
    eng.close()


def test_failed_block_leaves_ledger_at_prepass_total(tmp_path):
    """A swap-in that dies after cache hits returns the shared ledger to
    its pre-pass total and leaks no cache lease."""
    ledger = MemoryLedger(None)
    cache = BlockCache(1 << 20, ledger,
                       policy=lambda name, nb: name in ("u0", "u1"))
    store, eng = _engine(tmp_path, ledger=ledger, cache=cache)
    eng.swap_out(eng.swap_in(["u0", "u1", "u2"]))   # caches u0 and u1
    pre = ledger.resident
    assert pre > 0 and cache.active_leases() == {}
    store.force("io", "io", "io")                   # u2's read: hopeless
    with pytest.raises(SwapIOError):
        eng.swap_in(["u0", "u1", "u2"])
    assert ledger.resident == pre
    assert cache.active_leases() == {}
    eng.close()


@pytest.fixture(scope="module")
def qwen():
    model = Model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                                      dtype="float32"))
    params = model.init(0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 16)), dtype=torch.int32)
    return model, params, {"tokens": tokens}


@pytest.mark.parametrize("inner", ["mmap", "directio"])
def test_retried_faults_keep_logits_bitwise(qwen, tmp_path, inner):
    """io, corrupt, torn and latency scripted into one pass: every read
    succeeds on retry and the logits equal the unswapped forward."""
    model, params, batch = qwen
    sm = SwappedModel(model, params, str(tmp_path), store_backend="faulty",
                      store_options={"inner": inner, "p": 0.0,
                                     "latency_s": 0.001},
                      device="cpu")
    try:
        sm.engine.retry_backoff_s = 0.001
        sm.partition(8 << 20, DelayModel(), 2, 16)
        sm.store.force("io", "corrupt", None, "torn", None, "latency")
        logits, st = sm.forward(batch)
        assert st["faults"] == {"SwapIOError": 2, "SwapCorruptionError": 1}
        assert st["retries"] == 3
        assert sm.store.injected == {"io": 1, "latency": 1, "torn": 1,
                                     "corrupt": 1}
        assert torch.equal(logits, sm.forward_unswapped(batch))
        assert sm.engine.ledger.resident == 0
    finally:
        sm.close()
