"""The raw stores of the port against the JAX package's: ``rawio``,
``directio`` (the O_DIRECT path where the filesystem takes it, and the
buffered path with the probe refusing it), ``mmap`` with dummy assembly,
the engine's ablation ``mode`` and the size-aware cache admission.

qwen2.5-3b ``reduced()``, float32, params from JAX ``Model.init`` handed
over as numpy. Tolerance: exact everywhere. Unit files, their CRC32
digests, ``io_bytes``, ``stored_nbytes`` and ``resident_nbytes`` are
byte- and integer-identical to the reference's, every leaf read back is
bitwise the source, and the admission thresholds are the same integers.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.runtime import split_units as ref_split_units  # noqa: E402
from repro.core.swap_engine import SwapEngine as RefSwapEngine  # noqa: E402
from repro.core.swap_engine import \
    size_aware_policy as ref_size_aware_policy  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.store import build_store as ref_build_store  # noqa: E402
from repro.store.directio_store import \
    DirectIOStore as RefDirectIOStore  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel, split_units  # noqa: E402
from repro_torch.core.swap_engine import (BlockCache, MemoryLedger,  # noqa: E402
                                          SwapEngine, size_aware_policy)
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.store import build_store  # noqa: E402
from repro_torch.store.base import as_reader  # noqa: E402
from repro_torch.store.directio_store import (ALIGNMENT,  # noqa: E402
                                              AlignedArena, DirectIOStore)
from repro_torch.store.mmap_store import MmapStore  # noqa: E402
from repro_torch.store.rawio_store import RawIOStore  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# (backend, build options, probe forced off)
RAW = {
    "rawio": ("rawio", {}, False),
    "rawio-dispatch": ("rawio", {"gpu_dispatch": True}, False),
    "directio": ("directio", {}, False),
    "directio-buffered": ("directio", {}, True),
    "directio-qd1": ("directio", {"queue_depth": 1}, False),
    "mmap-dummy": ("mmap", {"assembly": "dummy"}, False),
}


@pytest.fixture(scope="module")
def units():
    cfg = dataclasses.replace(ref_get_arch("qwen2.5-3b").reduced(),
                              dtype="float32")
    ref_model = RefModel(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    port_model = Model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                                           dtype="float32"))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    ref_units = [(u.name, u.params) for u in ref_split_units(ref_model,
                                                              ref_params)]
    port_units = [(u.name, u.params) for u in split_units(port_model, params)]
    return ref_units, port_units, port_model, params


def _build_both(units, tmp_path, kind, monkeypatch):
    ref_units, port_units, _, _ = units
    backend, opts, buffered = RAW[kind]
    if buffered:
        monkeypatch.setattr(RefDirectIOStore, "_probe_direct",
                            lambda self: False)
        monkeypatch.setattr(DirectIOStore, "_probe_direct",
                            lambda self: False)
    ref = ref_build_store(ref_units, str(tmp_path / "ref"), backend=backend,
                          **opts)
    port = build_store(port_units, str(tmp_path / "port"), backend=backend,
                       device="cpu", **opts)
    return ref, port


@pytest.mark.parametrize("kind", sorted(RAW))
def test_raw_store_files_and_sizes_match_reference(units, tmp_path, kind,
                                                   monkeypatch):
    ref, port = _build_both(units, tmp_path, kind, monkeypatch)
    try:
        assert port.order == ref.order
        assert port.raw_format and ref.raw_format
        for name in ref.order:
            with open(ref._path(name), "rb") as a, \
                    open(port._path(name), "rb") as b:
                assert a.read() == b.read(), name
            assert port.nbytes(name) == ref.nbytes(name)
            assert port.stored_nbytes(name) == ref.stored_nbytes(name)
            assert port.resident_nbytes(name) == ref.resident_nbytes(name)
        assert port.digests == ref.digests
        if port.backend == "directio":
            # both probe the same filesystem; a forced refusal is honoured
            assert port.direct_io == ref.direct_io
            if RAW[kind][2]:
                assert port.direct_io is False
    finally:
        port.close()


@pytest.mark.parametrize("kind", sorted(RAW))
def test_raw_store_reads_match_reference(units, tmp_path, kind, monkeypatch):
    """Every unit read back is bitwise the source leaf; ``io_bytes`` and
    ``ledger_bytes`` are the reference's integers."""
    _, port_units, _, _ = units
    ref, port = _build_both(units, tmp_path, kind, monkeypatch)
    try:
        for (name, params), _ in zip(port_units, ref.order):
            got, want = port.read_unit(name), ref.read_unit(name)
            assert got.io_bytes == want.io_bytes, name
            assert got.ledger_bytes == want.ledger_bytes, name
            assert [s[0] for s in got.stages] == [s[0] for s in want.stages]
            for a, b in zip(tree_leaves(got.params), tree_leaves(params)):
                assert a.dtype == b.dtype and torch.equal(a, b), name
    finally:
        port.close()


@pytest.mark.parametrize("kind", ["directio", "rawio", "mmap-dummy"])
def test_read_unit_never_aliases_host_buffers(units, tmp_path, kind,
                                              monkeypatch):
    """On the CPU a read copies out of the arena / staging buffer: reading
    every other unit afterwards (which rotates the arena round) leaves an
    earlier unit's tensors unchanged."""
    _, port_units, _, _ = units
    _, port = _build_both(units, tmp_path, kind, monkeypatch)
    try:
        first = port.read_unit(port.order[1]).params
        snap = [t.clone() for t in tree_leaves(first)]
        for name in port.order * 2:
            port.read_unit(name)
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(first), snap))
    finally:
        port.close()


@pytest.mark.parametrize("kind", ["directio", "directio-buffered"])
def test_directio_one_buffer_shared_by_concurrent_readers(units, tmp_path,
                                                          kind, monkeypatch):
    """One arena buffer per store: four threads reading every unit of one
    shared store at once each get the source bits back, and the arena
    holds one buffer of the largest unit's aligned bytes."""
    import threading
    _, port_units, _, _ = units
    _, port = _build_both(units, tmp_path, kind, monkeypatch)
    src = dict(port_units)
    bad = []

    def reader():
        for name in port.order * 3:
            got = port.read_unit(name).params
            if not all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(got), tree_leaves(src[name]))):
                bad.append(name)
    try:
        threads = [threading.Thread(target=reader) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert bad == []
        largest = max(port.stored_nbytes(n) for n in port.order)
        assert port.arena.host_bytes == largest + ALIGNMENT
    finally:
        port.close()


def test_directio_files_padded_to_alignment(units, tmp_path, monkeypatch):
    _, port = _build_both(units, tmp_path, "directio", monkeypatch)
    import os
    for name in port.order:
        size = os.path.getsize(port._path(name))
        assert size % ALIGNMENT == 0
        assert size == port.stored_nbytes(name) >= port.nbytes(name)


@pytest.mark.parametrize("case", ["aligned", "reuse", "rotation", "growth"])
def test_aligned_arena(case):
    arena = AlignedArena(depth=3)
    if case == "aligned":
        for n in (1, 4095, 4096, 10_000):
            buf = arena.take(n)
            assert buf.ctypes.data % ALIGNMENT == 0
            assert buf.nbytes % ALIGNMENT == 0 and buf.nbytes >= n
    elif case == "reuse":
        for _ in range(12):
            arena.take(8192)
        assert arena.allocations == 3
    elif case == "rotation":
        bufs = [arena.take(4096) for _ in range(3)]
        for i, b in enumerate(bufs):
            b[:] = i
        assert [int(b[0]) for b in bufs] == [0, 1, 2]
        assert arena.take(4096).ctypes.data == bufs[0].ctypes.data
    else:
        arena.take(4096)
        big = arena.take(5 * ALIGNMENT)
        assert big.nbytes == 5 * ALIGNMENT and arena.allocations == 2
        assert arena.host_bytes >= 5 * ALIGNMENT + ALIGNMENT


def test_directio_short_read_raises(units, tmp_path, monkeypatch):
    """A file cut short reads short: a SwapIOError, never a partial
    unit."""
    from repro_torch.errors import SwapIOError
    _, port = _build_both(units, tmp_path, "directio", monkeypatch)
    name = port.order[1]
    import os
    os.truncate(port._path(name), port.stored_nbytes(name) // 2)
    with pytest.raises(SwapIOError):
        port.read_unit(name)
    port.close()


# ------------------------------------------------------------ engine modes
@pytest.mark.parametrize("mode,cls,extra", [
    ("snet", MmapStore, 1), ("copy_in", RawIOStore, 3),
    ("dummy_asm", MmapStore, 2)])
def test_mode_resolves_against_raw_store(units, tmp_path, mode, cls, extra):
    """``SwapEngine(mode=...)`` reads one set of mmap files through the
    arm's backend, with the reference's resident charge per unit."""
    ref_units, port_units, _, _ = units
    store = build_store(port_units, str(tmp_path / "p"), device="cpu")
    ref_store = ref_build_store(ref_units, str(tmp_path / "r"))
    eng = SwapEngine(store, mode=mode, gpu_dispatch=True)
    ref_eng = RefSwapEngine(ref_store, mode=mode, gpu_dispatch=True)
    try:
        assert type(eng.store) is cls and eng.mode == mode
        assert eng.store.skeletons is store.skeletons
        for name in store.order:
            assert eng.store.resident_nbytes(name) == \
                ref_eng.store.resident_nbytes(name) == \
                extra * store.nbytes(name)
        h = eng.swap_in(store.order[:3])
        assert h.resident_bytes == extra * sum(store.nbytes(n)
                                               for n in store.order[:3])
        for got, (_, want) in zip(h.params, port_units[:3]):
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(got), tree_leaves(want)))
        eng.swap_out(h)
        assert eng.ledger.resident == 0
    finally:
        eng.close()
        ref_eng.close()


@pytest.mark.parametrize("backend", ["quant", "faulty"])
def test_ablation_modes_refuse_non_raw_stores(units, tmp_path, backend):
    _, port_units, _, _ = units
    store = build_store(port_units, str(tmp_path / backend),
                        backend=backend, device="cpu")
    assert not store.raw_format
    for mode in ("copy_in", "dummy_asm"):
        with pytest.raises(TypeError):
            as_reader(store, mode=mode)
    with pytest.raises(ValueError):
        SwapEngine(store, mode="nope")


def test_store_backend_rejects_mode_combination(units, tmp_path):
    _, _, model, params = units
    with pytest.raises(ValueError):
        SwappedModel(model, params, str(tmp_path), store_backend="rawio",
                     mode="copy_in", device="cpu")


@pytest.mark.parametrize("mode,gpu_dispatch,k",
                         [("copy_in", True, 3), ("copy_in", False, 2),
                          ("dummy_asm", False, 2)])
def test_ablation_arm_equals_snet_bitwise(units, tmp_path, mode,
                                          gpu_dispatch, k):
    """One pass in each arm: the same logits as the snet pass, and at
    m = 1 a ledger peak of exactly k x the largest block."""
    _, _, model, params = units
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 16)), dtype=torch.int32)
    out = {}
    for arm in ("snet", mode):
        sm = SwappedModel(model, params, str(tmp_path / arm),
                          prefetch_depth=1, mode=arm,
                          gpu_dispatch=gpu_dispatch, device="cpu")
        try:
            sm.set_plan((1, 3))
            out[arm], _ = sm.forward({"tokens": tokens})
            blocks = [sum(sm.store.nbytes(n) for n in sm.store.order[lo:hi])
                      for lo, hi in sm.plan.blocks()]
            want = (1 if arm == "snet" else k) * max(blocks)
            assert sm.engine.stats.peak_resident == want
        finally:
            sm.close()
    assert torch.equal(out["snet"], out[mode])


# ------------------------------------------------------------ admission
SIZE_CASES = {
    "classes": ({"a": 10, "b": 10, "c": 20, "d": 50, "e": 0}, 45),
    "partial-class": ({"a": 10, "b": 30, "c": 30}, 50),
    "none-fit": ({"a": 100, "b": 200}, 50),
    "all-fit": ({"a": 1, "b": 2, "c": 3}, 1000),
    "zero-capacity": ({"a": 1}, 0),
}


@pytest.mark.parametrize("case", sorted(SIZE_CASES))
def test_size_aware_policy_matches_reference(case):
    sizes, capacity = SIZE_CASES[case]
    mine = size_aware_policy(sizes, capacity)
    ref = ref_size_aware_policy(sizes, capacity)
    probes = [(n, s) for n, s in sizes.items()] + [("unknown", 5),
                                                   ("unknown", 500)]
    assert [mine(n, s) for n, s in probes] == [ref(n, s) for n, s in probes]


def test_cache_policy_installed_and_pinned_override():
    ledger = MemoryLedger(None)
    cache = BlockCache(100, ledger, admit_frac=0.25)
    assert cache.admits("x", 25) and not cache.admits("x", 26)
    cache.set_policy(lambda name, nbytes: name == "hot")
    assert cache.admits("hot", 90) and not cache.admits("x", 1)
    cache.pin(["x"])
    assert cache.admits("x", 1000)
    cache.set_policy(None)
    assert cache.admits("y", 25) and not cache.admits("y", 26)


def test_partition_plans_resident_bytes_of_the_arm(units, tmp_path):
    """The planner sees a ``copy_in`` arm at logical size (the reference's
    ``min``), so its plan equals the snet plan at the same budget."""
    _, _, model, params = units
    plans = []
    for mode in ("snet", "copy_in"):
        sm = SwappedModel(model, params, str(tmp_path / mode), mode=mode,
                          device="cpu")
        try:
            plans.append(sm.partition(8 << 20, DelayModel(), 2, 32).points)
        finally:
            sm.close()
    assert plans[0] == plans[1]
