"""Store parity: the port writes the JAX package's unit files byte for
byte, and reads them back to the same values.

Tolerance: exact everywhere. The files, their CRC32 digests, the skeleton
refs and every leaf read back are byte-identical; eager dequantization is
one fp32 multiply per element on both sides, so bitwise too.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.runtime import split_units as ref_split_units  # noqa: E402
from repro.core.skeleton import assemble_np as ref_assemble_np  # noqa: E402
from repro.kernels.qtensor import QuantizedTensor as RefQT  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.store import build_store as ref_build_store  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.runtime import split_units  # noqa: E402
from repro_torch.errors import SwapCorruptionError  # noqa: E402
from repro_torch.kernels.qtensor import (QuantizedTensor,  # noqa: E402
                                          is_quantized, materialize_tree)
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.store import build_store  # noqa: E402
from repro_torch.store.quantized_store import roundtrip  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_leaves  # noqa: E402

STORES = {"mmap": {}, "int8": {"bits": 8}, "int4": {"bits": 4}}


@pytest.fixture(scope="module")
def units():
    cfg = dataclasses.replace(ref_get_arch("qwen2.5-3b").reduced(),
                              dtype="float32")
    ref_model = RefModel(cfg)
    ref_params = ref_model.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, ref_params)
    port_model = Model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                                           dtype="float32"))
    ref_units = [(u.name, u.params) for u in ref_split_units(ref_model,
                                                              ref_params)]
    port_units = [(u.name, u.params) for u in
                  split_units(port_model, params_from_jax(np_params))]
    return ref_units, port_units


def _build_both(units, tmp_path, kind, **extra):
    ref_units, port_units = units
    backend = "mmap" if kind == "mmap" else "quant"
    opts = dict(STORES[kind], **extra)
    ref = ref_build_store(ref_units, str(tmp_path / "ref"), backend=backend,
                          **opts)
    port = build_store(port_units, str(tmp_path / "port"), backend=backend,
                       device="cpu", **opts)
    return ref, port


@pytest.mark.parametrize("kind", sorted(STORES))
def test_unit_files_byte_identical(units, tmp_path, kind):
    ref, port = _build_both(units, tmp_path, kind)
    assert port.order == ref.order
    for name in ref.order:
        with open(ref._path(name), "rb") as a, open(port._path(name), "rb") as b:
            assert a.read() == b.read(), name
        assert os.path.basename(port._path(name)) == \
            os.path.basename(ref._path(name))
        assert port.nbytes(name) == ref.nbytes(name)
        assert port.stored_nbytes(name) == ref.stored_nbytes(name)
        assert port.resident_nbytes(name) == ref.resident_nbytes(name)
    assert port.digests == ref.digests
    assert port.meta_bytes() == ref.meta_bytes()


def test_per_unit_plan_byte_identical(units, tmp_path):
    """A ``{unit: 0|4|8}`` plan mixes widths per unit; units it does not
    name are stored raw."""
    plan = {"embed": 4, "layer000_dense": 8, "head": 0}
    ref, port = _build_both(units, tmp_path, "int8", plan=plan, eager=False)
    assert port.precision == ref.precision == "mixed"
    for name in ref.order:
        with open(ref._path(name), "rb") as a, open(port._path(name), "rb") as b:
            assert a.read() == b.read(), name
        assert port.resident_nbytes(name) == ref.resident_nbytes(name)
        assert port.read_unit(name).precision_bytes == \
            ref.read_unit(name).precision_bytes


def test_mmap_read_matches_reference_assembly(units, tmp_path):
    ref, port = _build_both(units, tmp_path, "mmap")
    for name in ref.order:
        rs, ps = ref.skeletons[name], port.skeletons[name]
        assert [(r.offset, r.shape, r.dtype) for r in ps.refs] == \
            [(r.offset, r.shape, r.dtype) for r in rs.refs]
        want = jax.tree.leaves(ref_assemble_np(
            rs, np.memmap(ref._path(name), dtype=np.uint8, mode="r")))
        r = port.read_unit(name)
        got = tree_leaves(r.params)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
        assert r.io_bytes == ref.nbytes(name)
        assert [s for s, _, _ in r.stages] == ["read", "unpack", "dispatch"]


def test_eager_quant_read_equals_reference(units, tmp_path):
    ref, port = _build_both(units, tmp_path, "int4", eager=True)
    for name in ref.order:
        want = jax.tree.leaves(ref.read_unit(name).params)
        got = tree_leaves(port.read_unit(name).params)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_lazy_quant_read_keeps_fused_weights_quantized(units, tmp_path, kind):
    ref, port = _build_both(units, tmp_path, kind, eager=False)
    for name in ref.order:
        rr, pr = ref.read_unit(name), port.read_unit(name)
        want = jax.tree_util.tree_flatten_with_path(
            rr.params, is_leaf=lambda x: isinstance(x, RefQT))[0]
        got = tree_flatten_with_path(pr.params, is_leaf=is_quantized)[0]
        assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
                for p, _ in want] == [p for p, _ in got]
        for (_, w), (path, g) in zip(want, got):
            assert isinstance(g, QuantizedTensor) == isinstance(w, RefQT)
            if isinstance(g, QuantizedTensor):
                assert path[-1] in ("wq", "wk", "wv", "wo", "wi0", "wi1",
                                    "lm_head")
                assert (g.shape, g.dtype, g.bits) == (w.shape, w.dtype, w.bits)
                assert g.q.numpy().tobytes() == np.asarray(w.q).tobytes()
                assert g.scales.numpy().tobytes() == \
                    np.asarray(w.scales).tobytes()
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert pr.ledger_bytes == rr.ledger_bytes
        assert pr.quantized_bytes == rr.quantized_bytes
        assert pr.io_bytes == rr.io_bytes


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_lazy_quant_read_widened_equals_the_round_trip(units, tmp_path,
                                                       kind):
    """A lazy unit widened (``materialize_tree``: the dequant kernel's
    plain version here) is bitwise the host round trip of the unit's
    weights, the in-memory reference of the quantized paths: the smoke
    builds that reference from the store's own units on the card."""
    _, port_units = units
    port = build_store(port_units, str(tmp_path), backend="quant",
                       device="cpu", eager=False, **STORES[kind])
    for name, params in port_units:
        got = tree_leaves(materialize_tree(port.read_unit(name).params))
        want = tree_leaves(roundtrip(params, STORES[kind]["bits"]))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("kind", ["mmap", "int8"])
def test_verify_rejects_a_flipped_byte(units, tmp_path, kind):
    _, port_units = units
    backend = "mmap" if kind == "mmap" else "quant"
    store = build_store(port_units, str(tmp_path / "s"), backend=backend,
                        device="cpu", verify=True, **STORES[kind])
    name = store.order[1]
    store.read_unit(name)                       # clean read passes
    with open(store._path(name), "r+b") as fh:
        b = fh.read(1)
        fh.seek(0)
        fh.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(SwapCorruptionError):
        store.read_unit(name)
    assert store.integrity_failures == 1


def test_unported_backends_raise(units, tmp_path):
    """``rawio``, ``directio`` and ``faulty``, once unported, now build
    through the registry on the CPU; only an unknown backend raises."""
    _, port_units = units
    for backend in ("rawio", "directio", "faulty"):
        store = build_store(port_units, str(tmp_path / backend),
                            backend=backend, device="cpu")
        assert store.backend == backend
        assert store.order == [n for n, _ in port_units]
        store.close()
    with pytest.raises(ValueError):
        build_store(port_units, str(tmp_path / "x"), backend="nope")
