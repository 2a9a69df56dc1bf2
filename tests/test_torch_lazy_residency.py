"""What a lazy quantized store puts on the device, against what the ledger
charges it, for the families whose units mix leaf kinds.

In lazy mode a unit's leaves are of three kinds: raw leaves, quantized
leaves the fused kernel streams (2-D, a fused key: payload and scales stay
on the device) and quantized leaves it cannot stream (embeddings, 3-D
expert stacks), which the loader widens on the host. The ledger charges the
first two kinds their bytes and a host-widened leaf its logical bytes
(``QuantMeta.resident_lazy``, the JAX package's charge). The device must
hold the same: no payload of a host-widened leaf beside its widening.

``reduced()`` configs, params from the port's own init: qwen2.5-3b (no unit
mixes kinds), deepseek-v2-lite (MLA + MoE: routed expert stacks beside
fused linears) and llama4-scout (MoE). Tolerances:
  * device bytes of the resident weights against the ledger's peak: equal
    within 1% (the 128-byte alignment of each device segment);
  * leaves and logits against the stored bytes decoded on their own:
    bitwise (the same bytes, the same casts).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel  # noqa: E402
from repro_torch.core.skeleton import torch_dtype  # noqa: E402
from repro_torch.kernels.dequant import unpack_int4  # noqa: E402
from repro_torch.kernels.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

BUDGET = 64 * 1024 * 1024
ARCHS = ["qwen2.5-3b", "deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]


def _swapped(arch, dtype, precision, workdir):
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    sm = SwappedModel(model, params, str(workdir), device="cpu",
                      store_backend="quant", precision=precision)
    sm.partition(BUDGET, DelayModel(), 2, 16)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    return sm, {"tokens": torch.from_numpy(tokens.astype(np.int32))}


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lazy_device_weight_bytes_match_the_ledger(tmp_path, arch,
                                                   precision):
    """The peak device bytes of the resident weights lie within 1% above
    the ledger's peak charge, for every family: a unit that mixes fused
    and host-widened leaves puts up only the fused leaves' payload."""
    sm, batch = _swapped(arch, "float32", precision, tmp_path)
    try:
        assert sm.plan.n_blocks >= 2
        _, stats = sm.forward(batch)
    finally:
        sm.close()
    ledger, dev = stats["peak_resident_mb"], stats["peak_device_weights_mb"]
    assert ledger <= dev <= 1.01 * ledger, (ledger, dev)


def _stored_leaves(sm, name):
    """A unit's lazy leaves decoded from its file on their own: raw bytes
    viewed in their dtype, fused leaves as QuantizedTensors of the stored
    payload and scales, every other quantized leaf widened in fp32 by
    numpy and cast to its dtype afterwards (the order of the casts the
    store has always used)."""
    store = sm.store
    meta = store._qmeta[name]
    buf = np.fromfile(store._path(name), dtype=np.uint8)
    blob = torch.from_numpy(buf.copy())
    out = []
    for ql in meta.leaves:
        dt = torch_dtype(ql.dtype)
        if ql.scale_offset < 0:
            out.append(blob[ql.offset:ql.offset + ql.nbytes].view(dt)
                       .reshape(ql.shape))
            continue
        q = blob[ql.offset:ql.offset + ql.nbytes].view(torch.int8) \
            .reshape(-1, ql.cols)
        s = blob[ql.scale_offset:ql.scale_offset + 4 * ql.cols] \
            .view(torch.float32)
        if ql.fusable:
            out.append(QuantizedTensor(q, s, ql.shape, ql.dtype, ql.bits))
            continue
        vals = unpack_int4(q.numpy(), ql.rows) if ql.bits == 4 else q.numpy()
        fp = np.multiply(vals, s.numpy()[None, :], dtype=np.float32)
        out.append(torch.from_numpy(fp).to(dt).reshape(ql.shape))
    return tree_unflatten(store.skeletons[name].treedef, out)


def _same(a, b) -> bool:
    if isinstance(a, QuantizedTensor):
        return (isinstance(b, QuantizedTensor) and torch.equal(a.q, b.q)
                and torch.equal(a.scales, b.scales) and a.bits == b.bits
                and tuple(a.shape) == tuple(b.shape))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e"])
def test_lazy_leaves_and_logits_are_the_stored_bytes(tmp_path, arch,
                                                     precision):
    """bf16, where the widened leaves are cast: every leaf ``read_unit``
    gives equals the unit's file decoded on its own, bitwise and in its
    dtype (the host cast of the widened fp32 leaf rounds as a device cast
    does), and the swapped logits equal the unswapped forward over those
    decoded leaves bitwise."""
    sm, batch = _swapped(arch, "bfloat16", precision, tmp_path)
    try:
        decoded = [_stored_leaves(sm, u.name) for u in sm.units]
        mixed = 0
        for u, want in zip(sm.units, decoded):
            got = sm.store.read_unit(u.name).params
            pairs = list(zip(tree_leaves(got), tree_leaves(want)))
            assert all(_same(a, b) for a, b in pairs), u.name
            qls = sm.store._qmeta[u.name].leaves
            mixed += (any(ql.fusable for ql in qls)
                      and any(ql.scale_offset >= 0 and not ql.fusable
                              for ql in qls))
        assert mixed > 0              # units with fused and widened leaves
        logits, _ = sm.forward(batch)
        want = sm.forward_unswapped(batch, resident=decoded)
    finally:
        sm.close()
    assert torch.equal(logits, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_widen_in_pieces_is_the_whole_array(monkeypatch, bits, dtype):
    """The loader's threaded widening, cut into pieces of a few rows (an
    odd row count: the int4 carrier's pad row), equals numpy's
    whole-array multiply cast to the dtype, bitwise."""
    from repro_torch.kernels.dequant import quantize_int4, quantize_int8
    from repro_torch.store import quantized_store as qs
    monkeypatch.setattr(qs, "_WIDEN_PIECE", 3 * 37)
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((101, 37)).astype(np.float32)
    q, s = (quantize_int8 if bits == 8 else quantize_int4)(w)
    vals = unpack_int4(q, 101) if bits == 4 else q
    want = torch.from_numpy(np.multiply(vals, s[None, :],
                                        dtype=np.float32)).to(dtype)
    got = qs.widen(q, s, 101, bits, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
