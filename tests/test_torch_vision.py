"""The port's conv workloads (``repro_torch.models.vision``) against the
JAX package's ``repro.models.vision``.

A sim's params come from JAX ``init_convnet`` through ``params_from_jax``
(one jit draws the four sims); a single layer's params and every input are
drawn from a seed with numpy. All four sims run at their own layer lists,
at batch 2; one jit gives the four sims' reference outputs. Tolerances:
the layer lists, ``trace_hw``, ``layer_flops_conv`` and ``prune_convnet``'s
layers and kept weights are exact; forward passes (whole nets, the
channel-split baseline, each layer kind alone) within 1e-5 (rtol and
atol) in fp32, since the two packages' convolutions sum in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import vision as ref_vision  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.dequant import quantize_int8  # noqa: E402
from repro_torch.kernels.qtensor import QuantizedTensor  # noqa: E402
from repro_torch.models import vision  # noqa: E402
from repro_torch.store.quantized_store import roundtrip_leaf  # noqa: E402

KINDS = ["vgg", "resnet", "yolo", "fcn"]
KEEPS = (0.25, 0.6)
GROUPS = 4
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 2


def _astuples(layers):
    return [dataclasses.astuple(l) for l in layers]


@pytest.fixture(scope="module")
def refs():
    """kind -> (ref layers, ref params, x numpy, ref outputs): the four
    sims' params from one jit of JAX ``init_convnet``, their outputs (the
    forward, the channel split, the pruned forwards at KEEPS, with the
    pruned nets) from one jit of the reference's functions."""
    sims = {k: ref_vision.MODELS[k]()[1] for k in KINDS}
    rparams = jax.jit(lambda key: {k: ref_vision.init_convnet(sims[k], key)
                                   for k in KINDS})(jax.random.key(7))
    xs = {k: np.random.default_rng(3).standard_normal(
        (BATCH, ref_vision.MODELS[k]()[2], ref_vision.MODELS[k]()[2], 3)
    ).astype(np.float32) for k in KINDS}
    pruned = {(kind, k): ref_vision.prune_convnet(sims[kind], rparams[kind], k)
              for kind in KINDS for k in KEEPS}

    def fwd(p, pp, xx):
        return {kind: {
            "full": ref_vision.apply_convnet(sims[kind], p[kind], xx[kind]),
            "split": ref_vision.apply_convnet_channel_split(
                sims[kind], p[kind], xx[kind], GROUPS),
            "pruned": [ref_vision.apply_convnet(pruned[kind, k][0],
                                                pp[kind][i], xx[kind])
                       for i, k in enumerate(KEEPS)]} for kind in KINDS}
    y = jax.jit(fwd)(rparams, {kind: [pruned[kind, k][1] for k in KEEPS]
                               for kind in KINDS},
                     {k: jnp.asarray(v) for k, v in xs.items()})
    return {kind: (sims[kind], rparams[kind], xs[kind], {
        "full": np.asarray(y[kind]["full"]),
        "split": np.asarray(y[kind]["split"]),
        "pruned": {k: pruned[kind, k] + (np.asarray(y[kind]["pruned"][i]),)
                   for i, k in enumerate(KEEPS)}}) for kind in KINDS}


@pytest.fixture(scope="module", params=KINDS)
def sim(request, refs):
    """(kind, ref layers, ref params, port layers, port params, x numpy,
    ref outputs)."""
    kind = request.param
    rname, _, rhw = ref_vision.MODELS[kind]()
    name, layers, hw = vision.MODELS[kind]()
    assert (name, hw) == (rname, rhw)
    rlayers, rparams, x, want = refs[kind]
    params = params_from_jax(jax.tree.map(np.asarray, rparams))
    return kind, rlayers, rparams, layers, params, x, want


@pytest.mark.parametrize("kind", KINDS)
def test_layer_lists_match_reference(kind):
    rname, rlayers, rhw = ref_vision.MODELS[kind]()
    name, layers, hw = vision.MODELS[kind]()
    assert (name, hw) == (rname, rhw)
    assert _astuples(layers) == _astuples(rlayers)


@pytest.mark.parametrize("kind", KINDS)
def test_trace_hw_and_flops_match_reference(kind):
    _, rlayers, hw = ref_vision.MODELS[kind]()
    _, layers, _ = vision.MODELS[kind]()
    assert vision.trace_hw(layers, hw) == ref_vision.trace_hw(rlayers, hw)
    for l, rl, h in zip(layers, rlayers, ref_vision.trace_hw(rlayers, hw)):
        for batch in (1, 4):
            assert (vision.layer_flops_conv(l, h, batch)
                    == ref_vision.layer_flops_conv(rl, h, batch))


def test_params_from_jax_carries_the_layer_list(sim):
    """A conv net's params are a list of per-layer dicts, pool / gap
    layers empty ones: the list crosses as it is, leaf for leaf."""
    _, rlayers, rparams, _, params, _, _ = sim
    assert isinstance(params, list) and len(params) == len(rparams)
    for l, rp, p in zip(rlayers, rparams, params):
        assert sorted(p) == sorted(rp)
        if l.kind in ("pool", "gap"):
            assert p == {}
        for k in p:
            assert p[k].dtype == torch.float32
            assert np.array_equal(p[k].numpy(), np.asarray(rp[k]))


def test_init_convnet_shapes_and_scales(sim):
    """The port draws its own numbers (a torch.Generator), at the
    reference's shapes, dtypes and init rule; one seed, one draw."""
    _, rlayers, rparams, layers, _, _, _ = sim

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return vision.init_convnet(layers, g)
    a, b = draw(0), draw(0)
    for l, rp, p, q in zip(layers, rparams, a, b):
        assert sorted(p) == sorted(rp)
        for k in p:
            assert tuple(p[k].shape) == tuple(rp[k].shape)
            assert torch.equal(p[k], q[k])
        if "b" in p:
            assert not p["b"].any()
            fan_in = l.k * l.k * l.cin if l.kind != "fc" else l.cin
            std = float(p["w"].std()) * fan_in ** 0.5
            assert 0.8 < std < 1.2


def test_apply_convnet_matches_reference(sim):
    _, _, _, layers, params, x, ref = sim
    want = ref["full"]
    got = vision.apply_convnet(layers, params, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_channel_split_matches_reference(sim):
    _, _, _, layers, params, x, ref = sim
    got = vision.apply_convnet_channel_split(layers, params,
                                             torch.from_numpy(x), GROUPS)
    np.testing.assert_allclose(got.numpy(), ref["split"], **TOL)
    full = vision.apply_convnet(layers, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("keep", KEEPS)
def test_prune_convnet_matches_reference(sim, keep):
    _, _, _, layers, params, x, ref = sim
    rl, rp, want = ref["pruned"][keep]
    pl, pp = vision.prune_convnet(layers, params, keep)
    assert _astuples(pl) == _astuples(rl)
    for a, b in zip(pp, rp):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k].numpy(), np.asarray(b[k]))
    got = vision.apply_convnet(pl, pp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _layer_params(l, rng):
    """A layer's params drawn with numpy at the init's shapes and scale,
    with a non-zero bias, so its broadcast is checked too."""
    if l.kind not in ("conv", "res", "fc"):
        return {}
    shape = (l.k, l.k, l.cin, l.cout) if l.kind != "fc" else (l.cin, l.cout)
    fan_in = int(np.prod(shape[:-1]))
    return {"w": (rng.standard_normal(shape) * fan_in ** -0.5
                  ).astype(np.float32),
            "b": (rng.standard_normal(l.cout) * 0.1).astype(np.float32)}


LAYER_CASES = [
    (ref_vision.Layer("conv", 8, 16, 3, 1), 10),
    (ref_vision.Layer("conv", 8, 16, 3, 2), 10),      # even input, stride 2
    (ref_vision.Layer("conv", 8, 16, 3, 2), 9),       # odd input, stride 2
    (ref_vision.Layer("conv", 8, 21, 1, 1), 9),       # 1 x 1 head
    (ref_vision.Layer("res", 8, 8, 3, 1), 10),
    (ref_vision.Layer("pool", 8, 8), 10),
    (ref_vision.Layer("pool", 8, 8), 9),              # VALID drops a row
    (ref_vision.Layer("gap", 8, 8), 10),
    (ref_vision.Layer("fc", 8, 24), 0),
]


@pytest.mark.parametrize("rl,hw", LAYER_CASES,
                         ids=[f"{l.kind}-k{l.k}-s{l.stride}-hw{hw}"
                              for l, hw in LAYER_CASES])
def test_each_layer_kind_matches_reference(rl, hw):
    l = vision.Layer(**dataclasses.asdict(rl))
    rng = np.random.default_rng(11)
    p = {k: torch.from_numpy(v) for k, v in _layer_params(l, rng).items()}
    rp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    shape = (BATCH, 8) if l.kind == "fc" else (BATCH, hw, hw, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(ref_vision.apply_layer(rl, rp, jnp.asarray(x)))
    got = vision.apply_layer(l, p, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_same_padding_is_asymmetric_at_stride_2():
    """XLA's "SAME" at k 3, s 2 on an even input pads one row and column
    at the high end only. The port matches it; conv2d's symmetric
    ``padding=1`` gives the same shape but shifted values."""
    assert vision.same_pads(32, 3, 2) == (0, 1)
    assert vision.same_pads(33, 3, 2) == (1, 1)
    assert vision.same_pads(32, 3, 1) == (1, 1)
    assert vision.same_pads(32, 1, 1) == (0, 0)
    rng = np.random.default_rng(4)
    p = {k: torch.from_numpy(v) for k, v in _layer_params(
        vision.Layer("conv", 4, 8, 3, 2), rng).items()}
    rp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    x = rng.standard_normal((BATCH, 16, 16, 4)).astype(np.float32)
    want = np.asarray(ref_vision._conv(jnp.asarray(x), rp["w"], rp["b"], 2))
    got = vision._conv(torch.from_numpy(x), p["w"], p["b"], 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    sym = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
        stride=2, padding=1).permute(0, 2, 3, 1) + p["b"]
    assert tuple(sym.shape) == want.shape
    assert np.abs(sym.numpy() - want).max() > 1e-2


def test_quantized_conv_weight_dequantizes_at_use():
    """A QuantizedTensor conv weight is widened at use (the plain
    ``dequant_int8`` on the CPU): bitwise the conv of its host round-trip,
    the store's reference."""
    l = vision.Layer("conv", 16, 32, 3, 1)
    g = torch.Generator()
    g.manual_seed(0)
    p = vision.init_layer(l, g)
    q, s = quantize_int8(p["w"].numpy())
    qt = QuantizedTensor(torch.from_numpy(q), torch.from_numpy(s),
                         tuple(p["w"].shape), "float32", 8)
    x = torch.randn((BATCH, 8, 8, 16), generator=g)
    got = vision.apply_layer(l, {"w": qt, "b": p["b"]}, x)
    want = vision.apply_layer(l, {"w": roundtrip_leaf(p["w"], 8),
                                  "b": p["b"]}, x)
    assert torch.equal(got, want)
