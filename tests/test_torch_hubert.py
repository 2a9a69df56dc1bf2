"""hubert's bidirectional audio encoder in the port against the JAX
package on the same weights: the params tree (no token embedding, a
``mask_emb``, an untied head), the prefill on frame features, the swapped
forward, the quantized store that an opted-out model resolves to mmap,
calibration's feature batch, and the refusals of an encoder-only model.

hubert-xlarge ``reduced()`` in float32 (2 layers, d_model 256, 4 / 4
heads of 64, a GELU MLP of 512, vocab 504, d_frontend 64, no RoPE,
attention without a causal mask), params from the JAX ``Model.init``
handed over as numpy. Tolerances, with their reasons:
  * port vs JAX, float32: rtol = atol = 1e-5 (sums in another order);
  * bf16 compute: 2e-2 (the compute dtype's rounding);
  * swapped vs unswapped inside the port on mmap: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import calibrate as ref_calibrate  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.cost_model import DelayModel as RefDelayModel  # noqa: E402
from repro.core.runtime import SwappedModel as RefSwappedModel  # noqa: E402
from repro.core.runtime import unit_infos as ref_unit_infos  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel, unit_infos  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ARCH = "hubert-xlarge"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BUDGET = 4 * 1024 * 1024
B, S = 2, 48


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _pair(dtype="float32"):
    ref_model = RefModel(dataclasses.replace(ref_get_arch(ARCH).reduced(),
                                             dtype=dtype))
    ref_params = jax.jit(ref_model.init)(jax.random.key(0))
    model = Model(dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


@pytest.fixture(scope="module")
def setup():
    return _pair()


def features(cfg, seed=0, B=B, S=S):
    """Seeded frame features [B, S, d_frontend], the conv extractor's
    output the stub stands for."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_frontend)).astype(np.float32)


def test_params_tree_units_and_infos_match_jax(setup, tmp_path):
    """No token embedding; the embed unit holds the frontend and
    ``mask_emb``; the untied head; unit names and info rows equal the
    reference's."""
    ref_model, ref_params, model, params = setup
    assert sorted(params) == sorted(ref_params) == [
        "final_norm", "frontend", "lm_head", "mask_emb", "segments"]
    for k in ("frontend", "lm_head", "mask_emb"):
        assert tuple(params[k].shape) == ref_params[k].shape
    assert sorted(model.init(0, device="cpu")) == sorted(params)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"))
    ref_rows = ref_unit_infos(ref_model, ref.units, B, S)
    ref_names = [u.name for u in ref.units]
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"), device="cpu")
    try:
        assert [u.name for u in sm.units] == ref_names
        assert sorted(sm.units[0].params) == ["frontend", "mask_emb"]
        rows = unit_infos(model, sm.units, B, S)
        assert [(r.name, r.size, r.depth, r.flops) for r in rows] == \
            [(r.name, r.size, r.depth, r.flops) for r in ref_rows]
    finally:
        sm.close()


def test_prefill_on_features_matches_jax(setup):
    """Last-position logits and the K/V of every layer."""
    ref_model, ref_params, model, params = setup
    x = features(model.cfg)
    want, wcache = jax.jit(ref_model.prefill)(
        ref_params, {"features": jnp.asarray(x)})
    got, gcache = model.prefill(params, {"features": torch.from_numpy(x)})
    assert tuple(got.shape) == (B, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for g_seg, w_seg in zip(gcache, wcache):
        for name in g_seg:
            np.testing.assert_allclose(_np(g_seg[name]),
                                       np.asarray(w_seg[name]), **TOL)


def test_attention_is_bidirectional_in_both(setup):
    """A change to the last frame alone moves the first position's hidden
    state in both packages, by the same amount: no causal mask."""
    ref_model, ref_params, model, params = setup
    x = features(model.cfg, seed=1)
    y = x.copy()
    y[:, -1] += 1.0
    fwd = jax.jit(lambda p, b: ref_model.forward(p, b, mode="prefill")[0])
    got = [model.forward(params, {"features": torch.from_numpy(a)})[0]
           for a in (x, y)]
    want = [fwd(ref_params, {"features": jnp.asarray(a)}) for a in (x, y)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    moved = _np(got[1][:, 0] - got[0][:, 0])
    assert np.abs(moved).max() > 1e-3 * np.abs(_np(got[0][:, 0])).max()
    np.testing.assert_allclose(moved, np.asarray(want[1][:, 0]
                                                 - want[0][:, 0]), **TOL)


def test_bf16_prefill_on_features_matches_jax():
    ref_model, ref_params, model, params = _pair("bfloat16")
    x = features(model.cfg, seed=2)
    want, _ = jax.jit(ref_model.prefill)(ref_params,
                                         {"features": jnp.asarray(x)})
    got, _ = model.prefill(params, {"features": torch.from_numpy(x)})
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_TOL)


@pytest.mark.parametrize("store", ["mmap", "quant"])
def test_swapped_bitwise_and_matches_jax(setup, tmp_path, store):
    """The swapped forward on features is bitwise the unswapped one and
    within 1e-5 of the reference's; asked for the quant store, the model
    (``quant_eligible=False``) serves from mmap in both packages."""
    ref_model, ref_params, model, params = setup
    x = features(model.cfg, seed=3)
    ref = RefSwappedModel(ref_model, ref_params, str(tmp_path / "ref"),
                          store_backend=store)
    ref.partition(BUDGET, RefDelayModel(), B, S)
    want, ref_st = ref.forward({"features": jnp.asarray(x)})
    ref.close()
    sm = SwappedModel(model, params, str(tmp_path / "port"),
                      store_backend=store, device="cpu")
    try:
        sm.partition(BUDGET, DelayModel(), B, S)
        assert sm.plan.points == ref.plan.points and sm.plan.n_blocks >= 2
        batch = {"features": torch.from_numpy(x)}
        got, st = sm.forward(batch)
        assert torch.equal(got, sm.forward_unswapped(batch))
        assert 0 < st["peak_resident_mb"] * 1e6 <= BUDGET
    finally:
        sm.close()
    assert (st["store_backend"], st["precision"]) == ("mmap", "fp") == \
        (ref_st["store_backend"], ref_st["precision"])
    assert st["bytes_resident_quantized"] == 0
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_calibration_batch_draws_features():
    """A model without token inputs calibrates on unit-normal features,
    the reference's draws."""
    cfg = get_arch(ARCH).reduced()
    got = calibrate.calibration_batch(cfg, seed=4)
    want = ref_calibrate.calibration_batch(ref_get_arch(ARCH).reduced(),
                                           seed=4)
    assert sorted(got) == sorted(want) == ["features"]
    np.testing.assert_array_equal(got["features"],
                                  np.asarray(want["features"]))


def test_encoder_only_refusals(setup):
    """No decode: the in-memory engine and the serve CLI refuse it, as the
    reference's do."""
    _, _, model, params = setup
    assert not model.cfg.supports_decode()
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(model, params, device="cpu").generate(
            [Request(0, [1, 2, 3])])
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", ARCH, "--reduce", "smoke", "--requests", "1",
                    "--device", "cpu"])
