"""The port on an NVIDIA GPU: each CUDA kernel against its plain version,
the wrappers' refusal to fall back, and the swapped slice on the card.

Every test here needs a GPU and skips without one. This file imports no
JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, with their reasons:
  * swap_linear_q, fp32 x: 1e-5 relative to the output's largest value
    (the kernel's fp32 sums run in another order and it scales once at the
    flush);
  * swap_linear_q, bf16 x: 2e-2 (one bf16 rounding of the output);
  * dequant: bitwise (one fp32 multiply per element on both sides);
  * mmap swapped vs unswapped: bitwise (the same ops on the same bytes).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel  # noqa: E402
from repro_torch.kernels import dequant as dq  # noqa: E402
from repro_torch.kernels import swap_linear_q as slq  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _rel(got, want) -> float:
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30)


def _weights(bits, K, N, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    q, s = (dq.quantize_int8 if bits == 8 else dq.quantize_int4)(w)
    return torch.from_numpy(q), torch.from_numpy(s)


@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_swap_linear_q_kernel_matches_plain(dev, bits, dtype, act):
    for M, K, N in ((3, 129, 67), (512, 2048, 256), (2, 2048, 11008),
                    (1, 7, 3)):
        q, s = _weights(bits, K, N, seed=M + K)
        g = torch.Generator().manual_seed(K)
        x = torch.randn((M, K), generator=g).to(dtype).to(dev)
        b = (torch.randn((N,), generator=g) * 0.1).to(dtype).to(dev)
        q, s = q.to(dev), s.to(dev)
        before = slq.launches.count
        got = slq.swap_linear_q(x, q, s, b, bits=bits, act=act)
        assert slq.launches.count == before + 1
        want = slq.swap_linear_q_plain(x, q, s, b, bits=bits, act=act)
        torch.cuda.synchronize()
        assert got.dtype == dtype and tuple(got.shape) == (M, N)
        assert _rel(got, want) <= TOL[dtype], (M, K, N)


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_kernel_matches_plain(dev, bits, out):
    R, C = 1001, 333
    q, s = _weights(bits, R, C, seed=R)
    q, s = q.to(dev), s.to(dev)
    before = dq.launches.count
    got = dq.dequant_int8(q, s, out, bits=bits, rows=R)
    assert dq.launches.count == before + 1
    assert torch.equal(got, dq.dequant_int8_plain(q, s, out, bits=bits,
                                                  rows=R))


def test_wrappers_raise_instead_of_falling_back(dev):
    q, s = _weights(8, 64, 32)
    q, s = q.to(dev), s.to(dev)
    x = torch.randn((8, 128), device=dev)[:, ::2]          # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        slq.swap_linear_q(x, q, s)
    with pytest.raises(TypeError):
        slq.swap_linear_q(torch.randn((8, 64), device=dev).half(), q, s)
    with pytest.raises(TypeError):
        dq.dequant_int8(q, s, torch.float16)


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, device="cpu")     # host: the store's source
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    return model, params, {"tokens": tokens}


@pytest.mark.parametrize("kind", ["mmap", "int8-lazy", "int4-lazy",
                                  "int8-eager"])
def test_swapped_slice_on_the_card(dev, tiny, tmp_path, kind):
    model, params, batch = tiny
    opts = {"mmap": dict(store_backend="mmap"),
            "int8-lazy": dict(store_backend="quant", precision="int8"),
            "int4-lazy": dict(store_backend="quant", precision="int4"),
            "int8-eager": dict(store_backend="quant", precision="int8",
                               store_options={"eager": True})}[kind]
    budget = 8 * 1024 * 1024
    sm = SwappedModel(model, params, str(tmp_path), budget=budget, **opts)
    try:
        assert sm.device.type == "cuda"
        sm.partition(budget, DelayModel(), 2, 32)
        slq.launches.reset()
        dq.launches.reset()
        logits, stats = sm.forward(batch)
        if kind == "mmap":
            assert torch.equal(logits, sm.forward_unswapped(batch))
        if kind.endswith("lazy"):
            assert slq.launches.count == 7 * model.cfg.n_layers + 1
        if kind.endswith("eager"):
            assert dq.launches.count > 0 and slq.launches.count == 0
    finally:
        sm.close()
    assert logits.is_cuda and bool(torch.isfinite(logits).all())
    assert stats["peak_resident_mb"] * 1e6 <= budget
