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
  * paged_attention: 1e-5 fp32 (the online softmax sums in another
    order), 2e-2 bf16 (one bf16 rounding of the output);
  * wkv6: 1e-5 fp32 inputs (the chunk's sums run in another order), 2e-2
    bf16 (one bf16 rounding of the output; the state stays fp32); rows of
    a BH 80 call against a 3-row call on them, every column split against
    the planned one, two calls with the state carried against one:
    bitwise;
  * swap_linear: 1e-5 fp32 x (the fp32 sums run in another order, and
    the three TF32 passes of the tensor-core route leave about 1e-6, also
    where x and w span 2^-20 .. 2^20), 2e-2 bf16 x (one bf16 rounding of
    the output); an M-row call against the
    1-row calls on its rows, and swap_linear_q's too: bitwise; a
    misaligned view against its aligned copy: bitwise; one-hot rows of x
    against a weight of distinct values: exact;
  * flash_attention: 1e-5 fp32 (online against dense softmax; three TF32
    passes at the pairs the TF32 kernel takes), 2e-2 bf16
    (P and the output rounded to bf16), at one head dim and at a value
    head dim of its own (MLA's 192 / 128); a row of a B-row call against
    the 1-row call on it, and two identical calls: bitwise; a block-local
    chunk of S or more against no chunk: bitwise (the same tiles and the
    same arithmetic);
  * mla_apply (reduced and full-width deepseek-v2 attention, bf16) on the
    card against its CPU run: 2e-2 of the largest value (bf16 rounds at
    other places in the two runs);
  * paged_attention: a sequence alone against the same sequence in
    batches of other lengths, and two identical calls: bitwise;
  * mmap swapped vs unswapped: bitwise (the same ops on the same bytes);
  * paged continuous batching vs solo in-memory decode, float32: equal
    tokens;
  * rwkv6 swapped vs unswapped on mmap: bitwise;
  * directio against mmap reads, a faulty read retried against a clean
    one, the copy_in / dummy_asm arms against snet: bitwise (the same
    bytes through other host paths);
  * the conv workloads: vgg_sim swapped on mmap against its in-memory
    forward bitwise (deterministic cuDNN), its quantized stores within
    2e-2 of the round-tripped forward;
  * a train step on a one-rank NCCL mesh against the unsharded step: the
    loss 1e-5 relative, each gradient leaf 1e-4 of its largest |g| (the
    local kernels sum as the unsharded ones; the mesh's reductions and
    the gradient accumulation run in another order);
  * the ring-buffer decode against the full cache: 1e-5 of each step's
    largest logit (one softmax against chunks of the online one).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.cost_model import DelayModel  # noqa: E402
from repro_torch.core.runtime import SwappedModel  # noqa: E402
from repro_torch.kernels import dequant as dq  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gemm_plan  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import swap_linear as sl  # noqa: E402
from repro_torch.kernels import swap_linear_q as slq  # noqa: E402
from repro_torch.kernels import wkv6 as kw  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.batch_engine import BatchDecodeEngine  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.paged_kv import PagedKVCache  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

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


def _paged_inputs(seed, B, H, KV, hd, T, seq_lens, dtype, pad_cols=0):
    """q, pools (page 0 zero), a SHUFFLED page table with ``pad_cols``
    extra columns of the padding page, seq_lens: on the card."""
    rng = np.random.default_rng(seed)
    n = [-(-s // T) for s in seq_lens]
    P = sum(n) + 3
    q = rng.standard_normal((B, H, hd)) * 0.5
    kp = rng.standard_normal((P + 1, T, KV, hd)) * 0.5
    vp = rng.standard_normal((P + 1, T, KV, hd)) * 0.5
    kp[0] = vp[0] = 0
    ids = rng.permutation(np.arange(1, P + 1))
    pt = np.zeros((B, max(n) + pad_cols), np.int32)
    used = 0
    for b, k in enumerate(n):
        pt[b, :k] = ids[used:used + k]
        used += k
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype).cuda()  # noqa: E731
    return (to(q), to(kp), to(vp), torch.from_numpy(pt).cuda(),
            torch.tensor(seq_lens, dtype=torch.int32).cuda())


PAGED_CASES = [
    # (B, H, KV, hd, T, seq_lens, scale, pad_cols): the reference test's
    # shape, qwen2.5-3b's and gemma2-9b's decode shapes, 4-token pages,
    # and pages longer than the kernel's 16-token staging chunk
    (3, 8, 2, 64, 8, [5, 23, 16], None, 0),
    (4, 16, 2, 128, 16, [1, 17, 40, 100], None, 2),
    (2, 16, 8, 256, 16, [4201, 25], 224.0 ** -0.5, 0),
    (2, 4, 4, 64, 4, [1, 70], None, 1),
    (2, 8, 1, 128, 48, [130, 3], None, 0),
]


@pytest.mark.parametrize("window,softcap", [(None, None), (7, None),
                                            (None, 30.0), (5, 30.0),
                                            (4096, 50.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(dev, dtype, window, softcap):
    for i, (B, H, KV, hd, T, sl, scale, pad) in enumerate(PAGED_CASES):
        args = _paged_inputs(i, B, H, KV, hd, T, sl, dtype, pad)
        before = pa.launches.count
        got = pa.paged_attention(*args, scale=scale, window=window,
                                 softcap=softcap)
        assert pa.launches.count == before + 1
        want = pa.paged_attention_plain(*args, scale=scale, window=window,
                                        softcap=softcap)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= TOL[dtype], (B, H, KV, hd, T, sl)


def test_paged_attention_raises_instead_of_falling_back(dev):
    q, kp, vp, pt, sl = _paged_inputs(0, 2, 8, 2, 64, 8, [5, 9],
                                      torch.float32)
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), kp.half(), vp.half(), pt, sl)
    with pytest.raises(TypeError):
        pa.paged_attention(q, kp, vp, pt.long(), sl)
    with pytest.raises(TypeError):
        pa.paged_attention(q.bfloat16(), kp, vp, pt, sl)
    with pytest.raises(ValueError):                      # head_dim 36
        pa.paged_attention(q[..., :36].contiguous(), kp[..., :36]
                           .contiguous(), vp[..., :36].contiguous(), pt, sl)
    wide = [torch.zeros(t.shape[:-1] + (264,), device=dev)
            for t in (q, kp, vp)]                        # head_dim 264
    with pytest.raises(ValueError):
        pa.paged_attention(*wide, pt, sl)


# (B, H, KV, hd, T, seq_lens, pad_cols): h2o-danube-3-4b's decode geometry
# (hd 120 at the row width 128, G 4) and granite-20b's (MQA: 48 query heads
# on one KV head, six groups of 8), ragged, past one split and past the
# 4,096-token window
GEOMETRY_CASES = [
    (3, 32, 8, 120, 16, [4100, 1, 300], 2),
    (4, 48, 1, 128, 16, [1, 40, 129, 700], 1),
    (2, 48, 1, 128, 4, [3, 70], 0),
]


@pytest.mark.parametrize("window,softcap", [(None, None), (4096, None),
                                            (7, None), (None, 30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_at_danube_and_granite_geometry(dev, dtype, window,
                                                        softcap):
    """hd 120 and G 48 launch the kernel and match the plain version."""
    for i, (B, H, KV, hd, T, sl, pad) in enumerate(GEOMETRY_CASES):
        args = _paged_inputs(30 + i, B, H, KV, hd, T, sl, dtype, pad)
        before = pa.launches.count
        got = pa.paged_attention(*args, window=window, softcap=softcap)
        assert pa.launches.count == before + 1
        want = pa.paged_attention_plain(*args, window=window,
                                        softcap=softcap)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= TOL[dtype], (B, H, KV, hd, T, sl)


@pytest.mark.parametrize("H,KV,hd", [(32, 8, 120), (48, 1, 128)])
def test_paged_attention_geometry_row_alone_equals_batched(dev, H, KV, hd):
    """A 4,100-token row (65 splits, 64 in the window) at h2o-danube's
    and granite-20b's geometry gives the same bits alone as beside other
    sequences, and two identical calls agree."""
    for window in (4096, None):
        for dtype in (torch.bfloat16, torch.float32):
            solo = None
            for others in ([], [25], [4500, 1, 300]):
                sl = [4100] + others
                q, kp, vp, pt, lens = _paged_inputs(
                    41, len(sl), H, KV, hd, 16, sl, dtype,
                    pad_cols=len(others))
                ref = _paged_inputs(41, 1, H, KV, hd, 16, [4100], dtype)
                q[0] = ref[0][0]
                n = -(-4100 // 16)
                kp[pt[0, :n].long()] = ref[1][ref[3][0, :n].long()]
                vp[pt[0, :n].long()] = ref[2][ref[3][0, :n].long()]
                got = pa.paged_attention(q, kp, vp, pt, lens,
                                         window=window)
                again = pa.paged_attention(q, kp, vp, pt, lens,
                                           window=window)
                assert torch.equal(got, again), (window, dtype, others)
                if solo is None:
                    solo = got[0]
                assert torch.equal(got[0], solo), (window, dtype, others)


def test_paged_attention_long_sequence_does_not_depend_on_the_batch(dev):
    """gemma2-9b's 4,201-token context (33 splits, 32 under the window)
    gives the same bits alone as beside 1 and 3 other sequences of other
    lengths, whose page tables are wider and whose split counts differ."""
    kw = dict(scale=224.0 ** -0.5, softcap=50.0)
    for window in (4096, None):
        for dtype in (torch.bfloat16, torch.float32):
            solo = None
            for others in ([], [25], [4500, 1, 300]):
                sl = [4201] + others
                args = _paged_inputs(11, len(sl), 16, 8, 256, 16, sl, dtype,
                                     pad_cols=len(others))
                q, kp, vp, pt, lens = args
                # the long row's q, pages and page list are the same in
                # every batch: rebuild them from the solo call's seed
                ref = _paged_inputs(11, 1, 16, 8, 256, 16, [4201], dtype)
                q[0] = ref[0][0]
                n = -(-4201 // 16)
                kp[pt[0, :n].long()] = ref[1][ref[3][0, :n].long()]
                vp[pt[0, :n].long()] = ref[2][ref[3][0, :n].long()]
                got = pa.paged_attention(q, kp, vp, pt, lens, window=window,
                                         **kw)[0]
                if solo is None:
                    solo = got
                assert torch.equal(got, solo), (window, dtype, others)


def test_paged_attention_kernel_splits_match_the_host_rule(dev):
    """The kernel's live range and split count (live_range) give the
    bounds split_bounds computes on the host, for which the CPU tests
    hold the cover and batch properties."""
    lens = [0, 1, 15, 16, 17, 25, 63, 64, 65, 127, 128, 129, 208, 4096,
            4097, 4201, 4500]
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    for L in (64, 128):
        for window in (None, 1, 17, 64, 4096):
            for cap in (64 * 16, 300 * 16):
                got = pa.kernel_split_bounds(sl, window, L, cap)
                want = [pa.split_bounds(n, window, L, cap) for n in lens]
                assert got == want, (L, window, cap)


def test_paged_attention_is_deterministic(dev):
    """Two identical calls give equal bits, with one split (qwen2.5-3b's
    decode) and with many (gemma2-9b's)."""
    for (B, H, KV, hd, sl, kw) in [
            (4, 16, 2, 128, [38, 65, 101, 130], {}),
            (2, 16, 8, 256, [4201, 25], dict(window=4096, softcap=50.0))]:
        for dtype in (torch.bfloat16, torch.float32):
            args = _paged_inputs(5, B, H, KV, hd, 16, sl, dtype)
            a = pa.paged_attention(*args, **kw)
            b = pa.paged_attention(*args, **kw)
            assert torch.equal(a, b), (hd, dtype)


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


def test_paged_decode_on_the_card(dev, tmp_path):
    """Continuous batching through the kernel equals solo in-memory decode
    (float32), and every decode step launched it once per layer."""
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (8, 13, 5, 30)]
    max_new = [2, 6, 3, 5]
    solo_eng = ServingEngine(model, params, max_len=64, device=dev)
    want = []
    for p, n in zip(prompts, max_new):
        r = Request(0, list(p), max_new_tokens=n)
        solo_eng.generate([r])
        want.append(r.output)
    sm = SwappedModel(model, params, str(tmp_path), budget=None)
    try:
        sm.partition(8 * 1024 * 1024, DelayModel(), 1, 16)
        kv = PagedKVCache(cfg, sm.engine.ledger, page_tokens=4, max_pages=12)
        be = BatchDecodeEngine(sm, kv, max_batch=2)
        reqs = [Request(i, list(p), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
        for r in reqs:
            be.submit(r)
        pa.launches.reset()
        be.run_all()
    finally:
        sm.close()
    assert [r.output for r in reqs] == want
    steps = sum(1 for t in be.trace if t.batch)
    assert pa.launches.count == cfg.n_layers * steps > 0
    assert kv.pages_in_use == 0


def _wkv_inputs(BH, S, hd, dtype, seed, state=False):
    """r, k, v, u, and log decays drawn over the whole clamp range
    [-5, -1e-4] (row 0 held at -5: the e^80 corner), on the card."""
    rng = np.random.default_rng(seed)
    r, k, v = rng.standard_normal((3, BH, S, hd)) * 0.5
    w = rng.uniform(-5.0, -1e-4, (BH, S, hd))
    w[0] = -5.0
    u = rng.standard_normal((BH, hd)) * 0.1
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype).cuda()  # noqa: E731
    s0 = (torch.from_numpy(rng.standard_normal((BH, hd, hd)).astype(
        np.float32) * 0.3).cuda() if state else None)
    return to(r), to(k), to(v), to(w), to(u), s0


WKV_CASES = [(80, 512, 64), (80, 16, 64), (3, 48, 32), (4, 5, 32),
             (5, 48, 64), (3, 512, 32), (7, 16, 32)]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain(dev, dtype, state):
    for i, (BH, S, hd) in enumerate(WKV_CASES):
        args = _wkv_inputs(BH, S, hd, dtype, seed=i, state=state)
        before = kw.launches.count
        y, s_fin = kw.wkv6(*args)
        assert kw.launches.count == before + 1
        assert kw.launches.by_shape[(BH, S, hd, str(dtype)[6:], state)] >= 1
        y_p, s_p = kw.wkv6_plain(*args)
        torch.cuda.synchronize()
        assert y.dtype == dtype and s_fin.dtype == torch.float32
        assert bool(torch.isfinite(y).all() and torch.isfinite(s_fin).all())
        assert _rel(y, y_p) <= TOL[dtype], (BH, S, hd)
        assert _rel(s_fin, s_p) <= TOL[torch.float32], (BH, S, hd)


def test_wkv6_cuda_tensor_never_runs_plain(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(kw, "wkv6_plain", refuse)
    r, k, v, w, u, _ = _wkv_inputs(2, 32, 64, torch.float32, seed=9)
    kw.wkv6(r, k, v, w, u)
    with pytest.raises(ValueError, match="chunks of 16"):
        kw.wkv6(r[:, :20].contiguous(), k[:, :20].contiguous(),
                v[:, :20].contiguous(), w[:, :20].contiguous(), u)
    with pytest.raises(TypeError):
        kw.wkv6(r.half(), k.half(), v.half(), w.half(), u.half())
    with pytest.raises(ValueError, match="contiguous"):
        kw.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError):                      # head_dim 16
        kw.wkv6(*(t[..., :16].contiguous() for t in (r, k, v, w, u)))
    with pytest.raises(ValueError, match="groups"):      # 64 / 16 < 8
        kw._wkv6(r, k, v, w, u, None, 16)


def _wkv_splits(hd):
    return [G for G in kw.GROUPS if hd % (G * kw.CONSUMER_COLUMNS) == 0]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_rows_do_not_depend_on_bh(dev, dtype, state):
    """Rows of a BH 80 call (one column split) equal the same rows run as
    a 3-row call (another split), bitwise: no row reads another, and a
    column's arithmetic does not depend on the split."""
    args = _wkv_inputs(80, 512, 64, dtype, seed=11, state=state)
    y, s_fin = kw.wkv6(*args)
    for rows in (slice(0, 3), slice(40, 43), slice(77, 80)):
        sub = [None if t is None else t[rows].contiguous() for t in args]
        y3, s3 = kw.wkv6(*sub)
        assert torch.equal(y3, y[rows]) and torch.equal(s3, s_fin[rows])


@pytest.mark.parametrize("S", [16, 48, 512])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_column_splits_agree_bitwise(dev, dtype, hd, S):
    """Every column split the kernel takes at this head_dim gives the
    planned launch's y and state bitwise, and a repeated call the same
    bits; each is within the tolerance of the plain version."""
    args = _wkv_inputs(6, S, hd, dtype, seed=12, state=True)
    y, s_fin = kw.wkv6(*args)
    y_p, s_p = kw.wkv6_plain(*args)
    assert _rel(y, y_p) <= TOL[dtype] and _rel(s_fin, s_p) <= 1e-5
    for G in _wkv_splits(hd) + [None]:
        yg, sg = kw._wkv6(*args, G)
        assert torch.equal(yg, y) and torch.equal(sg, s_fin), G


@pytest.mark.parametrize("S,cut", [(512, 256), (48, 32), (32, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_state_carried_across_two_calls(dev, dtype, S, cut):
    """S run as [0, cut) then [cut, S), the state of the first call handed
    to the second, equals one call bitwise: both cut at multiples of 16,
    so every chunk runs the same arithmetic."""
    r, k, v, w, u, s0 = _wkv_inputs(3, S, 64, dtype, seed=13, state=True)
    y, s_fin = kw.wkv6(r, k, v, w, u, s0)
    head = [t[:, :cut].contiguous() for t in (r, k, v, w)]
    tail = [t[:, cut:].contiguous() for t in (r, k, v, w)]
    y1, s1 = kw.wkv6(*head, u, s0)
    y2, s2 = kw.wkv6(*tail, u, s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(s2, s_fin)


def test_rwkv6_swapped_on_the_card(dev, tmp_path):
    """The rwkv6 path on the card: B6 once per layer per prefill, swapped
    equal to unswapped bitwise, and decode_loop's tokens equal to the
    in-memory engine's."""
    cfg = dataclasses.replace(get_arch("rwkv6-3b").reduced(),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": torch.from_numpy(prompts.astype(np.int32))}
    sm = SwappedModel(model, params, str(tmp_path), store_backend="quant")
    try:
        assert sm.store_backend == "mmap"
        sm.partition(8 * 1024 * 1024, DelayModel(), 2, 16)
        kw.launches.reset()
        logits, _ = sm.forward(batch)
        assert kw.launches.count == cfg.n_layers
        assert torch.equal(logits, sm.forward_unswapped(batch))
        gen, _ = sm.decode_loop(batch["tokens"], max_new_tokens=4, max_len=32)
    finally:
        sm.close()
    eng = ServingEngine(model, params, max_len=32, device=dev)
    reqs = [Request(i, list(map(int, p)), max_new_tokens=4)
            for i, p in enumerate(prompts)]
    eng.generate(reqs)
    assert [r.output for r in reqs] == gen.tolist()


# (M, K, N): ragged in every extent, qwen2.5-3b's prefill and decode
# shapes, one row, and a gemma2-9b MLP width at a few rows
SL_CASES = [(3, 129, 67), (512, 2048, 256), (2, 2048, 11008), (1, 7, 3),
            (130, 200, 150), (5, 3584, 14336)]


@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swap_linear_kernel_matches_plain(dev, dtype, act):
    for i, (M, K, N) in enumerate(SL_CASES):
        g = torch.Generator().manual_seed(i)
        x = (torch.randn((M, K), generator=g) * 0.5).to(dtype).to(dev)
        w = (torch.randn((K, N), generator=g) * K ** -0.5).to(dtype).to(dev)
        b = (torch.randn((N,), generator=g) * 0.1).to(dtype).to(dev)
        for bias in (b, None):
            before = sl.launches.count
            got = sl.swap_linear(x, w, bias, act=act)
            assert sl.launches.count == before + 1
            want = sl.swap_linear_plain(x, w, bias, act=act)
            torch.cuda.synchronize()
            assert got.dtype == dtype and tuple(got.shape) == (M, N)
            assert bool(torch.isfinite(got).all())
            assert _rel(got, want) <= TOL[dtype], (M, K, N, bias is None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swap_linear_rows_do_not_depend_on_m(dev, dtype):
    """Row i of an M-row call equals the 1-row call on that row bitwise:
    paged batched decode (M = batch) reproduces solo runs (M = 1)."""
    g = torch.Generator().manual_seed(3)
    K, N = 2048, 256
    w = (torch.randn((K, N), generator=g) * K ** -0.5).to(dtype).to(dev)
    b = (torch.randn((N,), generator=g) * 0.1).to(dtype).to(dev)
    x = (torch.randn((130, K), generator=g)).to(dtype).to(dev)
    for M in (2, 3, 4, 8, 65, 130):
        full = sl.swap_linear(x[:M].contiguous(), w, b, act="silu")
        for i in range(M):
            one = sl.swap_linear(x[i:i + 1].contiguous(), w, b, act="silu")
            assert torch.equal(full[i:i + 1], one), (M, i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_swap_linear_q_rows_do_not_depend_on_m(dev, bits, dtype):
    """B1 keeps B5's contract: row i of an M-row call equals the 1-row call
    on that row bitwise, at int8 and int4 (Run B decodes at M 1-4 on int8
    lazy). K = 2048 splits 8 ways at N = 256."""
    q, s = _weights(bits, 2048, 256, seed=bits)
    q, s = q.to(dev), s.to(dev)
    g = torch.Generator().manual_seed(4)
    b = (torch.randn((256,), generator=g) * 0.1).to(dtype).to(dev)
    x = torch.randn((130, 2048), generator=g).to(dtype).to(dev)
    for M in (2, 3, 4, 8, 65, 130):
        full = slq.swap_linear_q(x[:M].contiguous(), q, s, b, bits=bits,
                                 act="silu")
        for i in range(M):
            one = slq.swap_linear_q(x[i:i + 1].contiguous(), q, s, b,
                                    bits=bits, act="silu")
            assert torch.equal(full[i:i + 1], one), (M, i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_match_across_split_combines(dev, dtype):
    """At N = K = 2048 (8 splits) a 1-row call sums the splits over fp32
    scratch in the last block of each output tile ("blocks"), an 1100-row
    call inside each block ("serial"): the rows still equal their 1-row
    calls bitwise."""
    K = N = 2048
    g = torch.Generator().manual_seed(6)
    w = (torch.randn((K, N), generator=g) * K ** -0.5).to(dtype).to(dev)
    b = (torch.randn((N,), generator=g) * 0.1).to(dtype).to(dev)
    x = torch.randn((1100, K), generator=g).to(dtype).to(dev)
    q, s = _weights(8, K, N, seed=6)
    q, s = q.to(dev), s.to(dev)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert gemm_plan.plan(1100, N, K, name, "int8").combine == "serial"
    assert gemm_plan.plan(1, N, K, name, "int8").combine == "blocks"
    full = sl.swap_linear(x, w, b, act="gelu")
    fq = slq.swap_linear_q(x, q, s, b, bits=8, act="gelu")
    for i in (0, 1, 127, 128, 555, 1099):
        row = x[i:i + 1].contiguous()
        assert torch.equal(full[i:i + 1], sl.swap_linear(row, w, b,
                                                         act="gelu")), i
        assert torch.equal(fq[i:i + 1], slq.swap_linear_q(
            row, q, s, b, bits=8, act="gelu")), i


# qwen2.5-3b's linears at decode (M = 2): in bf16 every (K, N) with N =
# 2048 splits K 8 ways, the d_ff one not at all; the fp32 TF32 core sizes
# its splits for two blocks an SM: 8, 8, 3 and 16 ways
QWEN_DECODE = [(2, 2048, 2048), (2, 2048, 256), (2, 2048, 11008),
               (2, 11008, 2048), (4, 2048, 151936)]
QWEN_DECODE_SPLITS = {torch.bfloat16: (8, 8, 1, 8), torch.float32: (8, 8, 3, 16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_shapes_and_splits_match_plain(dev, dtype):
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    for i, (M, K, N) in enumerate(QWEN_DECODE):
        g = torch.Generator().manual_seed(20 + i)
        x = torch.randn((M, K), generator=g).to(dtype).to(dev)
        b = (torch.randn((N,), generator=g) * 0.1).to(dtype).to(dev)
        for bits in (8, 4):
            q, s = _weights(bits, K, N, seed=i)
            q, s = q.to(dev), s.to(dev)
            got = slq.swap_linear_q(x, q, s, b, bits=bits, act="silu")
            want = slq.swap_linear_q_plain(x, q, s, b, bits=bits, act="silu")
            assert _rel(got, want) <= TOL[dtype], (M, K, N, bits)
        if N == 151936:
            continue
        w = (torch.randn((K, N), generator=g) * K ** -0.5).to(dtype).to(dev)
        assert gemm_plan.plan(M, N, K, name, "bf16" if dtype ==
                              torch.bfloat16 else "fp32").splits == (
            QWEN_DECODE_SPLITS[dtype][i])
        got = sl.swap_linear(x, w, b, act="none")
        assert _rel(got, sl.swap_linear_plain(x, w, b)) <= TOL[dtype], (M, K, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_view_equals_aligned_copy(dev, dtype):
    """x at data_ptr() % 16 != 0 takes the plain-load route into the same
    tiles and the same arithmetic: its output equals the aligned copy's
    (TMA or cp.async) bitwise, for B5 and B1."""
    M, K, N = 130, 512, 256
    g = torch.Generator().manual_seed(7)
    buf = torch.randn((M * K + 8,), generator=g).to(dtype).to(dev)
    xv = buf[1:1 + M * K].view(M, K)
    xa = xv.clone()
    assert xv.data_ptr() % 16 != 0 and xa.data_ptr() % 16 == 0
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    weight = "bf16" if dtype == torch.bfloat16 else "fp32"
    w = (torch.randn((K, N), generator=g) * 0.05).to(dtype).to(dev)
    assert gemm_plan.plan(M, N, K, name, weight, xv.data_ptr(),
                          w.data_ptr()).route == "plain"
    assert gemm_plan.plan(M, N, K, name, weight, xa.data_ptr(),
                          w.data_ptr()).route != "plain"
    b = (torch.randn((N,), generator=g) * 0.1).to(dtype).to(dev)
    assert torch.equal(sl.swap_linear(xv, w, b, act="silu"),
                       sl.swap_linear(xa, w, b, act="silu"))
    for bits in (8, 4):
        q, s = _weights(bits, K, N, seed=bits)
        q, s = q.to(dev), s.to(dev)
        assert torch.equal(slq.swap_linear_q(xv, q, s, b, bits=bits),
                           slq.swap_linear_q(xa, q, s, b, bits=bits))


def test_bias_is_read_in_its_own_dtype(dev):
    """A bf16 bias is read as it is (no cast launched before the kernel),
    an fp32 one too: the same values in either dtype give the same bits."""
    g = torch.Generator().manual_seed(9)
    M, K, N = 3, 256, 160
    x = torch.randn((M, K), generator=g).bfloat16().to(dev)
    w = (torch.randn((K, N), generator=g) * 0.05).bfloat16().to(dev)
    b16 = (torch.randn((N,), generator=g) * 0.1).bfloat16().to(dev)
    b32 = b16.float()
    assert torch.equal(sl.swap_linear(x, w, b16, act="gelu"),
                       sl.swap_linear(x, w, b32, act="gelu"))
    q, s = _weights(8, K, N, seed=9)
    q, s = q.to(dev), s.to(dev)
    assert torch.equal(slq.swap_linear_q(x, q, s, b16, act="silu"),
                       slq.swap_linear_q(x, q, s, b32, act="silu"))


def _one_hot(M, K, dtype, dev):
    ks = [(7 * m + 3) % K for m in range(M)]
    x = torch.zeros((M, K), dtype=dtype, device=dev)
    x[torch.arange(M), torch.tensor(ks)] = 1
    return x, ks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_distinct_weights_land_where_they_belong(dev, dtype):
    """A weight with a distinct value at every (k, n) (distinct bf16 bit
    patterns; distinct integers in fp32) against one-hot rows of x: row m
    must return weight row k_m exactly, so a swizzle, transpose or tile
    offset fault cannot pass. K = 96 and N = 160 leave partial k- and
    n-tiles; the same against the plain version with random x."""
    K, N = 96, 160
    idx = torch.arange(K * N, dtype=torch.int32).reshape(K, N)
    if dtype == torch.bfloat16:
        w = (idx + 0x3C00).to(torch.int16).view(torch.bfloat16).to(dev)
    else:
        w = (idx + 1).to(torch.float32).to(dev)
    assert torch.unique(w.float()).numel() == K * N
    for M in (1, 2, 9, 130):
        x, ks = _one_hot(M, K, dtype, dev)
        assert torch.equal(sl.swap_linear(x, w), w[ks]), M
    vals = ((idx * 37 + 11) % 255 - 127).to(torch.int8)
    for bits, v in ((8, vals), (4, (idx * 37 + 11) % 15 - 7)):
        v = v.to(torch.int8)
        q = v if bits == 8 else torch.from_numpy(dq.pack_int4(v.numpy()))
        q, s = q.to(dev), torch.ones((N,), device=dev)
        for M in (1, 3, 130):
            x, ks = _one_hot(M, K, dtype, dev)
            got = slq.swap_linear_q(x, q, s, bits=bits)
            assert torch.equal(got.float(), v[ks].float().to(dev)), (bits, M)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((5, K), generator=g).to(dtype).to(dev)
    wr = (torch.randn((K, N), generator=g) * 0.1).to(dtype).to(dev)
    assert _rel(sl.swap_linear(x, wr), sl.swap_linear_plain(x, wr)) <= TOL[dtype]


def test_swap_linear_cuda_tensor_never_runs_plain(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(sl, "swap_linear_plain", refuse)
    x = torch.randn((8, 64), device=dev)
    w = torch.randn((64, 32), device=dev)
    sl.swap_linear(x, w, act="gelu")
    with pytest.raises(TypeError):
        sl.swap_linear(x.half(), w.half())
    with pytest.raises(TypeError):
        sl.swap_linear(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        sl.swap_linear(torch.randn((8, 128), device=dev)[:, ::2], w)
    with pytest.raises(ValueError, match="devices"):
        sl.swap_linear(x, w.cpu())


def _fa_inputs(B, S, H, KV, hd, dtype, seed, shuffled=False, dv=None):
    """q, k at head dim hd, v at dv (None: hd), and positions."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((rng.standard_normal((B, S, n, d)) * 0.5)
                                .astype(np.float32)).to(dtype).to("cuda")
               for n, d in ((H, hd), (KV, hd), (KV, dv or hd)))
    pos = (np.stack([rng.permutation(S) for _ in range(B)]) if shuffled
           else np.broadcast_to(np.arange(S), (B, S)))
    return q, k, v, torch.from_numpy(np.array(pos)).to("cuda")


# (B, S, H, KV, hd, scale, shuffled positions): the reference test's S,
# the port's ragged prompts, qwen2.5-3b's prefill, gemma2-9b's heads at
# its query scale, odd head dims, GQA 8 and 1, explicit positions
FA_CASES = [(1, 256, 4, 2, 64, None, False), (2, 37, 4, 2, 80, None, False),
            (4, 128, 16, 2, 128, None, False),
            (1, 300, 16, 8, 256, 224.0 ** -0.5, False),
            (1, 100, 8, 1, 120, None, False), (2, 129, 4, 4, 64, None, True),
            (3, 17, 8, 8, 32, None, False), (2, 130, 8, 8, 112, None, False),
            (2, 1500, 16, 16, 80, None, False)]


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 7, None), (True, None, 50.0),
    (False, None, None), (True, 64, 30.0), (True, 200, 50.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, dtype, causal, window,
                                              softcap):
    for i, (B, S, H, KV, hd, scale, shuffled) in enumerate(FA_CASES):
        q, k, v, pos = _fa_inputs(B, S, H, KV, hd, dtype, i, shuffled)
        kw = dict(scale=hd ** -0.5 if scale is None else scale,
                  causal=causal, window=window, softcap=softcap)
        before = fa.launches.count
        got = fa.flash_attention(q, k, v, pos, **kw)
        assert fa.launches.count == before + 1
        want = fa.flash_attention_plain(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= TOL[dtype], (B, S, H, KV, hd)


def test_flash_attention_cuda_tensor_never_runs_plain(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    q, k, v, pos = _fa_inputs(1, 40, 4, 2, 64, torch.float32, 0)
    fa.flash_attention(q, k, v, pos, scale=0.125, window=16)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half(), pos, scale=0.125)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v, pos, scale=0.125)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, v, pos.float(), scale=0.125)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, pos, scale=0.125)
    with pytest.raises(ValueError, match="devices"):
        fa.flash_attention(q, k, v, pos.cpu(), scale=0.125)
    big = torch.zeros((1, 4, 2, 320), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(big, big, big, pos[:, :4], scale=0.1)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 7, None), (True, None, 50.0),
    (False, None, None), (True, 64, 30.0), (True, 200, 50.0)])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_tensor_cores_at_ragged_s(dev, hd, causal, window,
                                                  softcap):
    """The bf16 tensor-core kernel at S around its 64-key and 128-row tiles
    and at gemma2-9b's 4,200 tokens: keys past S are masked, rows past S
    are not written, and no box reads the next batch row."""
    assert fa.path(torch.bfloat16, hd) == "tc"
    for i, S in enumerate((1, 2, 63, 64, 65, 127, 128, 129, 4200)):
        B = 2 if S < 4200 else 1
        q, k, v, pos = _fa_inputs(B, S, 4, 2, hd, torch.bfloat16, 40 + i)
        kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                  softcap=softcap)
        got = fa.flash_attention(q, k, v, pos, **kw)
        want = fa.flash_attention_plain(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), S
        assert _rel(got, want) <= TOL[torch.bfloat16], (S, hd)


# (S, H, KV, hd, dtype, causal): both kernels at the main paths' head
# dims, hubert's bidirectional encoder (hd 80, no mask) among them
FA_BITWISE = [(200, 16, 2, 128, torch.bfloat16, True),
              (130, 16, 8, 256, torch.bfloat16, True),
              (200, 16, 2, 128, torch.float32, True),
              (300, 32, 8, 120, torch.float32, True),
              (256, 48, 1, 128, torch.float32, True),
              (130, 8, 8, 64, torch.float32, False),
              (37, 4, 2, 80, torch.bfloat16, True),
              (200, 32, 32, 112, torch.bfloat16, True),
              (1500, 16, 16, 80, torch.bfloat16, False),
              (300, 32, 8, 120, torch.bfloat16, True)]


@pytest.mark.parametrize("S,H,KV,hd,dtype,causal", FA_BITWISE)
def test_flash_attention_rows_do_not_depend_on_the_batch(dev, S, H, KV, hd,
                                                         dtype, causal):
    """Row b of a 4-row call equals the 1-row call on that row bitwise,
    and two identical calls give equal bits (no split over keys, no
    atomics)."""
    q, k, v, pos = _fa_inputs(4, S, H, KV, hd, dtype, 7)
    kw = dict(scale=hd ** -0.5, causal=causal,
              window=64 if causal else None, softcap=50.0)
    full = fa.flash_attention(q, k, v, pos, **kw)
    assert torch.equal(full, fa.flash_attention(q, k, v, pos, **kw))
    for b in range(4):
        one = fa.flash_attention(q[b:b + 1].contiguous(),
                                 k[b:b + 1].contiguous(),
                                 v[b:b + 1].contiguous(), pos[b:b + 1], **kw)
        assert torch.equal(full[b:b + 1], one), (b, fa.path(dtype, hd))


def test_flash_attention_non_causal_window_raises_on_the_card(dev):
    """The kernel path refuses a window on a non-causal call, as the plain
    path does; LARGE_WINDOW and None run."""
    for dtype, hd in ((torch.bfloat16, 128), (torch.float32, 64)):
        q, k, v, pos = _fa_inputs(1, 40, 4, 2, hd, dtype, 1)
        with pytest.raises(ValueError, match="non-causal"):
            fa.flash_attention(q, k, v, pos, scale=0.1, causal=False,
                               window=16)
        a = fa.flash_attention(q, k, v, pos, scale=0.1, causal=False)
        b = fa.flash_attention(q, k, v, pos, scale=0.1, causal=False,
                               window=fa.LARGE_WINDOW)
        assert torch.equal(a, b)


# (B, S, H, KV, chunk, shuffled positions): S across 1, 2 and 3 chunk
# boundaries, llama4's 40 / 8 heads, a chunk that is no multiple of the
# kernels' 64-key tiles, and permuted positions
FA_CHUNK_CASES = [(2, 100, 8, 2, 64, False), (1, 300, 40, 8, 128, False),
                  (2, 200, 4, 2, 64, False), (1, 1100, 8, 2, 500, False),
                  (2, 129, 4, 4, 32, True)]


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_chunk_matches_plain(dev, dtype, hd, window):
    """Block-local (iRoPE) masking on both kernels: the launch carries the
    chunk and matches the plain version; a chunk of S or more gives the
    bits of no chunk."""
    for i, (B, S, H, KV, chunk, shuffled) in enumerate(FA_CHUNK_CASES):
        q, k, v, pos = _fa_inputs(B, S, H, KV, hd, dtype, 60 + i, shuffled)
        kw = dict(scale=hd ** -0.5, window=window)
        fa.launches.reset()
        got = fa.flash_attention(q, k, v, pos, chunk=chunk, **kw)
        assert list(fa.launches.by_shape)[0][10] == chunk
        want = fa.flash_attention_plain(q, k, v, pos, chunk=chunk, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), (S, chunk)
        assert _rel(got, want) <= TOL[dtype], (B, S, H, KV, chunk)
        assert torch.equal(fa.flash_attention(q, k, v, pos, chunk=S, **kw),
                           fa.flash_attention(q, k, v, pos, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_chunk_rows_do_not_depend_on_the_batch(dev, dtype):
    """With a chunk: row b of a 4-row call equals the 1-row call on that
    row bitwise, and two identical calls give equal bits."""
    q, k, v, pos = _fa_inputs(4, 300, 40, 8, 128, dtype, 9)
    kw = dict(scale=128 ** -0.5, chunk=128)
    full = fa.flash_attention(q, k, v, pos, **kw)
    assert torch.equal(full, fa.flash_attention(q, k, v, pos, **kw))
    for b in range(4):
        one = fa.flash_attention(q[b:b + 1].contiguous(),
                                 k[b:b + 1].contiguous(),
                                 v[b:b + 1].contiguous(), pos[b:b + 1], **kw)
        assert torch.equal(full[b:b + 1], one), b


def test_gemma_prefill_on_the_card(dev, tmp_path):
    """Reduced gemma2-9b (window 24, shorter than the prompt) swapped on
    mmap on the card: bitwise equal to the unswapped forward, every layer's
    prefill through flash_attention (window 24 on layer 0, none on layer
    1) and every linear through swap_linear."""
    cfg = dataclasses.replace(get_arch("gemma2-9b").reduced(),
                              dtype="float32", sliding_window=24)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 45))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    sm = SwappedModel(model, params, str(tmp_path))
    try:
        sm.partition(6 * 1024 * 1024, DelayModel(), 2, 45)
        fa.launches.reset()
        sl.launches.reset()
        logits, _ = sm.forward(batch)
        assert fa.launches.count == cfg.n_layers
        assert sorted(k[8] or 0 for k in fa.launches.by_shape) == [0, 24]
        assert sl.launches.count == 7 * cfg.n_layers
        assert torch.equal(logits, sm.forward_unswapped(batch))
    finally:
        sm.close()
    assert bool(torch.isfinite(logits).all())


def test_llama4_prefill_on_the_card(dev, tmp_path):
    """Reduced llama4-scout (4 layers, attn_chunk 8, a 20-token prompt)
    swapped on mmap on the card: bitwise equal to the unswapped forward,
    flash_attention at chunk 8 on the local layers 0-2 and without one on
    the global layer 3, swap_linear 7 times a layer (q, k, v, o and the
    shared expert's three; the routed experts and the router are batched
    library matmuls, as the reference leaves them to XLA)."""
    cfg = dataclasses.replace(get_arch("llama4-scout-17b-a16e").reduced(),
                              n_layers=4, dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    sm = SwappedModel(model, params, str(tmp_path))
    try:
        sm.partition(8 * 1024 * 1024, DelayModel(), 2, 20)
        fa.launches.reset()
        sl.launches.reset()
        logits, _ = sm.forward(batch)
        assert sorted(k[10] or 0 for k, n in fa.launches.by_shape.items()
                      for _ in range(n)) == [0, 8, 8, 8]
        assert sl.launches.count == 7 * cfg.n_layers
        assert torch.equal(logits, sm.forward_unswapped(batch))
    finally:
        sm.close()
    assert bool(torch.isfinite(logits).all())


def _reduced_qwen():
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    return model, params, {"tokens": torch.from_numpy(tokens.astype(np.int32))}


def test_directio_reads_equal_mmap_on_the_card(dev, tmp_path):
    """Every unit through the directio store lands on the card bitwise the
    mmap store's, on the O_DIRECT path or the buffered one."""
    from repro_torch.store import build_store
    from repro_torch.tree import tree_leaves
    model, params, _ = _reduced_qwen()
    from repro_torch.core.runtime import split_units
    units = [(u.name, u.params) for u in split_units(model, params)]
    mm = build_store(units, str(tmp_path / "m"), backend="mmap")
    dio = build_store(units, str(tmp_path / "d"), backend="directio")
    try:
        for name in mm.order:
            a = tree_leaves(mm.read_unit(name).params)
            b = tree_leaves(dio.read_unit(name).params)
            assert all(x.is_cuda and torch.equal(x, y) for x, y in zip(a, b))
    finally:
        dio.close()


def test_faulty_retry_equals_clean_read_on_the_card(dev, tmp_path):
    """io, corrupt and torn faults scripted into a swapped pass on the
    card: every read succeeds on retry and the logits equal the
    unswapped forward bitwise."""
    model, params, batch = _reduced_qwen()
    sm = SwappedModel(model, params, str(tmp_path), store_backend="faulty",
                      store_options={"inner": "directio", "p": 0.0})
    try:
        sm.engine.retry_backoff_s = 0.001
        sm.partition(8 << 20, DelayModel(), 2, 32)
        sm.store.force("io", "corrupt", None, "torn")
        logits, st = sm.forward(batch)
        assert st["retries"] == 3
        assert torch.equal(logits, sm.forward_unswapped(batch))
    finally:
        sm.close()


@pytest.mark.parametrize("mode,gpu_dispatch,k", [("copy_in", True, 3),
                                                 ("dummy_asm", False, 2)])
def test_ablation_arms_equal_snet_on_the_card(dev, tmp_path, mode,
                                              gpu_dispatch, k):
    model, params, batch = _reduced_qwen()
    out = {}
    for arm in ("snet", mode):
        sm = SwappedModel(model, params, str(tmp_path / arm),
                          prefetch_depth=1, mode=arm,
                          gpu_dispatch=gpu_dispatch)
        try:
            sm.set_plan((1, 3))
            out[arm], _ = sm.forward(batch)
            blocks = [sum(sm.store.nbytes(n) for n in sm.store.order[lo:hi])
                      for lo, hi in sm.plan.blocks()]
            assert sm.engine.stats.peak_resident == \
                (1 if arm == "snet" else k) * max(blocks)
        finally:
            sm.close()
    assert torch.equal(out["snet"], out[mode])



def test_calibration_repeats_and_mixed_pass_is_bitwise_on_the_card(dev,
                                                                   tmp_path):
    """calibrate_model on a small bf16 qwen on the card twice: the same
    plan JSON byte for byte (every pass bitwise repeatable); then its mixed
    store's swapped pass equals the pass repeated, bitwise."""
    from repro_torch.calibrate import calibrate_model, calibration_batch
    cfg = get_arch("qwen2.5-3b").reduced()
    assert cfg.dtype == "bfloat16"
    model = Model(cfg)
    params = model.init(0, device="cpu")
    runs = [calibrate_model(model, params, fidelity=2e-2,
                            workdir=str(tmp_path)) for _ in range(2)]
    assert runs[0][0].to_json() == runs[1][0].to_json()
    assert runs[0][1].to_json() == runs[1][1].to_json()
    plan = runs[0][1]
    sm = SwappedModel(model, params, str(tmp_path / "mixed"),
                      store_backend="quant", precision="mixed",
                      store_options={"plan": plan})
    try:
        sm.set_plan(tuple(range(1, len(sm.units))))
        batch = calibration_batch(cfg, seed=1)
        first, st = sm.forward(batch)
        again, _ = sm.forward(batch)
        assert first.is_cuda and bool(torch.isfinite(first).all())
        assert torch.equal(first, again)
        assert sum(st["bytes_by_precision"].values()) == st["bytes_swapped"]
    finally:
        sm.close()


# ------------------------------------------------------ the conv workloads
# the linears of the conv workloads' path: vgg_sim's three fc layers and
# resnet_sim's head at batch 4, and the 12 x 1280 fc stack at batch 64
CONV_PATH_LINEARS = [(4, 256, 4096), (4, 4096, 1024), (4, 1024, 100),
                     (4, 256, 100), (64, 1280, 1280)]
# vgg_sim's quantized leaves as dequant sees them: HWIO conv weights as
# (k * k * cin) x cout, then the fc weights
CONV_PATH_DEQUANT = [(288, 64), (576, 128), (1152, 128), (1152, 256),
                     (2304, 256), (256, 4096), (4096, 1024), (1024, 100)]


@pytest.mark.parametrize("M,K,N", CONV_PATH_LINEARS)
@pytest.mark.parametrize("bits", [0, 8, 4], ids=["fp32", "int8", "int4"])
def test_conv_path_linears_match_plain(dev, bits, M, K, N):
    """swap_linear (bits 0) and swap_linear_q at the conv workloads'
    shapes, fp32 x with a bias: 1e-5 of the plain version."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g).to(dev)
    b = (torch.randn((N,), generator=g) * 0.1).to(dev)
    if bits:
        q, s = _weights(bits, K, N, seed=K + N)
        q, s = q.to(dev), s.to(dev)
        got = slq.swap_linear_q(x, q, s, b, bits=bits)
        want = slq.swap_linear_q_plain(x, q, s, b, bits=bits)
    else:
        w = (torch.randn((K, N), generator=g) * K ** -0.5).to(dev)
        got = sl.swap_linear(x, w, b)
        want = sl.swap_linear_plain(x, w, b)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (M, N)
    assert _rel(got, want) <= TOL[torch.float32]


@pytest.mark.parametrize("R,C", CONV_PATH_DEQUANT)
@pytest.mark.parametrize("bits", [8, 4])
def test_conv_path_dequant_matches_plain(dev, bits, R, C):
    q, s = _weights(bits, R, C, seed=R + C)
    q, s = q.to(dev), s.to(dev)
    got = dq.dequant_int8(q, s, torch.float32, bits=bits, rows=R)
    assert torch.equal(got, dq.dequant_int8_plain(q, s, torch.float32,
                                                  bits=bits, rows=R))


@pytest.mark.parametrize("kind", ["mmap", "int8-fused", "int8-eager"])
def test_vgg_swapped_on_the_card(dev, tmp_path, kind):
    """vgg_sim through SwappedSequential at 4 x 32 x 32: mmap equals the
    in-memory forward bitwise; fused int8 streams its three fc weights
    through swap_linear_q, eager int8 widens its 8 quantized leaves with
    dequant_int8, both within 1e-4 of the round-tripped forward (they
    differ from it only in summation order)."""
    from repro_torch.core.runtime import SwappedSequential
    from repro_torch.models import vision
    from repro_torch.store.quantized_store import roundtrip
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _, layers, hw = vision.vgg_sim()
    g = torch.Generator().manual_seed(0)
    params = vision.init_convnet(layers, g)
    x = torch.randn((4, hw, hw, 3), generator=g).to(dev)
    opts = {"mmap": {},
            "int8-fused": dict(store_backend="quant", fused=True),
            "int8-eager": dict(store_backend="quant")}[kind]
    sw = SwappedSequential([(f"vgg{i:02d}", p) for i, p in enumerate(params)],
                           lambda i, p, xx: vision.apply_layer(layers[i], p,
                                                               xx),
                           str(tmp_path), budget=24 << 20, **opts)
    try:
        sw.set_plan((3, 7, 11, 12))
        slq.launches.reset()
        dq.launches.reset()
        out, st = sw.forward(x)
        ref_params = ([roundtrip(p, 8) for p in params] if opts
                      else params)
        want = vision.apply_convnet(
            layers, [{k: v.to(dev) for k, v in p.items()}
                     for p in ref_params], x)
        if kind == "mmap":
            assert torch.equal(out, want)
        else:
            assert _rel(out, want) <= 1e-4
        assert slq.launches.count == (3 if kind == "int8-fused" else 0)
        assert dq.launches.count == (8 if kind == "int8-eager" else 0)
    finally:
        sw.close()
    assert out.is_cuda and tuple(out.shape) == (4, 100)
    assert st["peak_resident_mb"] * 1e6 <= 24 << 20


# (B, S, H, KV, shuffled positions): MLA's (hd 192, dv 128) on the tensor
# cores at S around the 64-key and 128-row tiles and at phase 11's 4,096
FA_MLA_CASES = [(2, 1, 16, 16, False), (2, 63, 16, 16, False),
                (2, 64, 16, 16, False), (2, 65, 16, 16, False),
                (2, 300, 16, 16, False), (1, 4096, 16, 16, False),
                (2, 300, 16, 16, True), (2, 129, 8, 2, False)]


@pytest.mark.parametrize("B,S,H,KV,shuffled", FA_MLA_CASES)
def test_flash_attention_mla_pair_on_the_tensor_cores(dev, B, S, H, KV,
                                                      shuffled):
    """bf16 q, k at 192 and v at 128 take the tensor cores: the launch
    carries dv, the output is [B, S, H, 128] within 2e-2 of the plain
    version, and a repeated call gives the same bits."""
    assert fa.path(torch.bfloat16, 192, 128) == "tc"
    q, k, v, pos = _fa_inputs(B, S, H, KV, 192, torch.bfloat16, 80 + S,
                              shuffled, dv=128)
    kw = dict(scale=192 ** -0.5)
    fa.launches.reset()
    got = fa.flash_attention(q, k, v, pos, **kw)
    assert list(fa.launches.by_shape) == [
        (B, S, H, KV, 192, 128, "bfloat16", True, None, None, None, "tc")]
    want = fa.flash_attention_plain(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (B, S, H, 128)
    assert bool(torch.isfinite(got).all()), S
    assert _rel(got, want) <= TOL[torch.bfloat16], (B, S, H, KV)
    assert torch.equal(got, fa.flash_attention(q, k, v, pos, **kw))


# (B, S, H, KV, hd, dv, dtype): a value head dim of its own: MLA's pair
# in fp32, the reduced config's (48, 32) in both dtypes, GQA (KV < H), and
# dv above hd. MLA's fp32 pair and the bf16 (80, 256) take the CUDA cores;
# the bf16 (48, 32) rounds up to the tensor-core kernel's (64, 64), and
# the fp32 (48, 32) and (32, 64) to the TF32 kernel's
FA_DV_CASES = [(2, 129, 16, 16, 192, 128, torch.float32),
               (2, 37, 4, 4, 48, 32, torch.float32),
               (2, 37, 4, 4, 48, 32, torch.bfloat16),
               (1, 200, 8, 2, 192, 128, torch.float32),
               (2, 65, 4, 1, 32, 64, torch.float32),
               (1, 100, 8, 2, 80, 256, torch.bfloat16)]
FA_DV_TC = {(48, 32, torch.bfloat16)}
FA_DV_TF32 = {(48, 32, torch.float32), (32, 64, torch.float32)}


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 7, None), (False, None, None),
    (True, 64, 30.0)])
@pytest.mark.parametrize("B,S,H,KV,hd,dv,dtype", FA_DV_CASES)
def test_flash_attention_dv_on_the_cuda_cores(dev, B, S, H, KV, hd, dv,
                                              dtype, causal, window,
                                              softcap):
    assert fa.path(dtype, hd, dv) == (
        "tc" if (hd, dv, dtype) in FA_DV_TC
        else "tf32x3" if (hd, dv, dtype) in FA_DV_TF32 else "simt")
    q, k, v, pos = _fa_inputs(B, S, H, KV, hd, dtype, hd + dv, dv=dv)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)
    got = fa.flash_attention(q, k, v, pos, **kw)
    want = fa.flash_attention_plain(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (B, S, H, dv)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL[dtype], (B, S, H, KV, hd, dv)


# (hd, dv): the tensor cores at widths padded up to an instantiation:
# hubert's 80, zamba2's 112, h2o-danube's 120 (all to 128) and the reduced
# MLA's (48, 32) (to 64)
FA_PADDED = [(80, 80), (112, 112), (120, 120), (48, 32)]
# (causal, window, softcap, chunk): every mask the kernel takes
FA_PADDED_MASKS = [(True, None, None, None), (True, 7, None, None),
                   (True, None, 50.0, None), (True, None, None, 48),
                   (True, 20, 50.0, 64), (False, None, None, None)]


@pytest.mark.parametrize("causal,window,softcap,chunk", FA_PADDED_MASKS)
@pytest.mark.parametrize("hd,dv", FA_PADDED)
def test_flash_attention_padded_widths_on_the_tensor_cores(
        dev, hd, dv, causal, window, softcap, chunk):
    """bf16 at a pair that rounds up to an instantiation takes the tensor
    cores at S around the 64-key and 128-row tiles and at hubert's 1,500,
    GQA 4 / 2 heads, with the caller's scale: within 2e-2 of the plain
    version, the output [B, S, H, dv], and a repeated call equal."""
    assert fa.path(torch.bfloat16, hd, dv) == "tc"
    for i, S in enumerate((1, 2, 63, 64, 65, 127, 128, 129, 1500)):
        q, k, v, pos = _fa_inputs(2 if S < 1500 else 1, S, 4, 2, hd,
                                  torch.bfloat16, 90 + i, dv=dv)
        kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                  softcap=softcap, chunk=chunk)
        got = fa.flash_attention(q, k, v, pos, **kw)
        want = fa.flash_attention_plain(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        assert tuple(got.shape) == tuple(q.shape[:3]) + (dv,)
        assert bool(torch.isfinite(got).all()), S
        assert _rel(got, want) <= TOL[torch.bfloat16], (S, hd, dv)
        assert torch.equal(got, fa.flash_attention(q, k, v, pos, **kw))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,dv", FA_PADDED)
def test_flash_attention_padded_rows_do_not_depend_on_the_batch(dev, hd, dv,
                                                                causal):
    """At a padded pair: row b of a 4-row call equals the 1-row call on
    that row bitwise, and two identical calls give equal bits."""
    q, k, v, pos = _fa_inputs(4, 150, 8, 2, hd, torch.bfloat16, 13, dv=dv)
    kw = dict(scale=hd ** -0.5, causal=causal,
              window=64 if causal else None, softcap=50.0)
    full = fa.flash_attention(q, k, v, pos, **kw)
    assert torch.equal(full, fa.flash_attention(q, k, v, pos, **kw))
    for b in range(4):
        one = fa.flash_attention(q[b:b + 1].contiguous(),
                                 k[b:b + 1].contiguous(),
                                 v[b:b + 1].contiguous(), pos[b:b + 1], **kw)
        assert torch.equal(full[b:b + 1], one), (b, hd, dv)


FA_RULE = fa.path      # the rule itself, kept from the test's monkeypatch


def test_flash_attention_dispatch_takes_exactly_the_rule(dev, monkeypatch):
    """The tensor-core launch succeeds at every bf16 (hd, dv) that
    ``path`` sends to "tc" and is refused (a raised RuntimeError, never a
    fallback) at every other pair: the .cu dispatch and the Python rule
    accept the same pairs."""
    monkeypatch.setattr(fa, "path", lambda dtype, hd, dv=None: "tc")
    dims = sorted(set(range(8, 257, 8)) | {1, 12, 50, 100, 130, 250})
    for hd in dims:
        q, k, _, pos = _fa_inputs(1, 3, 2, 1, hd, torch.bfloat16, 0)
        for dv in dims:
            v = torch.ones((1, 3, 1, dv), dtype=torch.bfloat16, device=dev)
            try:
                fa.flash_attention(q, k, v, pos, scale=0.1)
                took = True
            except RuntimeError:
                took = False
            assert took == (FA_RULE(torch.bfloat16, hd, dv) == "tc"), (hd,
                                                                      dv)
    torch.cuda.synchronize()


# ------------------------------------------- the fp32 routes in TF32 x 3
# swap_linear's fp32 main-path shapes (M, K, N): h2o-danube's prefill
# (4,000 rows), admission (40), decode (3 and 1) at wq / wi0 / ffn wo,
# rwkv6's wo at 1,024 rows, qwen's run A decode, the conv fleets' fc
# layers (M 4) and fc stack (M 64)
TF32_LINEARS = [(4000, 3840, 3840), (4000, 3840, 10240), (4000, 10240, 3840),
                (40, 3840, 960), (3, 3840, 10240), (1, 3840, 10240),
                (1, 10240, 3840), (1024, 2560, 2560), (2, 2048, 11008),
                (4, 256, 4096), (4, 4096, 1024), (4, 1024, 100),
                (64, 1280, 1280)]


@pytest.mark.parametrize("M,K,N", TF32_LINEARS)
def test_swap_linear_fp32_takes_the_tf32_route(dev, M, K, N):
    """fp32 x and weight at the main paths' shapes: the launch is keyed
    "tf32x3", the output within 1e-5 of the plain version."""
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=dev) * 0.5
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    b = torch.randn((N,), generator=g, device=dev) * 0.1
    assert gemm_plan.plan(M, N, K, "float32", "fp32").core == "tf32x3"
    sl.launches.reset()
    got = sl.swap_linear(x, w, b, act="silu")
    assert list(sl.launches.by_shape) == [(M, K, N, "float32", "silu",
                                           "tf32x3")]
    want = sl.swap_linear_plain(x, w, b, act="silu")
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL[torch.float32], (M, K, N)


@pytest.mark.parametrize("M,K,N", [(3, 129, 67), (130, 200, 150), (1, 7, 3),
                                   (17, 1001, 130), (16, 12, 9),
                                   (200, 2052, 260)])
def test_swap_linear_fp32_wide_range_and_ragged_k(dev, M, K, N):
    """x and w whose values span 2^-20 .. 2^20 (where lo carries what hi
    drops), K no multiple of 8 (or of 4: plain loads), ragged N: within
    1e-5 of the plain version."""
    rng = np.random.default_rng(M * K + N)
    x, w = (torch.from_numpy((rng.standard_normal(shape)
                              * 2.0 ** rng.integers(-20, 21, shape))
                             .astype(np.float32)).to(dev)
            for shape in ((M, K), (K, N)))
    got = sl.swap_linear(x, w)
    want = sl.swap_linear_plain(x, w)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL[torch.float32], (M, K, N)


@pytest.mark.parametrize("K,N", [(3840, 10240), (10240, 3840), (3840, 960)])
def test_swap_linear_fp32_rows_across_row_tiles(dev, K, N):
    """Row i of an M-row call equals its 1-row call bitwise across the TF32
    core's row tiles (16 rows up to M 16, then 128) and its combines, at
    h2o-danube's decode, admission and prefill widths."""
    g = torch.Generator(device=dev).manual_seed(K + N)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    x = torch.randn((300, K), generator=g, device=dev)
    ones = {i: sl.swap_linear(x[i:i + 1].contiguous(), w)
            for i in (0, 1, 2, 15, 16, 39, 127, 128, 299)}
    for M in (3, 16, 17, 40, 300):
        full = sl.swap_linear(x[:M].contiguous(), w)
        for i, one in ones.items():
            if i < M:
                assert torch.equal(full[i:i + 1], one), (M, i)


# (B, S, H, KV, hd, window): flash_attention's fp32 main-path shapes:
# h2o-danube's 4,000-token admission and its training identity's 4,352
# under the 4,096 window, granite-20b's identity at G 48, qwen's run A
# admission, zamba2's shared block, the reduced configs' 64
TF32_ATTN = [(1, 4000, 32, 8, 120, 4096), (1, 4352, 32, 8, 120, 4096),
             (8, 256, 48, 1, 128, None), (1, 200, 16, 2, 128, None),
             (2, 300, 32, 32, 112, None), (2, 129, 4, 2, 64, None)]


@pytest.mark.parametrize("B,S,H,KV,hd,window", TF32_ATTN)
def test_flash_attention_fp32_takes_the_tf32_route(dev, B, S, H, KV, hd,
                                                   window):
    q, k, v, pos = _fa_inputs(B, S, H, KV, hd, torch.float32, S + hd)
    kw = dict(scale=hd ** -0.5, window=window)
    assert fa.path(torch.float32, hd) == "tf32x3"
    fa.launches.reset()
    got = fa.flash_attention(q, k, v, pos, **kw)
    assert [key[11] for key in fa.launches.by_shape] == ["tf32x3"]
    want = fa.flash_attention_plain(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL[torch.float32], (B, S, H, KV, hd)


@pytest.mark.parametrize("causal,window,softcap,chunk", FA_PADDED_MASKS)
@pytest.mark.parametrize("hd,dv", [(128, 128), (120, 120), (112, 112),
                                   (64, 64), (48, 32), (4, 60), (68, 100)])
def test_flash_attention_fp32_at_ragged_s(dev, hd, dv, causal, window,
                                          softcap, chunk):
    """The TF32 kernel at S around its 64-key and 128-row tiles, at every
    mask, at pairs padded up to its widths, shuffled positions on every
    other S: within 1e-5 of the plain version, the output [B, S, H, dv],
    a repeated call equal."""
    assert fa.path(torch.float32, hd, dv) == "tf32x3"
    for i, S in enumerate((1, 2, 63, 64, 65, 127, 128, 129, 700)):
        q, k, v, pos = _fa_inputs(2, S, 4, 2, hd, torch.float32, 120 + i,
                                  shuffled=i % 2 == 1, dv=dv)
        kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                  softcap=softcap, chunk=chunk)
        got = fa.flash_attention(q, k, v, pos, **kw)
        want = fa.flash_attention_plain(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        assert tuple(got.shape) == (2, S, 4, dv)
        assert bool(torch.isfinite(got).all()), S
        assert _rel(got, want) <= TOL[torch.float32], (S, hd, dv)
        assert torch.equal(got, fa.flash_attention(q, k, v, pos, **kw))


def test_flash_attention_fp32_wide_range(dev):
    """q and k at 2^-20 .. 2^0 and v at 2^-20 .. 2^20 per element: the lo
    terms carry what hi drops at every magnitude; a misaligned k and v
    (plain loads) give the aligned copies' bits."""
    rng = np.random.default_rng(5)
    B, S, H, KV, hd = 2, 300, 8, 2, 120

    def draw(shape, lo, hi):
        return torch.from_numpy((rng.standard_normal(shape)
                                 * 2.0 ** rng.integers(lo, hi + 1, shape))
                                .astype(np.float32)).to(dev)
    q, k = draw((B, S, H, hd), -20, 0), draw((B, S, KV, hd), -20, 0)
    v = draw((B, S, KV, hd), -20, 20)
    pos = torch.arange(S, device=dev).expand(B, S)
    kw = dict(scale=1.0, window=100, softcap=30.0)
    got = fa.flash_attention(q, k, v, pos, **kw)
    want = fa.flash_attention_plain(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL[torch.float32]
    buf = torch.empty(2 * k.numel() + 8, device=dev)
    kv = buf[1:1 + k.numel()].view(k.shape)
    vv = buf[2 + k.numel():2 + 2 * k.numel()].view(v.shape)
    kv.copy_(k)
    vv.copy_(v)
    assert kv.data_ptr() % 16 and vv.data_ptr() % 16
    assert torch.equal(fa.flash_attention(q, kv, vv, pos, **kw), got)


def test_flash_attention_tf32_dispatch_takes_exactly_the_rule(dev,
                                                              monkeypatch):
    """The TF32 launch succeeds at every fp32 (hd, dv) that ``path`` sends
    to "tf32x3" and is refused (a raised RuntimeError, never a fallback)
    at every other pair."""
    monkeypatch.setattr(fa, "path", lambda dtype, hd, dv=None: "tf32x3")
    dims = sorted(set(range(4, 257, 4)) | {1, 6, 50, 126, 130, 250})
    for hd in dims:
        q, k, _, pos = _fa_inputs(1, 3, 2, 1, hd, torch.float32, 0)
        for dv in dims:
            v = torch.ones((1, 3, 1, dv), device=dev)
            try:
                fa.flash_attention(q, k, v, pos, scale=0.1)
                took = True
            except RuntimeError:
                took = False
            assert took == (FA_RULE(torch.float32, hd, dv) == "tf32x3"), (
                hd, dv)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dv_rows_do_not_depend_on_the_batch(dev, dtype):
    """At (192, 128), on either kernel: row b of a 4-row call equals the
    1-row call on that row bitwise."""
    q, k, v, pos = _fa_inputs(4, 200, 16, 16, 192, dtype, 11, dv=128)
    kw = dict(scale=192 ** -0.5, window=64)
    full = fa.flash_attention(q, k, v, pos, **kw)
    for b in range(4):
        one = fa.flash_attention(q[b:b + 1].contiguous(),
                                 k[b:b + 1].contiguous(),
                                 v[b:b + 1].contiguous(), pos[b:b + 1], **kw)
        assert torch.equal(full[b:b + 1], one), b


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_mla_apply_on_the_card_matches_cpu(dev, width):
    """deepseek-v2's MLA in bf16 (full width: hd 192 / dv 128 on the
    tensor cores, wq and wo through swap_linear), prefill of 40 tokens and
    two absorbed decode steps on the card, against the same calls on the
    CPU."""
    from repro_torch.models import attention
    from repro_torch.models.params import init_from_defs
    cfg = get_arch("deepseek-v2-lite-16b")
    if width == "reduced":
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p_cpu = {k: v.to(torch.bfloat16) for k, v in init_from_defs(
        attention.mla_defs(cfg), 0, device=torch.device("cpu")).items()}
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    B, S, L = 2, 40, 48
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((B, S + 2, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    outs = {}
    for name, p, d in (("cpu", p_cpu, torch.device("cpu")),
                       ("cuda", p_dev, dev)):
        pos = torch.arange(S, device=d).expand(B, S)
        fa.launches.reset()
        y, c = attention.mla_apply(cfg, p, x[:, :S].to(d), pos, None, None)
        if name == "cuda":
            m = cfg.mla
            hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            assert [k[4:6] for k in fa.launches.by_shape] == [
                (hd, m.v_head_dim)]
        c = {k: torch.nn.functional.pad(v, (0, 0, 0, L - S))
             for k, v in c.items()}
        ys = [y]
        for t in (S, S + 1):
            dpos = torch.full((B,), t, dtype=torch.long, device=d)
            yt, c = attention.mla_apply(cfg, p, x[:, t:t + 1].to(d),
                                        dpos[:, None], c, dpos)
            ys.append(yt)
        outs[name] = [a.float().cpu() for a in ys] + [
            c[k].float().cpu() for k in sorted(c)]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= TOL[torch.bfloat16]


def test_deepseek_prefill_on_the_card(dev, tmp_path):
    """Reduced deepseek-v2-lite (2 MLA + moe layers, hd 48 / dv 32)
    swapped on mmap on the card: bitwise equal to the unswapped forward,
    flash_attention once per layer at (48, 32), swap_linear 5 times a
    layer (wq, wo and the shared expert's three)."""
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b").reduced(),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    sm = SwappedModel(model, params, str(tmp_path))
    try:
        sm.partition(5 * 1024 * 1024, DelayModel(), 2, 20)
        fa.launches.reset()
        sl.launches.reset()
        logits, _ = sm.forward(batch)
        assert fa.launches.count == cfg.n_layers
        assert {k[4:6] for k in fa.launches.by_shape} == {(48, 32)}
        assert sl.launches.count == 5 * cfg.n_layers
        assert torch.equal(logits, sm.forward_unswapped(batch))
    finally:
        sm.close()
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------------ training
# qwen2.5-3b's linears and attention at the training shapes (batch 8 x
# seq 256): the two Functions' gradients on the card against autograd
# through the plain versions on the same inputs (1e-5 fp32, 2e-2 bf16:
# the backward's products run in the working type and the recomputed
# pre-activation is rounded to it)
TRAIN_LINEARS = [(2048, 2048, "none", True), (2048, 256, "none", True),
                 (2048, 2048, "none", False), (2048, 11008, "silu", False),
                 (11008, 2048, "none", False)]


def _train_grads(fn, inputs, dy):
    for t in inputs:
        t.grad = None
    out = fn()
    out.backward(dy)
    torch.cuda.synchronize()
    return out.detach(), [t.grad for t in inputs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,act,bias", TRAIN_LINEARS)
def test_swap_linear_fn_grads_on_the_card(dev, K, N, act, bias, dtype):
    g = torch.Generator(device=dev).manual_seed(K + N)
    x = torch.randn((2048, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(dtype)
    b = (torch.randn((N,), generator=g, device=dev) * 0.1).to(dtype)
    dy = torch.randn((2048, N), generator=g, device=dev).to(dtype)
    inputs = [t.requires_grad_(True) for t in ((x, w, b) if bias else (x, w))]
    b = b if bias else None
    before = sl.launches.count
    y, got = _train_grads(lambda: sl.swap_linear(x, w, b, act=act), inputs,
                          dy)
    assert sl.launches.count == before + (1 if act == "none" else 2)
    y0, want = _train_grads(lambda: sl.swap_linear_plain(x, w, b, act=act),
                            inputs, dy)
    assert _rel(y, y0) <= TOL[dtype]
    for a, a0 in zip(got, want):
        assert a.dtype == dtype and _rel(a, a0) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 64, 30.0), (False, None, None)])
def test_flash_attention_fn_grads_on_the_card(dev, dtype, causal, window,
                                              softcap):
    g = torch.Generator(device=dev).manual_seed(7)
    B, S, H, KV, hd = 8, 256, 16, 2, 128
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    dy = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    pos = torch.arange(S, device=dev).expand(B, S)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)
    inputs = [t.requires_grad_(True) for t in (q, k, v)]
    before = fa.launches.count
    out, got = _train_grads(lambda: fa.flash_attention(q, k, v, pos, **kw),
                            inputs, dy)
    assert fa.launches.count == before + 1
    out0, want = _train_grads(
        lambda: fa.flash_attention_plain(q, k, v, pos, **kw), inputs, dy)
    assert _rel(out, out0) <= TOL[dtype]
    for a, a0 in zip(got, want):
        assert a.dtype == dtype and _rel(a, a0) <= TOL[dtype]


# phase 17's training attention at padded head dims: zamba2's shared
# block (32 / 32 heads of 112, causal) and hubert's encoder (16 / 16 heads
# of 80, no causal mask), batch 8 x 256
TRAIN_PADDED_ATTN = [(32, 32, 112, True), (16, 16, 80, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd,causal", TRAIN_PADDED_ATTN)
def test_flash_attention_fn_grads_at_padded_head_dims_on_the_card(
        dev, H, KV, hd, causal, dtype):
    """``FlashAttentionFn`` at phase 17's zamba2 and hubert shapes (the
    tensor cores in bf16) against autograd through the plain version:
    the output and each input's gradient within the tolerance of the
    qwen-shaped test."""
    assert fa.path(dtype, hd) == ("tc" if dtype == torch.bfloat16
                                  else "tf32x3")
    g = torch.Generator(device=dev).manual_seed(hd)
    B, S = 8, 256
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    dy = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    pos = torch.arange(S, device=dev).expand(B, S)
    kw = dict(scale=hd ** -0.5, causal=causal)
    inputs = [t.requires_grad_(True) for t in (q, k, v)]
    before = fa.launches.count
    out, got = _train_grads(lambda: fa.flash_attention(q, k, v, pos, **kw),
                            inputs, dy)
    assert fa.launches.count == before + 1
    out0, want = _train_grads(
        lambda: fa.flash_attention_plain(q, k, v, pos, **kw), inputs, dy)
    assert _rel(out, out0) <= TOL[dtype]
    for a, a0 in zip(got, want):
        assert a.dtype == dtype and _rel(a, a0) <= TOL[dtype]


# phase 17's h2o-danube and granite-20b attention under autograd (B, S, H,
# KV, hd, window): danube's 32 / 8 heads of 120 on one sequence of 4,352
# tokens under its 4,096 window (the last 256 queries lose their first
# keys to it: the kernel's forward and flash_attention_grad's masking must
# agree at the window's edge), granite's 48 query heads of 128 on one KV
# head at 8 x 256 (fp32: the three-pass TF32 kernel at G 48)
TRAIN_FAMILY_ATTN = [(1, 4352, 32, 8, 120, 4096), (8, 256, 48, 1, 128, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,window", TRAIN_FAMILY_ATTN)
def test_flash_attention_fn_grads_at_danube_and_granite_on_the_card(
        dev, B, S, H, KV, hd, window, dtype):
    """``FlashAttentionFn`` against autograd through the plain version at
    the two families' training shapes: the output and each input's
    gradient within the tolerance of the qwen-shaped test."""
    g = torch.Generator(device=dev).manual_seed(S + H)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dtype)
    dy = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    pos = torch.arange(S, device=dev).expand(B, S)
    kw = dict(scale=hd ** -0.5, window=window)
    inputs = [t.requires_grad_(True) for t in (q, k, v)]
    before = fa.launches.count
    out, got = _train_grads(lambda: fa.flash_attention(q, k, v, pos, **kw),
                            inputs, dy)
    assert fa.launches.count == before + 1
    out0, want = _train_grads(
        lambda: fa.flash_attention_plain(q, k, v, pos, **kw), inputs, dy)
    assert _rel(out, out0) <= TOL[dtype]
    for a, a0 in zip(got, want):
        assert a.dtype == dtype and _rel(a, a0) <= TOL[dtype]
    if window is not None:
        # the window masks something: without it the output differs
        with torch.no_grad():
            wide = fa.flash_attention(q, k, v, pos, scale=hd ** -0.5)
        assert _rel(wide[:, window:], out[:, window:]) > TOL[dtype]
        assert _rel(wide[:, :window], out[:, :window]) <= TOL[dtype]


@pytest.mark.parametrize("bits", [8, 4])
def test_swap_linear_q_at_the_llama4_head_on_the_card(dev, bits):
    """B1 at llama4-scout's head (fp32 x, K 5,120, N 202,048 = 1,578 x 128
    + 64: the first head whose last column tile the kernel masks) against
    swap_linear_q_plain at M 1, every column and the last 64 alone; the
    rows of a 4-row call equal their 1-row calls bitwise."""
    K, N = 5120, 202048
    g = torch.Generator(device=dev).manual_seed(bits)
    q = torch.randint(-127 if bits == 8 else -128, 128,
                      (K if bits == 8 else K // 2, N), generator=g,
                      device=dev, dtype=torch.int8)
    s = torch.rand((N,), generator=g, device=dev) * (2.0 / 127) / K ** 0.5
    x = torch.randn((4, K), generator=g, device=dev)
    got = slq.swap_linear_q(x[:1], q, s, bits=bits)
    want = slq.swap_linear_q_plain(x[:1], q, s, bits=bits)
    assert got.shape == (1, N) and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL[torch.float32]
    assert _rel(got[:, -64:], want[:, -64:]) <= TOL[torch.float32]
    full = slq.swap_linear_q(x, q, s, bits=bits)
    for i in range(4):
        assert torch.equal(full[i:i + 1],
                           slq.swap_linear_q(x[i:i + 1], q, s, bits=bits))


def test_kernels_without_a_backward_refuse_grad_on_the_card(dev):
    """swap_linear_q, dequant_int8 and paged_attention raise, naming the
    kernel, where autograd would record them; under no_grad they run."""
    q8, s = _weights(8, 64, 32)
    q8, s = q8.to(dev), s.to(dev).requires_grad_(True)
    x = torch.randn((4, 64), device=dev, requires_grad=True)
    calls = {
        "swap_linear_q": lambda: slq.swap_linear_q(x, q8, s),
        "dequant_int8": lambda: dq.dequant_int8(q8, s),
    }
    qa, kp, vp, table, lens = _paged_inputs(0, 2, 4, 2, 64, 16, [5, 20],
                                            torch.float32)
    calls["paged_attention"] = lambda: pa.paged_attention(
        qa.requires_grad_(True), kp, vp, table, lens)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel "
                                               f"has no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


# wkv6 under autograd (WKV6Fn: the kernel forward, wkv6_grad's torch-op
# backward) at rwkv6-3b's training rows, fewer of them (BH 80 of 320, S
# 256, hd 64): fp32 inputs against autograd through the plain version in
# float64 (1e-5: the fp32 plain version's decay gradient cancels terms up
# to e^5 larger than itself at the clamp, row 0 here), bf16 inputs
# against autograd through the plain version on the same inputs (2e-2:
# the gradients are rounded to bf16)
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_fn_grads_on_the_card(dev, dtype, state):
    args = _wkv_inputs(80, 256, 64, dtype, seed=11, state=state)
    g = torch.Generator(device=dev).manual_seed(12)
    dy = torch.randn((80, 256, 64), generator=g, device=dev).to(dtype)
    ds = torch.randn((80, 64, 64), generator=g, device=dev)
    ref_dtype = torch.float64 if dtype == torch.float32 else None

    def grads(fn, cast):
        ins = [None if t is None else
               (t if cast is None else t.to(cast)).detach().requires_grad_()
               for t in args]
        y, s_fin = fn(*ins)
        (torch.sum(y.double() * dy.double())
         + torch.sum(s_fin.double() * ds.double())).backward()
        torch.cuda.synchronize()
        return y.detach(), [t.grad for t in ins if t is not None]
    before = kw.launches.count
    y, got = grads(kw.wkv6, None)
    assert kw.launches.count == before + 1          # the backward launches
    y0, want = grads(kw.wkv6_plain, ref_dtype)      # nothing
    assert _rel(y, y0) <= TOL[dtype]
    assert len(got) == len(want) == (6 if state else 5)
    for a, a0, t in zip(got, want, [t for t in args if t is not None]):
        assert a.dtype == t.dtype and bool(torch.isfinite(a).all())
        assert _rel(a, a0) <= TOL[dtype]


def test_wkv6_under_grad_never_runs_plain_on_the_card(dev, monkeypatch):
    """A CUDA tensor under grad goes through WKV6Fn to the kernel, forward
    and backward, and never to the plain version."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(kw, "wkv6_plain", refuse)
    r, k, v, w, u, s0 = _wkv_inputs(4, 64, 64, torch.float32, seed=13,
                                    state=True)
    for t in (r, k, v, w, u, s0):
        t.requires_grad_(True)
    before = kw.launches.count
    y, s_fin = kw.wkv6(r, k, v, w, u, s0)
    assert type(y.grad_fn).__name__ == "WKV6FnBackward"
    (y.sum() + s_fin.sum()).backward()
    torch.cuda.synchronize()
    assert kw.launches.count == before + 1
    assert all(t.grad is not None for t in (r, k, v, w, u, s0))


# llama4-scout and qwen2-vl at reduced() widths: 3 bf16 steps of the
# launcher's loop on the card, every loss finite (their published widths
# do not fit one card's training state even at one layer)
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "qwen2-vl-72b"])
def test_reduced_train_steps_on_the_card(dev, arch):
    from repro_torch.launch.train import train
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16")
    before = (sl.launches.count, fa.launches.count)
    out = train(cfg, steps=3, batch=8, seq=64, log_every=1, device="cuda")
    losses = [loss for _, loss, _ in out["logged"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    # per step and layer (tests/test_torch_train_archs.py counts the same
    # on the CPU): 7 linears, forward and remat, and the gate's recompute
    # (llama4's shared expert, qwen2-vl's MLP); attention forward and remat
    L = cfg.n_layers
    assert sl.launches.count - before[0] == 15 * L * 3
    assert fa.launches.count - before[1] == 2 * L * 3
    assert all(p.device.type == "cuda"
               for p in tree_leaves(out["state"]["params"]))


# the mesh path on the card: a one-rank NCCL group, mesh (1, 1) ("data",
# "model"); the kernels take each device's local shards through local_map
def _nccl_mesh():
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    return make_smoke_mesh("cuda")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-3b"])
def test_mesh_train_step_on_the_card(dev, monkeypatch, arch):
    """deepseek-v2-lite (MLA, the EP dispatch) and rwkv6 ``reduced()`` in
    fp32, params and batch placed by ``train_state_specs`` /
    ``input_pspecs``: the loss within 1e-5 relative and each gradient leaf
    within 1e-4 of its largest |g| of the unsharded step's (chip_smoke's
    phase 19 tolerances); B5, B4 and B6 launched as often as unsharded,
    their plain versions never called."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch_for
    from repro_torch.distributed.sharding import (distribute, full_tensor,
                                                  set_mesh)
    from repro_torch.models.transformer import input_pspecs
    from repro_torch.training.train_loop import train_state_specs
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = Model(cfg)
    shape = ShapeConfig("t", seq_len=64, global_batch=4, mode="train")
    batch = {k: v.to(dev) for k, v in
             make_batch_for(cfg, shape, seed=0).items()}
    params = model.init(0, device=dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    counters = (sl.launches, fa.launches, kw.launches)
    before = [c.count for c in counters]
    loss0, _ = model.loss(params, batch)
    loss0.backward()
    per_step = [c.count - b for c, b in zip(counters, before)]
    assert per_step[0] > 0 and per_step[1] + per_step[2] > 0

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(sl, "swap_linear_plain", refuse)
    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    monkeypatch.setattr(kw, "wkv6_plain", refuse)
    mesh = _nccl_mesh()
    try:
        dparams = distribute(params, train_state_specs(model)["params"], mesh)
        set_mesh(mesh)
        before = [c.count for c in counters]
        with implicit_replication():
            loss, _ = model.loss(dparams, distribute(
                batch, input_pspecs(cfg, shape, mesh), mesh))
            loss.backward()
        assert [c.count - b for c, b in zip(counters, before)] == per_step
        loss = float(full_tensor(loss.detach()))
        loss0 = float(loss0.detach())
        assert abs(loss - loss0) <= 1e-5 * abs(loss0)
        for p, p0 in zip(tree_leaves(dparams), tree_leaves(params)):
            g = full_tensor(p.grad)
            assert float((g - p0.grad).abs().max()) <= 1e-4 * float(
                p0.grad.abs().max())
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def test_ring_decode_on_the_card(dev):
    """h2o-danube ``reduced()`` (window 64) in fp32: 50 decode steps past
    the ring's wrap on the windowed cache == the full cache's (1e-5 of each
    step's largest logit), teacher-forced by the full cache's tokens."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_arch("h2o-danube-3-4b").reduced(),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(0, device=dev)
    P, L = 40, 100
    prompt = torch.randint(0, cfg.vocab_size, (1, P),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        _, pre = model.prefill(params, {"tokens": prompt})
        full = model.alloc_cache(1, L, device=dev)
        try:
            transformer.WINDOWED_KV_CACHE = True
            ring = model.alloc_cache(1, L, device=dev)
        finally:
            transformer.WINDOWED_KV_CACHE = False
        assert ring[0]["k"].shape[2] == cfg.sliding_window
        for cache in (full, ring):
            for seg, p in zip(cache, pre):
                for k in seg:
                    seg[k][:, :, :P] = p[k]
        tok = prompt[:, -1:]
        for i in range(50):
            b = {"token": tok, "pos": torch.tensor([P + i], device=dev)}
            want, _ = model.decode_step(params, full, b)
            got, _ = model.decode_step(params, ring, b)
            assert _rel(got, want) <= 1e-5, i
            tok = want.argmax(-1).reshape(1, 1)


# ------------------------------------------- the int8-lazy arms' linears
# (K, N, act, bias, x dtype) of every swap_linear_q launch of chip_smoke.py
# phases 11-13's int8-lazy arms at published widths; each head takes the
# last position in fp32
ARM_LINEARS = [
    # deepseek-v2-lite: wq, attention wo, the shared expert's wi0 / wi1 /
    # wo, the head
    (2048, 3072, "none", False, torch.bfloat16),
    (2048, 2048, "none", False, torch.bfloat16),
    (2048, 2816, "silu", False, torch.bfloat16),
    (2048, 2816, "none", False, torch.bfloat16),
    (2816, 2048, "none", False, torch.bfloat16),
    (2048, 102400, "none", False, torch.float32),
    # zamba2-7b: the shared block's q / k / v / o, wi0, wi1, wo, each
    # Mamba2 layer's wo, the tied head
    (3584, 3584, "none", False, torch.bfloat16),
    (3584, 14336, "silu", False, torch.bfloat16),
    (3584, 14336, "none", False, torch.bfloat16),
    (14336, 3584, "none", False, torch.bfloat16),
    (7168, 3584, "none", False, torch.bfloat16),
    (3584, 32000, "none", False, torch.float32),
    # qwen2-vl-72b: wq (biased; wo at the same shape has none), wk / wv
    # (biased), wi0, wi1, wo, the head
    (8192, 8192, "none", True, torch.bfloat16),
    (8192, 8192, "none", False, torch.bfloat16),
    (8192, 1024, "none", True, torch.bfloat16),
    (8192, 29568, "silu", False, torch.bfloat16),
    (8192, 29568, "none", False, torch.bfloat16),
    (29568, 8192, "none", False, torch.bfloat16),
    (8192, 152064, "none", False, torch.float32),
]


def _card_weights(dev, bits, K, N, seed):
    """A random int8 (or int4 carrier) weight and scales made on the card:
    the numpy quantizer would take seconds a weight at these sizes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-127 if bits == 8 else -128, 128,
                      (K if bits == 8 else -(-K // 2), N), generator=g,
                      device=dev, dtype=torch.int8)
    s = torch.rand((N,), generator=g, device=dev) * (2.0 / 127) / K ** 0.5
    return q, s


@pytest.mark.parametrize("K,N,act,bias,dtype", ARM_LINEARS,
                         ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("bits", [8, 4])
def test_swap_linear_q_at_the_int8_lazy_arms_shapes(dev, bits, K, N, act,
                                                    bias, dtype):
    """B1 at each launch shape of the int8-lazy arms, int8 and int4, at M 2
    and 64 against the plain version, and the 64-row call's rows bitwise
    their 1-row calls."""
    q, s = _card_weights(dev, bits, K, N, seed=K + N + bits)
    g = torch.Generator(device=dev).manual_seed(K * 3 + N)
    b = ((torch.randn((N,), generator=g, device=dev) * 0.1).to(dtype)
         if bias else None)
    for M in (2, 64):
        x = torch.randn((M, K), generator=g, device=dev).to(dtype)
        got = slq.swap_linear_q(x, q, s, b, bits=bits, act=act)
        want = slq.swap_linear_q_plain(x, q, s, b, bits=bits, act=act)
        torch.cuda.synchronize()
        assert got.dtype == dtype and tuple(got.shape) == (M, N)
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= TOL[dtype], M
    for i in (0, 1, 31, 63):
        one = slq.swap_linear_q(x[i:i + 1].contiguous(), q, s, b, bits=bits,
                                act=act)
        assert torch.equal(got[i:i + 1], one), i


def _lazy_units(sm):
    stored = {n: sm.store.read_unit(n).params
              for n in dict.fromkeys(u.name for u in sm.units)}
    return [stored[u.name] for u in sm.units]


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "zamba2-7b",
                                  "qwen2-vl-72b"])
def test_int8_lazy_arm_on_the_card(dev, tmp_path, name):
    """The int8-lazy arms' identity at ``reduced()`` widths in bf16: the
    swapped pass is bitwise the unswapped forward over the store's own
    lazy leaves, B1 carries every fusable weight (B5 none) and B4 every
    attention layer."""
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(7)
    B, S = 2, 32
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.rope_type == "mrope":
        nv = cfg.n_vision_tokens
        side = int(nv ** 0.5)
        i = np.arange(S)
        pos = np.stack([i, np.where(i < nv, i // side, i),
                        np.where(i < nv, i % side, i)], axis=-1)
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, nv, cfg.d_frontend)).astype(np.float32))
        batch["positions"] = torch.from_numpy(np.broadcast_to(
            pos, (B, S, 3)).astype(np.int32).copy())
    kinds = cfg.layer_kinds()
    per = {"dense": 7, "moe": 5, "mamba2": 1, "shared_attn": 7}
    budget = 8 * 1024 * 1024
    sm = SwappedModel(model, params, str(tmp_path), store_backend="quant",
                      precision="int8")
    try:
        sm.partition(budget, DelayModel(), B, S)
        for c in (slq.launches, sl.launches, fa.launches):
            c.reset()
        logits, _ = sm.forward(batch)
        torch.cuda.synchronize()
        assert slq.launches.count == sum(per[k] for k in kinds) + 1
        assert sl.launches.count == 0
        assert fa.launches.count == sum(k in ("moe", "dense", "shared_attn")
                                        for k in kinds)
        want = sm.forward_unswapped(batch, resident=_lazy_units(sm))
    finally:
        sm.close()
    assert logits.is_cuda and bool(torch.isfinite(logits).all())
    assert torch.equal(logits, want)
