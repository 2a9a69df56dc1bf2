"""The host-side launch plans of the attention kernels: which flash_attention
kernel a (dtype, head_dim) takes, and how paged_attention cuts a decode
sequence into splits (flash-decoding) and sizes its scratch.

The plans are pure Python, so they are checked here on the CPU; the CUDA
kernels that follow them run only on the card (``tests/test_torch_cuda.py``).
The split arithmetic is also run end to end here: each split's online
softmax, then the splits added in split order, against the plain version
(float32, 1e-5: the sums run in another order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]


# ---------------------------------------------------------- flash_attention
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 120, 128, 200, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_path_by_dtype_and_head_dim(dtype, hd):
    """bf16 takes the tensor cores at every one of these head dims: each
    is a multiple of 8 and rounds up to an instantiation's width (16 and
    32 to 64; hubert's 80 and h2o-danube's 120 to 128; 200 to 256);
    fp32 takes them in three-pass TF32 up to 128 and the CUDA cores at 200
    and 256."""
    if dtype == torch.bfloat16:
        want = "tc"
    else:
        want = "tf32x3" if hd <= 128 else "simt"
    assert fa.path(dtype, hd) == want
    assert fa.PATHS[fa.path(dtype, hd)] in (0, 1, 2)


@pytest.mark.parametrize("hd,dv", [(192, 128), (48, 32), (128, 192),
                                   (192, 192), (128, 64), (64, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_path_by_value_head_dim(dtype, hd, dv):
    """With a value head dim of its own, bf16 takes the tensor cores where
    the pair rounds up to an instantiation: deepseek-v2's MLA pair
    (192, 128) and its reduced (48, 32) (to (64, 64)); (128, 192),
    (192, 192), (128, 64) and (64, 128) have none and take the CUDA cores.
    fp32 takes three-pass TF32 at the reduced (48, 32) alone: (192, 128)
    is wider than its instantiations. Equal pairs keep the rule of one
    head dim."""
    if dtype == torch.bfloat16:
        want = "tc" if (hd, dv) in ((192, 128), (48, 32)) else "simt"
    else:
        want = "tf32x3" if (hd, dv) == (48, 32) else "simt"
    assert fa.path(dtype, hd, dv) == want
    assert fa.path(dtype, 128, 128) == fa.path(dtype, 128)


def _tf32_pairs():
    """The fp32 (hd, dv) the TF32 kernel takes, spelled out: multiples of
    4 whose widths rounded up to 64 are (64, 64) or (128, 128)."""
    small = range(4, 65, 4)
    large = range(68, 129, 4)
    return ({(h, d) for h in small for d in small}
            | {(h, d) for h in large for d in large})


def test_fp32_takes_the_tf32_route_exactly_at_its_pairs():
    """Every fp32 (hd, dv) of 1 to 256: "tf32x3" at the pairs of
    Tf32Attn's two instantiations, "simt" everywhere else."""
    pairs = _tf32_pairs()
    assert len(pairs) == 16 * 16 * 2
    for hd in range(1, fa.MAX_HEAD_DIM + 1):
        for dv in range(1, fa.MAX_HEAD_DIM + 1):
            want = "tf32x3" if (hd, dv) in pairs else "simt"
            assert fa.path(torch.float32, hd, dv) == want, (hd, dv)
    assert fa.TF32_HEAD_DIMS == ((64, 64), (128, 128))


@pytest.mark.parametrize("hd,dv,want", [
    (128, 128, "tf32x3"),     # qwen2.5-3b (phase 4 run A), granite-20b
    (120, 120, "tf32x3"),     # h2o-danube-3-4b (phases 17, 19)
    (112, 112, "tf32x3"),     # zamba2-7b's shared block (phase 12)
    (64, 64, "tf32x3"),       # the reduced configs
    (48, 32, "tf32x3"),       # deepseek-v2's reduced MLA
    (192, 128, "simt"),       # deepseek-v2's MLA (phase 11's fp32 engine)
    (256, 256, "simt"),       # gemma2-9b
    (80, 80, "tf32x3"),       # hubert-xlarge
    (126, 126, "simt"),       # not a multiple of 4
])
def test_fp32_paths_of_the_configs(hd, dv, want):
    assert fa.path(torch.float32, hd, dv) == want


# ---------------------------------------------------------- paged_attention
@pytest.mark.parametrize("hd,dtype,chunk", [
    (64, torch.bfloat16, 64), (128, torch.bfloat16, 64),
    (256, torch.bfloat16, 32), (64, torch.float32, 64),
    (128, torch.float32, 32), (256, torch.float32, 16),
    (120, torch.bfloat16, 64), (120, torch.float32, 32)])
def test_chunk_tokens(hd, dtype, chunk):
    """A ring stage holds at most 64 tokens and at most 16 KB of K rows
    at the kernel's row width (h2o-danube's 120 at 128)."""
    assert pa.chunk_tokens(hd, dtype) == chunk
    es = torch.empty((), dtype=dtype).element_size()
    assert chunk * pa.padded_head_dim(hd) * es <= pa.STAGE_BYTES


@pytest.mark.parametrize("T", [1, 4, 8, 16, 48, 64, 100, 256, 1000])
@pytest.mark.parametrize("hd", [64, 120, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_len_is_a_multiple_of_page_and_chunk(dtype, hd, T):
    L = pa.split_len(hd, dtype, T)
    assert L > 0 and L % T == 0 and L % pa.chunk_tokens(hd, dtype) == 0
    base = math.lcm(T, pa.chunk_tokens(hd, dtype))
    assert L == base * max(1, round(pa.SPLIT_TOKENS[hd] / base))
    assert L / T + 2 <= 512         # the kernel's page ids of a split


def test_gemma_decode_fills_the_card():
    """gemma2-9b's first decode step (contexts 4,201 and 25, T = 16, hd 256,
    bf16): splits of 128 tokens, 33 a KV head for the long row (32 under
    its 4,096-token window), one for the short: with 8 KV heads, 272 and
    264 busy blocks for the 132 SMs."""
    L = pa.split_len(256, torch.bfloat16, 16)
    assert L == 128
    NP = -(-4201 // 16)
    assert pa.max_splits(NP, 16, L) == 33
    for window, n in ((4096, 32), (None, 33)):
        assert len(pa.split_bounds(4201, window, L, NP * 16)) == n
        assert len(pa.split_bounds(25, window, L, NP * 16)) == 1
        assert (n + 1) * 8 >= 2 * 132


def test_qwen_decode_splits():
    """qwen2.5-3b's paged decode (hd 128, pages of 16): splits of 64
    tokens, so a context of at most 64 takes one split and writes its
    output directly, and the longest of the paged run (208 tokens, 14
    pages) takes 4; scratch for 4 splits a sequence."""
    for dtype in DTYPES:
        L = pa.split_len(128, dtype, 16)
        assert L == 64
        assert pa.split_bounds(64, None, L, 4 * 16) == [(0, 64)]
        assert pa.max_splits(4, 16, L) == 1
        assert pa.scratch_floats(4, 2, 8, 128, 4, 16, L) == 0
        assert pa.split_bounds(208, None, L, 14 * 16) == [
            (0, 64), (64, 128), (128, 192), (192, 208)]
        assert pa.max_splits(14, 16, L) == 4
        assert pa.scratch_floats(4, 2, 8, 128, 14, 16, L) == \
            4 * 2 * 4 * 8 * 130


seq_and_window = st.tuples(st.integers(1, 5000),
                           st.one_of(st.none(), st.integers(1, 6000)))


@settings(max_examples=200, deadline=None)
@given(sw=seq_and_window, T=st.sampled_from([4, 16, 48]),
       hd=st.sampled_from([64, 120, 128, 256]), bf16=st.booleans())
def test_splits_cover_the_live_range_once(sw, T, hd, bf16):
    """The splits tile [lo, hi) (the live, in-window tokens) exactly once,
    in order, each at most L tokens and all but the last exactly L; one
    split when the live range is at most L; never more than max_splits of
    the page table."""
    seq_len, window = sw
    L = pa.split_len(hd, torch.bfloat16 if bf16 else torch.float32, T)
    NP = -(-seq_len // T)
    bounds = pa.split_bounds(seq_len, window, L, NP * T)
    lo = 0 if window is None else max(0, seq_len - window)
    covered = [t for s0, s1 in bounds for t in range(s0, s1)]
    assert covered == list(range(lo, seq_len))
    assert all(0 < s1 - s0 <= L for s0, s1 in bounds)
    assert all(s1 - s0 == L for s0, s1 in bounds[:-1])
    if seq_len - lo <= L:
        assert len(bounds) == 1
    assert len(bounds) <= pa.max_splits(NP, T, L)


@settings(max_examples=100, deadline=None)
@given(seqs=st.lists(st.integers(1, 3000), min_size=1, max_size=6),
       window=st.one_of(st.none(), st.integers(1, 4096)),
       extra_cols=st.integers(0, 3), T=st.sampled_from([8, 16]))
def test_split_boundaries_do_not_depend_on_the_batch(seqs, window,
                                                      extra_cols, T):
    """Each sequence's splits in a batch, whose page table is as wide as
    the longest sequence needs (plus padding columns), equal its splits
    alone in a table of its own pages: the boundaries depend on its
    seq_len, the window and L only."""
    L = pa.split_len(256, torch.bfloat16, T)
    NP = max(-(-s // T) for s in seqs) + extra_cols
    for s in seqs:
        solo = pa.split_bounds(s, window, L, -(-s // T) * T)
        assert pa.split_bounds(s, window, L, NP * T) == solo
        assert len(solo) <= pa.max_splits(NP, T, L)


@settings(max_examples=100, deadline=None)
@given(B=st.integers(1, 8), KV=st.sampled_from([1, 2, 8]),
       G=st.sampled_from([1, 2, 4, 8, 48]),
       hd=st.sampled_from([64, 120, 128, 256]),
       NP=st.integers(1, 400), T=st.sampled_from([4, 16, 48]))
def test_scratch_size_comes_from_the_page_table_width(B, KV, G, hd, NP, T):
    """Scratch holds (acc[hd], m, l) for every (sequence, KV head, split
    the grid may run, query head) when more than one split can occur, and
    nothing otherwise: from NP and the shapes, never from seq_lens."""
    L = pa.split_len(hd, torch.bfloat16, T)
    n = pa.max_splits(NP, T, L)
    assert n == math.ceil(NP * T / L)
    want = 0 if n == 1 else B * KV * n * G * (hd + 2)
    assert pa.scratch_floats(B, KV, G, hd, NP, T, L) == want


def _split_decode(q, k_pages, v_pages, page_table, seq_lens, *, scale,
                  window, softcap, L):
    """The kernel's arithmetic in float32 torch: per split an online
    softmax over its tokens, then the splits added in split order with
    weights exp(m_s - max m); one split divides directly."""
    B, H, hd = q.shape
    P, T, KV, _ = k_pages.shape
    G = H // KV
    NP = page_table.shape[1]
    out = torch.empty_like(q)
    for b in range(B):
        parts = []
        for s0, s1 in pa.split_bounds(int(seq_lens[b]), window, L, NP * T):
            tok = torch.arange(s0, s1)
            pages = page_table[b, tok // T].long()
            k = k_pages[pages, tok % T]                 # [n, KV, hd]
            v = v_pages[pages, tok % T]
            qf = q[b].reshape(KV, G, hd)
            s = torch.einsum("kgh,nkh->kgn", qf, k) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            m = s.max(dim=-1).values
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgn,nkh->kgh", p, v)))
        if len(parts) == 1:
            m, l, acc = parts[0]
            o = acc / torch.clamp(l, min=1e-30)[..., None]
        else:
            mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            l = torch.zeros_like(mx)
            acc = torch.zeros_like(parts[0][2])
            for m, ls, a in parts:
                w = torch.exp(m - mx)
                l = l + ls * w
                acc = acc + a * w[..., None]
            o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[b] = o.reshape(H, hd)
    return out


@pytest.mark.parametrize("window,softcap", [(None, None), (100, None),
                                            (None, 30.0), (300, 50.0)])
def test_split_arithmetic_matches_plain(window, softcap):
    """Splits of L = 64 tokens (pages of 16) over contexts of 1 to 700
    tokens, added in split order, equal the plain gather-then-attend
    softmax within 1e-5."""
    _split_arithmetic(8, 2, 32, window, softcap)


@pytest.mark.parametrize("H,KV,hd", [(32, 8, 120), (48, 1, 128)])
@pytest.mark.parametrize("window,softcap", [(None, None), (100, None),
                                            (300, 50.0)])
def test_split_arithmetic_at_danube_and_granite(window, softcap, H, KV, hd):
    """The same at h2o-danube's geometry (32 / 8 heads of 120) and
    granite-20b's (48 query heads of 128 on one KV head)."""
    _split_arithmetic(H, KV, hd, window, softcap)


def _split_arithmetic(H, KV, hd, window, softcap):
    rng = np.random.default_rng(3)
    B, T = 4, 16
    seq_lens = [1, 63, 300, 700]
    n = [-(-s // T) for s in seq_lens]
    P = sum(n) + 1
    ids = rng.permutation(np.arange(1, P))
    pt = np.zeros((B, max(n)), np.int32)
    used = 0
    for b, c in enumerate(n):
        pt[b, :c] = ids[used:used + c]
        used += c
    q, kp, vp = (torch.from_numpy(
        (rng.standard_normal(s) * 0.5).astype(np.float32))
        for s in ((B, H, hd), (P, T, KV, hd), (P, T, KV, hd)))
    pt, sl = torch.from_numpy(pt), torch.tensor(seq_lens, dtype=torch.int32)
    kw = dict(scale=hd ** -0.5, window=window, softcap=softcap)
    got = _split_decode(q, kp, vp, pt, sl, L=64, **kw)
    want = pa.paged_attention_plain(q, kp, vp, pt, sl, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
