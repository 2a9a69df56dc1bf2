"""paged_attention at the head geometries the port's kernel took last:
h2o-danube-3-4b's head dim 120 (32 query heads over 8 KV heads) and
granite-20b's multi-query attention (48 query heads over one KV head, head
dim 128), with the plan the kernel follows at those shapes.

The plain version against the JAX package's oracle and its Pallas kernel in
interpret mode, on the same numpy inputs from a seed: ragged sequence
lengths, a shuffled page table padded with page 0, with and without a
sliding window or a softcap. Tolerance: 1e-5 (float32; the sums run in
another order). The CUDA kernel at these shapes is held to the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.paged_attention import \
    paged_attention as pallas_paged_attention  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "paged_attention.cu")

# (H, KV, hd): h2o-danube-3-4b's and granite-20b's decode attention
DANUBE = (32, 8, 120)
GRANITE = (48, 1, 128)


def _inputs(seed, H, KV, hd, T, seq_lens, pad_cols):
    """q, pools (page 0 the zero page), a shuffled page table with
    ``pad_cols`` columns of page 0 past the longest sequence, seq_lens."""
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    n = [-(-s // T) for s in seq_lens]
    P = sum(n) + 2
    q = (rng.standard_normal((B, H, hd)) * 0.5).astype(np.float32)
    kp = (rng.standard_normal((P, T, KV, hd)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal((P, T, KV, hd)) * 0.5).astype(np.float32)
    kp[0] = 0
    vp[0] = 0
    ids = rng.permutation(np.arange(1, P))
    pt = np.zeros((B, max(n) + pad_cols), np.int32)
    used = 0
    for b, k in enumerate(n):
        pt[b, :k] = ids[used:used + k]
        used += k
    return q, kp, vp, pt, np.asarray(seq_lens, np.int32)


def _check(arrays, **kw):
    got = pa.paged_attention_plain(*(torch.from_numpy(a) for a in arrays),
                                   **kw)
    jx = [jnp.asarray(a) for a in arrays]
    for want in (ref.paged_attention_ref(*jx, **kw),
                 pallas_paged_attention(*jx, interpret=True, **kw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a CPU tensor takes the plain version through the wrapper
    wrapped = pa.paged_attention(*(torch.from_numpy(a) for a in arrays),
                                 **kw)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("window", [None, 7])
def test_danube_head_dim_120_matches_reference(window):
    """hd 120, 32 / 8 heads (G 4), pages of 4, ragged contexts of 1 to 29
    tokens, two padding columns; window 7 skips whole pages of the long
    rows."""
    H, KV, hd = DANUBE
    arrays = _inputs(0, H, KV, hd, 4, [29, 1, 13], 2)
    _check(arrays, window=window)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_granite_mqa_48_heads_matches_reference(softcap):
    """hd 128, 48 query heads on one KV head (G 48: six groups of 8 on the
    card), pages of 8, ragged contexts, one padding column, the softcap
    before the mask."""
    H, KV, hd = GRANITE
    arrays = _inputs(1, H, KV, hd, 8, [5, 23, 16, 40], 1)
    _check(arrays, softcap=softcap, scale=hd ** -0.5)


@pytest.mark.parametrize("hd,width", [(8, 64), (64, 64), (72, 128),
                                      (120, 128), (128, 128), (136, 256),
                                      (256, 256)])
def test_padded_head_dim(hd, width):
    """Every multiple of 8 up to 256 runs at the smallest compiled row
    width that holds it."""
    assert pa.padded_head_dim(hd) == width


@pytest.mark.parametrize("hd", [0, 36, 121, 264, 512])
def test_padded_head_dim_refuses(hd):
    """A head dim that is not a multiple of 8 (16-byte rows in bf16), or
    above 256, has no row width: the wrapper raises on the card."""
    with pytest.raises(ValueError, match="multiple of 8"):
        pa.padded_head_dim(hd)


def test_plan_at_danube_head_dim_120():
    """hd 120 plans as the row width 128 does: a stage of 64 bf16 / 32
    fp32 tokens, splits of 64 on pages of 16 (PAGE_TOKENS), so the
    4,000-token prompt decoding past its 4,096 window takes 64 splits (65
    at the widest page table) and 8 x 64 x 4 x 122 floats of scratch a
    sequence."""
    for dtype, chunk in ((torch.bfloat16, 64), (torch.float32, 32)):
        assert pa.chunk_tokens(120, dtype) == chunk
        assert pa.chunk_tokens(120, dtype) == pa.chunk_tokens(128, dtype)
        L = pa.split_len(120, dtype, 16)
        assert L == 64 == pa.split_len(128, dtype, 16)
        NP = -(-4100 // 16)
        assert pa.max_splits(NP, 16, L) == 65
        bounds = pa.split_bounds(4100, 4096, L, NP * 16)
        assert bounds[0] == (4, 68) and bounds[-1] == (4036, 4100)
        assert len(bounds) == 64
        assert pa.scratch_floats(1, 8, 4, 120, NP, 16, L) == \
            8 * 65 * 4 * 122


def test_groups_of_query_heads():
    """G query heads a KV head take ceil(G / 8) blocks of up to 8 heads:
    granite's 48 six, h2o-danube's 4 and qwen's 8 one; the scratch indexes
    every head of the KV head (G, not a group's 8)."""
    assert pa.GROUP == 8
    assert [pa.groups(G) for G in (1, 4, 8, 9, 12, 48)] == [1, 1, 1, 2, 2, 6]
    L = pa.split_len(128, torch.bfloat16, 16)
    assert pa.scratch_floats(3, 1, 48, 128, 20, 16, L) == \
        3 * 1 * 5 * 48 * 130


def test_kernel_source_follows_the_plan():
    """The host plan and ``csrc/paged_attention.cu`` name the same
    constants: the row widths of the hd dispatch, the heads a block, a
    ring stage's bytes and the tokens it caps at."""
    src = SOURCE.read_text()
    widths = [int(w) for w in re.findall(r"return launch_hd<DT, (\d+)>", src)]
    assert tuple(widths) == pa.ROW_WIDTHS
    bounds = [int(w) for w in re.findall(r"if \(hd <= (\d+)\) return "
                                         r"launch_hd<DT, (?:\d+)>", src)]
    assert bounds == list(pa.ROW_WIDTHS[:-1])
    assert re.search(r"hd % 8 != 0 \|\| hd > 256", src)
    assert int(re.search(r"constexpr int MAX_G = (\d+);", src).group(1)) \
        == pa.GROUP
    chunk = re.search(r"CHUNK = (\d+) / \(HD \* ES\) < (\d+)", src)
    assert int(chunk.group(1)) == pa.STAGE_BYTES
    assert int(chunk.group(2)) == 64
    assert math.gcd(*pa.ROW_WIDTHS) == 64
