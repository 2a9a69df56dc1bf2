"""The launch plan of the port's weight-streaming matmuls (``swap_linear``
and ``swap_linear_q``, ``kernels/gemm_plan.py``), on the CPU: no card is
needed, since the plan is a pure function of the call's shape, dtypes and
pointer alignment.

What it must guarantee:
  * everything that sets the order of an output's sum (core, k-tile,
    split count and boundaries) is the same for every M at every main-path
    (N, K), so row i of an M-row call equals the 1-row call bitwise;
  * the core follows (x dtype, weight kind) alone: an fp32 weight takes
    the three-pass TF32 core at every M, decode included, and an int8 or
    int4 weight under fp32 x the CUDA cores;
  * the load route follows alignment and never M;
  * the fp32 scratch matches the split;
  * every main-path shape takes the fast route (TMA or cp.async);
  * the plan is the one place that decides: ``csrc/sm90_gemm.cuh`` takes
    its row tile and combine and shares its tiles and codes.
"""
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import gemm_plan as gp  # noqa: E402

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "sm90_gemm.cuh")
MS = (1, 2, 4, 130, 512, 4200)
# (x dtype, weight): B5 in bf16 and fp32, B1 at int8 / int4 under both
KINDS = [("bfloat16", "bf16"), ("float32", "fp32"), ("bfloat16", "int8"),
         ("bfloat16", "int4"), ("float32", "int8"), ("float32", "int4")]


def _main_path_nk():
    """(N, K) of every linear the main paths run through B1 or B5:
    qwen2.5-3b's and gemma2-9b's layers, qwen's tied head (B1, fp32) and
    rwkv6-3b's time-mix output projection."""
    out = []
    for arch in ("qwen2.5-3b", "gemma2-9b"):
        c = get_arch(arch)
        D, F, hd = c.d_model, c.d_ff, c.resolved_head_dim
        out += [(c.n_heads * hd, D), (c.n_kv_heads * hd, D),
                (D, c.n_heads * hd), (F, D), (D, F)]
    q = get_arch("qwen2.5-3b")
    r = get_arch("rwkv6-3b")
    out += [(q.vocab_size, q.d_model), (r.d_model, r.d_model)]
    return sorted(set(out))


MAIN_NK = _main_path_nk()


def test_main_path_shapes_are_the_expected_widths():
    assert (2048, 11008) in MAIN_NK and (151936, 2048) in MAIN_NK
    assert (3584, 14336) in MAIN_NK and (2560, 2560) in MAIN_NK
    assert len(MAIN_NK) == 11     # qwen's wq and attention wo share (2048, 2048)


@pytest.mark.parametrize("x_dtype,weight", KINDS)
@pytest.mark.parametrize("N,K", MAIN_NK)
def test_order_does_not_depend_on_m(N, K, x_dtype, weight):
    plans = [gp.plan(M, N, K, x_dtype, weight) for M in MS]
    assert len({p.order for p in plans}) == 1
    p = plans[0]
    waves = gp.TF32_WAVES if p.core == "tf32x3" else 1
    assert p.splits == gp.k_splits(N, K, p.block_k, waves)
    assert p.split_bounds == gp.split_bounds(K, p.block_k, p.splits)


@pytest.mark.parametrize("x_dtype,weight", KINDS)
@pytest.mark.parametrize("N,K", MAIN_NK)
def test_main_path_takes_the_fast_route(N, K, x_dtype, weight):
    fast = "tma" if x_dtype == "bfloat16" else "cp.async"
    for M in MS:
        assert gp.plan(M, N, K, x_dtype, weight, 256, 512).route == fast


@pytest.mark.parametrize("x_dtype,weight", KINDS)
@pytest.mark.parametrize("x_off,w_off", [(0, 0), (2, 0), (0, 4), (8, 8),
                                         (16, 32)])
def test_route_follows_alignment_never_m(x_dtype, weight, x_off, w_off):
    N, K = 2048, 2048
    routes = {gp.plan(M, N, K, x_dtype, weight, 1024 + x_off,
                      4096 + w_off).route for M in MS}
    assert len(routes) == 1
    aligned = x_off % 16 == 0 and w_off % 16 == 0
    fast = "tma" if x_dtype == "bfloat16" else "cp.async"
    assert routes == {fast if aligned else "plain"}


@pytest.mark.parametrize("x_dtype,weight,N,K,route", [
    ("bfloat16", "bf16", 67, 129, "plain"),     # ragged rows
    ("bfloat16", "bf16", 152, 200, "tma"),      # N % 8, K % 8
    ("bfloat16", "int8", 152, 200, "plain"),    # int8 rows need N % 16
    ("bfloat16", "int4", 160, 200, "tma"),
    ("bfloat16", "bf16", 256, 12, "plain"),     # x rows need K % 8
    ("float32", "fp32", 148, 12, "cp.async"),   # fp32 rows need N % 4, K % 4
    ("float32", "fp32", 150, 12, "plain"),
    ("float32", "int4", 144, 7, "plain"),
    ("bfloat16", "bf16", 3, 0, "plain"),        # K = 0: nothing to load
])
def test_route_follows_row_strides(x_dtype, weight, N, K, route):
    assert {gp.plan(M, N, K, x_dtype, weight).route for M in MS} == {route}


@pytest.mark.parametrize("x_dtype,weight", KINDS)
@pytest.mark.parametrize("N,K", MAIN_NK + [(67, 129), (150, 200), (3, 7)])
def test_scratch_matches_the_split(N, K, x_dtype, weight):
    for M in MS:
        p = gp.plan(M, N, K, x_dtype, weight)
        tiles = p.grid[0] * p.grid[1]
        assert p.grid[:2] == (-(-M // p.block_m), -(-N // p.block_n))
        if p.splits == 1:
            assert p.combine == "none"
        elif tiles * p.splits > 2 * gp.NUM_SMS:
            assert p.combine == "serial"
        else:
            assert p.combine == ("blocks" if p.grid[0] == 1 else "pass")
        if p.grid[0] == 1 and p.splits > 1:
            assert p.combine == "blocks"            # decode
        if p.combine == "blocks":                   # one count per tile
            assert tiles <= gp.NUM_SMS
        if p.combine in ("blocks", "pass"):
            assert p.grid[2] == p.splits
            assert p.scratch_bytes == p.splits * M * -(-N // 4) * 4 * 4
        else:
            assert p.grid[2] == 1 and p.scratch_bytes == 0
        assert 0 < p.smem_bytes <= gp.SMEM_LIMIT


@pytest.mark.parametrize("x_dtype,weight", KINDS)
@pytest.mark.parametrize("M,combine", [(1, "blocks"), (4, "blocks"),
                                       (130, "pass"), (1100, "serial")])
def test_combine_follows_row_tiles(M, combine, x_dtype, weight):
    """qwen's wk / wv (K 2048 split 8 ways at N 256): the last blocks of
    one row tile add the splits, a second pass those of several, and past
    two waves each block walks its own; the split is the same in all."""
    p = gp.plan(M, 256, 2048, x_dtype, weight)
    assert p.combine == combine and p.splits == 8


@pytest.mark.parametrize("N,K", MAIN_NK)
def test_split_bounds_cover_k(N, K):
    for bk in (gp.TC_BLOCK_K, gp.SIMT_BLOCK_K):
        s = gp.k_splits(N, K, bk)
        b = gp.split_bounds(K, bk, s)
        assert b[0] == 0 and b[-1] == K and len(b) == s + 1
        assert all(lo < hi for lo, hi in zip(b, b[1:]))
        assert all(lo % bk == 0 for lo in b[:-1])
        assert s == 1 or min(hi - lo for lo, hi in zip(b, b[1:])) >= (
            gp.MIN_SPLIT_K - bk)


@pytest.mark.parametrize("N,K", MAIN_NK)
def test_decode_fills_the_card_where_k_allows(N, K):
    """One row (decode): the column tiles times the splits reach about one
    block per SM unless K is too shallow to split further."""
    for x_dtype, weight, waves in (("bfloat16", "int8", 1),
                                   ("float32", "fp32", gp.TF32_WAVES)):
        p = gp.plan(1, N, K, x_dtype, weight)
        tiles_n = -(-N // gp.PLAN_BLOCK_N)
        assert (tiles_n * p.splits > waves * gp.NUM_SMS // 2
                or p.splits == K // gp.MIN_SPLIT_K)
        assert tiles_n * p.splits <= waves * gp.NUM_SMS or p.splits == 1


FP32_NK = [(3840, 3840), (960, 3840), (10240, 3840), (3840, 10240),
           (2048, 2048), (256, 2048), (11008, 2048), (2048, 11008),
           (2560, 2560), (4096, 256), (1024, 4096), (100, 1024), (100, 256),
           (4096, 79), (1280, 1280)]


@pytest.mark.parametrize("N,K", FP32_NK)
def test_fp32_route_does_not_depend_on_m(N, K):
    """Every fp32-weight linear the main paths launch (h2o-danube's, qwen's
    run A, rwkv6's wo, the conv fleets' fc layers and fc stack): at every M
    from 1 to 8,704 the core is the TF32 one, and block_k, the splits and
    their bounds, what sets the order of an output's sum, are the same."""
    want = gp.plan(1, N, K, "float32", "fp32")
    assert want.core == "tf32x3" and want.block_k == gp.TF32_BLOCK_K
    assert want.splits == gp.k_splits(N, K, gp.TF32_BLOCK_K, gp.TF32_WAVES)
    for M in range(1, 8705):
        p = gp.plan(M, N, K, "float32", "fp32")
        assert (p.core, p.block_k, p.splits, p.split_bounds) == (
            want.core, want.block_k, want.splits, want.split_bounds), M
        big = -(-M // 128) * -(-N // 128) >= 2 * gp.NUM_SMS
        assert p.block_m == (16 if M <= 16 else 128 if big else 64), M


@pytest.mark.parametrize("M", MS)
def test_core_follows_dtype_and_weight_kind(M):
    """bf16 x takes wgmma with every weight; fp32 x the TF32 core with an
    fp32 weight and the CUDA cores with an int8 or int4 one (B1's fp32-x
    route stays as it is)."""
    for x_dtype, weight, core in (("bfloat16", "bf16", "wgmma"),
                                  ("bfloat16", "int8", "wgmma"),
                                  ("bfloat16", "int4", "wgmma"),
                                  ("float32", "fp32", "tf32x3"),
                                  ("float32", "int8", "simt"),
                                  ("float32", "int4", "simt")):
        assert gp.core_of(x_dtype, weight) == core
        for N, K in ((2048, 2048), (151936, 2048), (67, 129)):
            assert gp.plan(M, N, K, x_dtype, weight).core == core


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        gp.plan(2, 8, 8, "float16", "int8")
    with pytest.raises(ValueError):
        gp.plan(2, 8, 8, "float32", "bf16")
    with pytest.raises(ValueError):
        gp.plan(0, 8, 8, "float32", "fp32")
    with pytest.raises(ValueError):
        gp.plan(2, 8, 8, "bfloat16", "int2")


def test_plan_mirrors_the_header():
    src = HEADER.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert (const("TC_BM"), const("TC_BN"), const("TC_BK"),
            const("TC_STAGES")) == (gp.TC_BLOCK_M, gp.TC_BLOCK_N,
                                    gp.TC_BLOCK_K, gp.TC_STAGES)
    assert const("ROUTE_FAST") == gp.ROUTE_CODES["tma"]
    assert const("ROUTE_PLAIN") == gp.ROUTE_CODES["plain"]
    assert "BM == 8 ? 128 : 64" in src and "BM == 8 ? 4 : 3" in src
    assert gp.SIMT_TILES == {8: (128, 4), 64: (64, 3)}
    assert "static constexpr int BK = 32;" in src and gp.SIMT_BLOCK_K == 32
    for name, code in gp.COMBINE_CODES.items():
        assert const(f"COMBINE_{name.upper()}") == code
    assert const("COUNTERS") == gp.NUM_SMS       # the wrapper's count buffer
    # the row tile comes from the plan: the header takes what it is given
    assert "block_m == 8) return launch_simt<WK, 8>" in src
    assert "block_m != 64 && block_m != 128" in src
    assert "M <= 8" not in src and "NUM_SMS" not in src
    for M, N in ((1, 2048), (512, 2048), (1100, 2048), (512, 11008)):
        want = 128 if -(-M // 128) * -(-N // 128) >= gp.NUM_SMS else 64
        assert gp.block_shape(M, N, "bfloat16", "bf16")[0] == want
    # the TF32 core: its tile, its row tiles from the plan, its ring
    tf = src[src.index("template <int BM> struct Tf32Tile"):]
    tf = tf[:tf.index("\n};")]
    assert "BN = 128, BK = 32;" in tf
    assert "STAGES = BM == 16 ? 3 : 4;" in tf
    assert (gp.TF32_BLOCK_N, gp.TF32_BLOCK_K) == (128, 32)
    assert gp.TF32_STAGES == {16: 3, 64: 4, 128: 4}
    assert "XLD = BK + 8;" in tf and "WLD = BN + 4;" in tf
    assert (gp.TF32_XLD, gp.TF32_WLD) == (40, 132)
    assert gp.TF32_BLOCK_MS == (16, 64, 128) and gp.TF32_THREADS == 256
    for bm in gp.TF32_BLOCK_MS:
        assert f"block_m == {bm}) return launch_tf32<{bm}>" in src
    assert "MIN_BLOCKS = BM == 16 ? 3 : 1;" in tf
    assert "STAGES * STAGE_BYTES + OUTS * SIMT_THREADS * 4;" in tf
    assert gp.smem_bytes("tf32x3", "fp32", 128) == (
        4 * (128 * 40 + 32 * 132) * 4 + 128 * 128 * 4)
    assert gp.smem_bytes("tf32x3", "fp32", 64) == (
        4 * (64 * 40 + 32 * 132) * 4 + 64 * 128 * 4)
    assert 3 * gp.smem_bytes("tf32x3", "fp32", 16) <= gp.SMEM_LIMIT
    # an fp32 weight reaches the TF32 core only: no fp32-weight simt_gemm
    assert "run_simt<W_FP>" not in src
    assert 'static_assert(WK != W_FP, "an fp32 weight takes the TF32 core")' \
        in src
    entry = (HEADER.parent / "swap_linear.cu").read_text()
    assert "if (dtype == 0) return run_tf32(a, block_m, route, st);" in entry
    assert "run_simt" not in entry
    assert "(long long)s * ktiles) / splits" in src


def test_weight_stream_is_one_pass_per_row_tile():
    K, N = 2048, 256
    for x_dtype, weight, per_k in (("bfloat16", "bf16", 2),
                                   ("float32", "fp32", 4),
                                   ("bfloat16", "int8", 1),
                                   ("float32", "int4", 0.5)):
        assert gp.weight_stream_bytes(1, K, N, x_dtype, weight) == K * N * per_k
        for M in MS:
            tiles = -(-M // gp.block_shape(M, N, x_dtype, weight)[0])
            assert (gp.weight_stream_bytes(M, K, N, x_dtype, weight)
                    == tiles * K * N * per_k)
    assert gp.weight_stream_bytes(3, 7, 5, "bfloat16", "int4") == 4 * 5
