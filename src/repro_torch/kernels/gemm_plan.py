"""Launch plan of the weight-streaming matmuls ``swap_linear`` and
``swap_linear_q``: a pure function of the call's shape, dtypes and
pointer alignment, computed by the wrappers and handed to the CUDA core in
``csrc/sm90_gemm.cuh``. This is the one place that decides; the core only
checks that it can run the plan (its tiles and codes are this module's).

- ``core``: from (x dtype, weight kind) alone. bf16 x runs the tensor
  cores (``wgmma``, 128-column tiles of 128 or 64 rows, 64-deep k-steps,
  a 4-stage TMA ring); fp32 x with an fp32 weight runs them too, in
  three-pass TF32 (``tf32x3``: ``mma.sync`` with each operand split into
  TF32 hi and lo, within 1e-5 of fp32; 128-column tiles of 16 rows for
  M <= 16, else 128 once such tiles fill the card twice, else 64; 32-deep
  k-steps, a 4-stage ``cp.async`` ring); fp32
  x with an int8 or int4 weight runs the CUDA cores in fp32 (``simt``:
  32-deep k-steps, a row tile of 8 for M <= 8, else 64).
- ``splits`` and ``split_bounds``: K cut into equal k-tile runs so that
  decode (one row tile) has about one block per SM (two on the TF32 core,
  whose 16-row decode tiles run up to three to an SM). They set the order of
  every output's sum, so they depend on (N, K, core) alone, never on M:
  row i of an M-row call equals the 1-row call on that row bitwise.
- ``combine``: where the splits' sums meet. While the split blocks stay
  within two waves, one split per block into fp32 scratch, added in order
  by the last block of each output tile to finish (``blocks``: one row
  tile, as at decode) or by a second kernel over the whole output
  (``pass``: several row tiles, whose sums the last blocks alone would add
  on too few SMs). ``serial`` past two waves (a block walks its splits in
  the same order), ``none`` for one split. It may follow M: all give the
  same bits.
- ``route``: ``tma`` (bf16 x) or ``cp.async`` (fp32 x) where the rows and
  bases are 16-byte aligned, ``plain`` (masked loads into the same tiles)
  where they are not. It follows alignment and never M.
"""
from __future__ import annotations

from dataclasses import dataclass

NUM_SMS = 132               # H100 SXM
PLAN_BLOCK_N = 128          # the column tile the split count is sized for
MIN_SPLIT_K = 256           # the fewest k a split may cover
SMEM_LIMIT = 227 * 1024     # shared memory one block may use on Hopper

# tensor-core core (bf16 x)
TC_BLOCK_M, TC_BLOCK_N, TC_BLOCK_K, TC_STAGES = 128, 128, 64, 4
# three-pass TF32 core (fp32 x, fp32 weight): row tiles, 128 columns,
# 32-deep k-steps, stages by row tile; x rows padded to 40 floats, weight
# rows to 132; the outputs' sums over serial splits in shared memory;
# decode runs three blocks to an SM, and its splits size for two waves
TF32_BLOCK_MS, TF32_BLOCK_N, TF32_BLOCK_K = (16, 64, 128), 128, 32
TF32_STAGES = {16: 3, 64: 4, 128: 4}
TF32_XLD, TF32_WLD = 40, 132
TF32_THREADS, TF32_WAVES = 256, 2
# CUDA-core core (fp32 x, quantized weight): block_m -> (block_n, stages)
SIMT_BLOCK_K = 32
SIMT_TILES = {8: (128, 4), 64: (64, 3)}

WEIGHTS = ("bf16", "fp32", "int8", "int4")
ROUTE_CODES = {"tma": 0, "cp.async": 0, "plain": 1}
COMBINE_CODES = {"none": 0, "serial": 1, "blocks": 2, "pass": 3}


@dataclass(frozen=True)
class GemmPlan:
    core: str               # "wgmma", "tf32x3" or "simt"
    weight: str             # one of WEIGHTS
    block_m: int
    block_n: int
    block_k: int
    splits: int
    split_bounds: tuple     # splits + 1 k offsets, 0 ... K
    combine: str            # "none", "serial", "blocks" or "pass"
    route: str              # "tma", "cp.async" or "plain"
    grid: tuple             # (row tiles, column tiles, splits run apart)
    scratch_bytes: int      # fp32 partial sums the wrapper allocates
    smem_bytes: int         # dynamic shared memory of one block

    @property
    def order(self) -> tuple:
        """What sets the order of an output's sum: equal for every M."""
        return (self.core, self.weight, self.block_k, self.splits,
                self.split_bounds)

    @property
    def combine_code(self) -> int:
        return COMBINE_CODES[self.combine]

    @property
    def route_code(self) -> int:
        return ROUTE_CODES[self.route]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def core_of(x_dtype: str, weight: str) -> str:
    """The core a call runs: "wgmma" for bf16 x, "tf32x3" for fp32 x with
    an fp32 weight, "simt" for fp32 x with an int8 or int4 one."""
    if weight not in WEIGHTS:
        raise ValueError(f"weight must be one of {WEIGHTS}, got {weight!r}")
    if x_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"x must be float32 or bfloat16, got {x_dtype}")
    if weight in ("bf16", "fp32") and weight != {"bfloat16": "bf16",
                                                  "float32": "fp32"}[x_dtype]:
        raise ValueError(f"a {weight} weight needs x of its dtype, "
                         f"got {x_dtype}")
    if x_dtype == "bfloat16":
        return "wgmma"
    return "tf32x3" if weight == "fp32" else "simt"


def k_splits(N: int, K: int, block_k: int, waves: int = 1) -> int:
    """Splits of K: enough that the column tiles of one row tile give about
    ``waves`` blocks per SM, each split at least MIN_SPLIT_K deep and one
    k-tile."""
    s = max(1, waves * NUM_SMS // _cdiv(N, PLAN_BLOCK_N))
    s = min(s, max(1, K // MIN_SPLIT_K))
    return max(1, min(s, _cdiv(K, block_k)))


def split_bounds(K: int, block_k: int, splits: int) -> tuple:
    """k offsets of the splits: split s covers k-tiles
    [s * T // S, (s + 1) * T // S) of the T = ceil(K / block_k)."""
    T = _cdiv(K, block_k)
    return tuple(min(K, (s * T // splits) * block_k)
                 for s in range(splits + 1))


def smem_bytes(core: str, weight: str, block_m: int) -> int:
    """Dynamic shared memory of one block: the ring's stages (x tile and
    weight tile, the latter still quantized for int8 / int4) plus, on the
    bf16 tensor cores, the two bf16 tiles a quantized weight is widened
    into (mbarriers and alignment slack not counted)."""
    if core == "tf32x3":
        x = block_m * TF32_XLD * 4
        w = TF32_BLOCK_K * TF32_WLD * 4
        tot = block_m * TF32_BLOCK_N * 4       # the serial splits' sums
        return TF32_STAGES[block_m] * (x + w) + tot
    if core == "wgmma":
        x = block_m * TC_BLOCK_K * 2
        w = {"bf16": TC_BLOCK_K * TC_BLOCK_N * 2,
             "int8": TC_BLOCK_K * TC_BLOCK_N,
             "int4": TC_BLOCK_K // 2 * TC_BLOCK_N}[weight]
        wide = 0 if weight == "bf16" else 2 * TC_BLOCK_K * TC_BLOCK_N * 2
        return TC_STAGES * (x + w) + wide
    block_n, stages = SIMT_TILES[block_m]
    x = block_m * (SIMT_BLOCK_K + 4) * 4
    w = {"int8": SIMT_BLOCK_K * block_n,
         "int4": SIMT_BLOCK_K // 2 * block_n}[weight]
    return stages * (x + w)


def combine_in_blocks(tiles: int, splits: int) -> bool:
    """Run the splits apart (one split per block into fp32 partials) while
    the split blocks stay within two waves, as at decode; past that the
    output tiles keep the SMs busy themselves and the partials' traffic
    costs more than the idle SMs it would fill. With two splits or more
    that leaves at most NUM_SMS output tiles, one arrival count each."""
    return tiles * splits <= 2 * NUM_SMS


def block_shape(M: int, N: int, x_dtype: str, weight: str) -> tuple:
    """(block_m, block_n, block_k) of the core that takes (x_dtype,
    weight) for an [M, K] x [K, N] call. Only the row tile follows M, and
    a row's arithmetic is the same in every row tile: on the bf16 tensor
    cores 128 rows (two consumer warpgroups) once such tiles fill the card,
    else 64; on the TF32 core 16 rows (one m16 tile) for M <= 16, else
    128 once such tiles fill the card twice, else 64; on the CUDA cores 8
    rows for M <= 8, else 64."""
    core = core_of(x_dtype, weight)
    if core == "wgmma":
        tiles = _cdiv(M, TC_BLOCK_M) * _cdiv(N, TC_BLOCK_N)
        bm = TC_BLOCK_M if tiles >= NUM_SMS else TC_BLOCK_M // 2
        return bm, TC_BLOCK_N, TC_BLOCK_K
    if core == "tf32x3":
        small, mid, big = TF32_BLOCK_MS
        if M <= small:
            bm = small
        else:
            tiles = _cdiv(M, big) * _cdiv(N, TF32_BLOCK_N)
            bm = big if tiles >= TF32_WAVES * NUM_SMS else mid
        return bm, TF32_BLOCK_N, TF32_BLOCK_K
    bm = 8 if M <= 8 else 64
    return bm, SIMT_TILES[bm][0], SIMT_BLOCK_K


def fast_route_ok(N: int, K: int, x_dtype: str, weight: str,
                  x_ptr: int, w_ptr: int) -> bool:
    """TMA / cp.async need 16-byte aligned bases and row strides."""
    if x_ptr % 16 or w_ptr % 16:
        return False
    per16 = {"bf16": 8, "fp32": 4, "int8": 16, "int4": 16}[weight]
    if N % per16:
        return False
    if core_of(x_dtype, weight) == "wgmma":
        return K > 0 and K % 8 == 0     # TMA: a non-empty row of 16-byte steps
    return K % 4 == 0


def plan(M: int, N: int, K: int, x_dtype: str, weight: str,
         x_ptr: int = 0, w_ptr: int = 0) -> GemmPlan:
    """The launch plan for x [M, K] (``x_dtype`` "float32" or "bfloat16")
    times a [K, N] weight (``weight`` "bf16" / "fp32" in x's dtype, or
    "int8" / "int4" quantized), with x and the weight at the given device
    addresses."""
    core = core_of(x_dtype, weight)
    if M <= 0 or N <= 0 or K < 0:
        raise ValueError(f"bad shape M={M} N={N} K={K}")
    bm, bn, bk = block_shape(M, N, x_dtype, weight)
    splits = k_splits(N, K, bk, TF32_WAVES if core == "tf32x3" else 1)
    tiles = (_cdiv(M, bm), _cdiv(N, bn))
    if splits == 1:
        combine = "none"
    elif combine_in_blocks(tiles[0] * tiles[1], splits):
        combine = "blocks" if tiles[0] == 1 else "pass"
    else:
        combine = "serial"
    fast = fast_route_ok(N, K, x_dtype, weight, x_ptr, w_ptr)
    route = ("tma" if core == "wgmma" else "cp.async") if fast else "plain"
    apart = combine in ("blocks", "pass")
    scratch = splits * M * _cdiv(N, 4) * 4 * 4 if apart else 0
    return GemmPlan(core=core, weight=weight, block_m=bm, block_n=bn,
                    block_k=bk, splits=splits,
                    split_bounds=split_bounds(K, bk, splits),
                    combine=combine, route=route,
                    grid=tiles + (splits if apart else 1,),
                    scratch_bytes=scratch,
                    smem_bytes=smem_bytes(core, weight, bm))


def weight_stream_bytes(M: int, K: int, N: int, x_dtype: str,
                        weight: str) -> int:
    """Device-memory weight traffic of one call: every weight tile is read
    once per row tile (the L2 cache may serve some of the re-reads), so one
    row tile streams the weight once, K * N at its stored width."""
    bm = block_shape(M, N, x_dtype, weight)[0]
    stored = {"bf16": 2 * K, "fp32": 4 * K, "int8": K,
              "int4": _cdiv(K, 2)}[weight]
    return _cdiv(M, bm) * stored * N
