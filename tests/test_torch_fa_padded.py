"""flash_attention's tensor-core rule at padded head dims, on the CPU.

bf16 takes the tensor-core kernel (``fa_tc`` in
``src/repro_torch/csrc/flash_attention.cuh``, dispatched by
``flash_attention.cu``) at every (hd, dv) whose
entries are multiples of 8, at most 256, and round up to one of the
kernel's instantiations (``kernels/flash_attention.py::TC_HEAD_DIMS``):
TMA reads q, k and v at their real widths and zero-fills each 64-column
box past them. No card is needed to check what that design rests on:

  * the rule: every config the port carries maps its bf16 prefill pair to
    "tc", and the ``.cu`` dispatch (read as text, as
    ``tests/test_torch_gemm_schedule.py`` reads ``sm90_gemm.cuh``) takes
    exactly the pairs ``path`` sends there, with a k-step count for each,
    each pair's entry compiled in a source of its own;
  * the premise, through the plain version in float32: q, k and v
    zero-padded to the padded widths give the unpadded output in the dv
    real columns (within 1e-6 of the largest value: only the order of the
    sums differs) and exact zeros past them, with the caller's scale,
    under every mask;
  * the function at these head dims is the JAX package's: the port's
    plain version against the Pallas kernel in interpret mode at hd 112
    and 120 (rtol = atol = 1e-5 fp32, 2e-2 bf16, as
    ``tests/test_torch_flash_attention.py``).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
SOURCE = CSRC / "flash_attention.cu"        # the C entry and its dispatch
HEADER = CSRC / "flash_attention.cuh"       # the kernels and run_tc
# (hd, dv) padded on the tensor cores: hubert's 80, zamba2's 112,
# h2o-danube's 120 (to 128), the reduced MLA's (48, 32) (to 64)
PADDED = [(80, 80), (112, 112), (120, 120), (48, 32)]
# (causal, window, softcap, chunk)
MASKS = [(True, None, None, None), (True, 7, None, None),
         (True, None, 30.0, None), (False, None, None, None),
         (True, None, None, 16), (True, 20, 50.0, 24)]


def _prefill_pair(cfg):
    """The (hd, dv) of a config's prefill attention, or None where it has
    no attention layer (rwkv6)."""
    if not set(cfg.layer_kinds()) - {"rwkv6", "mamba2"}:
        return None
    if cfg.mla is not None:
        m = cfg.mla
        return (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim)
    return (cfg.resolved_head_dim, cfg.resolved_head_dim)


def _dispatch():
    """(the (HD, HDV) instantiations repro_flash_attention dispatches to,
    run_tc's k-step offsets, the entry's text), read from the sources."""
    text = SOURCE.read_text()
    entry = text[text.index('extern "C" int repro_flash_attention'):]
    pairs = []
    for m in re.finditer(r"if \(w_hd == (\d+) && w_dv == (\d+)\) \{\s*"
                         r"return repro_fa_tc_(\d+)_(\d+)\(", entry):
        a, b, c, d = map(int, m.groups())
        assert (a, b) == (c, d), m.group(0)
        pairs.append((a, b))
    text = HEADER.read_text()
    body = text[text.index("int run_tc("):text.index("template <typename T, "
                                                     "int HD, int HDV>\nint "
                                                     "launch_simt")]
    offsets = set()
    for m in re.finditer(r"case (-?\d+):\s*return launch_tc<HD, HDV, "
                         r"HD / 16( - (\d+))?>", body):
        off = int(m.group(1))
        assert -off == int(m.group(3) or 0), m.group(0)
        offsets.add(off)
    return pairs, offsets, entry


def _cu_takes(hd, dv, pairs):
    """The .cu dispatch's gate, as its text states it."""
    return (hd % 8 == 0 and dv % 8 == 0
            and ((hd + 63) // 64 * 64, (dv + 63) // 64 * 64) in pairs)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_config_prefills_on_the_tensor_cores(name):
    """Each config with attention, at its published widths and reduced,
    takes the tensor cores in bf16, and in fp32 three-pass TF32 where its
    pair rounds up to (64, 64) or (128, 128) (the CUDA cores at gemma2's
    256 and deepseek's (192, 128)); its pair's padded widths are an
    instantiation the dispatch reaches."""
    pairs, _, _ = _dispatch()
    for cfg in (ARCHS[name], ARCHS[name].reduced()):
        pair = _prefill_pair(cfg)
        if pair is None:
            assert name == "rwkv6-3b"
            continue
        assert fa.path(torch.bfloat16, *pair) == "tc", (cfg.name, pair)
        want = ("tf32x3" if fa.tc_widths(*pair) in fa.TF32_HEAD_DIMS
                else "simt")
        assert fa.path(torch.float32, *pair) == want, (cfg.name, pair)
        assert fa.tc_widths(*pair) in pairs, (cfg.name, pair)


def test_the_configs_pairs_are_the_expected_ones():
    got = {name: _prefill_pair(cfg) for name, cfg in ARCHS.items()}
    assert got["hubert-xlarge"] == (80, 80)
    assert got["zamba2-7b"] == (112, 112)
    assert got["h2o-danube-3-4b"] == (120, 120)
    assert got["deepseek-v2-lite-16b"] == (192, 128)
    assert _prefill_pair(ARCHS["deepseek-v2-lite-16b"].reduced()) == (48, 32)
    assert got["rwkv6-3b"] is None


def test_dispatch_takes_exactly_the_rule():
    """The instantiations the .cu dispatches to are TC_HEAD_DIMS, its gate
    accepts a bf16 (hd, dv) of 1..256 iff ``path`` says "tc", and run_tc
    has a k-step count for every hd it is handed."""
    pairs, offsets, entry = _dispatch()
    assert sorted(pairs) == sorted(fa.TC_HEAD_DIMS)
    assert "hd % 8 != 0 || dv % 8 != 0" in entry
    assert "(hd + 63) / 64 * 64" in entry and "(dv + 63) / 64 * 64" in entry
    assert fa.TC_ALIGN == 8
    n_tc = 0
    for hd in range(1, fa.MAX_HEAD_DIM + 1):
        for dv in range(1, fa.MAX_HEAD_DIM + 1):
            tc = fa.path(torch.bfloat16, hd, dv) == "tc"
            assert tc == _cu_takes(hd, dv, pairs), (hd, dv)
            if tc:
                HD = fa.tc_widths(hd, dv)[0]
                assert -(-hd // 16) - HD // 16 in offsets, (hd, dv)
                n_tc += 1
    # 8 hd x 8 dv at (64, 64) and (128, 128), 8 x 8 at (256, 256) (hd
    # 200..256) and 8 x 8 at (192, 128)
    assert n_tc == 4 * 64



def test_each_instantiation_compiles_in_a_source_of_its_own():
    """The build runs one nvcc per source, all at once: each tensor-core
    instantiation the dispatch reaches (bf16's and fp32's three-pass TF32),
    and the CUDA-core kernel in each dtype, is defined by exactly one
    source apart from the dispatch, which instantiates no kernel itself;
    the header declares every entry."""
    pairs, _, _ = _dispatch()
    header = HEADER.read_text()
    defined = {}
    for src in sorted(CSRC.glob("flash_attention*.cu")):
        for m in re.finditer(r'extern "C" int (repro_fa_\w+)\(REPRO_FA_PARAMS\)'
                             r" \{\s*return (run_tc<(\d+), (\d+)>|"
                             r"run_tf32<(\d+), (\d+)>|"
                             r"run_simt<(float|__nv_bfloat16)>)\(",
                             src.read_text()):
            assert m.group(1) not in defined, m.group(1)
            defined[m.group(1)] = (src.name, m.group(2))
            assert f"int {m.group(1)}(REPRO_FA_PARAMS);" in header
    assert "run_tc<" not in SOURCE.read_text()
    assert "run_simt<" not in SOURCE.read_text()
    assert "run_tf32<" not in SOURCE.read_text()
    for a, b in pairs:
        name, call = defined[f"repro_fa_tc_{a}_{b}"]
        assert call == f"run_tc<{a}, {b}>" and name != SOURCE.name
    for a, b in fa.TF32_HEAD_DIMS:
        name, call = defined[f"repro_fa_tf32_{a}_{b}"]
        assert call == f"run_tf32<{a}, {b}>" and name != SOURCE.name
    assert defined["repro_fa_simt_fp32"][1] == "run_simt<float>"
    assert defined["repro_fa_simt_bf16"][1] == "run_simt<__nv_bfloat16>"
    files = {name for name, _ in defined.values()}
    assert len(files) == len(pairs) + len(fa.TF32_HEAD_DIMS) + 2


def test_tf32_dispatch_takes_exactly_the_rule():
    """The .cu's three-pass TF32 gate (path 2: fp32, hd and dv multiples of
    4, widths rounded up to 64 one of its instantiations) accepts an fp32
    (hd, dv) of 1..256 iff ``path`` says "tf32x3"."""
    text = SOURCE.read_text()
    entry = text[text.index('extern "C" int repro_flash_attention'):]
    gate = entry[entry.index("if (path == PATH_TF32)"):]
    gate = gate[:gate.index("if (path != PATH_SIMT)")]
    assert "dtype != 0 || hd % 4 != 0 || dv % 4 != 0" in gate
    pairs = []
    for m in re.finditer(r"if \(w_hd == (\d+) && w_dv == (\d+)\) \{\s*"
                         r"return repro_fa_tf32_(\d+)_(\d+)\(", gate):
        a, b, c, d = map(int, m.groups())
        assert (a, b) == (c, d), m.group(0)
        pairs.append((a, b))
    assert sorted(pairs) == sorted(fa.TF32_HEAD_DIMS)
    assert fa.PATHS["tf32x3"] == 2 and "PATH_TF32 = 2;" in HEADER.read_text()
    for hd in range(1, fa.MAX_HEAD_DIM + 1):
        for dv in range(1, fa.MAX_HEAD_DIM + 1):
            takes = (hd % 4 == 0 and dv % 4 == 0
                     and fa.tc_widths(hd, dv) in pairs)
            assert (fa.path(torch.float32, hd, dv) == "tf32x3") == takes

def _inputs(B, S, H, KV, hd, dv, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((rng.standard_normal((B, S, n, d)) * 0.5)
                                .astype(np.float32))
               for n, d in ((H, hd), (KV, hd), (KV, dv)))
    pos = torch.from_numpy(np.stack([rng.permutation(S) for _ in range(B)]))
    return q, k, v, pos


def _pad(t, width):
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


@pytest.mark.parametrize("causal,window,softcap,chunk", MASKS)
@pytest.mark.parametrize("hd,dv", PADDED)
def test_zero_padding_keeps_the_output(hd, dv, causal, window, softcap,
                                       chunk):
    """What the kernel computes at the padded widths, in float32 through
    the plain version: zero columns of q and k add nothing to a score, the
    scale stays the caller's, zero columns of v give zero output columns;
    GQA 4 / 2 heads and shuffled positions."""
    B, S, H, KV = 2, 70, 4, 2
    q, k, v, pos = _inputs(B, S, H, KV, hd, dv, hd + dv)
    w_hd, w_dv = fa.tc_widths(hd, dv)
    assert (w_hd, w_dv) in fa.TC_HEAD_DIMS and (w_hd, w_dv) != (hd, dv)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap, chunk=chunk)
    want = fa.flash_attention_plain(q, k, v, pos, **kw)
    got = fa.flash_attention_plain(_pad(q, w_hd), _pad(k, w_hd),
                                   _pad(v, w_dv), pos, **kw)
    assert tuple(got.shape) == (B, S, H, w_dv)
    err = (got[..., :dv] - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item(), err
    assert torch.count_nonzero(got[..., dv:]) == 0


def _to_bh(a, G):
    a = np.repeat(a, G, axis=2)
    B, S, H, hd = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


@pytest.mark.parametrize("hd", [112, 120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 64, 30.0), (False, None, None)])
def test_plain_matches_pallas_interpret_at_padded_head_dims(
        hd, dtype, causal, window, softcap):
    """The TPU kernel blocks over the full hd, so it runs these head dims
    as they are; the port's plain version computes the same function."""
    B, S, H, KV = 1, 256, 4, 2
    rng = np.random.default_rng(hd)
    q, k, v = ((rng.standard_normal((B, S, n, hd)) * 0.5).astype(np.float32)
               for n in (H, KV, KV))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)
    got = fa.flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.arange(S).expand(B, S), **kw).float().numpy()
    args = [jnp.asarray(_to_bh(a, g)).astype(jdt)
            for a, g in ((q, 1), (k, H // KV), (v, H // KV))]
    out = ref_flash(*args, block_q=128, block_k=128, interpret=True, **kw)
    want = (np.asarray(out.astype(jnp.float32)).reshape(B, H, S, hd)
            .transpose(0, 2, 1, 3))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
