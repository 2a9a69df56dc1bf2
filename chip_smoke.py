#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its wall time:

1. device: the card's name and power limit (``nvidia-smi``), then the build
   of the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` call);
2. kernels: ``swap_linear_q`` and ``dequant_int8`` held against their plain
   PyTorch versions on the card at every shape the slice launches, plus
   odd and ragged shapes, and timed at the main path's shapes beside their
   plain version, a library call and the card's bound;
3. the slice: qwen2.5-3b at its published widths with the depth cut from
   36 to 4 layers and random weights from a seed; a swapped prefill of 4
   requests x 128 tokens on the mmap store and on the quantized store
   (int8 lazy, int4 lazy, int8 eager), each under a budget below the
   store's resident bytes, checked against the unswapped forward; then
   greedy decode of 2 requests x 4 tokens on the int8 lazy store.

Before the last line it prints one ``{"kernels": [...]}`` JSON line: per
kernel and main-path shape, the launches the slice made there, the error
against the plain version, and the times. The last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
then exits non-zero without that line; without CUDA it exits 2 at once.
"""
from __future__ import annotations

import os

# deterministic cuBLAS (bitwise swapped == unswapped): set before torch
# initialises CUDA
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,    # bf16 tensor cores, dense
            "float32": 67e12}      # fp32 outside the tensor cores (fp32
                                   # accuracy rules out TF32)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # max |err| / max |plain|
SLEEP_CYCLES_PER_S = 2.0e9         # >= the H100's SM clock: holds long enough

N_LAYERS = 4
BATCH, PROMPT = 4, 128
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 2, 8, 4
BUDGET_FRACTION = 0.9              # of each store's resident bytes


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str):
    """Context manager printing a phase's wall time."""
    class _P:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== phase {name}: {time.perf_counter() - self.t0:.1f} s",
                      flush=True)
    return _P()


def time_ms(torch, fn, target_s: float = 0.1) -> float:
    """Mean device time of ``fn`` over a run of launches (CUDA events).

    A sleep kernel holds the stream while the host enqueues the whole run,
    so the events time the device alone: without it a small kernel would
    be timed at Python's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0          # host + device, an upper bound
    reps = int(min(50, max(3, target_s / max(one, 1e-6))))
    hold_s = min(reps * one * 1.2 + 2e-3, 0.5)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(torch, got, want) -> tuple:
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d, d / max(scale, 1e-30)


# ---------------------------------------------------------------- kernels
def slice_linear_shapes(cfg):
    """(K, N, act, x dtype, bias) of every fused linear the slice launches,
    one entry per launch key (M, K, N, bits, dtype, act): where two linears
    share a key (wq and the attention wo at qwen's widths) the first wins."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    bias = cfg.attn_bias
    out = {}
    for K, N, act, dt, b in [(D, H * hd, "none", "bfloat16", bias),   # wq
                             (D, KV * hd, "none", "bfloat16", bias),  # wk, wv
                             (H * hd, D, "none", "bfloat16", False),  # attn wo
                             (D, F, "silu", "bfloat16", False),       # wi0
                             (D, F, "none", "bfloat16", False),       # wi1
                             (F, D, "none", "bfloat16", False),       # ffn wo
                             (D, V, "none", "float32", False)]:       # head
        out.setdefault((K, N, act, dt), b)
    return [k + (b,) for k, b in out.items()]


def check_kernels(torch, cfg):
    """Phase 2: every kernel against its plain version on the card.
    Returns the timing rows of the main-path shapes."""
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import swap_linear_q as slq

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def weights(K, N, bits):
        Kq = K if bits == 8 else (K + 1) // 2
        lo = -127 if bits == 8 else -128
        q = torch.randint(lo, 128, (Kq, N), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand((N,), generator=g, device=dev) * (2.0 / 127) / K ** 0.5
        return q, s

    # the sweep: every shape the slice launches, at every bits x dtype x
    # act x M, plus one odd shape
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kn = [(D, D), (D, cfg.n_kv_heads * cfg.resolved_head_dim), (D, F), (F, D),
          (D, V)]
    n_checked, worst = 0, {"float32": 0.0, "bfloat16": 0.0}
    for (K, N) in kn + [(129, 67)]:
        for bits in (8, 4):
            q, s = weights(K, N, bits)
            for dname, dt in dts.items():
                for M in ((3,) if K == 129 else (2, 512)):
                    x = torch.randn((M, K), generator=g, device=dev).to(dt)
                    b = (torch.randn((N,), generator=g, device=dev) * 0.1).to(dt)
                    for act in ("none", "silu", "gelu"):
                        got = slq.swap_linear_q(x, q, s, b, bits=bits, act=act)
                        want = slq.swap_linear_q_plain(x, q, s, b, bits=bits,
                                                       act=act)
                        _, rel = rel_err(torch, got, want)
                        require(bool(torch.isfinite(got).all()),
                                f"swap_linear_q non-finite at {(M, K, N)}")
                        require(rel <= TOL[dname],
                                f"swap_linear_q int{bits} {dname} {act} "
                                f"{(M, K, N)}: rel err {rel:.3g} > {TOL[dname]}")
                        worst[dname] = max(worst[dname], rel)
                        n_checked += 1
            del q, s
    print(f"swap_linear_q: {n_checked} cases match the plain version "
          f"(worst rel err fp32 {worst['float32']:.3g} <= 1e-5, "
          f"bf16 {worst['bfloat16']:.3g} <= 2e-2)", flush=True)

    n_checked = 0
    for (R, C) in [(1001, 333), (D, D), (V, D)]:
        for bits in (8, 4):
            Rq = R if bits == 8 else (R + 1) // 2
            q = torch.randint(-128, 128, (Rq, C), generator=g, device=dev,
                              dtype=torch.int8)
            s = torch.rand((C,), generator=g, device=dev)
            for od in (torch.float32, torch.bfloat16):
                got = dq.dequant_int8(q, s, od, bits=bits, rows=R)
                want = dq.dequant_int8_plain(q, s, od, bits=bits, rows=R)
                require(torch.equal(got, want),
                        f"dequant int{bits} -> {od} at {(R, C)} differs")
                n_checked += 1
    print(f"dequant_int8: {n_checked} cases bitwise equal to the plain "
          f"version", flush=True)
    torch.cuda.synchronize()

    # timing at the main path's shapes
    rows = []
    for bits, Ms in ((8, (BATCH * PROMPT, DECODE_BATCH)),
                     (4, (BATCH * PROMPT,))):
        for (K, N, act, dname, has_bias) in slice_linear_shapes(cfg):
            q, s = weights(K, N, bits)
            dt = dts[dname]
            for M in Ms:
                x = torch.randn((M, K), generator=g, device=dev).to(dt)
                b = ((torch.randn((N,), generator=g, device=dev) * 0.1).to(dt)
                     if has_bias else None)
                got = slq.swap_linear_q(x, q, s, b, bits=bits, act=act)
                want = slq.swap_linear_q_plain(x, q, s, b, bits=bits, act=act)
                err, rel = rel_err(torch, got, want)
                require(rel <= TOL[dname], f"timing case {(M, K, N)} rel {rel}")
                k_ms = time_ms(torch, lambda: slq.swap_linear_q(
                    x, q, s, b, bits=bits, act=act))
                p_ms = time_ms(torch, lambda: slq.swap_linear_q_plain(
                    x, q, s, b, bits=bits, act=act))
                # library yardstick: cuBLAS on the weight dequantized
                # beforehand (not timed), in x's dtype, + the epilogue
                vals = dq.unpack_int4_tensor(q, K) if bits == 4 else q
                w_lib = (vals.float() * s[None, :]).to(dt)
                fn = {"silu": torch.nn.functional.silu}.get(act)

                def lib():
                    r = torch.addmm(b, x, w_lib) if b is not None else x @ w_lib
                    return fn(r) if fn else r
                l_ms = time_ms(torch, lib)
                del w_lib
                xs = 2 if dname == "bfloat16" else 4
                nbytes = (M * K * xs + q.numel() + 4 * N
                          + (N * xs if b is not None else 0) + M * N * xs)
                ops = 2.0 * M * N * K
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS[dname] * 1e3
                rows.append({
                    "name": "swap_linear_q", "route": "cuda",
                    "source": "src/repro_torch/csrc/swap_linear_q.cu",
                    "replaces": "src/repro/kernels/swap_linear_q.py:44",
                    "key": (M, K, N, bits, dname, act),
                    "shape": f"M={M} K={K} N={N} int{bits} x={dname} "
                             f"act={act}",
                    "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
                    "plain_ms": p_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": l_ms})
            del q, s
    for (R, C) in [(D, D), (D, cfg.n_kv_heads * cfg.resolved_head_dim),
                   (D, F), (F, D), (V, D), (D, V)]:
        q = torch.randint(-127, 128, (R, C), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand((C,), generator=g, device=dev)
        got = dq.dequant_int8(q, s, torch.float32)
        want = dq.dequant_int8_plain(q, s, torch.float32)
        err = (got - want).abs().max().item()
        require(err == 0.0, f"dequant timing case {(R, C)}")
        k_ms = time_ms(torch, lambda: dq.dequant_int8(q, s, torch.float32))
        p_ms = time_ms(torch, lambda: dq.dequant_int8_plain(q, s,
                                                            torch.float32))
        l_ms = time_ms(torch, lambda: torch.mul(q, s))
        t_bytes = (R * C + 4 * C + 4 * R * C) / HBM_BYTES_PER_S * 1e3
        t_ops = R * C / PEAK_OPS["float32"] * 1e3
        rows.append({
            "name": "dequant_int8", "route": "cuda",
            "source": "src/repro_torch/csrc/dequant.cu",
            "replaces": "src/repro/kernels/dequant.py:42",
            "key": (R, C, 8, "float32"),
            "shape": f"R={R} C={C} int8 -> float32",
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": l_ms})
        del q, s
    for r in rows:
        print(f"  {r['name']:14s} {r['shape']:46s} kernel {r['ms']:.4f} ms  "
              f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} "
              f"ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- slice
STORES = [
    ("mmap", dict(store_backend="mmap")),
    ("int8-lazy", dict(store_backend="quant", precision="int8")),
    ("int4-lazy", dict(store_backend="quant", precision="int4")),
    ("int8-eager", dict(store_backend="quant", precision="int8",
                        store_options={"eager": True})),
]


def run_slice(torch, cfg, main_launches):
    import numpy as np
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import swap_linear_q as slq
    from repro_torch.models.transformer import Model
    from repro_torch.store.quantized_store import roundtrip

    counters = {"swap_linear_q": slq.launches, "dequant_int8": dq.launches}

    def reset():
        for c in counters.values():
            c.reset()

    def collect():
        got = {k: c.count for k, c in counters.items()}
        for k, c in counters.items():
            for key, n in c.by_shape.items():
                main_launches[k][key] = main_launches[k].get(key, 0) + n
        return got

    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(0, device="cpu")     # host: the store's source
    print(f"params: {sum(p.numel() for p in _leaves(params)) / 1e6:.1f} M "
          f"(fp32, host), init {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)),
                             dtype=torch.int32)
    batch = {"tokens": tokens}
    refs = {}
    results = {}
    for kind, opts in STORES:
        t_store = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            sm = SwappedModel(model, params, d, device="cuda", **opts)
            try:
                resident = sum(sm.store.resident_nbytes(u.name)
                               for u in sm.units)
                budget = int(BUDGET_FRACTION * resident)
                sm.engine.ledger.budget = budget          # enforced
                sm.partition(budget, DelayModel(), BATCH, PROMPT)
                require(sm.plan.n_blocks >= 3,
                        f"{kind}: {sm.plan.n_blocks} blocks < 3")
                t_build = time.perf_counter() - t_store
                sm.forward(batch)                                  # warm
                sm.engine.stats.__init__()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset()
                logits, st = sm.forward(batch)
                counts = collect()
                max_alloc = torch.cuda.max_memory_allocated()
                es = sm.engine.stats
                require(bool(torch.isfinite(logits).all()),
                        f"{kind}: non-finite logits")
                require(tuple(logits.shape) == (BATCH, 1, cfg.vocab_size),
                        f"{kind}: logits shape {tuple(logits.shape)}")
                require(es.peak_resident <= budget,
                        f"{kind}: peak ledger {es.peak_resident} > {budget}")
                if kind == "mmap":
                    direct = sm.forward_unswapped(batch)
                    require(torch.equal(logits, direct),
                            "mmap: swapped logits != unswapped logits")
                    err = (0.0, 0.0)
                else:
                    bits = 4 if kind.startswith("int4") else 8
                    if bits not in refs:
                        refs[bits] = [roundtrip(u.params, bits)
                                      for u in sm.units]
                    direct = sm.forward_unswapped(batch,
                                                  unit_params=refs[bits])
                    err = rel_err(torch, logits, direct)
                    require(err[1] <= 2e-2, f"{kind}: swapped vs unswapped "
                            f"dequantized rel err {err[1]:.3g} > 2e-2")
                units_per_pass = 7 * cfg.n_layers + 1
                if kind.endswith("lazy"):
                    require(counts["swap_linear_q"] == units_per_pass,
                            f"{kind}: swap_linear_q launched "
                            f"{counts['swap_linear_q']} times, expected "
                            f"{units_per_pass} (1 pass x (7 x {cfg.n_layers}"
                            f" + 1))")
                if kind.endswith("eager"):
                    require(counts["dequant_int8"] > 0,
                            f"{kind}: dequant_int8 never launched")
                stage = {s: es.stage_seconds(s)
                         for s in ("read", "unpack", "dispatch", "exec",
                                   "wait")}
                results[kind] = {
                    "blocks": sm.plan.n_blocks, "points": sm.plan.points,
                    "m": sm.plan.m, "latency_s": st["latency_s"],
                    "budget": budget, "resident": resident,
                    "peak_ledger": es.peak_resident,
                    "peak_device_weights": es.peak_device_weights,
                    "max_memory_allocated": max_alloc,
                    "bytes_swapped": st["bytes_swapped"],
                    "bytes_logical": st["bytes_logical"],
                    "stage_s": stage,
                    "overlap_efficiency": st["overlap_efficiency"],
                    "launches": counts, "err_vs_unswapped": err,
                    "smem_working_set": st["smem_working_set"],
                    "build_s": t_build}
                r = results[kind]
                print(f"[{kind}] blocks={r['blocks']} {r['points']} m={r['m']}"
                      f" latency {r['latency_s'] * 1e3:.1f} ms; peak ledger "
                      f"{r['peak_ledger'] / 1e9:.3f} GB <= budget "
                      f"{budget / 1e9:.3f} GB (resident {resident / 1e9:.3f}"
                      f" GB); device bytes of the resident weights "
                      f"{r['peak_device_weights'] / 1e9:.3f} GB (peak); "
                      f"max_memory_allocated {max_alloc / 1e9:.3f} GB;"
                      f" swapped {r['bytes_swapped'] / 1e9:.3f} GB "
                      f"({r['bytes_logical'] / 1e9:.3f} GB logical)",
                      flush=True)
                print(f"[{kind}] stages s: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in stage.items())
                    + f"; overlap_eff {r['overlap_efficiency']:.3f}; "
                    f"launches {counts}; err vs unswapped (abs, rel) "
                    f"{err[0]:.3g}, {err[1]:.3g}; kernel smem "
                    f"{r['smem_working_set']} B; store build "
                    f"{t_build:.1f} s", flush=True)

                if kind == "int8-lazy":
                    prompt = tokens[:DECODE_BATCH, :DECODE_PROMPT]
                    reset()
                    gen, dstats = sm.decode_loop(
                        prompt, max_new_tokens=DECODE_NEW,
                        max_len=DECODE_PROMPT + DECODE_NEW)
                    counts = collect()
                    passes = DECODE_PROMPT + DECODE_NEW - 1
                    require(counts["swap_linear_q"]
                            == passes * units_per_pass,
                            f"decode: swap_linear_q launched "
                            f"{counts['swap_linear_q']} times, expected "
                            f"{passes * units_per_pass}")
                    require(any(k[0] == DECODE_BATCH for k in
                                slq.launches.by_shape),
                            "decode: no launch at M = 2")
                    require(tuple(gen.shape) == (DECODE_BATCH, DECODE_NEW),
                            f"decode shape {tuple(gen.shape)}")
                    require(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
                            "decode: token out of range")
                    require(dstats["peak_resident_mb"] * 1e6 <= budget,
                            "decode: peak ledger over budget")
                    results["decode"] = {"tokens": gen.tolist(),
                                         "wall_s": dstats["wall_s"],
                                         "passes": passes,
                                         "launches": counts}
                    print(f"[decode int8-lazy] {DECODE_BATCH} x {DECODE_NEW} "
                          f"tokens after a {DECODE_PROMPT}-token prompt: "
                          f"{gen.tolist()}; {passes} swapped passes in "
                          f"{dstats['wall_s']:.2f} s; launches {counts}",
                          flush=True)
            finally:
                sm.close()
        torch.cuda.empty_cache()
        print(f"[{kind}] store phase {time.perf_counter() - t_store:.1f} s",
              flush=True)
    return results


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    with phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        card = smi[torch.cuda.current_device()].strip()
        print(card, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"{torch.cuda.get_device_name(0)}; devices "
              f"{torch.cuda.device_count()}", flush=True)
        t0 = time.perf_counter()
        path = _build.build()
        _build.library()
        regs = [ln.strip() for ln in _build.build_log.splitlines()
                if "registers" in ln]
        print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
              f"{path.name}; ptxas: {regs[:2]} ... ({len(regs)} variants)",
              flush=True)

    cfg = dataclasses.replace(get_arch("qwen2.5-3b"), n_layers=N_LAYERS)
    with phase("2 kernels against their plain versions"):
        rows = check_kernels(torch, cfg)

    with phase("3 the slice at full width"):
        print(f"model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads "
              f"/ {cfg.n_kv_heads} KV heads, head_dim "
              f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, qkv bias {cfg.attn_bias}, tied "
              f"{cfg.tie_embeddings}, {cfg.dtype}", flush=True)
        print(f"reduced: n_layers 36->{N_LAYERS}", flush=True)
        main_launches = {"swap_linear_q": {}, "dequant_int8": {}}
        run_slice(torch, cfg, main_launches)

    for name, per_shape in main_launches.items():
        require(sum(per_shape.values()) > 0,
                f"{name} was never launched on the main path")
    out = []
    for r in rows:
        r = dict(r)
        r["launches"] = main_launches[r["name"]].get(r.pop("key"), 0)
        out.append(r)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
