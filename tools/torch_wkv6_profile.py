"""Where a chunk's time goes inside the wkv6 kernel, role by role.

    python3 tools/torch_wkv6_profile.py

Builds an instrumented copy of ``src/repro_torch/csrc/wkv6.cu`` into
``build/wkv6_profile/`` (one ``nvcc``): ``clock64()`` marks between the
steps of each role add the cycles spent in each to per-thread sums, and
block 0 writes them out at the end. The copy is made by inserting the
marks at fixed lines of the source; a source whose lines moved makes this
script fail, not measure something else. The marks cost a few cycles each.

At rwkv6-3b's prefill (BH 80, S 512, hd 64; fp32 and bf16) and its
engine prefill (S 16), it prints
the card's name and power limit, the plain launch's device time (CUDA
events, ``chip_smoke.time_ms``) and, per chunk of block 0, the cycles of:
the decay team (waiting for the stage, step 1, its barrier), the A and IN
team (waiting, step 2 with the split of v, its barrier, step 3 and its
barrier) and each consumer warp (waiting, the two state terms on the
tensor cores, the output). Needs a CUDA card and nvcc; exits 2 without a
card.
"""
from __future__ import annotations

import ctypes
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "wkv6_profile"
# (BH, S, hd, dtype)
CASES = [(80, 512, 64, "float32"), (80, 512, 64, "bfloat16"),
         (80, 16, 64, "float32")]
ROLES = [("decay team", ["wait", "step 1", "barrier"]),
         ("A and IN team", ["wait", "step 2 + v split", "barrier",
                            "step 3", "barrier"])]


def instrument(src: str) -> str:
    """The kernel source with cycle marks (fails if an anchor moved)."""
    def at(s, anchor, text, start, after=True):
        i = s.index(anchor, start)
        i += len(anchor) if after else 0
        return s[:i] + text + s[i:]
    s = src.replace("namespace {\n",
                    "__device__ unsigned long long g_prof[64];\nnamespace {\n",
                    1)
    s = s.replace(
        "  const int warp = tid >> 5, lane = tid & 31;\n",
        "  const int warp = tid >> 5, lane = tid & 31;\n"
        "  long long pacc[8] = {};\n  long long pt = clock64();\n"
        "#define MARK(i) { const long long n_ = clock64(); "
        "pacc[i] += n_ - pt; pt = n_; }\n", 1)
    a = s.index("    // ---- decay team")
    s = at(s, "      mbar_wait(&consumed[s], ((c / DEPTH) & 1) ^ 1);\n",
           "      MARK(0)\n", a)
    s = at(s, "      named_sync(1, NA);\n", "      MARK(1)\n", a, False)
    s = at(s, "      named_sync(1, NA);\n", "      MARK(2)\n", a)
    s = at(s, "    return;\n", "    if (blockIdx.x == 0 && tid == 0) "
           "for (int e = 0; e < 3; ++e) g_prof[e] = pacc[e];\n", a, False)
    b = s.index("    // ---- A and IN team")
    s = at(s, "      mbar_wait(&decayed[s], (c / DEPTH) & 1);\n",
           "      MARK(0)\n", b)
    s = at(s, "      named_sync(2, NB);\n", "      MARK(1)\n",
           s.index("      // v split for the consumers", b), False)
    s = at(s, "      named_sync(2, NB);\n", "      MARK(2)\n",
           s.index("      // v split for the consumers", b))
    i3 = s.index("      // 3. IN", b)
    s = at(s, "      named_sync(2, NB);\n", "      MARK(3)\n", i3, False)
    s = at(s, "        if (c + DEPTH < nc) load(c + DEPTH);\n      }\n",
           "      MARK(4)\n", i3)
    s = at(s, "    return;\n", "    if (blockIdx.x == 0 && p == 0) "
           "for (int e = 0; e < 5; ++e) g_prof[3 + e] = pacc[e];\n", i3,
           False)
    c = s.index("  // ---- consumers")
    s = at(s, "    mbar_wait(&prepared[s], (c / DEPTH) & 1);\n", "    MARK(0)\n",
           c)
    s = at(s, "    // y = IN + y^T's transpose", "    MARK(1)\n", c, False)
    s = at(s, "    // the stage's hand-over terms", "    MARK(2)\n", c, False)
    s = at(s, "  float* so = s_out", "  if (blockIdx.x == 0 && lane == 0) "
           "for (int e = 0; e < 3; ++e) g_prof[16 + 4 * cw + e] = pacc[e];\n",
           c, False)
    return s + ('\nextern "C" int read_prof(void* dst) {\n'
                '  return (int)cudaMemcpyFromSymbol(dst, g_prof, '
                'sizeof(g_prof));\n}\n')


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("torch_wkv6_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6 as kw
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "wkv6_profile.cu"
    cu.write_text(instrument((csrc / "wkv6.cu").read_text()))
    lib_path = OUT / f"libwkv6_profile.{os.getpid()}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-shared", "-o", str(lib_path), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib_path.unlink()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_wkv6.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.repro_wkv6.restype = i
    lib.read_prof.argtypes = [p]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for BH, S, hd, dname in CASES:
        args = smoke.wkv6_inputs(torch, 7, BH, S, hd, dts[dname], False)
        r, k, v, w, u, _ = args
        G = kw.launch_plan(BH, hd, n_sm)
        ms = smoke.time_ms(torch, lambda: kw.wkv6(*args))
        y = torch.empty_like(r)
        s_out = torch.empty((BH, hd, hd), dtype=torch.float32, device="cuda")
        err = lib.repro_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                             w.data_ptr(), u.data_ptr(), None, y.data_ptr(),
                             s_out.data_ptr(), BH, S, hd, kw.DTYPES[r.dtype],
                             G, torch.cuda.current_stream().cuda_stream)
        smoke.require(err == 0, f"instrumented launch: CUDA error {err}")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 64)()
        smoke.require(lib.read_prof(ctypes.addressof(buf)) == 0,
                      "reading the cycle sums")
        nc = S // min(16, S)
        print(f"wkv6 BH={BH} S={S} hd={hd} {dname} groups {G}: "
              f"{ms:.4f} ms (uninstrumented); cycles a chunk, block 0:",
              flush=True)
        base = 0
        for role, steps in ROLES:
            print(f"  {role}: " + ", ".join(
                f"{name} {buf[base + e] / nc:.0f}"
                for e, name in enumerate(steps)), flush=True)
            base += len(steps)
        for cw in range(hd // G // kw.CONSUMER_COLUMNS):
            b = 16 + 4 * cw
            print(f"  consumer warp {cw}: wait {buf[b] / nc:.0f}, state "
                  f"terms {buf[b + 1] / nc:.0f}, output {buf[b + 2] / nc:.0f}",
                  flush=True)
        del args, y, s_out
    return 0


if __name__ == "__main__":
    sys.exit(main())
