"""Time the port's wkv6 kernel over every column split it takes.

    python3 tools/torch_wkv6_sweep.py

On one CUDA card, with the inputs of ``chip_smoke.py`` (``wkv6_inputs``):
for each shape in ``SHAPES`` (rwkv6-3b's prefill at batch 1, 2 and 4, its
engine prefill, bf16, the reduced config's head_dim 32) and every column
split the kernel takes at that head_dim, the kernel's device time (CUDA
events, ``chip_smoke.time_ms``) beside the split that
``kernels/wkv6.launch_plan`` picks. Each run is
first held to the plain version (``chip_smoke.TOL``) and to the planned
launch's output, bitwise: the measurement behind the plan's rule.

Prints the card's name and power limit, then one line per case. Needs a
CUDA card; exits 2 without one.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (BH, S, hd, dtype): rwkv6-3b (40 heads of 64) at batch 1, 2, 4 x 512
# tokens, its engine's 16-token prefill, bf16; the reduced config (hd 32)
SHAPES = [(80, 512, 64, "float32"), (40, 512, 64, "float32"),
          (160, 512, 64, "float32"), (80, 16, 64, "float32"),
          (80, 512, 64, "bfloat16"), (3, 48, 32, "float32")]


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("torch_wkv6_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6 as kw
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0])
    _build.library()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for BH, S, hd, dname in SHAPES:
        args = smoke.wkv6_inputs(torch, 7, BH, S, hd, dts[dname], False)
        y_p, s_p = kw.wkv6_plain(*args)
        y_0, s_0 = kw.wkv6(*args)
        plan = kw.launch_plan(BH, hd, n_sm)
        for G in kw.GROUPS:
            if hd % (G * kw.CONSUMER_COLUMNS):
                continue
            y, s = kw._wkv6(*args, G)
            for what, got, want in (("y", y, y_p), ("state", s, s_p)):
                _, rel = smoke.rel_err(torch, got, want)
                smoke.require(rel <= smoke.TOL[dname],
                              f"{(BH, S, hd, dname, G)} {what} rel err "
                              f"{rel:.3g}")
            smoke.require(torch.equal(y, y_0) and torch.equal(s, s_0),
                          f"{(BH, S, hd, dname)}: groups {G} differs from "
                          f"the plan's {plan} bitwise")
            ms = smoke.time_ms(torch, lambda: kw._wkv6(*args, G))
            mark = "  <- plan" if G == plan else ""
            print(f"wkv6 BH={BH} S={S} hd={hd} {dname} groups {G} "
                  f"({BH * G} blocks): {ms:.4f} ms{mark}", flush=True)
        del args, y_p, s_p, y_0, s_0
    return 0


if __name__ == "__main__":
    sys.exit(main())
