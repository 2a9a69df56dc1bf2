"""Device time of swap_linear (B5) in fp32 at the main paths' fp32 shapes,
for one checkout of the PyTorch port: an A/B of two checkouts on one card.

Loads the checkout's ``chip_smoke.py`` (its CUDA-event timer) and its
``repro_torch`` (the kernels built into the checkout's own ``build/``),
then times ``swap_linear`` on seeded fp32 inputs at every row below, the
median of three timed runs, and prints one line a row: the checkout, the
row and the device ms. The rows are the fp32 linears ``chip_smoke.py``
times: h2o-danube-3-4b's paged run (phase 19: M 4,000, 40, 3 and 1),
qwen2.5-3b's run A decode (phase 4, M 2), rwkv6-3b's time-mix output
projection (phase 5, M 1,024) and the conv fleets' fc layers (phase 10).
Device times move between calls, so two versions are compared within one
call, alternating: for a parent checkout ``P`` and a change ``C``::

    for d in P C C P; do python3 tools/torch_gemm_ab.py $d; done

Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import importlib.util
import statistics
import sys
from pathlib import Path

# (label, M, K, N, act, bias)
DANUBE = [(3840, 3840, "none"), (3840, 960, "none"), (3840, 10240, "silu"),
          (3840, 10240, "none"), (10240, 3840, "none")]
QWEN = [(2048, 2048, "none"), (2048, 256, "none"), (2048, 11008, "silu"),
        (2048, 11008, "none"), (11008, 2048, "none")]
ROWS = ([("h2o-danube-3-4b", M, K, N, act, False)
         for M in (4000, 40, 3, 1) for K, N, act in DANUBE]
        + [("qwen2.5-3b", 2, K, N, act, K == 2048 and N in (2048, 256))
           for K, N, act in QWEN]
        + [("rwkv6-3b wo", 1024, 2560, 2560, "none", False)]
        + [(label, M, K, N, "none", True) for label, M, K, N in (
            ("vgg_sim fc", 4, 256, 4096), ("vgg_sim fc", 4, 4096, 1024),
            ("vgg_sim fc", 4, 1024, 100), ("resnet_sim fc", 4, 256, 100),
            ("fc stack 12 x 1280", 64, 1280, 1280))])


def main(argv) -> int:
    if len(argv) != 1:
        print("usage: torch_gemm_ab.py CHECKOUT", file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("torch_gemm_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import swap_linear as sl
    _build.library()
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    for label, M, K, N, act, has_bias in ROWS:
        x = torch.randn((M, K), generator=g, device="cuda") * 0.5
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        b = (torch.randn((N,), generator=g, device="cuda") * 0.1
             if has_bias else None)
        ms = statistics.median(
            smoke.time_ms(torch, lambda: sl.swap_linear(x, w, b, act=act))
            for _ in range(3))
        print(f"{root.name} | {label} M={M} K={K} N={N} float32 act={act}"
              f"{' +bias' if has_bias else ''} | {ms:.4f} ms", flush=True)
        del x, w, b
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
