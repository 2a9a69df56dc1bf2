"""Device time of flash_attention (B4) at ``chip_smoke.py``'s timed rows,
for one checkout of the PyTorch port: an A/B of two checkouts on one card.

Loads the checkout's ``chip_smoke.py`` (its ``FA_TIMED`` rows, seeded
inputs and CUDA-event timer) and its ``repro_torch`` (the kernels built
into the checkout's own ``build/``), then times the kernel at every row,
the median of three timed runs, and prints one line a row: the checkout,
the row, the kernel path and the device ms. Device times move between
calls (another card, another power limit), so two versions are compared
within one call, alternating: for a parent checkout ``P`` and a change
``C``::

    for d in P C C P; do python3 tools/torch_fa_ab.py $d; done

``--dtype float32`` (or ``bfloat16``) times only that dtype's rows.

Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import importlib.util
import statistics
import sys
from pathlib import Path


def main(argv) -> int:
    only = None
    if len(argv) == 3 and argv[1] == "--dtype":
        argv, only = argv[:1], argv[2]
    if len(argv) != 1:
        print("usage: torch_fa_ab.py CHECKOUT [--dtype DTYPE]",
              file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("torch_fa_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    _build.library()
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for row in smoke.FA_TIMED:
        (label, dname, B, S, H, KV, hd, dv, scale, window, softcap,
         chunk), causal = row[:12], (row[12] if len(row) > 12 else True)
        if only is not None and dname != only:
            continue
        q, k, v, pos = smoke.fa_inputs(torch, 9, B, S, H, KV, hd, dts[dname],
                                       dv=dv)
        kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
                  chunk=chunk)
        ms = statistics.median(
            smoke.time_ms(torch, lambda: fa.flash_attention(q, k, v, pos,
                                                            **kw))
            for _ in range(3))
        print(f"{root.name} | {label} B={B} S={S} {H}/{KV} hd={hd} dv={dv} "
              f"{dname} causal={causal} window={window} softcap={softcap} "
              f"chunk={chunk} | {fa.path(dts[dname], hd, dv)} | {ms:.4f} ms",
              flush=True)
        del q, k, v, pos
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
