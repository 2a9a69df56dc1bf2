"""Time the port's attention kernels over the choices their designs fix.

    python3 tools/torch_attention_sweep.py

On one CUDA card, with the inputs of ``chip_smoke.py``:

* ``paged_attention`` (flash-decoding) at the main paths' decode shapes for
  each split length target in ``SPLIT`` (``kernels/paged_attention.py``'s
  ``SPLIT_TOKENS`` is set to it for every head_dim, then restored): the
  measurement behind the split length the kernel takes;
* ``flash_attention``'s tensor-core kernel at gemma2-9b's 4,200-token
  prefill with and without the softcap, causal and not, and at head_dim
  256, 128 and 64: how its time follows the softmax's work and the
  tensor-core work.

Prints the card's name and power limit, then one line per case with the
kernel's device time (CUDA events, ``chip_smoke.time_ms``). Needs a CUDA
card; exits 2 without one.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPLIT = (64, 128, 256, 512)
# (label, dtype, B, H, KV, hd, seq_lens, scale, window, softcap)
PAGED = [("gemma2-9b", "bfloat16", 2, 16, 8, 256, [4201, 25], 224.0 ** -0.5,
          None, 50.0),
         ("qwen2.5-3b", "bfloat16", 1, 16, 2, 128, [208], 128 ** -0.5, None,
          None),
         ("qwen2.5-3b", "float32", 4, 16, 2, 128, [38, 65, 101, 130],
          128 ** -0.5, None, None)]
# (hd, causal, softcap) at B=1 S=4200, 16 / 8 heads, bf16
FLASH = [(256, True, 50.0), (256, True, None), (256, False, None),
         (128, True, None), (64, True, None)]


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0])
    _build.library()
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    chosen = dict(pa.SPLIT_TOKENS)
    try:
        for label, dname, B, H, KV, hd, sl, scale, window, softcap in PAGED:
            args = smoke.paged_inputs(torch, 7, B, H, KV, hd,
                                      smoke.PAGE_TOKENS, sl, dts[dname])
            kw = dict(scale=scale, window=window, softcap=softcap)
            want = pa.paged_attention_plain(*args, **kw)
            for target in SPLIT:
                pa.SPLIT_TOKENS = {d: target for d in chosen}
                _, rel = smoke.rel_err(torch, pa.paged_attention(*args, **kw),
                                       want)
                smoke.require(rel <= smoke.TOL[dname], f"{label}: {rel}")
                ms = smoke.time_ms(torch,
                                   lambda: pa.paged_attention(*args, **kw))
                L = pa.split_len(hd, dts[dname], smoke.PAGE_TOKENS)
                print(f"paged_attention {label} {dname} B={B} seq_lens={sl}"
                      f" split target {target} (L={L}): {ms:.4f} ms",
                      flush=True)
    finally:
        pa.SPLIT_TOKENS = chosen

    for hd, causal, softcap in FLASH:
        q, k, v, pos = smoke.fa_inputs(torch, 9, 1, smoke.GEMMA_PREFILL, 16,
                                       8, hd, torch.bfloat16)
        kw = dict(scale=hd ** -0.5, causal=causal, softcap=softcap)
        ms = smoke.time_ms(torch, lambda: fa.flash_attention(q, k, v, pos,
                                                             **kw))
        print(f"flash_attention ({fa.path(q.dtype, hd)}) B=1 S="
              f"{smoke.GEMMA_PREFILL} 16/8 heads hd={hd} bf16 causal={causal}"
              f" softcap={softcap}: {ms:.4f} ms", flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
