"""End-to-end A/B of two checkouts of the PyTorch port on one CUDA card.

Runs, for the checkout given as the first argument, phases of its
``chip_smoke.py`` with the same seeds and checks as the smoke, each in the
checkout's own code and kernels (built into its ``build/``): by default the
two swapped prefill phases that stream the most weight bytes per pass,
phase 5 (rwkv6-3b, 4 layers, 2 x 512 tokens on mmap in fp32 and bf16) and
phase 6 (gemma2-9b, 2 layers, one 4,200-token prompt on mmap in bf16);
given phase numbers after the checkout, those of 4 (paged continuous
batching: runs A, B and C), 5 and 6. Their latency and stage-span lines are
what it prints.

Host-clock spans vary with the machine between calls, so two versions are
compared within one call, alternating: for a parent checkout ``P`` and a
change ``C``::

    for d in P C C P; do python3 tools/torch_e2e_ab.py $d; done
    for d in P C C P; do python3 tools/torch_e2e_ab.py $d 4; done

Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path


def main(argv) -> int:
    if not argv or any(a not in ("4", "5", "6") for a in argv[1:]):
        print("usage: torch_e2e_ab.py CHECKOUT [4|5|6 ...]", file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    phases = {int(a) for a in argv[1:]} or {5, 6}
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)   # sets the deterministic-cuBLAS env
    import torch
    if not torch.cuda.is_available():
        print("torch_e2e_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"== {root.name}: kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {k: {} for k in ("swap_linear_q", "dequant_int8",
                                "paged_attention", "wkv6", "swap_linear",
                                "flash_attention")}
    if 5 in phases:
        smoke.run_rwkv6(torch, launches)
    if phases & {4, 6}:
        gmodel, gparams = smoke.gemma_model(torch)
    if 4 in phases:
        import dataclasses
        from repro_torch.configs import get_arch
        from repro_torch.models.transformer import Model
        cfg = dataclasses.replace(get_arch("qwen2.5-3b"),
                                  n_layers=smoke.N_LAYERS)
        model = Model(cfg)
        params = model.init(0, device="cpu")
        smoke.run_paged(torch, cfg, model, params, gmodel, gparams, launches)
        del model, params
        torch.cuda.empty_cache()
    if 6 in phases:
        smoke.run_gemma_prefill(torch, gmodel, gparams, launches)
    print(f"== {root.name}: done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
