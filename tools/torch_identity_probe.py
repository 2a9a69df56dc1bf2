"""The fp32 gradient identities of ``chip_smoke.py`` (phases 15 and 17) for
one checkout, each family's misses printed instead of stopping at the
first.

Runs the checkout's ``chip_smoke.train_identity`` (the loss and every
gradient leaf of ``Model.loss`` through the kernels against the plain
versions) on each family at its phase-17 depth and batch, with the
checks recorded rather than raised, and prints the worst leaf and every
check that missed. ``--reference cublas`` makes the identity's reference
linears ``swap_linear_plain`` (PyTorch's fp32 matmul, cuBLAS on the card)
in place of ``chip_smoke.rounded_linear`` (float64, rounded once);
``--exact-linears`` makes the kernel side's linears
``chip_smoke.rounded_linear`` too (no swap_linear launch), so that the
two sides differ only in how an fp32 product is summed. A checkout
older than ``rounded_linear`` runs its own reference, ``swap_linear_plain``::

    python3 tools/torch_identity_probe.py CHECKOUT [--reference cublas]
        [--exact-linears] [ARCH ...]

Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import sys
from pathlib import Path

FAMILIES = {"qwen2.5-3b": 2, "gemma2-9b": 2, "deepseek-v2-lite-16b": 2,
            "zamba2-7b": 12, "hubert-xlarge": 4, "h2o-danube-3-4b": 2,
            "granite-20b": 2}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("archs", nargs="*", default=list(FAMILIES))
    ap.add_argument("--reference", choices=("rounded", "cublas"),
                    default="rounded")
    ap.add_argument("--exact-linears", action="store_true")
    a = ap.parse_args(argv)
    root = Path(a.checkout).resolve()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("torch_identity_probe: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import swap_linear as sl
    from repro_torch.models import layers
    missed = []
    smoke.require = lambda ok, msg: ok or missed.append(msg)
    rounded = getattr(smoke, "rounded_linear", None)
    if rounded is None:
        a.reference = "cublas"
    elif a.reference == "cublas":
        smoke.rounded_linear = sl.swap_linear_plain
    if a.exact_linears and rounded is not None:
        layers.swap_linear = rounded
    for arch in a.archs:
        cfg = dataclasses.replace(get_arch(arch), n_layers=FAMILIES[arch])
        missed.clear()
        smoke.train_identity(torch, cfg, f"{root.name} {arch}",
                             *smoke.TRAIN_ID_SHAPE.get(
                                 arch, (smoke.TRAIN_BATCH, smoke.TRAIN_SEQ)))
        print(f"{root.name} {arch} reference {a.reference}"
              f"{' exact-linears' if a.exact_linears else ''}: "
              f"{len(missed)} checks missed "
              f"{[m[:120] for m in missed]}", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
