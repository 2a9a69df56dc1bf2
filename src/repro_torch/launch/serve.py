"""Swapped serving of one model: a swapped prefill under a weight budget,
then greedy decode of a few tokens with the weights streamed per step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --budget-mb 8 --requests 2 --prompt-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --budget-mb 4 --store quant --precision int4 \
        --device cpu

Runs on ``cuda`` unless ``--device`` says otherwise; without CUDA the
default raises. The flags are the JAX CLI's (``repro.launch.serve``) that
this path reads, plus ``--device``.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import DelayModel
from repro_torch.core.runtime import SwappedModel
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model


def scale_config(cfg: ModelConfig, preset: str) -> ModelConfig:
    """Reduce an arch to a runnable scale, keeping its family traits."""
    if preset == "smoke":
        return cfg.reduced()
    if preset == "100m":
        kw = dict(n_layers=min(cfg.n_layers, 8), d_model=768, n_heads=12,
                  n_kv_heads=min(cfg.n_kv_heads, 4) or 1, head_dim=64,
                  d_ff=2048, vocab_size=min(cfg.vocab_size, 32768))
        if cfg.n_kv_heads == 1:
            kw["n_kv_heads"] = 1
        return dataclasses.replace(cfg, **kw)
    return cfg


def serve(args: argparse.Namespace) -> dict:
    """Build, plan and run the swapped path; returns what it printed."""
    device = resolve_device(args.device)
    mcfg = scale_config(get_arch(args.arch), args.reduce)
    if not mcfg.supports_decode():
        raise SystemExit(f"{mcfg.name} is encoder-only: no decode serving")
    if args.budget_mb is None:
        raise SystemExit("the in-memory engine is not ported yet: pass "
                         "--budget-mb for the swapped path")
    model = Model(mcfg)
    params = model.init(0, device="cpu")     # host: the store's source
    rng = np.random.default_rng(0)
    budget = int(args.budget_mb * 1e6)
    tokens = torch.as_tensor(rng.integers(
        0, mcfg.vocab_size, (args.requests, args.prompt_len)), dtype=torch.int32)
    with tempfile.TemporaryDirectory() as d:
        sm = SwappedModel(model, params, d, budget=None,
                          prefetch_depth=args.prefetch_depth,
                          store_backend=args.store, precision=args.precision,
                          device=device)
        try:
            sm.partition(budget, DelayModel(), args.requests, args.prompt_len)
            sm.forward({"tokens": tokens})                      # warm
            sm.engine.stats.__init__()
            logits, stats = sm.forward({"tokens": tokens})
            print(f"[serve] swapped prefill: {stats['latency_s']*1e3:.1f} ms, "
                  f"peak resident {stats['peak_resident_mb']:.1f} MB "
                  f"(budget {args.budget_mb:g} MB), "
                  f"blocks={sm.plan.n_blocks}, "
                  f"store={stats['store_backend']}/{stats['precision']}, "
                  f"swapped {stats['bytes_swapped']/1e6:.1f} MB "
                  f"({stats['bytes_logical']/1e6:.1f} MB logical, "
                  f"{stats['bytes_resident_quantized']/1e6:.1f} MB "
                  f"quantized-resident), "
                  f"kernel smem {stats['smem_working_set']} B, "
                  f"overlap_eff={stats['overlap_efficiency']*100:.1f}%, "
                  f"device={device}", flush=True)
            out = {"logits": logits, "stats": stats}
            if args.new_tokens > 0:
                gen, dstats = sm.decode_loop(
                    tokens, max_new_tokens=args.new_tokens,
                    max_len=args.prompt_len + args.new_tokens)
                print(f"[serve] decode {args.requests} x {gen.shape[1]} "
                      f"tokens: {dstats['wall_s']*1e3:.1f} ms, "
                      f"peak resident {dstats['peak_resident_mb']:.1f} MB",
                      flush=True)
                print(f"[serve] sample output: {gen[0].tolist()}", flush=True)
                out["tokens"] = gen
        finally:
            sm.close()
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="SwapNet swapped serving (PyTorch/CUDA port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="SwapNet weight budget: stream blocks within it")
    ap.add_argument("--store", default="mmap", choices=["mmap", "quant"],
                    help="block store: mmap (zero-copy, lossless) or quant "
                         "(per-channel quantized units kept quantized-"
                         "resident; 2-D weights stream through the fused "
                         "dequant-matmul kernel)")
    ap.add_argument("--precision", default=None, choices=["int8", "int4"],
                    help="quant-store precision (default: the arch's "
                         "swap_precision)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="pipeline residency m (1=serial, 2=double buffer)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    return ap


def main(argv=None) -> dict:
    return serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
