"""Serving of one model, in one of three modes:

* swapped (``--budget-mb``): a swapped prefill under a weight budget, then
  greedy decode of a few tokens with the weights streamed per step;
* paged (``--paged --budget-mb``): continuous-batching decode through the
  paged KV cache, weight blocks and KV pages under ONE ledger;
* in-memory (neither): the plain engine, every weight resident.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --budget-mb 8 --requests 2 --prompt-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --budget-mb 4 --store quant --precision int4 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --budget-mb 24 --paged --kv-frac 0.3 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --requests 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --reduce smoke --budget-mb 8 --prompt-len 16 --device cpu

rwkv6 serves on the swapped and the in-memory paths (``--store quant``
resolves to mmap: it is quant-ineligible); ``--paged`` refuses it, as the
paged KV cache covers attention stacks only. Its chunked prefill takes
prompts of at most 16 tokens or a multiple of 16.

Runs on ``cuda`` unless ``--device`` says otherwise; without CUDA the
default raises. The flags are the JAX CLI's (``repro.launch.serve``) that
these modes read, plus ``--device``.
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
from repro_torch.serving.batch_engine import BatchDecodeEngine
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged_kv import PagedKVCache


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


def serve_paged(args: argparse.Namespace, mcfg: ModelConfig, model: Model,
                params: dict, device: torch.device) -> dict:
    """Swap-aware continuous-batching decode: weight blocks are planned
    against (1 - kv_frac) of the budget and the KV page pool is sized from
    the rest, BOTH charged to one ledger that enforces the whole budget;
    page pressure preempts the youngest/lowest-priority sequences
    (recomputed on re-admission)."""
    budget = int(args.budget_mb * 1e6)
    kv_bytes = int(budget * args.kv_frac)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        sm = SwappedModel(model, params, d, budget=budget,
                          prefetch_depth=args.prefetch_depth,
                          store_backend=args.store, precision=args.precision,
                          device=device)
        try:
            sm.partition(budget - kv_bytes, DelayModel(), 1, args.prompt_len)
            kv = PagedKVCache.for_budget(mcfg, sm.engine.ledger, kv_bytes,
                                         page_tokens=args.page_tokens,
                                         device=device)
            be = BatchDecodeEngine(sm, kv, max_batch=args.max_batch)
            reqs = [Request(i, list(map(int, rng.integers(
                        0, mcfg.vocab_size, args.prompt_len))),
                        max_new_tokens=args.new_tokens)
                    for i in range(args.requests)]
            for r in reqs:
                be.submit(r)
            be.run_all()
            st = be.stats()
            peak = sm.engine.ledger.peak
        finally:
            sm.close()
    print(f"[serve-paged] {args.requests} requests x {args.new_tokens} new "
          f"tokens under {args.budget_mb:.0f} MB "
          f"(kv_frac={args.kv_frac:g}, {kv.max_pages} pages x "
          f"{kv.page_tokens} tok): {st['tok_per_s']:.2f} tok/s, "
          f"occupancy {st['mean_occupancy']*100:.0f}%, "
          f"preemptions {st['preemptions']:.0f}, "
          f"peak resident {peak/1e6:.1f} MB "
          f"({'OK' if peak <= budget else 'OVER'}), "
          f"KV pool on device {kv.pool_bytes/1e6:.1f} MB, "
          f"device={device}", flush=True)
    print(f"[serve-paged] sample output: {reqs[0].output[:12]}", flush=True)
    return {"requests": reqs, "stats": st, "peak": peak, "budget": budget}


def serve_in_memory(args: argparse.Namespace, mcfg: ModelConfig,
                    model: Model, params: dict,
                    device: torch.device) -> dict:
    """The plain in-memory engine, every weight resident on ``device``."""
    rng = np.random.default_rng(0)
    engine = ServingEngine(model, params, max_len=args.max_len,
                           device=device)
    reqs = [Request(i, list(map(int, rng.integers(0, mcfg.vocab_size,
                                                  args.prompt_len))),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    engine.generate(reqs)                                   # warm
    reqs2 = [Request(100 + i, r.prompt, r.max_new_tokens)
             for i, r in enumerate(reqs)]
    stats = engine.generate(reqs2)
    print(f"[serve] {args.requests} requests x {args.new_tokens} new "
          f"tokens: prefill {stats['prefill_s']*1e3:.1f} ms, "
          f"{stats['tok_per_s']:.1f} tok/s decode, device={device}",
          flush=True)
    print(f"[serve] sample output: {reqs2[0].output[:12]}", flush=True)
    return {"requests": reqs2, "stats": stats}


def serve(args: argparse.Namespace) -> dict:
    """Build the model and run the mode the flags select; returns what it
    printed."""
    device = resolve_device(args.device)
    mcfg = scale_config(get_arch(args.arch), args.reduce)
    if not mcfg.supports_decode():
        raise SystemExit(f"{mcfg.name} is encoder-only: no decode serving")
    if args.paged and args.budget_mb is None:
        raise SystemExit("--paged needs --budget-mb: weight blocks and KV "
                         "pages share that budget")
    model = Model(mcfg)
    params = model.init(0, device="cpu")     # host: the store's source
    if args.paged:
        return serve_paged(args, mcfg, model, params, device)
    if args.budget_mb is None:
        return serve_in_memory(args, mcfg, model, params, device)
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
                    help="SwapNet budget: stream weight blocks within it "
                         "(without it, and without --paged, the in-memory "
                         "engine serves)")
    ap.add_argument("--paged", action="store_true",
                    help="continuous-batching decode through the paged KV "
                         "cache (requires --budget-mb): weight blocks and "
                         "KV pages share one ledger, sequences admit/retire "
                         "at every decode step")
    ap.add_argument("--kv-frac", type=float, default=0.3,
                    help="fraction of --budget-mb reserved for KV pages in "
                         "--paged mode (the rest plans weight blocks)")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="tokens per KV page (one page spans all layers)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="decode batch slots for --paged continuous batching")
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
    ap.add_argument("--max-len", type=int, default=128,
                    help="decode cache capacity of the in-memory engine")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    return ap


def main(argv=None) -> dict:
    return serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
