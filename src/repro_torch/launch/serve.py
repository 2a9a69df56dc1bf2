"""Serving of one model, in one of three modes, or of several under one
budget, in one of two:

* swapped (``--budget-mb``): a swapped prefill under a weight budget, then
  greedy decode of a few tokens with the weights streamed per step;
* paged (``--paged --budget-mb``): continuous-batching decode through the
  paged KV cache, weight blocks and KV pages under ONE ledger;
* in-memory (neither): the plain engine, every weight resident;
* multi (``--multi a,b --budget-mb``): the tenants' swapped prefills
  interleaved round-robin under one shared ledger and block cache, each
  held to its tenant's unswapped logits;
* multi-scheduled (``--multi a,b --budget-mb --executors K``, K > 1): K
  executor threads over the same runtime, requests admitted by
  urgency-weighted deadline (``--priorities``, assigned round-robin) and
  lower classes preempted at block boundaries.

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
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --multi qwen2.5-3b,gemma2-9b --reduce smoke --budget-mb 48 \
        --executors 2 --priorities 1,8 --store directio --device cpu

rwkv6 serves on the swapped and the in-memory paths (``--store quant``
resolves to mmap: it is quant-ineligible); ``--paged`` refuses it, as the
paged KV cache covers attention stacks only. Its chunked prefill takes
prompts of at most 16 tokens or a multiple of 16.

Runs on ``cuda`` unless ``--device`` says otherwise; without CUDA the
default raises. The flags are the JAX CLI's (``repro.launch.serve``) that
these modes read, plus ``--device``; ``--profile``, ``--http`` and the
layered config are not ported yet.
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
from repro_torch.core.multi_model import MultiModelRuntime
from repro_torch.core.runtime import SwappedModel
from repro_torch.core.serving_scheduler import ServingScheduler
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serving.batch_engine import BatchDecodeEngine
from repro_torch.serving.engine import Request, ServingEngine, pad_prompts
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


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, float), q)) if xs else 0.0


def _build_multi_runtime(args: argparse.Namespace, workdir: str,
                         device: torch.device):
    """The tenants of ``--multi`` (tenant i from seed i) in one planned
    :class:`MultiModelRuntime`; returns (archs, runtime, {arch: model})."""
    archs = [a.strip() for a in args.multi.split(",") if a.strip()]
    if len(archs) < 2:
        raise SystemExit("--multi wants at least two comma-separated archs")
    rt = MultiModelRuntime(int(args.budget_mb * 1e6),
                           prefetch_depth=args.prefetch_depth,
                           cache_frac=args.cache_frac,
                           store_backend=args.store,
                           precision=args.precision,
                           executors=args.executors, device=device)
    models = {}
    for i, arch in enumerate(archs):
        model = Model(scale_config(get_arch(arch), args.reduce))
        rt.add_model(arch, model, model.init(i, device="cpu"), workdir)
        models[arch] = model
    rt.plan(batch=args.requests, seq=args.prompt_len)
    return archs, rt, models


def _prefill_batch(rng, mcfg: ModelConfig, args: argparse.Namespace) -> dict:
    reqs = [Request(i, list(map(int, rng.integers(0, mcfg.vocab_size,
                                                  args.prompt_len))))
            for i in range(args.requests)]
    return pad_prompts(mcfg, reqs)


def _agreement(rt: MultiModelRuntime, arch: str, logits, batch) -> tuple:
    """(exact, cosine) of a swapped pass against the tenant's unswapped
    forward: exact stores must match bitwise; the quantized store's bounded
    error is reported as the cosine of the two logit vectors."""
    ref = rt.models[arch].forward_unswapped(batch)
    a = logits.double().flatten()
    b = ref.double().flatten()
    cos = float(a @ b / max(float(a.norm() * b.norm()), 1e-30))
    return bool(torch.equal(logits, ref)), cos


def serve_multi(args: argparse.Namespace, device: torch.device) -> dict:
    """Two or more models interleaved under ONE weight budget, one pass at
    a time: the paper's §6 multi-DNN scenario. The first round's logits are
    held to each tenant's unswapped forward; then peak residency against
    the budget, overlap efficiency and the cache hit rate."""
    budget = int(args.budget_mb * 1e6)
    rng = np.random.default_rng(0)
    exact, fidelity = True, {}
    with tempfile.TemporaryDirectory() as d:
        archs, rt, models = _build_multi_runtime(args, d, device)
        try:
            for round_i in range(args.rounds):
                for arch in archs:          # interleave tenants round-robin
                    batch = _prefill_batch(rng, models[arch].cfg, args)
                    logits, _ = rt.forward(arch, batch)
                    if round_i:
                        continue
                    same, cos = _agreement(rt, arch, logits, batch)
                    if rt.models[arch].store_backend == "quant":
                        fidelity[arch] = cos
                    else:
                        exact = exact and same
            st = rt.stats()
        finally:
            rt.close()
    parts = []
    if fidelity:
        parts.append(f"fidelity={min(fidelity.values()):.4f}")
    if len(fidelity) < len(archs):
        parts.append(f"lossless={exact}")
    peak = st["peak_resident_mb"] * 1e6
    print(f"[serve-multi] {len(archs)} models under {args.budget_mb:.0f} MB "
          f"(store={args.store}): peak resident "
          f"{st['peak_resident_mb']:.1f} MB "
          f"({'OK' if peak <= budget else 'OVER'}), {' '.join(parts)}, "
          f"device={device}", flush=True)
    print(f"[serve-multi] cache {st['cache_resident_mb']:.1f}/"
          f"{st['cache_capacity_mb']:.1f} MB, "
          f"hit rate {st['cache_hit_rate']*100:.1f}% "
          f"({st['cache_hits']} hits / {st['cache_misses']} misses)",
          flush=True)
    for name, ms in st["models"].items():
        print(f"[serve-multi]   {name}: blocks={ms['n_blocks']} m={ms['m']} "
              f"store={ms['store_backend']}/{ms['precision']} "
              f"overlap_eff={ms['overlap_efficiency']*100:.1f}% "
              f"swapped {ms['bytes_swapped_mb']:.1f} MB "
              f"({ms['bytes_logical_mb']:.1f} MB logical)", flush=True)
    return {"stats": st, "lossless": exact, "fidelity": fidelity,
            "peak": peak, "budget": budget}


def serve_multi_scheduled(args: argparse.Namespace,
                          device: torch.device) -> dict:
    """K concurrent executors + priority-aware preemptive scheduling over
    the shared-budget runtime: requests carry an urgency class
    (``--priorities``, assigned round-robin) and are admitted by
    urgency-weighted deadline; lower classes yield at block boundaries to
    higher ones. Reports per-class p50 / p99 latency, the preemption count
    and every request's agreement with its tenant's unswapped model."""
    classes = [float(p) for p in args.priorities.split(",")]
    budget = int(args.budget_mb * 1e6)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        archs, rt, models = _build_multi_runtime(args, d, device)
        try:
            batches = {a: _prefill_batch(rng, models[a].cfg, args)
                       for a in archs}
            refs = {a: rt.models[a].forward_unswapped(batches[a])
                    for a in archs}
            for a in archs:
                rt.forward(a, batches[a])                   # warm
            sched = ServingScheduler(rt, auto_rebalance=args.rebalance)
            submitted = []
            try:
                for round_i in range(args.rounds):
                    for j, arch in enumerate(archs):
                        prio = classes[(round_i * len(archs) + j)
                                       % len(classes)]
                        submitted.append(sched.submit(arch, batches[arch],
                                                      priority=prio))
                for r in submitted:
                    r.wait(timeout=600)
            finally:
                sched.shutdown(timeout=600)
            exact = all(torch.equal(r.logits, refs[r.model])
                        for r in submitted
                        if rt.models[r.model].store_backend != "quant")
            st = rt.stats()
        finally:
            rt.close()
    peak = st["peak_resident_mb"] * 1e6
    print(f"[serve-sched] {len(archs)} models, {args.executors} executors "
          f"under {args.budget_mb:.0f} MB (store={args.store}): peak "
          f"resident {st['peak_resident_mb']:.1f} MB "
          f"({'OK' if peak <= budget else 'OVER'}), lossless={exact}, "
          f"preemptions={sched.preemptions}, device={device}", flush=True)
    by_class = sched.latency_by_class()
    for prio in sorted(by_class, reverse=True):
        lat = [x * 1e3 for x in by_class[prio]]
        print(f"[serve-sched]   priority {prio:g}: n={len(lat)} "
              f"p50={_percentile(lat, 50):.1f} ms "
              f"p99={_percentile(lat, 99):.1f} ms", flush=True)
    return {"stats": st, "lossless": exact, "peak": peak, "budget": budget,
            "preemptions": sched.preemptions, "latency_by_class": by_class}


def serve(args: argparse.Namespace) -> dict:
    """Build the model(s) and run the mode the flags select; returns what
    it printed."""
    device = resolve_device(args.device)
    if args.multi is not None:
        if args.budget_mb is None:
            raise SystemExit("--multi requires --budget-mb")
        if args.executors > 1:
            return serve_multi_scheduled(args, device)
        return serve_multi(args, device)
    if args.arch is None:
        raise SystemExit("need --arch (one model) or --multi a,b")
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
    ap.add_argument("--arch", default=None)
    ap.add_argument("--multi", default=None,
                    help="comma-separated archs served interleaved under one "
                         "shared weight budget (requires --budget-mb)")
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
    ap.add_argument("--store", default="mmap",
                    choices=["mmap", "rawio", "quant", "directio"],
                    help="block store: mmap (zero-copy, lossless), rawio "
                         "(read()-based ablation arm), quant (per-channel "
                         "quantized units kept quantized-resident; 2-D "
                         "weights stream through the fused dequant-matmul "
                         "kernel) or directio (O_DIRECT lossless reads that "
                         "bypass the page cache; buffered reads on "
                         "filesystems without O_DIRECT)")
    ap.add_argument("--precision", default=None, choices=["int8", "int4"],
                    help="quant-store precision (default: the arch's "
                         "swap_precision)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="pipeline residency m (1=serial, 2=double buffer)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3,
                    help="multi-tenant round-robin passes (repeat requests "
                         "exercise the shared block cache)")
    ap.add_argument("--executors", type=int, default=1,
                    help="concurrent executor threads for --multi serving "
                         "(>1 runs the priority-aware preemptive scheduler; "
                         "each model's blocks are planned against a 1/K "
                         "slice of the block budget so K pipelines co-fit)")
    ap.add_argument("--priorities", default="1",
                    help="comma-separated urgency classes assigned "
                         "round-robin to --multi requests (e.g. '1,8'; "
                         "higher = more urgent: admitted earlier, preempts "
                         "lower classes at block boundaries)")
    ap.add_argument("--rebalance", action="store_true",
                    help="re-split the block budget (MultiDNNScheduler, "
                         "Eq. 1) whenever the queued urgency mix changes")
    ap.add_argument("--cache-frac", type=float, default=0.25,
                    help="fraction of the budget reserved for the shared "
                         "hot-block cache (multi-tenant mode)")
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
