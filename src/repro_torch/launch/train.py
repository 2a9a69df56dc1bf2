"""End-to-end training driver, the JAX package's ``launch/train.py``.

    # laptop scale on the CPU: the smoke-reduced model, a few steps
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --reduce smoke --steps 5 --device cpu
    # on the card (the default device): ~100M params, synthetic data
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --reduce 100m --steps 300 --batch 8 --seq 256

The flags are the reference's plus ``--device`` (default ``cuda``; without
CUDA it raises). This loop trains on one device; the same train step on
the production meshes (the state sharded by ``train_state_specs``) is
traced, not run, by ``python -m repro_torch.launch.dryrun``. :func:`train` is the loop that :func:`main` runs once it
has built the config; ``chip_smoke.py`` drives the same loop on its own
depth-cut config. On the card every linear runs ``swap_linear`` and every
attention ``flash_attention``, forward and backward (through their
``autograd.Function``s).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.transformer import Model
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import TrainState, make_train_step
from repro_torch.tree import tree_leaves


def scale_config(cfg: ModelConfig, preset: str) -> ModelConfig:
    """Reduce an assigned arch to a runnable scale, keeping its family
    traits: "smoke" is ``cfg.reduced()``, "100m" about 100 M params,
    anything else the config as it is."""
    if preset == "smoke":
        return cfg.reduced()
    if preset == "100m":
        kw = dict(n_layers=min(cfg.n_layers, 8), d_model=768, n_heads=12,
                  n_kv_heads=min(cfg.n_kv_heads, 4) or 1, head_dim=64,
                  d_ff=2048, vocab_size=min(cfg.vocab_size, 32768))
        if cfg.n_kv_heads == 1:
            kw["n_kv_heads"] = 1
        if cfg.hybrid_attn_every:
            kw["n_layers"] = 8
        if cfg.moe is not None:
            kw["moe"] = dataclasses.replace(cfg.moe, n_routed=8,
                                            d_expert=512, d_shared=1024)
            kw["d_ff"] = 512
        if cfg.rope_type == "mrope":
            kw["mrope_sections"] = (8, 12, 12)
        return dataclasses.replace(cfg, **kw)
    return cfg


def default_opt(steps: int, lr: float) -> OptConfig:
    """The launcher's schedule: warmup over a tenth of the steps (at most
    50), cosine to ``steps``."""
    return OptConfig(peak_lr=lr, warmup_steps=min(50, steps // 10 + 1),
                     total_steps=steps)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, log_every: int = 10, ckpt: Optional[str] = None,
          device="cuda") -> dict:
    """Train ``cfg`` for ``steps`` steps from ``Model.init(0)`` on
    :class:`SyntheticLM` batches (prefetched on the host) with the
    launcher's AdamW schedule, printing the reference's lines. Returns
    {"state", "logged": [(step, loss, seconds since the loop began)],
    "first", "last"}; the logged steps end in a host wait for the card, so
    their losses are read."""
    device = resolve_device(device)
    model = Model(cfg)
    params = model.init(0, device=device)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n / 1e6:.1f}M params, {steps} steps @ "
          f"batch={batch} seq={seq} device={device}", flush=True)
    state = TrainState(params)
    step_fn = make_train_step(model, default_opt(steps, lr))
    ds = SyntheticLM(cfg, seq, batch)
    logged, first, last = [], None, None
    t0 = time.perf_counter()
    for i, b in zip(range(steps), ds.prefetch()):
        state, metrics = step_fn(state, b)
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            synchronize(device)
            dt = time.perf_counter() - t0
            first = loss if first is None else first
            last = loss
            logged.append((i, loss, dt))
            tps = (i + 1) * batch * seq / dt
            print(f"  step {i:4d} loss={loss:7.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} tok/s={tps:,.0f}",
                  flush=True)
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'no decrease'})", flush=True)
    if ckpt:
        checkpoint.save(ckpt, state["params"])
        print(f"[train] checkpoint -> {ckpt}", flush=True)
    return {"state": state, "logged": logged, "first": first, "last": last}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", default="100m",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = scale_config(get_arch(args.arch), args.reduce)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          log_every=args.log_every, ckpt=args.ckpt, device=device)


if __name__ == "__main__":
    main()
