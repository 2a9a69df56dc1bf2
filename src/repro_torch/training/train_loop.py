"""Training step and state, the JAX package's ``training/train_loop.py``.

The state holds the fp32 master params (leaves that require grad), the
AdamW moments and the step count. A step runs :meth:`Model.loss`, then
``loss.backward()``: on the card every linear's gradient crosses
``swap_linear``'s ``SwapLinearFn`` and every attention's
``flash_attention``'s ``FlashAttentionFn``. Then ``adamw_update`` in
place, and the grads are dropped.

:func:`train_state_specs` gives the state's sharding on a device mesh
(``distributed/sharding.py``): with the state's leaves DTensors placed by
it, the same step runs sharded (``launch/dryrun.py`` traces it on a fake
256- or 512-rank group).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.distributed.sharding import P
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import OptConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def TrainState(params) -> dict:
    """{"params", "mu", "nu", "step"}: ``params``' float leaves are made to
    require grad (in place) and are the master weights the optimizer
    updates; the moments are fp32 zeros on each leaf's device."""
    for p in tree_leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    mu, nu = adamw_init(params)
    return {"params": params, "mu": mu, "nu": nu, "step": 0}


def train_state_specs(model: Model) -> dict:
    """PartitionSpecs of the state: params and both moments as
    :meth:`Model.param_specs`, the step replicated (the port keeps it a
    host int)."""
    ps = model.param_specs()
    return {"params": ps, "mu": ps, "nu": ps, "step": P()}


def make_train_step(model: Model, opt: OptConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the batch moves to
    the params' device; loss and grads, AdamW in place, ``step`` + 1.
    A leaf the loss never reads gets a zero gradient, as JAX's autodiff
    gives it. Metrics: the loss's (``loss``, ``aux``, ``tokens``) and the
    optimizer's (``grad_norm``, ``lr``)."""
    def train_step(state: dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[dict, dict]:
        params = state["params"]
        dev = tree_leaves(params)[0].device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        loss, metrics = model.loss(params, batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        om = adamw_update(params, grads, state["mu"], state["nu"],
                          state["step"], opt)
        for p in tree_leaves(params):
            p.grad = None
        state["step"] += 1
        return state, {**{k: v.detach() for k, v in metrics.items()}, **om}
    return train_step
