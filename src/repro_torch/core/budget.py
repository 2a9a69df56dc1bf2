"""Cross-model memory budget allocation (paper §6.2.2, Eq. 1).

A_i = (M_i / sum M) * (1 - 1/n) * M  +  (PS_i / sum PS) * (1/n) * M
with performance score PS_i = u_i * latency_i / memory_i (urgency-weighted).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence


@dataclass
class ModelDemand:
    name: str
    memory: float          # M_i, bytes required (model size)
    latency: float         # direct-inference latency estimate (s)
    urgency: float = 1.0   # u_i, user-configured


def performance_score(d: ModelDemand) -> float:
    return d.urgency * d.latency / max(d.memory, 1.0)


def allocate_budgets(demands: Sequence[ModelDemand], available: float) -> List[float]:
    """Paper Eq. 1. If everything fits, give each model what it asks for."""
    total = sum(d.memory for d in demands)
    if total <= available:
        return [d.memory for d in demands]
    n = len(demands)
    ps = [performance_score(d) for d in demands]
    ps_sum = max(sum(ps), 1e-30)
    return [
        (d.memory / total) * (1.0 - 1.0 / n) * available
        + (p / ps_sum) * (1.0 / n) * available
        for d, p in zip(demands, ps)
    ]
