"""Multi-DNN scheduling on top of SwapNet (paper §6.2).

Combines budget allocation (Eq. 1), per-model partitioning (Eq. 3/4 via the
lookup table) and run-time adaptation (§6.2.2 "Adaptively Partition and
Exchange Blocks", Fig. 18): lookup tables are precomputed per plausible block
count; a budget change only re-selects a row (index math, no re-profiling),
matching the paper's 60-70 ms adaptation path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.budget import ModelDemand, allocate_budgets
from repro_torch.core.partition import (BlockPlan, PartitionPlanner,
                                        TableRow, create_blocks,
                                        simulate_pipeline)


@dataclass
class ScheduledModel:
    name: str
    planner: PartitionPlanner
    urgency: float = 1.0
    budget: float = 0.0
    plan: Optional[BlockPlan] = None
    table: List[TableRow] = field(default_factory=list)

    def demand(self) -> ModelDemand:
        s = float(np.sum(self.planner.sizes))
        f = float(np.sum(self.planner.flops))
        return ModelDemand(self.name, s, self.planner.dm.t_ex(f), self.urgency)

    def predicted_latency(self) -> float:
        s, d, f = create_blocks(self.plan, self.planner.sizes,
                                self.planner.depths, self.planner.flops)
        return simulate_pipeline(s, d, f, self.planner.dm, self.planner.m)


def lift_to_floors(budgets: Sequence[float], floors: Sequence[float],
                   usable: float, reserved: float = 0.0) -> List[float]:
    """Lift every budget to its physical floor, funding the lifts from the
    models with headroom; donors are CLAMPED at their own floor.

    Redistribution is iterative: each round takes the outstanding deficit
    from the remaining donors in proportion to their headroom, capping each
    donor's payment at its headroom. A single proportional round already
    respects the caps when the deficit is computed against the same budgets
    it is taken from, but clamping must not rely on that coincidence — any
    upstream change to how the deficit is measured (e.g. proportional to
    BUDGET rather than headroom, or budgets mutated between the two steps)
    silently pushed donors below their floor, which downstream turns into a
    best_partition failure for a model whose budget was supposedly feasible.
    The loop is invariant-true by construction: no output ever sits below
    its floor, and the total is preserved.
    """
    floors = [float(f) for f in floors]
    out = [float(b) for b in budgets]
    if sum(floors) > usable:
        raise ValueError(
            f"available memory {usable/1e6:.1f} MB (after "
            f"{reserved/1e6:.1f} MB reserved) below the "
            f"sum of per-model floors {sum(floors)/1e6:.1f} MB")
    deficit = sum(max(f - b, 0.0) for f, b in zip(floors, out))
    out = [max(b, f) for f, b in zip(floors, out)]
    while deficit > 1e-6:
        donors = [i for i in range(len(out)) if out[i] - floors[i] > 1e-9]
        if not donors:       # float dust: usable >= sum(floors) guarantees
            break            # the true deficit is already below tolerance
        hr_total = sum(out[i] - floors[i] for i in donors)
        take = min(deficit, hr_total)
        paid = 0.0
        for i in donors:
            pay = min(out[i] - floors[i],
                      (out[i] - floors[i]) / hr_total * take)
            out[i] -= pay
            paid += pay
        deficit -= paid
        if paid <= 0.0:
            break
    return out


class MultiDNNScheduler:
    """Paper §6.2: allocate budgets across DNNs, partition each, adapt on
    budget changes. Each model runs its own depth-m prefetch pipeline to
    overlap swap-in with execution; when the models share one runtime
    (``core/multi_model.py``) ``reserved`` carves the shared block cache +
    pinned units out of the available memory before Eq. 1 splits the rest."""

    def __init__(self, models: Sequence[ScheduledModel], available: float,
                 delta: float = 0.05, reserved: float = 0.0):
        self.models = list(models)
        self.available = available
        self.reserved = reserved
        self.delta = delta
        self.replan()

    def replan(self) -> None:
        budgets = allocate_budgets([m.demand() for m in self.models],
                                   self.available - self.reserved)
        # Eq. 1 is share-based and can dip below a model's physical floor
        # (its largest layer). Lift those to their floor and fund the lift
        # from the models with headroom — donors CLAMPED at their own floor.
        floors = [m.planner.min_feasible_budget(self.delta)
                  for m in self.models]
        budgets = lift_to_floors(budgets, floors,
                                 self.available - self.reserved,
                                 self.reserved)
        for m, b in zip(self.models, budgets):
            m.budget = b
            m.plan, m.table = m.planner.best_partition(b, self.delta)

    def adapt(self, new_available: float) -> float:
        """Runtime adaptation (Fig. 18): returns wall-time spent adapting.
        Only re-selects lookup-table rows / re-runs the cheap partition search
        — never re-profiles layers (operation 1 is one-time)."""
        t0 = time.perf_counter()
        self.available = new_available
        self.replan()
        return time.perf_counter() - t0

    def summary(self) -> List[Dict]:
        out = []
        for m in self.models:
            out.append({
                "model": m.name,
                "budget_mb": m.budget / 1e6,
                "n_blocks": m.plan.n_blocks,
                "points": m.plan.points,
                "predicted_latency_s": m.predicted_latency(),
            })
        return out
