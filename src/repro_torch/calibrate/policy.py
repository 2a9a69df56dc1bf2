"""Precision-assignment policy: sensitivity profile -> :class:`PrecisionPlan`.

The JAX package's ``repro/calibrate/policy.py``, kept as the port's own
copy: the same solver and the same canonical JSON, so one profile gives a
byte-identical plan in either package.

The knapsack the mixed-precision path solves (ROADMAP "per-unit mixed
precision"): given each unit's measured output-error contribution at int8
and int4 (see profiler.py) and its stored bytes at every candidate
precision, pick the per-unit assignment fp | int8 | int4 that MINIMIZES the
bytes a swap-in must move — which, through the planner's resident-size
packing (``cost_model.resident_infos``), is what maximizes layers-per-block
under a fixed budget — subject to a fidelity target on the model output.

Error composition: per-unit errors are combined root-sum-square. Unit
quantization perturbations are independent draws (independent rounding
residuals through a shared linear-ish map), so RSS is the first-order
estimate of their joint output error; ``headroom`` shrinks the target the
solver works against to absorb the correlated remainder RSS ignores.

The solver is a greedy ratio ladder, not an LP: start every quantizable
unit at int4 (cheapest bytes), then while the predicted error exceeds the
(headroom-scaled) target, upgrade the unit with the best error-reduction
per extra stored byte one step up the ladder int4 -> int8 -> fp. Greedy on
the squared-error/byte ratio is the classic knapsack relaxation and — the
property the determinism tests pin — the upgrade TRAJECTORY depends only
on the profile, never on the target: a tighter target just walks further
along the same sequence, so per-unit precision is monotone in the target
(fidelity-monotonicity satellite).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional

PLAN_VERSION = 1

# upgrade ladder (bytes ascending, error descending); "fp" = raw, exact
PRECISION_LADDER = ("int4", "int8", "fp")
PRECISION_BITS = {"int4": 4, "int8": 8, "fp": 0}
# coarser-first rank used by the monotonicity tests
PRECISION_RANK = {p: i for i, p in enumerate(PRECISION_LADDER)}


@dataclass
class PrecisionPlan:
    """Per-unit precision assignment, the artifact the mixed swap path
    threads end-to-end: ``QuantizedStore`` consumes ``bits_map()`` to pick
    per-leaf bit-widths at build time, the planner packs against the
    resulting per-unit resident bytes, and ``SwapStats.bytes_by_precision``
    reports the realized split."""
    assignments: Dict[str, str]         # unit name -> fp | int8 | int4
    fidelity_target: float              # max rel-L2 model-output error asked
    predicted_err: float                # RSS estimate under the assignment
    stored_bytes: int = 0               # predicted stored payload, all units
    version: int = PLAN_VERSION

    def bits_for(self, name: str) -> int:
        """Bit-width for one unit (0 = raw fp); unknown units stay fp —
        safer to swap a stray unit exact than to quantize unprofiled."""
        return PRECISION_BITS[self.assignments.get(name, "fp")]

    def bits_map(self) -> Dict[str, int]:
        """``{unit: 0|8|4}`` — the shape ``QuantizedStore(plan=...)`` eats
        (duck-typed so the store never imports this package)."""
        return {n: PRECISION_BITS[p] for n, p in self.assignments.items()}

    def histogram(self) -> Dict[str, int]:
        out = {p: 0 for p in PRECISION_LADDER}
        for p in self.assignments.values():
            out[p] += 1
        return out

    # ------------------------------------------------------------ serialize
    def to_json(self) -> str:
        """Canonical (sorted, fixed-separator) encoding: two plans born from
        the same profile + target are byte-identical (determinism test)."""
        return json.dumps({
            "version": self.version,
            "fidelity_target": self.fidelity_target,
            "predicted_err": self.predicted_err,
            "stored_bytes": self.stored_bytes,
            "assignments": dict(sorted(self.assignments.items())),
        }, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "PrecisionPlan":
        d = json.loads(s)
        if d.get("version") != PLAN_VERSION:
            raise ValueError(f"PrecisionPlan version {d.get('version')!r} "
                             f"!= supported {PLAN_VERSION}")
        return cls(assignments=dict(d["assignments"]),
                   fidelity_target=float(d["fidelity_target"]),
                   predicted_err=float(d["predicted_err"]),
                   stored_bytes=int(d.get("stored_bytes", 0)),
                   version=int(d["version"]))

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "PrecisionPlan":
        with open(path) as fh:
            return cls.from_json(fh.read())


@dataclass
class _UnitState:
    name: str
    bytes_by: Dict[str, int]            # precision -> stored bytes
    err_by: Dict[str, float] = field(default_factory=dict)
    level: int = 0                      # index into PRECISION_LADDER

    @property
    def precision(self) -> str:
        return PRECISION_LADDER[self.level]

    def err(self, level: Optional[int] = None) -> float:
        p = PRECISION_LADDER[self.level if level is None else level]
        return 0.0 if p == "fp" else self.err_by.get(p, 0.0)


def assign_precisions(profile, fidelity: float,
                      headroom: float = 0.7) -> PrecisionPlan:
    """Solve the assignment for a fidelity target (max rel-L2 model-output
    error). ``profile`` is a :class:`~repro_torch.calibrate.profiler
    .SensitivityProfile` (or anything with its ``units`` mapping:
    ``name -> {bytes_fp, bytes_int8, bytes_int4, err_int8, err_int4}``).

    ``headroom`` < 1 shrinks the target the RSS estimate must meet, leaving
    margin for the correlated error the independence assumption drops —
    the bench gates the MEASURED mixed-arm error against the full target.
    """
    if fidelity <= 0:
        raise ValueError(f"fidelity target must be > 0 (got {fidelity!r})")
    states = []
    for name in sorted(profile.units):
        u = profile.units[name]
        st = _UnitState(name, {
            "fp": int(u["bytes_fp"]),
            "int8": int(u["bytes_int8"]),
            "int4": int(u["bytes_int4"]),
        }, {"int8": float(u["err_int8"]), "int4": float(u["err_int4"])})
        # nothing quantizable in the unit -> identical bytes at every
        # precision: keep it fp so the store round-trips it bit-exactly
        if st.bytes_by["int4"] >= st.bytes_by["fp"]:
            st.level = PRECISION_RANK["fp"]
        states.append(st)

    def combined() -> float:
        return sum(s.err() ** 2 for s in states) ** 0.5

    target = fidelity * headroom
    while combined() > target:
        best = None                     # (ratio, gain, name) max
        for s in states:
            if s.precision == "fp":
                continue
            gain = s.err() ** 2 - s.err(s.level + 1) ** 2
            cost = max(s.bytes_by[PRECISION_LADDER[s.level + 1]]
                       - s.bytes_by[s.precision], 1)
            key = (gain / cost, gain, s.name)
            if best is None or key > best[0]:
                best = (key, s)
        if best is None or best[0][1] <= 0.0:
            break                       # every unit exact, or no gain left
        best[1].level += 1

    total = sum(s.bytes_by[s.precision] for s in states)
    return PrecisionPlan(
        assignments={s.name: s.precision for s in states},
        fidelity_target=float(fidelity),
        predicted_err=float(combined()),
        stored_bytes=int(total))
