"""Per-unit quantization-sensitivity profiler (the mixed-precision path).

Answers one question per (swap unit, candidate precision): if ONLY this
unit's quantizable leaves round-trip through int8 / packed int4, exactly
the transform ``QuantizedStore`` applies at build time, how far does the
MODEL OUTPUT move? The answers feed :func:`policy.assign_precisions`.

Two methods, as in the JAX package's ``repro/calibrate/profiler.py``:

* ``output``: one clean swapped pass records the reference output, then
  one pass per (unit x precision) with that unit's params replaced by
  their host round-trip (``store/quantized_store.roundtrip``) through
  ``SwappedModel.param_override``, so the sweep runs block by block under
  the same plan as production. Error = relative L2 at the model output.
  Cost: 1 + 2q passes for q quantizable units.
* ``weight``: the relative Frobenius perturbation ``||W - Wq|| / ||W||``
  per unit, in float64 on the host. No forward pass.

The artifact is byte-compatible with the JAX package's: the same unit
signature strings (a shape tuple's repr and the dtype's numpy name), the
same leaf order (sorted keys), the same float64 sums.

``profile_model`` sweeps a ``SwappedModel`` and ``profile_sequential``
the conv workloads' ``SwappedSequential``, through one shared sweep.
``store/quantized_store.roundtrip`` (bytes equal to the JAX package's
``quantize_unit_params``, per leaf its ``quantize_roundtrip``) makes the
perturbed unit.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from repro_torch.store.quantized_store import (leaf_meta, quantizable_leaf,
                                               roundtrip, roundtrip_leaf,
                                               unit_stored_nbytes)
from repro_torch.tree import tree_leaves

PROFILE_VERSION = 1
CANDIDATE_BITS = {"int8": 8, "int4": 4}

# dtypes numpy calls floating: the reference's weight proxy tests
# ``np.issubdtype(dtype, np.floating)``, which is false for bfloat16, so a
# bfloat16 leaf adds nothing to either sum there, nor here
_NP_FLOATS = ("float16", "float32", "float64")


def _host64(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float64).numpy()
    return np.asarray(leaf, np.float64)


def unit_precision_bytes(params, min_quant_size: int = 1024) -> Dict[str, int]:
    """Stored bytes of one unit at each candidate precision (exact: the
    quant store's aligned segment layout)."""
    return {"fp": unit_stored_nbytes(params, 0, min_quant_size),
            "int8": unit_stored_nbytes(params, 8, min_quant_size),
            "int4": unit_stored_nbytes(params, 4, min_quant_size)}


def _rel_l2(y, y_ref) -> float:
    a = _host64(y).ravel()
    b = _host64(y_ref).ravel()
    denom = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / (denom if denom > 0.0 else 1.0)


def _weight_err(params, bits: int, min_quant_size: int) -> float:
    """``weight`` proxy: relative Frobenius perturbation over the unit."""
    num = den = 0.0
    for leaf in tree_leaves(params):
        if leaf_meta(leaf)[1] not in _NP_FLOATS:
            continue
        x = _host64(leaf)
        den += float(np.sum(x * x))
        if quantizable_leaf(leaf, min_quant_size):
            d = _host64(roundtrip_leaf(leaf, bits, min_quant_size)) - x
            num += float(np.sum(d * d))
    return (num / den) ** 0.5 if den > 0.0 else 0.0


def _unit_signature(name: str, params) -> str:
    sig = []
    for leaf in tree_leaves(params):
        shape, dname, _ = leaf_meta(leaf)
        sig.append(f"{tuple(int(s) for s in shape)}:{dname}")
    return f"{name}|" + ",".join(sig)


@dataclass
class SensitivityProfile:
    """Versioned calibration artifact: per-unit error at each candidate
    precision plus the exact stored-bytes table the policy packs against."""
    arch: str
    method: str                          # output | weight
    seed: int
    signature: str                       # digest of arch + unit/leaf shapes
    units: Dict[str, Dict[str, float]] = field(default_factory=dict)
    batch_shape: tuple = ()
    version: int = PROFILE_VERSION

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "arch": self.arch,
            "method": self.method,
            "seed": self.seed,
            "signature": self.signature,
            "batch_shape": list(self.batch_shape),
            "units": {n: dict(sorted(u.items()))
                      for n, u in sorted(self.units.items())},
        }, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "SensitivityProfile":
        d = json.loads(s)
        if d.get("version") != PROFILE_VERSION:
            raise ValueError(f"SensitivityProfile version {d.get('version')!r}"
                             f" != supported {PROFILE_VERSION}")
        return cls(arch=d["arch"], method=d["method"], seed=int(d["seed"]),
                   signature=d["signature"],
                   units={n: dict(u) for n, u in d["units"].items()},
                   batch_shape=tuple(d.get("batch_shape", ())),
                   version=int(d["version"]))

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "SensitivityProfile":
        with open(path) as fh:
            return cls.from_json(fh.read())


def shape_signature(named_units) -> str:
    """Digest over unit names + leaf shapes / dtypes: the key that pins a
    saved profile to the exact model geometry it was measured on."""
    h = hashlib.sha256()
    for name, params in named_units:
        h.update(_unit_signature(name, params).encode())
        h.update(b";")
    return h.hexdigest()[:16]


def _profile(named_units, run_clean, run_override, arch: str, method: str,
             seed: int, min_quant_size: int,
             batch_shape: tuple) -> SensitivityProfile:
    """The sweep both profilers share. ``run_clean()`` -> reference output;
    ``run_override(name, qparams)`` -> the output with one unit's params
    substituted (neither is called for ``method="weight"``)."""
    if method not in ("output", "weight"):
        raise ValueError(f"unknown method {method!r}")
    prof = SensitivityProfile(
        arch=arch, method=method, seed=seed,
        signature=shape_signature(named_units), batch_shape=batch_shape)
    y_ref = run_clean() if method == "output" else None
    for name, params in named_units:
        row: Dict[str, float] = {
            f"bytes_{k}": int(v)
            for k, v in unit_precision_bytes(params, min_quant_size).items()}
        has_q = any(quantizable_leaf(a, min_quant_size)
                    for a in tree_leaves(params))
        for prec, bits in CANDIDATE_BITS.items():
            if not has_q:
                err = 0.0
            elif method == "weight":
                err = _weight_err(params, bits, min_quant_size)
            else:
                qp = roundtrip(params, bits, min_quant_size)
                err = _rel_l2(run_override(name, qp), y_ref)
                del qp
            row[f"err_{prec}"] = err
        prof.units[name] = row
    return prof


def profile_sequential(sw, x, method: str = "output", seed: int = 0,
                       min_quant_size: int = 1024) -> SensitivityProfile:
    """Profile a planned :class:`~repro_torch.core.runtime.SwappedSequential`
    on input ``x``: the perturbed passes run through ``sw.forward`` with
    its ``param_override`` seam, block by block under the executor's
    plan."""
    if sw.plan is None:
        raise RuntimeError("call partition_with()/set_plan() first")
    names = [n for n, _ in sw.named_units]

    def run(override):
        sw.param_override = override
        try:
            return sw.forward(x)[0]
        finally:
            sw.param_override = None

    return _profile(
        sw.named_units,
        run_clean=lambda: run(None),
        run_override=lambda name, qp: run(
            lambda i, p: qp if names[i] == name else p),
        arch="sequential", method=method, seed=seed,
        min_quant_size=min_quant_size,
        batch_shape=tuple(int(s) for s in x.shape))


def profile_model(sm, batch: dict, method: str = "output", seed: int = 0,
                  min_quant_size: int = 1024) -> SensitivityProfile:
    """Profile a planned :class:`~repro_torch.core.runtime.SwappedModel` on
    a prefill ``batch``. Unit names come back namespaced as the model's
    store and planner see them, so the resulting plan's keys line up."""
    if sm.plan is None:
        raise RuntimeError("call partition()/set_plan() first")
    seen, named = set(), []
    for u in sm.units:
        if u.name not in seen:
            seen.add(u.name)
            named.append((u.name, u.params))

    def run(override):
        sm.param_override = override
        try:
            return sm.forward(batch)[0]
        finally:
            sm.param_override = None

    return _profile(
        named,
        run_clean=lambda: run(None),
        run_override=lambda name, qp: run(
            lambda u, p: qp if u.name == name else p),
        arch=sm.cfg.name, method=method, seed=seed,
        min_quant_size=min_quant_size,
        batch_shape=tuple(int(s) for s in next(iter(batch.values())).shape))
