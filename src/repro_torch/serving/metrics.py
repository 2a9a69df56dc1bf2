"""Serving metrics registry: one snapshot surface over what already exists.

The runtime and scheduler already track everything an operator needs —
ledger residency/peak, cache hits, per-class latencies, preemptions,
faults/retries, KV-page occupancy — but each lives on a different object
and was only reachable from inside the process. :class:`MetricsRegistry`
SNAPSHOTS those internal counters on demand (it owns no counters of its
own, so the numbers can never drift from what the scheduler reports) and
renders them in two forms:

  * :meth:`snapshot` — a plain nested dict (the control plane's JSON
    surface, the fleet bench's scrape target);
  * :meth:`render_prometheus` — Prometheus text exposition format v0.0.4
    (``# HELP``/``# TYPE`` + samples), served at ``GET /metrics``.

The JAX package's ``repro/serving/metrics.py``, kept as the port's own
copy: the same families, labels and text format, over the port's runtime
and scheduler. Latency quantiles use the same ``numpy.percentile`` the
benches and ``serve.py`` report, over ``ServingScheduler.latency_by_class``
— so a scrape and the in-process report agree EXACTLY on the same data.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["MetricsRegistry", "render_prometheus"]

# (metric name, help text, type) — the registry's stable contract; the
# docs-drift checker verifies the documented names against this list.
METRIC_FAMILIES: List[Tuple[str, str, str]] = [
    ("swapnet_ledger_budget_bytes", "Configured memory budget", "gauge"),
    ("swapnet_ledger_resident_bytes", "Bytes currently charged to the "
     "shared ledger", "gauge"),
    ("swapnet_ledger_peak_bytes", "High-water mark of ledger residency",
     "gauge"),
    ("swapnet_ledger_occupancy", "resident/budget (0..1)", "gauge"),
    ("swapnet_cache_capacity_bytes", "Shared block-cache capacity", "gauge"),
    ("swapnet_cache_resident_bytes", "Bytes resident in the block cache",
     "gauge"),
    ("swapnet_cache_hits_total", "Block-cache hits", "counter"),
    ("swapnet_cache_misses_total", "Block-cache misses", "counter"),
    ("swapnet_cache_hit_rate", "hits/(hits+misses) (0..1)", "gauge"),
    ("swapnet_requests_completed_total", "Completed requests by priority "
     "class", "counter"),
    ("swapnet_request_latency_seconds", "Completed-request latency "
     "quantiles by priority class", "gauge"),
    ("swapnet_queue_depth", "Requests waiting in the admission queue",
     "gauge"),
    ("swapnet_preemptions_total", "Block/step-boundary preemptions",
     "counter"),
    ("swapnet_requests_shed_total", "Requests shed past their deadline",
     "counter"),
    ("swapnet_requests_failed_fast_total", "Requests failed by a tripped "
     "per-model breaker", "counter"),
    ("swapnet_model_up", "1 = serving, 0 = circuit breaker tripped",
     "gauge"),
    ("swapnet_swap_retries_total", "Loader read retries by model",
     "counter"),
    ("swapnet_swap_faults_total", "Swap faults by model and taxonomy class",
     "counter"),
    ("swapnet_model_bytes_swapped_total", "Storage->host bytes streamed by "
     "model", "counter"),
    ("swapnet_model_overlap_efficiency", "Fraction of swap-in hidden "
     "behind compute", "gauge"),
    ("swapnet_kv_pages_in_use", "KV pages currently allocated by model",
     "gauge"),
    ("swapnet_kv_pages_capacity", "KV page-pool capacity by model", "gauge"),
    ("swapnet_kv_page_occupancy", "in_use/capacity (0..1) by model",
     "gauge"),
    ("swapnet_http_requests_total", "Control-plane HTTP requests by "
     "endpoint", "counter"),
]

_HELP = {name: (help_, type_) for name, help_, type_ in METRIC_FAMILIES}


def _fmt_labels(labels: Dict[str, object]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(value: float) -> str:
    """Integers render bare; floats keep ROUND-TRIP precision (``repr``,
    not ``%g`` — a scrape must equal the in-process number exactly, and
    ``%g`` silently truncates to 6 significant digits)."""
    value = float(value)
    if value == int(value):
        return str(int(value))
    return repr(value)


def render_prometheus(samples: List[Tuple[str, Dict, float]]) -> str:
    """Render ``(name, labels, value)`` samples as Prometheus text,
    grouping samples under one HELP/TYPE header per family."""
    by_family: Dict[str, List[Tuple[Dict, float]]] = {}
    order: List[str] = []
    for name, labels, value in samples:
        if name not in by_family:
            by_family[name] = []
            order.append(name)
        by_family[name].append((labels, value))
    lines: List[str] = []
    for name in order:
        help_, type_ = _HELP.get(name, ("", "gauge"))
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {type_}")
        for labels, value in by_family[name]:
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


class MetricsRegistry:
    """Snapshot view over a runtime + scheduler (+ control-plane counters).

    Attach whatever exists — every source is optional, and a missing one
    simply contributes no samples (the registry works for a bare runtime
    without a scheduler, and for tests that fake either)."""

    def __init__(self, runtime=None, scheduler=None):
        self.runtime = runtime
        self.scheduler = scheduler
        self.http_requests: Dict[str, int] = {}   # endpoint -> count

    # ------------------------------------------------------------- sources
    def attach(self, runtime=None, scheduler=None) -> "MetricsRegistry":
        if runtime is not None:
            self.runtime = runtime
        if scheduler is not None:
            self.scheduler = scheduler
        return self

    def count_http(self, endpoint: str) -> None:
        self.http_requests[endpoint] = self.http_requests.get(endpoint, 0) + 1

    # ------------------------------------------------------------ snapshot
    def latency_quantiles(self) -> Dict[float, Dict[str, float]]:
        """Per-priority-class p50/p99 (seconds) over completed requests —
        ``np.percentile`` over ``ServingScheduler.latency_by_class``, the
        exact computation ``serve.py`` and the benches print."""
        if self.scheduler is None:
            return {}
        out: Dict[float, Dict[str, float]] = {}
        for prio, lats in self.scheduler.latency_by_class().items():
            arr = np.asarray(lats, float)
            out[prio] = {
                "n": len(lats),
                "p50_s": float(np.percentile(arr, 50)) if lats else 0.0,
                "p99_s": float(np.percentile(arr, 99)) if lats else 0.0,
            }
        return out

    def collect(self) -> List[Tuple[str, Dict, float]]:
        """Live ``(name, labels, value)`` samples from every source."""
        samples: List[Tuple[str, Dict, float]] = []
        rt = self.runtime
        if rt is not None:
            ledger = rt.ledger
            budget = float(ledger.budget or 0)
            resident = float(ledger.resident)
            samples += [
                ("swapnet_ledger_budget_bytes", {}, budget),
                ("swapnet_ledger_resident_bytes", {}, resident),
                ("swapnet_ledger_peak_bytes", {}, float(ledger.peak)),
                ("swapnet_ledger_occupancy", {},
                 resident / budget if budget else 0.0),
                ("swapnet_cache_capacity_bytes", {},
                 float(rt.cache.capacity)),
                ("swapnet_cache_resident_bytes", {},
                 float(rt.cache.resident_bytes)),
                ("swapnet_cache_hits_total", {}, float(rt.cache.hits)),
                ("swapnet_cache_misses_total", {}, float(rt.cache.misses)),
                ("swapnet_cache_hit_rate", {}, float(rt.cache.hit_rate())),
            ]
            for name, sm in rt.models.items():
                st = sm.engine.stats
                labels = {"model": name}
                samples += [
                    ("swapnet_swap_retries_total", labels, float(st.retries)),
                    ("swapnet_model_bytes_swapped_total", labels,
                     float(st.bytes_swapped)),
                    ("swapnet_model_overlap_efficiency", labels,
                     float(st.overlap_efficiency())),
                ]
                for kind, n in sorted(st.faults.items()):
                    samples.append(("swapnet_swap_faults_total",
                                    {"model": name, "kind": kind}, float(n)))
            for name, engine in getattr(rt, "_batch_engines", {}).items():
                kv = engine.kv
                labels = {"model": name}
                samples += [
                    ("swapnet_kv_pages_in_use", labels,
                     float(kv.pages_in_use)),
                    ("swapnet_kv_pages_capacity", labels,
                     float(kv.max_pages)),
                    ("swapnet_kv_page_occupancy", labels,
                     float(kv.pages_in_use) / max(kv.max_pages, 1)),
                ]
        sched = self.scheduler
        if sched is not None:
            samples += [
                ("swapnet_queue_depth", {}, float(len(sched.queue))),
                ("swapnet_preemptions_total", {}, float(sched.preemptions)),
                ("swapnet_requests_shed_total", {}, float(sched.shed)),
                ("swapnet_requests_failed_fast_total", {},
                 float(sched.failed_fast)),
            ]
            for prio, q in sorted(self.latency_quantiles().items()):
                cls = {"priority": f"{prio:g}"}
                samples.append(("swapnet_requests_completed_total",
                                cls, float(q["n"])))
                for quant, key in (("0.5", "p50_s"), ("0.99", "p99_s")):
                    samples.append(("swapnet_request_latency_seconds",
                                    {**cls, "quantile": quant}, q[key]))
            if rt is not None:
                for name in rt.models:
                    samples.append(
                        ("swapnet_model_up", {"model": name},
                         0.0 if sched.model_down(name) is not None else 1.0))
        for endpoint, n in sorted(self.http_requests.items()):
            samples.append(("swapnet_http_requests_total",
                            {"endpoint": endpoint}, float(n)))
        return samples

    def snapshot(self) -> Dict:
        """Nested-dict view (the control plane's JSON status surface)."""
        out: Dict = {}
        for name, labels, value in self.collect():
            if labels:
                key = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                out.setdefault(name, {})[key] = value
            else:
                out[name] = value
        return out

    def render_prometheus(self) -> str:
        return render_prometheus(self.collect())
