"""Failure taxonomy of the swap pipeline (store -> loader -> scheduler).

SwapNet re-reads weight blocks from storage on EVERY inference pass, so a
slow, torn, or corrupted read on a worn flash card / network filesystem
lands directly in the serving critical path. This module names the failure
classes every tier agrees on; ``docs/ARCHITECTURE.md`` ("Failure handling")
has the degradation matrix saying which layer absorbs which class.

  * :class:`SwapIOError`         — the storage channel failed outright
    (``EIO``, missing file, short read the backend could not assemble).
    Subclasses :class:`IOError` so pre-taxonomy ``except IOError`` callers
    keep working.
  * :class:`SwapCorruptionError` — the bytes arrived but the per-unit CRC32
    recorded at store-build time does not match (bit rot, a torn write, an
    injected flip). NEVER retried silently into wrong weights: the loader
    re-reads, and only a clean read is handed to the executor.
  * :class:`SwapTimeoutError`    — a read (or a whole unit swap-in) blew its
    deadline; the data, even if it eventually arrived, is treated as failed
    so tail latency stays bounded. Subclasses :class:`TimeoutError`.

All three are retryable at the loader tier (bounded exponential backoff,
``SwapEngine.read_retries``); what escapes the retries carries ``unit`` /
``attempts`` context and surfaces at the next block boundary, where the
serving tier decides between retry-at-request-granularity and fail-fast
(per-model circuit breaker in ``ServingScheduler``).

:class:`RequestCancelled` is the scheduler-tier terminal state for requests
removed via ``ServingScheduler.cancel`` — deliberately NOT a
:class:`SwapError`: cancellation is a caller decision, not a fault, and
must not trip the per-model circuit breaker.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["SwapError", "SwapIOError", "SwapCorruptionError",
           "SwapTimeoutError", "RequestCancelled", "ConfigError"]


class ConfigError(ValueError):
    """A layered serving configuration (``repro.config``) failed to resolve:
    unknown key, uncoercible value, missing profile, or a cross-field
    invariant violation. Raised at STARTUP (or at the control-plane request
    that carried the bad overlay) — never from the serving hot path."""


class SwapError(Exception):
    """Base of the swap-pipeline failure taxonomy.

    ``unit`` is the swap-unit name the failure is attributable to (None for
    model-level failures), ``model`` the owning model where known, and
    ``attempts`` how many read attempts were burned before the error
    escaped the loader's retry loop (0 = never retried).
    """

    def __init__(self, msg: str, *, unit: Optional[str] = None,
                 model: Optional[str] = None, attempts: int = 0):
        super().__init__(msg)
        self.unit = unit
        self.model = model
        self.attempts = attempts


class SwapIOError(SwapError, IOError):
    """The storage channel failed: raised I/O error, missing file, or a
    short/torn read the backend could not assemble into a unit."""


class SwapCorruptionError(SwapError):
    """Unit bytes failed their build-time CRC32 integrity check — the read
    'succeeded' but the payload cannot be trusted."""


class SwapTimeoutError(SwapError, TimeoutError):
    """A read exceeded its per-read deadline (``SwapEngine.read_deadline_s``)
    or a request was shed at its deadline instead of being left to hang."""


class RequestCancelled(Exception):
    """The caller removed a queued request via ``ServingScheduler.cancel``
    (e.g. after its own ``wait(timeout)`` expired) — a decision, not a
    fault, so it never counts against a model's failure breaker."""
