# Verbatim copy of src/repro/campaign/faults.py (loads no jax).
"""Deterministic fault injection for campaign robustness testing.

A fault-tolerant runner is only as trustworthy as the failure paths its
tests actually execute.  This module provides the seam: the campaign
runner calls :meth:`FaultSchedule.check` at every shard boundary (just
before dispatching the shard's ``index_range`` sweep), and the schedule
— built either from an explicit ``{(shard_lo, attempt): fault}`` map or
from a seed + per-kind rates — raises the scheduled fault.  Schedules
are pure functions of ``(seed, shard_lo, attempt)`` (hash-derived, no
mutable RNG state), so a test or a resumed campaign replays the exact
same failure sequence regardless of shard execution order.

Fault taxonomy (mirrors the runner's classifier for REAL exceptions):

* :class:`TransientFault` — retry with exponential backoff (bounded);
* :class:`ShardTimeout` — a transient subtype the runner raises itself
  when a shard exceeds ``timeout_s``;
* :class:`OOMFault` — the shard is too big: split it in half and retry
  the halves (recursively, down to ``min_shard_points``);
* :class:`DeterministicFault` — retrying cannot help: quarantine the
  shard and continue (graceful degradation, partial-result report);
* :class:`KillCampaign` — simulated SIGKILL: propagates out of the
  runner mid-campaign, leaving the checkpoint directory exactly as a
  killed process would.  ``resume()`` then picks up the survivors.
* :class:`KillWorker` — simulated SIGKILL of ONE pool worker process
  (``workers > 1``): the in-flight shard is lost and retried as
  transient while the pool respawns a replacement — never an abort.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, Optional, Tuple, Union


class CampaignFault(Exception):
    """Base class for injected campaign faults."""
    kind = "deterministic"


class TransientFault(CampaignFault):
    """Recoverable by retrying (e.g. a flaky device / RPC hiccup)."""
    kind = "transient"


class ShardTimeout(TransientFault):
    """The shard exceeded its ``timeout_s`` budget (retried as
    transient; a genuinely hung dispatch keeps failing and quarantines
    after ``max_retries``)."""
    kind = "transient"


class OOMFault(CampaignFault):
    """The shard's working set exceeded device memory: the runner
    splits the index range in half and retries the halves."""
    kind = "oom"


class DeterministicFault(CampaignFault):
    """A reproducible failure retrying cannot fix: quarantined."""
    kind = "deterministic"


class KillCampaign(CampaignFault):
    """Simulated process death (SIGKILL): the runner re-raises this
    without any handling, so on-disk state is whatever the completed
    shards already checkpointed."""
    kind = "kill"


class KillWorker(TransientFault):
    """Simulated WORKER death (SIGKILL of one pool process).

    Under a parallel executor (``workers > 1``) the scheduled shard is
    submitted with a die flag and the target worker SIGKILLs itself on
    receipt — the shard is genuinely in flight in a process that
    genuinely dies, exercising the real detection / salvage / respawn
    path.  The loss classifies as *transient* (the shard retries on a
    surviving or respawned worker); the campaign never aborts.  Under
    the serial executor there is no separate process: the fault is
    raised at the shard boundary and retried as an ordinary transient.
    """
    kind = "transient"


#: a schedule entry: an exception instance/class, or a callable
#: ``(lo, hi, attempt) -> Optional[BaseException]``
FaultSpec = Union[BaseException, type, Callable]


def _unit_hash(seed: int, lo: int, attempt: int, salt: str) -> float:
    """Deterministic uniform in [0, 1) from (seed, shard, attempt)."""
    h = hashlib.sha256(f"{seed}:{lo}:{attempt}:{salt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultSchedule:
    """Seeded / explicit failure schedule injected at shard boundaries.

    ``faults`` maps ``(shard_lo, attempt)`` (1-based attempt) to the
    fault to raise when the runner is about to execute the shard whose
    range starts at ``shard_lo`` for the ``attempt``-th time.  Entries
    may be exception instances, exception classes, or callables
    ``(lo, hi, attempt) -> exception | None``.

    ``seed`` + ``rates`` add hash-derived random faults: for each
    ``(shard_lo, attempt)`` an independent uniform per fault kind is
    compared against ``rates = {"transient": p, "oom": p,
    "deterministic": p}`` — deterministic in the seed, independent of
    execution order, identical on resume.

    ``kill_after`` simulates SIGKILL after N shards have COMPLETED:
    the runner reports its completed count on every check and the
    schedule raises :class:`KillCampaign` the first time
    ``n_completed >= kill_after``.  ``max_injections`` bounds the total
    number of seeded (rate-based) faults so a schedule can never
    quarantine an entire campaign by chance.
    """

    def __init__(self, faults: Optional[Dict[Tuple[int, int],
                                             FaultSpec]] = None, *,
                 seed: Optional[int] = None,
                 rates: Optional[Dict[str, float]] = None,
                 kill_after: Optional[int] = None,
                 max_injections: Optional[int] = None):
        self.faults = dict(faults or {})
        self.seed = seed
        self.rates = dict(rates or {})
        unknown = set(self.rates) - {"transient", "oom", "deterministic"}
        if unknown:
            raise ValueError(f"unknown fault-rate kinds {sorted(unknown)}; "
                             f"valid: ['transient', 'oom', "
                             f"'deterministic']")
        if self.rates and seed is None:
            raise ValueError("rate-based fault injection needs a seed "
                             "(schedules must be deterministic)")
        self.kill_after = kill_after
        self.max_injections = max_injections
        self.injected = 0          # audit counter (all raised faults)
        self.log: list = []        # [(lo, hi, attempt, kind), ...]

    _KINDS = {"transient": TransientFault, "oom": OOMFault,
              "deterministic": DeterministicFault}

    def _raise(self, exc: BaseException, lo: int, hi: int,
               attempt: int) -> None:
        self.injected += 1
        self.log.append((lo, hi, attempt,
                         getattr(exc, "kind", "deterministic")))
        raise exc

    def check(self, lo: int, hi: int, attempt: int, *,
              n_completed: int = 0) -> None:
        """Raise the fault scheduled for this (shard, attempt), if any.

        Called by the runner immediately before dispatching the shard
        ``[lo, hi)`` for the ``attempt``-th time (1-based);
        ``n_completed`` is the number of shards checkpointed so far in
        THIS runner invocation (drives ``kill_after``).
        """
        if self.kill_after is not None and n_completed >= self.kill_after:
            self._raise(KillCampaign(
                f"injected kill after {n_completed} completed shards"),
                lo, hi, attempt)
        spec = self.faults.get((lo, attempt))
        if spec is not None:
            exc = spec
            if callable(spec) and not isinstance(spec, BaseException):
                exc = (spec(lo, hi, attempt)
                       if not isinstance(spec, type) else spec(
                           f"injected at shard [{lo}, {hi}) "
                           f"attempt {attempt}"))
            if exc is not None:
                self._raise(exc, lo, hi, attempt)
        if self.seed is not None and (
                self.max_injections is None
                or self.injected < self.max_injections):
            for kind, rate in sorted(self.rates.items()):
                if _unit_hash(self.seed, lo, attempt, kind) < rate:
                    self._raise(self._KINDS[kind](
                        f"seeded {kind} fault at shard [{lo}, {hi}) "
                        f"attempt {attempt}"), lo, hi, attempt)


def classify_failure(exc: BaseException) -> str:
    """Map an exception to a handling policy: ``'transient'`` (retry w/
    backoff), ``'oom'`` (split the shard), ``'deterministic'``
    (quarantine) or ``'kill'`` (propagate).

    Injected :class:`CampaignFault` subtypes carry their kind; real
    exceptions are classified by type and message — XLA surfaces OOM as
    ``RESOURCE_EXHAUSTED`` and transient runtime trouble as
    ``UNAVAILABLE`` / ``DEADLINE_EXCEEDED`` in the error string.
    """
    if isinstance(exc, CampaignFault):
        return exc.kind
    if isinstance(exc, MemoryError):
        return "oom"
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return "transient"
    msg = str(exc).lower()
    if "resource_exhausted" in msg or "out of memory" in msg:
        return "oom"
    if "unavailable" in msg or "deadline_exceeded" in msg:
        return "transient"
    return "deterministic"
