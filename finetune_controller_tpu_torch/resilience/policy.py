"""Retry policy: failure classification + capped decorrelated-jitter backoff.

A copy of the reference's ``resilience/policy.py`` (stdlib only), kept by
the port so that its serve fleet and router import nothing of the reference
package.

The serve fleet uses it twice: the router classifies a decode-step fault
to decide whether a request fails over to another replica, and the fleet
spaces the respawns of a failed replica by :class:`RetryPolicy`.  Retryable
classes are infrastructure failures (the work is fine, the replica was
not); a user failure is terminal, since a retry replays the same crash.
Everything here is stdlib-only and deterministic under a seed.
"""

from __future__ import annotations

import dataclasses
import enum
import random


class FailureClass(str, enum.Enum):
    """Why a job stopped — the axis the retry decision turns on."""

    #: SIGTERM-shaped exits (spot reclaim, liveness-lease kill, eviction).
    #: The trainer checkpoints on SIGTERM (``train/trainer.py``
    #: PreemptionGuard), so a respawn resumes nearly for free.
    PREEMPTION = "preemption"
    #: the substrate failed the job: SIGKILL/OOM, the backend forgot it,
    #: object-store errors, a resubmit that itself failed
    INFRA = "infra"
    #: the job failed deterministically (bad hyperparameters, a crashing
    #: spec, data errors) — retrying replays the same crash
    USER = "user"
    #: not enough signal to classify
    UNKNOWN = "unknown"


#: classes worth another attempt.  UNKNOWN is retryable on purpose: the cost
#: of one wasted respawn is far below the cost of abandoning a long run over
#: a report the backend could not describe.
RETRYABLE: frozenset[FailureClass] = frozenset(
    {FailureClass.PREEMPTION, FailureClass.INFRA, FailureClass.UNKNOWN}
)

#: message fragments that identify an infrastructure failure when no exit
#: code is available (lease kills and lost-job sweeps synthesize these)
_INFRA_HINTS = (
    "lease expired",
    "no longer tracked",
    "vanished",
    "resubmit failed",
    "backend error",
    "artifact sync failed",
)

#: 128 + signal number exits, as the shell (and our subprocess backend) report
_SIGTERM_EXITS = frozenset({143, -15})
_SIGKILL_EXITS = frozenset({137, -9, 134, -6})  # SIGKILL/OOM + SIGABRT


def classify_failure(exit_code: int | None, message: str = "") -> FailureClass:
    """Map an exit code (+ free-text backend message) to a failure class.

    Exit-code conventions: ``143``/``-15`` is a SIGTERM exit — the trainer's
    save-and-exit preemption path uses exactly this code — and ``137``/``-9``
    is the OOM-killer / forced reclaim.  A plain ``1`` or ``2`` is a Python
    traceback or usage error: deterministic, therefore terminal.
    """
    msg = (message or "").lower()
    if exit_code in _SIGTERM_EXITS:
        return FailureClass.PREEMPTION
    if exit_code in _SIGKILL_EXITS:
        return FailureClass.INFRA
    if any(h in msg for h in _INFRA_HINTS):
        return FailureClass.INFRA
    if exit_code is not None and exit_code > 0:
        if exit_code in (1, 2):
            return FailureClass.USER
        if exit_code > 128:
            # some other fatal signal — treat as infrastructure
            return FailureClass.INFRA
        return FailureClass.USER
    return FailureClass.UNKNOWN


@dataclasses.dataclass
class RetryPolicy:
    """Max-attempt budget + capped exponential backoff with decorrelated jitter.

    The delay schedule is the "decorrelated jitter" variant (each delay drawn
    uniformly from ``[base, 3 * previous]``, capped): it decorrelates the
    respawn times of jobs that failed together — a revoked TPU pool takes
    every job down in the same second, and deterministic exponential backoff
    would march them all back in lockstep.

    ``seed`` makes the schedule reproducible (the chaos tests pin it);
    ``None`` seeds from entropy like any production backoff.
    """

    max_attempts: int = 3
    base_delay_s: float = 2.0
    max_delay_s: float = 60.0
    retry_on: frozenset[FailureClass] = RETRYABLE
    seed: int | None = None

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def classify(self, exit_code: int | None, message: str = "") -> FailureClass:
        return classify_failure(exit_code, message)

    def should_retry(self, failure: FailureClass, attempt: int) -> bool:
        """``attempt`` is the 1-based number of the attempt that just failed;
        ``max_attempts`` bounds the TOTAL run count, so the last permitted
        attempt's failure is terminal."""
        return failure in self.retry_on and attempt < self.max_attempts

    def next_delay(self, prev_delay_s: float | None = None) -> float:
        """Decorrelated jitter: ``uniform(base, 3 * prev)`` capped at max."""
        prev = prev_delay_s if prev_delay_s else self.base_delay_s
        hi = max(self.base_delay_s, min(self.max_delay_s, 3.0 * prev))
        return self._rng.uniform(self.base_delay_s, hi)
