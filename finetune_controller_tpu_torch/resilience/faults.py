"""Serve-plane fault injection: the chaos hand on a fleet replica.

A copy of the serve part of the reference's ``resilience/faults.py``
(stdlib only).  A :class:`ServeFault` kills a chosen replica (its decode
step raises :class:`ReplicaKilled`) or wedges it (its decode step stops
making progress while holding lanes) when that replica's engine reaches a
chosen decode step.  Armed directly or through ``FTC_FAULT_SERVE_*``; the
fleet arms it by wrapping the victim engine's ``step``.
"""

from __future__ import annotations

import dataclasses
import logging
import os

logger = logging.getLogger(__name__)

ENV_SERVE_REPLICA = "FTC_FAULT_SERVE_REPLICA"
ENV_SERVE_AT_STEP = "FTC_FAULT_SERVE_AT_STEP"
ENV_SERVE_MODE = "FTC_FAULT_SERVE_MODE"
ENV_SERVE_ONCE_FILE = "FTC_FAULT_SERVE_ONCE_FILE"


class ReplicaKilled(RuntimeError):
    """The injected replica crash (raised from the victim's decode step).

    A distinct type so tests can assert on the injection, but the router
    deliberately does NOT special-case it: the failover path classifies it
    like any other decode fault (``resilience.policy.classify_failure``), so
    the chaos harness exercises exactly the code path a real CUDA fault takes.
    """


@dataclasses.dataclass(frozen=True)
class ServeFault:
    """One scheduled serve-replica failure: when replica ``replica_id``'s
    engine reaches decode step ``at_step`` with work in flight, its step
    either raises (``mode="kill"`` — the crashed-replica shape) or silently
    stops advancing while holding its lanes (``mode="stall"`` — the
    stuck-decode shape the health check must catch)."""

    replica_id: str
    at_step: int
    mode: str = "kill"  # "kill" | "stall"
    #: marker file created when the fault fires; while it exists the fault
    #: is spent — the restarted replica (same env) runs clean.  None = the
    #: fault re-arms on every matching replica that reaches the step.
    once_file: str | None = None

    def to_env(self) -> dict[str, str]:
        env = {
            ENV_SERVE_REPLICA: self.replica_id,
            ENV_SERVE_AT_STEP: str(self.at_step),
            ENV_SERVE_MODE: self.mode,
        }
        if self.once_file:
            env[ENV_SERVE_ONCE_FILE] = self.once_file
        return env

    @classmethod
    def from_env(cls, env=os.environ) -> "ServeFault | None":
        replica = env.get(ENV_SERVE_REPLICA)
        raw_step = env.get(ENV_SERVE_AT_STEP)
        if not replica or not raw_step:
            return None
        try:
            at_step = int(raw_step)
        except ValueError:
            logger.warning("ignoring malformed serve fault env: %s=%r",
                           ENV_SERVE_AT_STEP, raw_step)
            return None
        mode = env.get(ENV_SERVE_MODE, "kill").strip().lower()
        if mode not in ("kill", "stall"):
            logger.warning("ignoring unknown serve fault mode %r", mode)
            return None
        return cls(replica_id=replica, at_step=at_step, mode=mode,
                   once_file=env.get(ENV_SERVE_ONCE_FILE) or None)


class ServeFaultInjector:
    """Fleet-side trigger: wraps the victim replica's ``engine.step``.

    The wrapper fires once per injector when the engine's ``steps_total``
    reaches the fault's step WITH requests in flight (a mid-workload kill,
    not an idle one).  ``kill`` raises :class:`ReplicaKilled` — the batcher's
    step-fault path fails the in-flight futures and the router retries them
    on a survivor; ``stall`` returns no progress while the lanes stay held —
    only the fleet's stalled-decode health check can catch that shape.
    """

    def __init__(self, fault: ServeFault):
        self.fault = fault
        self.fired = False

    @classmethod
    def from_env(cls, env=os.environ) -> "ServeFaultInjector | None":
        fault = ServeFault.from_env(env)
        return cls(fault) if fault is not None else None

    def _spend_once(self) -> bool:
        """True when the fault may fire (and marks it spent)."""
        once = self.fault.once_file
        if once:
            if os.path.exists(once):
                return False  # spent by a previous replica/process
            with open(once, "w") as f:
                f.write(f"serve fault fired ({self.fault.mode})\n")
        return True

    def arm(self, replica_id: str, engine) -> bool:
        """Wrap ``engine.step`` when ``replica_id`` matches; returns whether
        the replica was armed.  (The reference's ``hard_kill`` variant
        SIGKILLs a worker process; the port's fleet runs in-process
        replicas only.)"""
        if replica_id != self.fault.replica_id:
            return False
        real_step = engine.step
        fault = self.fault

        def faulty_step():
            due = (
                not self.fired
                and engine.steps_total >= fault.at_step
                and engine.active_requests > 0
            )
            if due and self._spend_once():
                self.fired = True
                logger.warning(
                    "serve fault injection: %s replica %s at decode step %d",
                    fault.mode, replica_id, engine.steps_total,
                )
            if self.fired:
                if fault.mode == "kill":
                    raise ReplicaKilled(
                        f"serve fault injection: replica {replica_id} killed "
                        f"at decode step {engine.steps_total}"
                    )
                return []  # stall: hold the lanes, make no progress
            return real_step()

        engine.step = faulty_step
        return True
