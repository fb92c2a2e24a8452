"""Deterministic, seeded fault injection: the chaos harness's hand on the
process (a copy of the reference's stdlib-only ``resilience/faults.py``).

- **kill-at-step** (:class:`StepFault`): the trainer, at a chosen global
  step, sends a chosen signal to itself.  Armed through the environment
  (``FTC_FAULT_KILL_AT_STEP``, ``FTC_FAULT_SIGNAL``, ``FTC_FAULT_ONCE_FILE``;
  the local backend's ``extra_env`` seam), fired at most once per
  ``once_file`` so the respawned attempt runs clean: one revocation, then a
  healthy pool.  ``Trainer.fit`` arms it after every completed step; with
  SIGTERM the trainer saves and exits 143, with SIGKILL it dies without a
  save.
- **store faults** (:class:`FaultyObjectStore`): a wrapper over any object
  store of ``controller/objectstore.py`` whose write paths fail (or stall)
  on a seeded schedule.
- **serve faults** (:class:`ServeFault`): a chosen fleet replica is killed
  (its decode step raises :class:`ReplicaKilled`) or wedged (its decode step
  stops making progress while holding lanes) when that replica's engine
  reaches a chosen decode step.  Armed directly or through
  ``FTC_FAULT_SERVE_*``; the fleet arms it by wrapping the victim engine's
  ``step``.

Nothing here imports controller or serve modules.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import signal

logger = logging.getLogger(__name__)

ENV_KILL_AT_STEP = "FTC_FAULT_KILL_AT_STEP"
ENV_SIGNAL = "FTC_FAULT_SIGNAL"
ENV_ONCE_FILE = "FTC_FAULT_ONCE_FILE"

ENV_SERVE_REPLICA = "FTC_FAULT_SERVE_REPLICA"
ENV_SERVE_AT_STEP = "FTC_FAULT_SERVE_AT_STEP"
ENV_SERVE_MODE = "FTC_FAULT_SERVE_MODE"
ENV_SERVE_ONCE_FILE = "FTC_FAULT_SERVE_ONCE_FILE"


@dataclasses.dataclass(frozen=True)
class StepFault:
    """One scheduled kill: ``signum`` to self when training reaches
    ``kill_at_step``."""

    kill_at_step: int
    signum: int = signal.SIGTERM
    #: marker file created when the fault fires; while it exists the fault is
    #: spent — the respawned attempt (same env) runs clean. None = fire on
    #: every attempt that reaches the step.
    once_file: str | None = None

    def to_env(self) -> dict[str, str]:
        """Render for a backend's ``extra_env`` (the injection seam)."""
        env = {
            ENV_KILL_AT_STEP: str(self.kill_at_step),
            ENV_SIGNAL: str(int(self.signum)),
        }
        if self.once_file:
            env[ENV_ONCE_FILE] = self.once_file
        return env

    @classmethod
    def from_env(cls, env=os.environ) -> "StepFault | None":
        raw = env.get(ENV_KILL_AT_STEP)
        if not raw:
            return None
        try:
            step = int(raw)
            signum = int(env.get(ENV_SIGNAL, str(int(signal.SIGTERM))))
        except ValueError:
            logger.warning("ignoring malformed fault env: %s=%r",
                           ENV_KILL_AT_STEP, raw)
            return None
        return cls(kill_at_step=step, signum=signum,
                   once_file=env.get(ENV_ONCE_FILE) or None)


class StepFaultInjector:
    """Trainer-side trigger: call :meth:`maybe_fire` once per completed step."""

    def __init__(self, fault: StepFault):
        self.fault = fault
        self.fired = False

    @classmethod
    def from_env(cls, env=os.environ) -> "StepFaultInjector | None":
        fault = StepFault.from_env(env)
        return cls(fault) if fault is not None else None

    def maybe_fire(self, step: int) -> bool:
        """Send the configured signal to this process when ``step`` matches.

        Returns True when the signal was sent.  With SIGTERM the trainer's
        PreemptionGuard turns this into the graceful checkpoint-and-exit-143
        path; SIGKILL tests the crash-without-save path.
        """
        if self.fired or step < self.fault.kill_at_step:
            return False
        once = self.fault.once_file
        if once:
            if os.path.exists(once):
                return False  # spent on a previous attempt
            # create BEFORE the kill: a SIGKILL gives no chance afterwards
            with open(once, "w") as f:
                f.write(f"fired at step {step}\n")
        self.fired = True
        logger.warning("fault injection: sending signal %d to self at step %d",
                       self.fault.signum, step)
        os.kill(os.getpid(), self.fault.signum)
        return True


class FaultInjectionError(OSError):
    """The injected store failure (distinct type so tests can assert on it)."""


class FaultyObjectStore:
    """Seeded write-error / slow-I/O wrapper around any ObjectStore.

    Write-path methods (``put_bytes``/``put_file``/``put_stream``) fail with
    :class:`FaultInjectionError` with probability ``write_error_rate`` drawn
    from a seeded RNG — the schedule is a pure function of the seed and the
    call sequence, so a chaos test replays identically.  ``slow_io_s`` adds a
    fixed delay before each write.  Everything else delegates to the wrapped
    store untouched.
    """

    def __init__(
        self,
        inner,
        *,
        write_error_rate: float = 0.0,
        slow_io_s: float = 0.0,
        seed: int = 0,
    ):
        self._inner = inner
        self.write_error_rate = write_error_rate
        self.slow_io_s = slow_io_s
        self._rng = random.Random(seed)
        self.injected_errors = 0
        self.write_calls = 0

    async def _maybe_fail(self, op: str, uri: str) -> None:
        if self.slow_io_s > 0:
            import asyncio

            await asyncio.sleep(self.slow_io_s)
        self.write_calls += 1
        if self._rng.random() < self.write_error_rate:
            self.injected_errors += 1
            raise FaultInjectionError(f"injected {op} failure for {uri}")

    async def put_bytes(self, uri, data):
        await self._maybe_fail("put_bytes", uri)
        return await self._inner.put_bytes(uri, data)

    async def put_file(self, uri, path):
        await self._maybe_fail("put_file", uri)
        return await self._inner.put_file(uri, path)

    async def put_stream(self, uri, chunks):
        await self._maybe_fail("put_stream", uri)
        return await self._inner.put_stream(uri, chunks)

    def __getattr__(self, name):
        # reads, listings, helpers: pass through (slow_io applies to writes
        # only — read-side degradation is a different experiment)
        return getattr(self._inner, name)


# ---------------------------------------------------------------------------
# Serve-plane faults
# ---------------------------------------------------------------------------


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

    def arm(self, replica_id: str, engine, *, hard_kill: bool = False) -> bool:
        """Wrap ``engine.step`` when ``replica_id`` matches; returns whether
        the replica was armed.

        ``hard_kill=True`` is the cross-process variant (the transport worker
        arms it): ``mode="kill"`` sends a REAL ``SIGKILL`` to the worker
        process instead of raising — the socket drops, the heartbeat stops,
        and the fleet runs its genuine crashed-worker detection.
        ``mode="stall"`` behaves the same in both variants."""
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
                    if hard_kill:
                        os.kill(os.getpid(), signal.SIGKILL)
                    raise ReplicaKilled(
                        f"serve fault injection: replica {replica_id} killed "
                        f"at decode step {engine.steps_total}"
                    )
                return []  # stall: hold the lanes, make no progress
            return real_step()

        engine.step = faulty_step
        return True
