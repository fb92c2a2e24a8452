"""Artifact promotion — publish a finished job's artifacts for inference.

Capability parity with the reference's ``PromotionTask``
(``app/tasks/promotion.py:10-62`` — SURVEY.md §2 component 19, §3.4): a
background copy of the artifacts prefix into the deploy bucket with the state
machine NOT_PROMOTED → IN_PROGRESS → COMPLETED/FAILED, and the reverse
(DELETING → cleanup → NOT_PROMOTED).
"""

from __future__ import annotations

import asyncio
import logging

from ..obs import events as obs_events
from ..obs.events import make_event
from .objectstore import ObjectStore, build_uri
from .schemas import PromotionStatus
from .statestore import StateStore

logger = logging.getLogger(__name__)

#: settled promotion state → timeline event (docs/observability.md)
_SETTLE_EVENTS = {
    PromotionStatus.COMPLETED: obs_events.PROMOTED,
    PromotionStatus.FAILED: obs_events.PROMOTION_FAILED,
    PromotionStatus.NOT_PROMOTED: obs_events.UNPROMOTED,
}


def promotion_destination(deploy_bucket: str, promotion_path: str, job_id: str) -> str:
    """Reference: destination assembly, ``app/main.py:736,769-771``."""
    return build_uri(deploy_bucket, promotion_path, job_id)


class PromotionTask:
    """Background promote/unpromote operations (run via ``asyncio.create_task``,
    the reference used FastAPI ``BackgroundTasks`` — ``app/main.py:776-781``)."""

    def __init__(self, state: StateStore, store: ObjectStore):
        self.state = state
        self.store = store

    async def _settle(
        self, job_id: str, expect: PromotionStatus, to: PromotionStatus,
        uri: str | None = None,
    ) -> None:
        """CAS the task's completion write: applies only while the job is
        still in the state THIS task claimed.  A blind write here could stomp
        a crash-recovery sweep (another process already marked FAILED and the
        user re-promoted) — the stale task must lose, not the fresh one."""
        if not await self.state.transition_job_promotion(
            job_id, [expect], to, uri
        ):
            logger.warning(
                "promotion state for %s moved concurrently (expected %s); "
                "leaving the newer transition in place", job_id, expect.value,
            )
            return
        event = _SETTLE_EVENTS.get(to)
        if event is not None:
            # timeline (docs/observability.md): only the task whose CAS won
            # records the outcome — a stale task's event would lie
            try:
                await self.state.append_job_event(
                    job_id, make_event(event, destination=uri)
                )
            except Exception:
                logger.debug("timeline append (%s) failed for %s", event,
                             job_id, exc_info=True)

    async def promote_job_task(
        self, job_id: str, artifacts_uri: str, destination_uri: str
    ) -> None:
        """Reference: ``promotion.py:11-36``.  The caller already claimed
        IN_PROGRESS via ``begin_promotion``; every write here is a CAS from
        that state so concurrent transitions are never overwritten."""
        try:
            n = await self.store.copy_prefix(artifacts_uri, destination_uri)
            if n == 0:
                raise FileNotFoundError(f"no artifacts under {artifacts_uri}")
            await self._settle(
                job_id, PromotionStatus.IN_PROGRESS, PromotionStatus.COMPLETED,
                destination_uri,
            )
            logger.info("promoted %s: %d objects -> %s", job_id, n, destination_uri)
        except asyncio.CancelledError:
            # shutdown mid-copy: record FAILED so the job isn't stuck
            # IN_PROGRESS forever (the promote guard refuses retries otherwise)
            await self._settle(
                job_id, PromotionStatus.IN_PROGRESS, PromotionStatus.FAILED
            )
            raise
        except Exception:
            logger.exception("promotion failed for %s", job_id)
            await self._settle(
                job_id, PromotionStatus.IN_PROGRESS, PromotionStatus.FAILED
            )

    async def unpromote_job_task(self, job_id: str, destination_uri: str) -> None:
        """Reference: ``unpromote_job_task``, ``promotion.py:38-62``; DELETING
        was claimed by the caller's ``begin_promotion`` CAS."""
        try:
            await self.store.delete_prefix(destination_uri)
            await self._settle(
                job_id, PromotionStatus.DELETING, PromotionStatus.NOT_PROMOTED
            )
            logger.info("unpromoted %s (removed %s)", job_id, destination_uri)
        except asyncio.CancelledError:
            await self._settle(
                job_id, PromotionStatus.DELETING, PromotionStatus.FAILED
            )
            raise
        except Exception:
            logger.exception("unpromotion failed for %s", job_id)
            await self._settle(
                job_id, PromotionStatus.DELETING, PromotionStatus.FAILED
            )

    async def recover_interrupted(self) -> int:
        """Crash recovery at startup: anything still IN_PROGRESS/DELETING has
        no task running (the process died) — mark FAILED so the user can retry."""
        n = 0
        for job in await self.state.find_jobs_with_promotion_in(
            [PromotionStatus.IN_PROGRESS, PromotionStatus.DELETING]
        ):
            # CAS from the observed in-flight state: with a shared remote
            # store, another replica's LIVE task may settle between our read
            # and this write — its fresher transition must win
            if await self.state.transition_job_promotion(
                job.job_id,
                [PromotionStatus.IN_PROGRESS, PromotionStatus.DELETING],
                PromotionStatus.FAILED,
            ):
                n += 1
        if n:
            logger.warning("marked %d interrupted promotion(s) as failed", n)
        return n
