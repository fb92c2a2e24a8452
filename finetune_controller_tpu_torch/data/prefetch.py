"""Overlapped host input pipeline: background prefetch + device transfer (a
copy of the reference's ``data/prefetch.py``; the optional transfer stage is
any callable, e.g. a copy to the card).

Every loader in this package (``loader``, ``synthetic``) yields host-side
numpy batches from a plain Python iterator — built synchronously on the
training thread, so the device idles for the whole host build.
:class:`PrefetchIterator` wraps any of them with the Podracer-style overlap
(arXiv:2104.06272): a bounded background producer builds batch N+1..N+k while
the device runs step N, and an optional transfer stage runs on the producer
thread too.

Contract:
  * **order-preserving** — one producer thread + a FIFO queue; batch k of the
    wrapped iterator is the k-th batch out, so checkpoint-resume
    fast-forwarding stays deterministic (tested);
  * **bounded** — at most ``depth`` finished batches wait in the queue (plus
    one being built), so host memory stays O(depth) batches;
  * **crash-transparent** — a producer exception is re-raised on the
    consumer thread as the ORIGINAL exception (no hang, no wrapper type);
  * **clean shutdown** — :meth:`close` (also on context-manager exit) stops
    the producer even when it is blocked on a full queue; the thread is a
    daemon so an unclosed iterator never wedges interpreter exit;
  * **observable** — per-batch host-build / transfer seconds (producer side)
    and consumer wait seconds are recorded; :meth:`pop_stats` drains
    windowed aggregates for metrics/bench reporting.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

__all__ = ["PrefetchIterator", "prefetch_batches"]

#: queue sentinel: the wrapped iterator is exhausted
_DONE = object()


class _Failure:
    """Producer-side exception, carried through the queue to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchIterator:
    """Wrap ``batches`` with a background producer thread (depth-bounded
    queue) and an optional ``transfer`` stage applied on the producer thread
    (e.g. a copy of the batch to the card)."""

    def __init__(
        self,
        batches: Iterable[Any],
        depth: int = 2,
        transfer: Callable[[Any], Any] | None = None,
        name: str = "input-prefetch",
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._inner = iter(batches)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._transfer = transfer
        self._exhausted = False
        # consumer-visible timing (what the training step actually waited)
        self.last_wait_s = 0.0
        # producer-side timing for the batch most recently handed out
        self.last_build_s = 0.0
        self.last_transfer_s = 0.0
        self._agg_lock = threading.Lock()
        self._agg = {"batches": 0, "build_s": 0.0, "transfer_s": 0.0,
                     "wait_s": 0.0}
        self._thread = threading.Thread(
            target=self._produce, name=name, daemon=True
        )
        self._thread.start()

    # ---- producer ---------------------------------------------------------

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(self._inner)
                except StopIteration:
                    self._put(_DONE)
                    return
                build_s = time.perf_counter() - t0
                t1 = time.perf_counter()
                if self._transfer is not None:
                    batch = self._transfer(batch)
                transfer_s = time.perf_counter() - t1
                if not self._put((batch, build_s, transfer_s)):
                    return  # closed while waiting for queue space
        except BaseException as exc:  # noqa: BLE001  # ftc: ignore[silent-except] -- not swallowed: carried across the thread boundary and re-raised on the consumer in __next__
            self._put(_Failure(exc))

    def _put(self, item: Any) -> bool:
        """Bounded put that stays responsive to :meth:`close` — a plain
        blocking ``put`` on a full queue would hang shutdown forever."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # ---- consumer ---------------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._exhausted:
            raise StopIteration
        if self._stop.is_set():
            # closed: the producer exited without posting _DONE and the
            # queue was drained — a blocking get() here would hang forever
            raise StopIteration
        t0 = time.perf_counter()
        item = self._queue.get()
        self.last_wait_s = time.perf_counter() - t0
        if item is _DONE:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, _Failure):
            self._exhausted = True
            self.close()
            raise item.exc  # the original exception, original traceback
        batch, self.last_build_s, self.last_transfer_s = item
        with self._agg_lock:
            self._agg["batches"] += 1
            self._agg["build_s"] += self.last_build_s
            self._agg["transfer_s"] += self.last_transfer_s
            self._agg["wait_s"] += self.last_wait_s
        return batch

    def pop_stats(self) -> dict[str, float]:
        """Drain the aggregate window: totals since the last pop —
        ``batches``, producer-side ``build_s``/``transfer_s``, and
        consumer-visible ``wait_s``."""
        with self._agg_lock:
            out = dict(self._agg)
            for k in self._agg:
                self._agg[k] = 0 if k == "batches" else 0.0
        return out

    # ---- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Stop the producer and join it. Safe to call repeatedly, and from
        the consumer while the producer is blocked on a full queue."""
        self._stop.set()
        # drain so a producer stuck in _put observes the stop event promptly
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        # the producer can still be inside next(self._inner) (e.g. an image
        # decode) — bounded join; the daemon thread cannot block exit
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def prefetch_batches(
    batches: Iterable[Any],
    depth: int = 2,
    transfer: Callable[[Any], Any] | None = None,
) -> Iterator[Any]:
    """Wrap ``batches`` with background prefetch; ``depth <= 0`` is the
    escape hatch — the plain synchronous iterator comes back unchanged."""
    if depth <= 0:
        return iter(batches)
    return PrefetchIterator(batches, depth=depth, transfer=transfer)
