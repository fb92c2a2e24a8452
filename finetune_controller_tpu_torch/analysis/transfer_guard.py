"""Runtime transfer guard: no silent device<->host syncs in the hot windows.

The expensive regression is the sync nobody wrote on purpose: a debug host
fetch left in the step path, a numpy array slipping into the step (an
implicit host->device copy every step), a logging helper that reads a device
value per token.  On the CPU these are free; on a card they stall the launch
queue and profile as "mysteriously slow", never as an error.

:class:`TransferGuard` wraps the two host-side hot windows — the trainer's
step and the serve engine's decode dispatch — and makes any transfer there a
LOUD failure:

* **the CUDA sync-debug mode**: inside a window on the card,
  ``torch.cuda.set_sync_debug_mode("error")`` (``"warn"`` in warn mode)
  makes every synchronizing CUDA call raise — a ``.item()``, a ``.cpu()``, a
  blocking host->device copy, a stream synchronize.  The mode is
  process-wide, so a guard arms it only on the main thread and only where
  its owner says no other thread drives the card (the trainer without a
  prefetch-to-device thread, an engine stepped directly); windows in worker
  threads (the batcher's replicas) rely on the next two checks alone;
* **the inputs**: a numpy array reaching a guarded call (on any device), or
  a CPU tensor of rank >= 1 beside CUDA tensors, trips the guard before the
  call runs — the implicit host->device copy the reference's
  ``transfer_guard_host_to_device("disallow")`` refuses;
* **a thread-local trap on the port's host fetch** (:func:`device_get`):
  inside a window it trips the guard on every device, the CPU included —
  the counterpart of the reference's ``jax.device_get`` trap, thread-safe by
  construction (the engine steps in worker threads while other threads
  fetch freely).

The first call per label is exempt: first-use work (a kernel's build and
load, the allocator's first blocks) legitimately syncs, and the guard
targets the steady state.  Windows nest per thread; the inner one wins.

Knobs:

* ``TrainConfig.transfer_guard`` — ``"raise"`` / ``"warn"`` / ``"off"``;
  the empty default inherits ``FTC_TRANSFER_GUARD``; any other value leaves
  the guard off, as in the reference;
* ``FTC_TRANSFER_GUARD`` — same values, read by the serve engine and as
  the trainer fallback; off when unset;
* ``FTC_FAULT_TRANSFER=1`` — the chaos hand: the guard itself performs a
  host fetch of the call's output INSIDE the window (on the card a raw
  device->host copy, which the sync-debug mode catches; elsewhere through
  :func:`device_get`), proving the abort path.

``action="warn"`` swaps the CUDA mode to torch's ``warn`` and downgrades
trap and input trips to a once-per-label warning — observation mode.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Any, Callable

import numpy as np
import torch

from .recompile_guard import tree_flatten

logger = logging.getLogger(__name__)

__all__ = ["TransferGuard", "TransferGuardError", "device_get"]


class TransferGuardError(RuntimeError):
    """A device<->host transfer happened inside a guarded hot window."""


_WINDOW = threading.local()  # .guard / .label while inside a window


def device_get(tree: Any) -> Any:
    """The port's host fetch: every tensor of ``tree`` (a nest of tuples,
    lists and dicts) as a numpy array on the host.  Inside a guarded window
    it trips the active guard first."""
    guard = getattr(_WINDOW, "guard", None)
    if guard is not None:
        guard._trip(f"device_get inside guarded window {getattr(_WINDOW, 'label', '?')!r}")

    def fetch(x: Any) -> Any:
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x

    if isinstance(tree, dict):
        return {k: device_get(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(device_get(v) for v in tree)
    return fetch(tree)


def _is_sync_error(exc: BaseException) -> bool:
    return "synchronizing CUDA operation" in str(exc)


class TransferGuard:
    """Guard hot windows against device<->host transfers.

    One instance spans a run (trainer) or an engine's lifetime (serve);
    ``trips`` counts violations observed — the clean-path assertion is
    ``trips == 0``.  ``arm_cuda`` says whether this guard's owner lets the
    window arm the process-wide CUDA sync-debug mode (it is still armed only
    on the main thread).
    """

    def __init__(self, action: str = "raise", *, name: str = "transfer-guard",
                 skip_first: bool = True, inject_fault: bool | None = None,
                 arm_cuda: bool = True):
        if action not in ("raise", "warn"):
            raise ValueError(f"action must be 'raise' or 'warn', got {action!r}")
        self.action = action
        self.name = name
        self.skip_first = skip_first
        self.arm_cuda = arm_cuda
        self.trips = 0
        self._warned: set[str] = set()
        self._calls: dict[str, int] = {}
        #: chaos hand: a real host fetch INSIDE the window, so tests and the
        #: card run prove the abort path end to end
        self._fault = (
            inject_fault if inject_fault is not None
            else os.environ.get("FTC_FAULT_TRANSFER", "") not in ("", "0")
        )

    @classmethod
    def from_env(cls, default: str = "off", *, name: str = "transfer-guard",
                 arm_cuda: bool = True) -> "TransferGuard | None":
        """Build from ``FTC_TRANSFER_GUARD`` (off/warn/raise); None = off."""
        mode = os.environ.get("FTC_TRANSFER_GUARD", default).strip().lower()
        if mode in ("", "0", "off", "false"):
            return None
        if mode in ("1", "on", "true"):
            mode = "raise"
        return cls(mode, name=name, arm_cuda=arm_cuda)

    # ---- the window --------------------------------------------------------

    def _trip(self, what: str) -> None:
        self.trips += 1
        detail = (
            f"{self.name}: {what} — a device<->host sync in a guarded hot "
            "window stalls the launch queue every step. Move the transfer "
            "outside the window (log-cadence host reads, explicit copies to "
            "the device before the call), or run with "
            "FTC_TRANSFER_GUARD=warn to observe without aborting."
        )
        if self.action == "raise":
            raise TransferGuardError(detail)
        label = getattr(_WINDOW, "label", "?")
        if label not in self._warned:
            self._warned.add(label)
            logger.warning("%s", detail)

    def _cuda_armed(self) -> bool:
        return (self.arm_cuda and torch.cuda.is_available()
                and threading.current_thread() is threading.main_thread())

    @contextlib.contextmanager
    def window(self, label: str):
        """Guard one hot-window execution.  Re-entrant per thread (the inner
        window wins); the first call per label is exempt."""
        n = self._calls.get(label, 0)
        self._calls[label] = n + 1
        if self.skip_first and n == 0:
            yield
            return
        prev_guard = getattr(_WINDOW, "guard", None)
        prev_label = getattr(_WINDOW, "label", None)
        _WINDOW.guard, _WINDOW.label = self, label
        armed = self._cuda_armed()
        prev_mode = torch.cuda.get_sync_debug_mode() if armed else 0
        if armed:
            torch.cuda.set_sync_debug_mode("error" if self.action == "raise" else "warn")
        try:
            yield
        except TransferGuardError:
            raise
        except RuntimeError as exc:
            if _is_sync_error(exc):
                self.trips += 1
                raise TransferGuardError(
                    f"{self.name}: the CUDA sync-debug mode caught a device<->host "
                    f"sync inside window {label!r}: {exc}"
                ) from exc
            raise
        finally:
            if armed:
                torch.cuda.set_sync_debug_mode(prev_mode)
            _WINDOW.guard, _WINDOW.label = prev_guard, prev_label

    def _check_inputs(self, label: str, args: tuple, kwargs: dict) -> None:
        leaves, _ = tree_flatten((args, kwargs))
        on_card = any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves)
        for x in leaves:
            if isinstance(x, np.ndarray):
                self._trip(f"a numpy array {x.shape} reached guarded call {label!r} "
                           "(an implicit host->device copy)")
                return
            if on_card and isinstance(x, torch.Tensor) and not x.is_cuda and x.ndim:
                self._trip(f"a host tensor {tuple(x.shape)} reached guarded call {label!r} "
                           "beside CUDA tensors (an implicit host->device copy)")
                return

    def run(self, label: str, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run ``fn`` inside a guarded window; the fault hand (if armed)
        fetches the result INSIDE the window."""
        with self.window(label):
            if getattr(_WINDOW, "guard", None) is self:  # not the exempt first call
                self._check_inputs(label, args, kwargs)
            out = fn(*args, **kwargs)
            self._maybe_inject(out)
            return out

    def _maybe_inject(self, out: Any) -> None:
        if not self._fault:
            return
        leaves = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        if not leaves:
            return
        x = leaves[0]
        if x.is_cuda and self._cuda_armed():
            x.detach().cpu()  # a raw device->host copy: the sync-debug mode's catch
        else:
            device_get(x)

    def wrap(self, fn: Callable, label: str) -> Callable:
        """Wrap a callable so every call runs in a guarded window."""

        def guarded(*args: Any, **kwargs: Any):
            return self.run(label, fn, *args, **kwargs)

        guarded.__name__ = f"transfer_guarded_{getattr(fn, '__name__', label)}"
        guarded.__wrapped__ = fn
        return guarded
