"""Training checkpoints with crash-safe, asynchronous saves (counterpart of
``train/checkpoint.py``).

Each checkpoint is a directory ``<root>/step_N/`` holding ``state.pt``
(``torch.save`` of ``{"step", "trainable", "opt_state"}``, tensors on the
CPU) and, when the trainer passes one, the topology ``manifest.json``
(``train/elastic.py``).  The contract is the reference's:

* **Atomic commit.** A save stages ``step_N.tmp/`` (state and manifest,
  both synced) and renames it into place, so a reader sees a whole
  checkpoint or none, and the state and its manifest commit together.  A
  replayed step replaces its earlier save.
* **Asynchronous saves.** :meth:`CheckpointManager.save` hands the state,
  already on the host, to a writer thread and returns; at most one save is
  in flight.  :meth:`~CheckpointManager.wait` is the durability barrier and
  re-raises a background save's exception; ``steps``, ``latest_step``,
  ``load_manifest`` and ``restore`` wait first.  Garbage collection runs on
  the writer thread after each commit and keeps the newest ``keep``
  committed steps.
* **Stale staging swept.** A kill mid-save strands its staging directory;
  the manager's constructor removes every staging name of both packages
  (``step_N.tmp``, ``step_N.manifest.tmp``, orbax's
  ``step_N.orbax-checkpoint-tmp-*`` and the port's earlier
  ``.step_N.tmp-<pid>``).
* **Shape-checked restore.** ``restore(step, like=)`` raises
  :class:`CheckpointShapeError` naming the first missing, extra or
  mis-shaped leaf (against the manifest when there is one, then against the
  state) before the caller copies anything.  A manifest-less checkpoint
  restores as before.
* **The JAX package's checkpoints.** A ``step_N/`` holding the reference's
  ``state.msgpack`` (its multi-process layout, ``_save_msgpack``) is read
  with ``utils/flax_msgpack.py``; a step in orbax's OCDBT layout (its
  one-process save, ``ocp.StandardCheckpointer``) with ``train/ocdbt.py``
  (the OCDBT database, zarr v2 arrays, zstd frames by the native decoder
  ``csrc/zstd_decode.cc``).  Either tree is mapped to the port's state:
  the trainable flax paths through ``models/convert.trainable_from_flax``,
  optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) to the port's
  optimizer state (``train/optimizer.py`` matches the optax chain step for
  step); its manifest's leaves are checked under the mapped names.  The
  port writes only its own layout.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Mapping

import torch

logger = logging.getLogger(__name__)

_STEP_DIR = re.compile(r"^step_(\d+)$")
#: uncommitted save staging: the reference's ``step_N.tmp``,
#: ``step_N.manifest.tmp`` and orbax's ``step_N.orbax-checkpoint-tmp-<ts>``,
#: and the port's earlier ``.step_N.tmp-<pid>`` — a kill mid-save strands
#: any of them
_TMP_RE = re.compile(
    r"^(step_\d+(\.tmp|\.manifest\.tmp|\.orbax-checkpoint-tmp-.*)|\.step_\d+\.tmp-\d+)$"
)

MANIFEST_NAME = "manifest.json"
STATE_NAME = "state.pt"
MSGPACK_NAME = "state.msgpack"
#: files orbax's OCDBT layout leaves in a committed step directory
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "ocdbt.process_0",
                  "_sharding", "d")


def _shape_desc(node: object) -> str:
    if isinstance(node, dict):
        return "a subtree"
    shape = tuple(getattr(node, "shape", ()) or ())
    return f"shape {shape}"


class CheckpointShapeError(ValueError):
    """A restore target (``like`` tree) does not match the checkpoint.

    Raised before any tensor is copied, with the first offending leaf path
    and both shapes."""

    def __init__(self, path: str, ckpt: object, like: object):
        self.path = path
        super().__init__(
            f"checkpoint/template mismatch at {path!r}: checkpoint has "
            f"{ckpt}, restore template has {like} — wrong model config or "
            "training mode for this checkpoint"
        )


class _Shape(tuple):
    """A manifest leaf's shape, standing in for the array it describes."""

    @property
    def shape(self) -> tuple:
        return tuple(self)

    def __getitem__(self, i):
        out = tuple.__getitem__(self, i)
        return _Shape(out) if isinstance(i, slice) else out


def _adam_node(tree: Any) -> Mapping | None:
    """The first ``{count, mu, nu}`` node of an optax state dict."""
    if not isinstance(tree, Mapping):
        return None
    if {"count", "mu", "nu"} <= set(tree):
        return tree
    for key in sorted(tree):
        found = _adam_node(tree[key])
        if found is not None:
            return found
    return None


def state_from_jax(raw: Mapping) -> dict[str, Any]:
    """The port's ``{"step", "trainable", "opt_state"}`` for a JAX trainer's
    host state dict (``flax.serialization.to_state_dict`` of ``step``,
    ``trainable`` and the ``clip_by_global_norm`` + ``adamw`` state).
    Leaves stay what they are (arrays, or :class:`_Shape` for a manifest)."""
    from ..models.convert import flat_paths, trainable_from_flax

    for key in ("step", "trainable", "opt_state"):
        if key not in raw:
            raise CheckpointShapeError(key, "<missing>", "a subtree" if key != "step"
                                       else "shape ()")
    adam = _adam_node(raw["opt_state"])
    if adam is None:
        raise CheckpointShapeError("opt_state", "no ScaleByAdamState (count, mu, nu)",
                                   "the port's AdamW state")

    def named(tree):
        return trainable_from_flax(flat_paths(tree)) if isinstance(tree, Mapping) else {}

    return {"step": raw["step"], "trainable": named(raw["trainable"]),
            "opt_state": {"count": adam["count"], "mu": named(adam["mu"]),
                          "nu": named(adam["nu"])}}


def _nest(leaves: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for path, value in leaves.items():
        *parents, last = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def _to_tensor(x: Any):
    import numpy as np

    from ..models.convert import _tensor

    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    return int(arr) if arr.ndim == 0 and arr.dtype.kind in "iu" else _tensor(arr)


class CheckpointManager:
    """Saves are asynchronous by default: :meth:`save` hands the (already
    host-side) state to a writer thread and returns, so serialization and
    disk I/O overlap the next training steps.  At most one save is in
    flight; :meth:`wait` (called before the next save, any read, and by the
    trainer's exit path) is the durability barrier."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3, *, sweep: bool = True):
        """``sweep=False`` for a reader (the serving loader, the rlhf
        actor): only the directory's writer sweeps, so a reader never
        removes the staging of a save in flight."""
        self.directory = Path(directory)
        self.keep = max(1, keep)
        self.directory.mkdir(parents=True, exist_ok=True)
        if sweep:
            self._sweep_stale_tmp()
        self._pending: threading.Thread | None = None
        self._pending_error: list[BaseException] = []

    def _sweep_stale_tmp(self) -> None:
        """Remove uncommitted staging left by a crash.  Init is the safe
        sweep point: this manager is the directory's single writer and no
        save is in flight yet."""
        for p in self.directory.iterdir():
            if not _TMP_RE.match(p.name):
                continue
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                try:
                    p.unlink()
                except OSError:
                    logger.warning("could not remove stale staging %s", p.name)
            logger.warning("swept stale uncommitted checkpoint staging %s", p.name)

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step}"

    def wait(self) -> None:
        """Block until any in-flight save is committed to disk.

        Re-raises a background save's exception — a swallowed disk-full here
        would let a preempted job exit believing its checkpoint committed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error:
            err = self._pending_error.pop()
            raise RuntimeError(f"background checkpoint save failed: {err}") from err

    def _committed_steps(self) -> list[int]:
        """Step dirs already committed on disk (does not wait: an in-flight
        save's dir appears only at its rename)."""
        found = (_STEP_DIR.match(p.name) for p in self.directory.iterdir() if p.is_dir())
        return sorted(int(m.group(1)) for m in found if m)

    def steps(self) -> list[int]:
        self.wait()
        return self._committed_steps()

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, *, blocking: bool = False,
             manifest: dict | None = None) -> Path:
        """Commit ``state`` (tensors on the host, not to be written to
        afterwards) as ``step_N`` in the background; ``blocking`` waits for
        the commit.  Raises a previous background save's error."""
        self.wait()  # one in-flight save at a time
        final = self.path(step)
        self._pending = threading.Thread(
            target=self._save_sync, args=(final, state, manifest),
            name=f"checkpoint-step-{step}", daemon=False)
        self._pending.start()
        if blocking:
            self.wait()
        return final

    def _save_sync(self, final: Path, state: dict, manifest: dict | None) -> None:
        try:
            self._write(final, state, manifest)
        except BaseException as exc:  # noqa: BLE001 — re-raised from wait()
            logger.exception("background checkpoint save to %s failed", final)
            self._pending_error.append(exc)

    def _write(self, final: Path, state: dict, manifest: dict | None) -> None:
        t0 = time.perf_counter()
        tmp = final.with_name(final.name + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        with open(tmp / STATE_NAME, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        if manifest is not None:
            with open(tmp / MANIFEST_NAME, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
        if final.exists():  # a replayed step replaces its earlier save
            shutil.rmtree(final)
        os.replace(tmp, final)
        logger.info("checkpoint %s committed in %.3f s (%d bytes)", final.name,
                    time.perf_counter() - t0, (final / STATE_NAME).stat().st_size)
        # gc after the commit, on the writer thread (the directory's single
        # writer): the newest ``keep`` committed steps stay
        for step in self._committed_steps()[:-self.keep]:
            shutil.rmtree(self.path(step), ignore_errors=True)
            logger.info("gc'd checkpoint step_%d", step)

    # ---- reading -----------------------------------------------------------

    def layout(self, step: int) -> str:
        """``"torch"`` (the port's ``state.pt``), ``"msgpack"`` (the JAX
        package's ``state.msgpack``) or ``"orbax"`` (its OCDBT layout);
        raises ``FileNotFoundError`` for a directory holding no state."""
        self.wait()
        path = self.path(step)
        if (path / STATE_NAME).exists():
            return "torch"
        if (path / MSGPACK_NAME).exists():
            return "msgpack"
        names = sorted(p.name for p in path.iterdir()) if path.is_dir() else []
        if any(name in _ORBAX_MARKERS for name in names):
            return "orbax"
        raise FileNotFoundError(f"checkpoint {path} holds no {STATE_NAME} or {MSGPACK_NAME} "
                                f"({names[:6]})")

    def load_manifest(self, step: int) -> dict | None:
        """The step's ``manifest.json`` (``train/elastic.py`` schema), or
        None for a manifest-less (legacy) checkpoint."""
        self.wait()
        path = self.path(step) / MANIFEST_NAME
        if not path.exists():
            return None
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def _validate_like(path_prefix: str, ckpt_node: Any, like_node: Any) -> None:
        """Walk checkpoint/template state dicts together; raise
        :class:`CheckpointShapeError` at the first structural or shape
        mismatch."""
        ckpt_is_map = isinstance(ckpt_node, Mapping)
        like_is_map = isinstance(like_node, Mapping)
        if ckpt_is_map != like_is_map:
            raise CheckpointShapeError(
                path_prefix or "<root>",
                "a subtree" if ckpt_is_map else _shape_desc(ckpt_node),
                "a subtree" if like_is_map else _shape_desc(like_node),
            )
        if not ckpt_is_map:
            cs = tuple(getattr(ckpt_node, "shape", ()) or ())
            ls = tuple(getattr(like_node, "shape", ()) or ())
            if cs != ls:
                raise CheckpointShapeError(path_prefix or "<root>", f"shape {cs}",
                                           f"shape {ls}")
            return
        for key in sorted(set(ckpt_node) | set(like_node)):
            sub = f"{path_prefix}/{key}" if path_prefix else str(key)
            if key not in ckpt_node:
                raise CheckpointShapeError(sub, "<missing>", _shape_desc(like_node[key]))
            if key not in like_node:
                raise CheckpointShapeError(sub, _shape_desc(ckpt_node[key]), "<missing>")
            CheckpointManager._validate_like(sub, ckpt_node[key], like_node[key])

    def _validate_manifest_like(self, step: int, like: Any, layout: str) -> bool:
        """Validate ``like`` against the step's manifest leaf map (a JAX
        manifest's leaves under their mapped names); False when no manifest
        exists (legacy checkpoint)."""
        manifest = self.load_manifest(step)
        leaves = (manifest or {}).get("leaves")
        if not leaves:
            return False
        from .elastic import leaf_entries

        shapes = {path: _Shape(entry["shape"]) for path, entry in leaves.items()}
        if layout in ("msgpack", "orbax"):
            shapes = leaf_entries(state_from_jax(_nest(shapes)))
            shapes = {path: _Shape(entry["shape"]) for path, entry in shapes.items()}
        like_leaves = leaf_entries(like)
        for path in sorted(set(shapes) | set(like_leaves)):
            if path not in shapes:
                raise CheckpointShapeError(
                    path, "<missing>", f"shape {tuple(like_leaves[path]['shape'])}")
            if path not in like_leaves:
                raise CheckpointShapeError(path, f"shape {tuple(shapes[path])}", "<missing>")
            cs, ls = tuple(shapes[path]), tuple(like_leaves[path]["shape"])
            if cs != ls:
                raise CheckpointShapeError(path, f"shape {cs}", f"shape {ls}")
        return True

    def restore(self, step: int, like: Any | None = None) -> dict:
        """The step's state as the port's dict (tensors on the CPU).  With
        ``like`` (a state tree of the live trainer: only shapes are read)
        the manifest and then the state are checked against it first."""
        layout = self.layout(step)
        if like is not None:
            self._validate_manifest_like(step, like, layout)
        path = self.path(step)
        if layout == "torch":
            state = torch.load(path / STATE_NAME, map_location="cpu", weights_only=True)
        else:
            if layout == "msgpack":
                from ..utils import flax_msgpack

                raw = flax_msgpack.restore((path / MSGPACK_NAME).read_bytes())
            else:
                from .ocdbt import read_orbax_tree

                raw = read_orbax_tree(path)
            mapped = state_from_jax(raw)
            state = {"step": _to_tensor(mapped["step"]),
                     "trainable": {k: _to_tensor(v) for k, v in mapped["trainable"].items()},
                     "opt_state": {
                         "count": _to_tensor(mapped["opt_state"]["count"]),
                         "mu": {k: _to_tensor(v) for k, v in mapped["opt_state"]["mu"].items()},
                         "nu": {k: _to_tensor(v) for k, v in mapped["opt_state"]["nu"].items()}}}
        if like is not None:
            self._validate_like("", state, like)
        return state
