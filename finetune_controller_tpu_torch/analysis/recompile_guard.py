"""Count distinct call signatures of the hot paths against a budget.

The reference wraps its jitted callables and fingerprints each call's
*compilation signature* — pytree structure plus per-leaf (shape, dtype,
weak_type); a new signature there is a new XLA compile.  The port runs
eagerly and compiles nothing, but a new signature still costs: new cuBLAS
and kernel launch shapes, and new caching-allocator blocks that fragment
the pool.  So :class:`RecompileGuard` keeps the reference's contract as it
is: it fingerprints each call the same way (a Python numeric scalar counts
by its TYPE, any other non-array leaf by its value, as a static argument of
jit would), and past ``budget`` distinct signatures it warns once
(``on_excess="warn"``) or raises :class:`RecompileBudgetExceeded`
(``on_excess="raise"``).  The same call sequence trips it at the same call
as the reference's guard.

Threaded into the hot paths behind config flags:

* ``TrainConfig.recompile_budget`` (0 = off) wraps the trainer's step and
  eval calls; ``TrainConfig.recompile_action`` picks warn vs raise;
* the serve engine's ``EngineConfig.recompile_budget`` (0 = the default
  budget: one prefill per prompt bucket plus the decode step) raises.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

logger = logging.getLogger(__name__)

__all__ = ["RecompileBudgetExceeded", "RecompileGuard", "signature_of", "tree_flatten"]


class RecompileBudgetExceeded(RuntimeError):
    """More distinct call signatures than the configured budget."""


def tree_flatten(tree: Any) -> tuple[list[Any], Any]:
    """(leaves, structure) of a nest of tuples, lists and dicts, with the
    reference's pytree rules: dict keys in sorted order, ``None`` a node
    without leaves, anything else a leaf.  The structure is hashable and
    compares equal exactly when two trees have the same shape."""
    leaves: list[Any] = []

    def walk(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (tuple, list)):
            kind = type(node).__name__ if hasattr(node, "_fields") else \
                ("tuple" if isinstance(node, tuple) else "list")
            return (kind, tuple(walk(x) for x in node))
        leaves.append(node)
        return "*"

    return leaves, walk(tree)


def _dtype_name(dtype: Any) -> str:
    """``float32`` for torch.float32 and numpy's float32 alike."""
    return str(dtype).removeprefix("torch.")


def _leaf_signature(leaf: Any) -> Any:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return ("array", tuple(shape), _dtype_name(dtype),
                bool(getattr(leaf, "weak_type", False)))
    if isinstance(leaf, (bool, int, float, complex)):
        # a Python scalar keys a compiled program by its TYPE, not its value
        # — fingerprinting the value would flag recompiles that never happen
        return ("pyscalar", type(leaf).__name__)
    # any other leaf is a static argument, whose value keys the program
    try:
        hash(leaf)
        return ("static", leaf)
    except TypeError:
        return ("static", repr(leaf))


def signature_of(*args: Any, **kwargs: Any) -> tuple:
    """The (structure, leaf-signature) fingerprint of one call."""
    leaves, structure = tree_flatten((args, kwargs))
    return (structure, tuple(_leaf_signature(x) for x in leaves))


class RecompileGuard:
    """Count distinct call signatures across a set of wrapped functions.

    One guard instance spans a whole training run or an engine's lifetime:
    the budget covers the SUM of signatures over every label.
    """

    def __init__(self, budget: int, *, on_excess: str = "warn",
                 name: str = "recompile-guard"):
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        if on_excess not in ("warn", "raise"):
            raise ValueError(f"on_excess must be 'warn' or 'raise', got {on_excess!r}")
        self.budget = budget
        self.on_excess = on_excess
        self.name = name
        self._seen: dict[str, set[tuple]] = {}
        self._warned = False

    @property
    def compilations(self) -> int:
        """Distinct signatures observed so far, across all labels."""
        return sum(len(s) for s in self._seen.values())

    def counts(self) -> dict[str, int]:
        return {label: len(sigs) for label, sigs in self._seen.items()}

    def check(self, label: str, sig: tuple) -> None:
        sigs = self._seen.setdefault(label, set())
        if sig in sigs:
            return
        sigs.add(sig)
        total = self.compilations
        if total <= self.budget:
            if total > 1:
                logger.info("%s: signature %d/%d (label=%s)", self.name, total,
                            self.budget, label)
            return
        detail = (
            f"{self.name}: {total} distinct call signatures exceed the "
            f"budget of {self.budget} (per label: {self.counts()}). A "
            "signature changing per call usually means a shape or a static "
            "Python value varies per step — pad to a fixed shape or hoist "
            "the varying value into a tensor argument."
        )
        if self.on_excess == "raise":
            raise RecompileBudgetExceeded(detail)
        if not self._warned:  # one warning, not one per extra signature
            self._warned = True
            logger.warning("%s", detail)

    def wrap(self, fn: Callable, label: str) -> Callable:
        """Wrap a callable; each call checks its signature first."""

        def guarded(*args: Any, **kwargs: Any):
            self.check(label, signature_of(*args, **kwargs))
            return fn(*args, **kwargs)

        guarded.__name__ = f"guarded_{getattr(fn, '__name__', label)}"
        guarded.__wrapped__ = fn
        return guarded
