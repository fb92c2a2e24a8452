"""Model registry: name → job-spec class, with plugin discovery.

Capability parity with the reference's registry pair
(``app/jobs/registered_models.py:15-37`` + ``app/models/model_loader.py:14-45``
— SURVEY.md §2 component 3): a process-wide manifest dict, built-in specs
registered eagerly, and dynamic discovery of user plugin modules from a
directory via importlib. Unlike the reference, registration is re-entrant and
resettable (test seam), and a bad plugin module is reported per-file instead of
aborting the scan.
"""

from __future__ import annotations

import importlib.util
import logging
import sys
from pathlib import Path

from .specs import BaseFineTuneJob

logger = logging.getLogger(__name__)

#: name → spec class (reference: ``JOB_MANIFESTS``, ``registered_models.py:15-17``)
JOB_MANIFESTS: dict[str, type[BaseFineTuneJob]] = {}


def register(cls: type[BaseFineTuneJob]) -> type[BaseFineTuneJob]:
    """Register a job-spec class (usable as a decorator in plugins)."""
    if not (isinstance(cls, type) and issubclass(cls, BaseFineTuneJob)):
        raise TypeError(f"{cls!r} is not a BaseFineTuneJob subclass")
    JOB_MANIFESTS[cls.model_name] = cls
    return cls


def get_spec(model_name: str) -> type[BaseFineTuneJob] | None:
    return JOB_MANIFESTS.get(model_name)


def reset() -> None:
    JOB_MANIFESTS.clear()


def load_builtin_models() -> None:
    """Register the shipped example specs (reference:
    ``registered_models.py:20-27`` registering ``app/models/examples``)."""
    from .examples import BUILTIN_JOB_SPECS

    for cls in BUILTIN_JOB_SPECS:
        register(cls)


def load_models_from_directory(directory: Path | str) -> list[str]:
    """Import every ``*.py`` in ``directory`` and register any
    :class:`BaseFineTuneJob` subclasses found (reference:
    ``model_loader.py:14-45`` — importlib scan of ``app/models/custom/``).

    Returns the model names registered. A module that fails to import is
    logged and skipped — one broken plugin must not take the API down.
    """
    directory = Path(directory).expanduser()
    registered: list[str] = []
    if not directory.is_dir():
        logger.warning("plugin directory %s does not exist; skipping", directory)
        return registered
    for py in sorted(directory.glob("*.py")):
        if py.name.startswith("_"):
            continue
        mod_name = f"ftc_plugin_{py.stem}"
        try:
            spec = importlib.util.spec_from_file_location(mod_name, py)
            assert spec and spec.loader
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = module
            spec.loader.exec_module(module)
        except Exception:
            logger.exception("failed to load model plugin %s", py)
            continue
        for obj in vars(module).values():
            if (
                isinstance(obj, type)
                and issubclass(obj, BaseFineTuneJob)
                and obj is not BaseFineTuneJob
                and obj.__module__ == mod_name
            ):
                register(obj)
                registered.append(obj.model_name)
    if registered:
        logger.info("registered %d plugin model(s): %s", len(registered), registered)
    return registered


def load_model_modules(plugin_dir: Path | str | None = None) -> None:
    """Full registry bootstrap (reference: ``load_model_modules``,
    ``registered_models.py:20-37``): built-ins first, then the plugin dir."""
    load_builtin_models()
    if plugin_dir:
        load_models_from_directory(plugin_dir)
