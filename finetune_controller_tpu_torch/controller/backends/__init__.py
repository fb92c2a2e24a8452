"""Training backends: where jobs actually run.

The reference delegates execution to a Kubernetes cluster (Kubeflow
``PyTorchJob`` + Kueue — SURVEY.md §2 components 6/10/11/24). Here the seam is
an explicit interface (:class:`~finetune_controller_tpu_torch.controller.backends.base.TrainingBackend`).
The port has one implementation:

- :mod:`.local` — in-process fake cluster running the port's trainer as
  subprocesses, with gang-scheduled admission. Carries the CI/integration
  story the reference never had (SURVEY.md §4).

The reference's k8s backend is not ported yet (ROADMAP Queue A item 3c).
"""

from .base import BackendError, TrainingBackend
from .scheduler import GangScheduler, Workload

__all__ = ["BackendError", "TrainingBackend", "GangScheduler", "Workload"]
