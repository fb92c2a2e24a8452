"""Training backends: where jobs actually run.

The reference delegates execution to a Kubernetes cluster (Kubeflow
``PyTorchJob`` + Kueue — SURVEY.md §2 components 6/10/11/24). Here the seam is
an explicit interface (:class:`~finetune_controller_tpu_torch.controller.backends.base.TrainingBackend`).
The port has two implementations:

- :mod:`.local` — in-process fake cluster running the port's trainer as
  subprocesses, with gang-scheduled admission. Carries the CI/integration
  story the reference never had (SURVEY.md §4).
- :mod:`.k8s` — JobSet manifests admitted by Kueue on ``nvidia.com/gpu``
  nodes, through a stdlib client of the kube API.
"""

from .base import BackendError, TrainingBackend
from .scheduler import GangScheduler, Workload

__all__ = ["BackendError", "TrainingBackend", "GangScheduler", "Workload"]
