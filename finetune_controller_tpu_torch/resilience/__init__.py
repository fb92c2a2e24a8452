"""Resilience of the port: failure classification and retry backoff
(``policy``), fault injection for the trainer, the object store and the
serve plane (``faults``), the trainer's liveness heartbeat and the monitor's
lease (``heartbeat``), and the retry supervisor (``supervisor``), copies of
the reference's stdlib-only modules.

This ``__init__`` re-exports only the controller-free pieces, as the
reference's does: the trainer imports :class:`HeartbeatWriter` and
:class:`StepFaultInjector` in processes that carry no controller.  Import
:class:`.supervisor.RetrySupervisor` from its module.
"""

from .faults import FaultyObjectStore, StepFault, StepFaultInjector
from .heartbeat import HEARTBEAT_FILENAME, HeartbeatWriter, LeaseChecker
from .policy import RETRYABLE, FailureClass, RetryPolicy, classify_failure

__all__ = [
    "FailureClass",
    "RetryPolicy",
    "classify_failure",
    "RETRYABLE",
    "HeartbeatWriter",
    "LeaseChecker",
    "HEARTBEAT_FILENAME",
    "StepFault",
    "StepFaultInjector",
    "FaultyObjectStore",
]
