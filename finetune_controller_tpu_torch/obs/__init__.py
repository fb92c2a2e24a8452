"""Observability of the port: the job-lifecycle events (``events``), spans
and the controller's trace assembly (``trace``), the trainer's step-phase
clock (``phase``) and the control plane's Prometheus hub (``prom``), copies
of the reference's stdlib-only modules, written in the reference's formats."""
