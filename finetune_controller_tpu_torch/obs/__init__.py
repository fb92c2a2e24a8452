"""Observability of the port's trainer: lifecycle events (``events``),
spans (``trace``) and the step-phase clock (``phase``), copies of the
reference's stdlib-only modules, written in the reference's formats so the
controller's readers parse them."""
