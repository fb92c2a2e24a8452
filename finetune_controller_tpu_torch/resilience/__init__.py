"""Resilience of the port: failure classification and retry backoff
(``policy``), the serve-plane fault injector (``faults``), the trainer's
liveness heartbeat and the monitor's lease (``heartbeat``), and the retry
supervisor (``supervisor``), copies of the reference's stdlib-only modules."""
