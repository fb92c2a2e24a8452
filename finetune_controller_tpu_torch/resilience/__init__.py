"""Resilience helpers of the port: failure classification and retry backoff
(``policy``), the serve-plane fault injector (``faults``) and the trainer's
liveness heartbeat (``heartbeat``), copies of the reference's stdlib-only
modules."""
