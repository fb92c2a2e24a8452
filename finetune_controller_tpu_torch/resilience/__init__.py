"""Resilience helpers of the port: failure classification and retry backoff
(``policy``) and the serve-plane fault injector (``faults``), copies of the
reference's stdlib-only modules."""
