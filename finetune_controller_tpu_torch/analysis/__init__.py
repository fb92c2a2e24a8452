"""Runtime guards of the hot paths (counterpart of the reference's
``analysis/``, which also holds the ftc-lint static rules and the shard
audit; the port has the two runtime guards so far):

- :mod:`.recompile_guard` — distinct call signatures against a budget;
- :mod:`.transfer_guard` — no silent device<->host syncs in the trainer's
  step and the serve engine's decode window.
"""
