"""Cross-process serve transport (counterpart of the reference's
``transport/``).

Every serve replica can live in its OWN worker process — one engine and
batcher per process, its own CUDA context and kernel libraries — behind a
length-prefixed msgpack/JSON RPC protocol on a local socket, so the fleet's
replicas stop sharing a Python interpreter with each other and with the
control plane.  The fleet and router (``serve/fleet.py``,
``serve/router.py``) cannot tell the modes apart: a
:class:`~.client.RemoteReplica` has the surface the in-process ``Batcher``
has, so failover, exactly-once request ids, drain, rollover and tenancy
work unchanged (``serve_transport=inproc`` | ``process``).

Module map:

* ``wire``     — framing and codec (u32 length prefix; flax-style msgpack
  through the port's own stdlib coder, or JSON with base64 bytes) and the
  byte counters ``/metrics`` reads;
* ``worker``   — the worker process
  (``python -m finetune_controller_tpu_torch.transport.worker --spec …``);
* ``client``   — ``RemoteReplica``: async-socket RPC client with cached
  health snapshots, the heartbeat lease and process teardown;
* ``process``  — ``ProcessTransport``: spawn and kill of worker sandboxes
  on the local host;
* ``builders`` — how a worker process rebuilds its serving model (a staged
  deploy dir, the seeded tiny preset, or an RLHF learner's frozen base).

The rollout and reward workers of the disaggregated RLHF plane
(``prefs/rollout_plane.py``) ride the same worker, client and process
layers.
"""

from __future__ import annotations

#: process-wide transport counters (``ftc_serve_transport_*`` on the
#: server's ``/metrics``), shared by the client, wire and fleet layers
METRICS: dict[str, int] = {
    "rpcs_total": 0,
    "rpc_errors_total": 0,
    "worker_respawns_total": 0,
    "workers_spawned_total": 0,
    "bytes_sent_total": 0,
    "bytes_received_total": 0,
}


def incr(name: str, n: int = 1) -> None:
    METRICS[name] = METRICS.get(name, 0) + n


def metrics_snapshot() -> dict[str, int]:
    snap = dict(METRICS)
    snap["bytes_total"] = (
        snap.get("bytes_sent_total", 0) + snap.get("bytes_received_total", 0)
    )
    return snap


class TransportError(RuntimeError):
    """The worker process or its socket failed — retryable from the fleet's
    point of view (``RemoteReplica`` maps it to
    :class:`~..serve.batcher.ReplicaUnavailable` on the generate path, so the
    router's failover is the in-process one)."""


class RemoteError(RuntimeError):
    """An exception raised INSIDE the worker, re-raised here with its remote
    type in the message (``SomeError: detail``), so
    ``resilience.policy.classify_failure`` reads the text a local raise
    would give."""

    def __init__(self, remote_type: str, message: str):
        super().__init__(f"{remote_type}: {message}")
        self.remote_type = remote_type
