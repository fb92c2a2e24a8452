"""Continuous-batching serving of the port (counterpart of the reference's
``serve/`` package).

* :mod:`engine` — slot-based batch decode over a paged KV pool (the CUDA
  paged-attention kernel on the card) or a dense per-lane cache, with
  multi-tenant LoRA adapters and the host-RAM KV tier;
* :mod:`kv_pages` — the page pool's host-side allocator and the host tier;
* :mod:`prefix_cache` — prefix reuse, namespaced by adapter;
* :mod:`adapters` — the multi-tenant adapter registry;
* :mod:`batcher` — asyncio admission queue with backpressure, deadlines and
  per-tenant fairness;
* :mod:`fleet` — N health-checked replicas, in process sharing one model
  or each a worker process (``transport/``): failure and respawn, drain,
  rollover;
* :mod:`router` — spreads requests over the fleet with failover,
  idempotent request ids and Retry-After load shedding;
* :mod:`loader` — a trained job's directory into a serving model, merged
  or as the base plus its adapter, and the store half that stages a
  promoted prefix;
* :mod:`service` — the HTTP routes that load, serve and unload promoted
  jobs (in process or from worker processes).
"""

from .adapters import AdapterRegistry, UnknownAdapter
from .engine import BatchEngine, EngineConfig, GenRequest, GenResult
from .fleet import Replica, ReplicaFleet, ReplicaState
from .kv_pages import KVPagePool, PageRun, PoolExhausted
from .router import FleetUnavailable, ReplicaRouter

__all__ = [
    "AdapterRegistry",
    "BatchEngine",
    "EngineConfig",
    "FleetUnavailable",
    "GenRequest",
    "GenResult",
    "KVPagePool",
    "PageRun",
    "PoolExhausted",
    "Replica",
    "ReplicaFleet",
    "ReplicaRouter",
    "ReplicaState",
    "UnknownAdapter",
]
