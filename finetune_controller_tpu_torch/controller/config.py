"""Settings for the control plane.

The port's copy adds two settings: ``device`` (``FTC_DEVICE``, default
``cuda``), the torch device the serve manager loads promoted models onto
(``serve/loader.py``) — with ``cuda`` and no card the first load raises;
nothing drops to the host; the tests set ``cpu`` — and ``kube_api_url``
(``FTC_KUBE_API_URL``), the k8s backend's API server when it is not the
in-cluster one.

Capability parity with the reference's pydantic-settings singleton
(``app/core/config.py:16-93``) with its two warts fixed:

- **No import-time I/O.** The reference reads a Kubernetes Secret inside computed
  fields at import (``app/core/config.py:59-90``), which makes the package
  unimportable without cluster access. Here nothing happens until
  :func:`get_settings` is called, and tests inject their own instance via
  :func:`set_settings`.
- **No hard dependency on pydantic-settings.** Plain env parsing over a pydantic
  model keeps the dependency surface to what is baked into the image.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from pydantic import BaseModel, Field

#: the well-known dev secret — treated as UNSET by the auth startup guard:
#: a deployment that enables auth outside `local` with only this secret would
#: let anyone who read the source forge admin tokens
DEFAULT_JWT_SECRET = "dev-secret-do-not-use-in-prod"


class Settings(BaseModel):
    """Environment-driven configuration (reference: ``app/core/config.py:16-58``)."""

    environment: str = "local"  # local | development | production
    namespace: str = "default"

    # --- API ---
    cors_origins: list[str] = Field(default_factory=lambda: ["*"])
    api_prefix: str = "/api/v1"

    # --- Auth (reference: OpenBridge OAuth, app/core/config.py:33-42) ---
    auth_enabled: bool = False
    introspection_url: str = ""  # remote token introspection endpoint
    introspection_client_id: str = ""
    introspection_client_secret: str = ""
    jwks_url: str = ""  # JWKS endpoint for RS256 validation
    jwt_secret: str = DEFAULT_JWT_SECRET  # HS256 dev mint/verify
    #: RS256 audience enforcement is opt-in: set it and tokens must carry a
    #: matching `aud` (string or array); empty = no audience check
    jwt_audience: str = ""
    dev_disable_introspection: bool = True

    # --- State store (reference: Mongo URL/creds, app/core/config.py:44-49) ---
    state_dir: str = "~/.finetune_controller_tpu_torch/state"
    #: "sqlite" (WAL database — safe for the deployed API+monitor two-process
    #: layout on one node) | "jsonl" (single-process append-only log) |
    #: "remote" (the shared state service, ``statestore_main`` — API×N
    #: replicas + monitor across nodes, the role MongoDB plays for the
    #: reference, ``app/database/db.py:51``)
    state_backend: str = "sqlite"
    #: remote state service endpoint + bearer token (state_backend=remote)
    state_service_url: str = ""
    state_service_token: str = ""

    # --- Object store (reference: S3 buckets, app/core/config.py:53-58) ---
    #: "local" (filesystem root, hermetic CI) | "gcs" | "s3" (cloud buckets)
    object_store_backend: str = "local"
    object_store_root: str = "~/.finetune_controller_tpu_torch/objects"
    #: GCS: endpoint override (fake server in tests) + real-bucket prefix so
    #: one project hosts the datasets/artifacts/deploy logical buckets
    gcs_endpoint: str = "https://storage.googleapis.com"
    gcs_bucket_prefix: str = ""
    #: S3: endpoint/region (MinIO-style gateways and the test fake override
    #: the endpoint); creds ride AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY —
    #: the env contract the reference's k8s Secret fills (config.py:59-90)
    s3_endpoint: str = "https://s3.amazonaws.com"
    s3_region: str = "us-east-1"
    s3_bucket_prefix: str = ""
    datasets_bucket: str = "datasets"
    artifacts_bucket: str = "artifacts"
    deploy_bucket: str = "deploy"
    presign_secret: str = "dev-presign-secret"
    presign_expiry_s: int = 3600

    # --- Monitor / sync cadence (reference: app/core/config.py:50-52) ---
    job_monitor_interval_s: float = 2.0
    artifact_sync_interval_s: float = 60.0
    #: the standalone monitor daemon's /metrics listener port
    #: (docs/observability.md: ftc_build_info / ftc_uptime_seconds for BOTH
    #: control-plane processes); 0 = no listener (in-process monitors are
    #: already covered by the API server's /metrics)
    monitor_metrics_port: int = 0
    #: pre-warmed trainer processes per runtime env on the local backend —
    #: they pay the interpreter start, ``import torch``, the training stack's
    #: imports and loading the built kernel libraries before a job arrives,
    #: shortening submit -> first training step (0 = off).  CUDA itself is
    #: initialised only once a job's request line has set its card
    #: (``train/warm_worker.py``)
    warm_workers: int = 0

    # --- Log streaming (reference: LOG_STREAM_SEARCH_STRING, app/core/config.py:26) ---
    log_stream_search_string: str = ""
    log_stream_start_timeout_s: float = 300.0

    # --- Scheduler / device catalog (reference: CONFIGURATION_FILE, app/core/config.py:43) ---
    device_config_file: str = ""
    #: admission policy (docs/scheduling.md): "fairshare" (multi-tenant
    #: weighted DRF with checkpoint-aware preemption, the default) | "fifo"
    #: (the legacy best-effort gang scheduler — no tenants, no preemption)
    sched_policy: str = "fairshare"
    #: tenant queue weights as a JSON object, e.g. '{"prod": 4, "batch": 1}'.
    #: Unknown queues named at submit auto-register with weight 1.0.
    sched_queues: str = ""
    #: resize-instead-of-evict (docs/elasticity.md): shrink multi-slice
    #: victims to their fair share (and admit blocked multi-slice jobs
    #: shrunk) instead of full eviction, growing them back when chips free.
    #: false restores the evict-only behavior.
    sched_resize: bool = True
    #: how long a flavor must be free of other tenants' demand before the
    #: scheduler grows a shrunk job back (a grow costs a checkpoint
    #: restart, so this debounces thrash); also the per-job floor between
    #: consecutive resizes of the same job
    sched_grow_delay_s: float = 60.0

    # --- Backend selection ---
    backend: str = "local"  # local | k8s
    monitor_in_process: bool = True  # reference: DEV_LOCAL_JOB_MONITOR (config.py:51)
    #: the k8s backend's API server: empty = in-cluster
    #: (``https://$KUBERNETES_SERVICE_HOST:$KUBERNETES_SERVICE_PORT`` with the
    #: pod's service-account token and CA); else the base URL to use, e.g. a
    #: ``kubectl proxy`` (``http://127.0.0.1:8001``)
    kube_api_url: str = ""

    # --- Rate limits per minute (reference: app/main.py:377,525,714) ---
    rate_limit_submit_per_min: int = 10
    rate_limit_read_per_min: int = 50
    rate_limit_promote_per_min: int = 2
    rate_limit_generate_per_min: int = 120

    # --- Serving (serve/, docs/serving.md) ---
    #: the torch device promoted models are served on (``serve/loader.py``):
    #: ``cuda`` (the first card) or ``cpu``; never a silent fallback
    device: str = "cuda"
    #: decode lanes per served model — the compiled batch; traffic above this
    #: queues (continuous batching refills lanes between steps)
    serve_slots: int = 8
    #: prefill pad targets (ascending); one prefill compile per bucket — the
    #: compile-count dial (docs/serving.md)
    serve_prompt_buckets: list[int] = Field(default_factory=lambda: [32, 128, 512])
    #: hard per-request generation cap; also sizes the KV cache
    #: (max(buckets) + this = cache slots per lane)
    serve_max_new_tokens: int = 128
    #: prefix-reuse KV cache (docs/serving.md): admissions sharing a cached
    #: prompt prefix (the shared-system-prompt case) splice it in and prefill
    #: only the suffix — bit-identical outputs, prefill compute saved
    serve_prefix_cache: bool = True
    #: byte budget (MiB) of device-resident prefix snapshots per served
    #: model; least-recently-used snapshots evict past it.  Size it to hold
    #: AT LEAST one snapshot (2 * cache_len * n_kv_heads * head_dim *
    #: n_layers * dtype bytes — ~84 MB for an 8B config at the default
    #: buckets): a budget below one snapshot makes every insert refuse and
    #: the cache silently inert (the engine logs a warning once)
    serve_prefix_cache_mb: int = 512
    #: default when a request omits max_new_tokens
    serve_default_max_new_tokens: int = 32
    #: admission queue depth — past it requests get 429 (backpressure)
    serve_max_queue: int = 64
    #: idle park interval of the drive loop (1 ms floor).  Submissions wake
    #: the loop IMMEDIATELY via an event, so this never adds first-token
    #: latency — it only bounds the fallback re-check while fully idle
    #: (keep it large: an idle loop wakes 1000/this times per second)
    serve_max_wait_ms: float = 1000.0
    #: default per-request deadline: queued-past-it → dropped, decoding-past-it
    #: → evicted mid-flight (0 = no deadline)
    serve_request_timeout_s: float = 60.0
    #: load a promoted job's checkpoint on its first generate request (off =
    #: only explicit POST /admin/serve/{job}/load serves traffic)
    serve_autoload: bool = True
    #: fold LoRA deltas into the base kernels at load (dense-model matmul
    #: count; int4-quantized bases always serve unmerged).  Ignored when
    #: serve_max_adapters > 0: multi-tenant serving needs the pristine base,
    #: so the loaded job's own adapter becomes tenant #1 instead of merging
    serve_merge_lora: bool = True

    # --- Paged KV cache (docs/serving.md §Paged KV) ---
    #: page the serve KV cache: lanes hold fixed-size pages proportional to
    #: their actual length instead of reserving cache_len slots at admit —
    #: memory stops capping concurrency (vLLM-style; PAPERS.md).  Greedy and
    #: sampled outputs are bit-identical to the unpaged path
    serve_paged_kv: bool = False
    #: sequence positions per KV page; smaller pages pack mixed-length lanes
    #: tighter, larger pages cut page-table overhead.  Divides the cache
    #: length (max bucket + serve_max_new_tokens) for the tightest layout
    serve_kv_page_tokens: int = 16
    #: total pool pages per replica INCLUDING the reserved scratch page;
    #: 0 auto-sizes to the unpaged capacity (slots * pages-per-lane + 1) —
    #: set it LOWER to actually oversubscribe memory, which is the point:
    #: admission reserves worst-case pages, so a full pool backpressures
    #: (429 + Retry-After) instead of OOMing mid-decode
    serve_kv_pool_pages: int = 0
    #: host-RAM KV tier budget (MiB) behind the device page pool (0 = off;
    #: docs/serving.md §KV tiering).  Needs paged KV and the prefix cache:
    #: past the DEVICE prefix budget (serve_prefix_cache_mb), LRU prefix
    #: entries demote page-by-page to pinned host memory and page back in
    #: on their next hit — effective prefix capacity grows past the device
    #: budget with zero change to splice semantics, and idle-session KV
    #: stops competing with hot decode lanes for device pages
    serve_kv_host_pool_mb: int = 0

    # --- Multi-tenant adapters (docs/serving.md §Multi-tenant adapters) ---
    #: tenant adapters multiplexable per served base model (0 = off): LoRA
    #: jobs serve UNMERGED on a shared base fleet, each lane applying its
    #: request's adapter via a gathered batched einsum — N tenants per base
    #: model on the same chips.  When on, the base job loads unmerged and
    #: its own adapter auto-registers as the first tenant
    serve_max_adapters: int = 0
    #: adapter stack rank ceiling; tenants trained at lower rank zero-pad
    #: (bit-neutral), higher-rank adapters are refused at load
    serve_adapter_rank: int = 32
    #: deficit-round-robin admission quantum (token cost credited to every
    #: waiting tenant per round) — fairness knob: one hot tenant cannot
    #: starve the rest of the batch
    serve_drr_quantum_tokens: int = 256

    # --- Serve fleet (docs/serving.md §Fleet, failover, and drain) ---
    #: replicas per served job (each a full engine+batcher stack behind the
    #: router); 1 keeps the single-engine footprint but gains health checks,
    #: drains, and rollover
    serve_replicas: int = 1
    #: fleet health-check cadence (stall/fault detection + due restarts);
    #: also the autoscale tenant's reconcile cadence
    serve_health_interval_s: float = 2.0
    #: a replica with work in flight that completes no decode step for this
    #: long is stuck: torn down (requests fail over) and restarted with
    #: backoff.  Must exceed the worst-case single decode step INCLUDING a
    #: first-use prefill compile (minutes on large configs)
    serve_replica_stall_s: float = 120.0
    #: graceful-drain budget: in-flight lanes get this long to finish before
    #: stragglers fail over (rollover, scale-down, and preemption all drain)
    serve_drain_timeout_s: float = 30.0
    #: failover budget: extra replicas a request may be re-enqueued on after
    #: its replica dies mid-decode (original deadline preserved)
    serve_failover_retries: int = 2
    #: restart budget for crashed/stuck replicas per incident streak (the
    #: backoff schedule rides retry_base_delay_s/retry_max_delay_s)
    serve_replica_restart_attempts: int = 3
    #: serve-as-a-scheduler-tenant autoscale (docs/scheduling.md §Serve
    #: tenant): replica count follows queue-depth pressure, with every
    #: replica a preemptible low-priority workload; needs the local
    #: backend's fair-share scheduler
    serve_autoscale: bool = False
    serve_min_replicas: int = 1
    serve_max_replicas: int = 4
    #: queued requests PER healthy replica that count as pressure
    serve_scale_up_queue_depth: int = 8
    #: consecutive pressured health ticks before a grow is submitted
    serve_scale_sustain_ticks: int = 2
    #: tenant queue serve workloads land in (weight via FTC_SCHED_QUEUES)
    serve_queue: str = "serve"
    #: device flavor for replica workloads ("" = the catalog's default)
    serve_flavor: str = ""

    # --- Serve transport (docs/serving.md §Cross-process transport) ---
    #: where replicas run: "inproc" (engines share the API process's
    #: interpreter and CUDA context — tests/dev footprint) or "process" (one
    #: worker PROCESS per replica with its own CUDA context behind the RPC
    #: socket, ``transport/`` — replicas stop sharing the interpreter, which
    #: is what should make 2 replicas about 2x)
    serve_transport: str = "inproc"
    #: first worker port; 0 = ephemeral ports (collision-free; the bound
    #: port is read back from the worker sandbox's transport.json)
    serve_worker_port_base: int = 0
    #: spawn handshake budget per worker (the process start, the model
    #: build from the staged dir and the engine warm-up happen inside it;
    #: raise it for big presets)
    serve_worker_spawn_timeout_s: float = 300.0
    #: worker heartbeat cadence; the fleet's liveness lease is 3x this
    #: (floored) — a SIGKILLed or wedged worker is declared dead past it
    serve_worker_heartbeat_s: float = 2.0

    # --- Resilience (resilience/, docs/resilience.md) ---
    #: total run attempts per job before a retryable failure becomes terminal
    #: (0 disables the retry supervisor entirely — reference-parity behavior:
    #: FAILED jobs stay in place for forensics and nothing is resubmitted)
    retry_max_attempts: int = 3
    #: backoff floor/ceiling for the decorrelated-jitter schedule
    retry_base_delay_s: float = 2.0
    retry_max_delay_s: float = 60.0
    #: liveness lease: a RUNNING job whose newest heartbeat is older than
    #: this is declared stuck, killed, and handed to the supervisor (0 = off).
    #: Must comfortably exceed artifact_sync_interval_s + the trainer's
    #: heartbeat_interval_s — the runtime enforces a floor of 3x the sync
    #: cadence so a slow sync can never masquerade as a dead trainer.
    #: It must ALSO exceed the worst-case single-step time including the
    #: first step's kernel builds (minutes on large configs): heartbeats land
    #: between steps, so a lease tighter than one step phase kills healthy
    #: jobs mid-compile (docs/resilience.md).
    liveness_lease_s: float = 300.0

    @property
    def state_path(self) -> Path:
        return Path(self.state_dir).expanduser()

    @property
    def object_store_path(self) -> Path:
        return Path(self.object_store_root).expanduser()


_ENV_PREFIX = "FTC_"
_settings: Settings | None = None


def _from_env() -> Settings:
    """Build Settings from ``FTC_*`` env vars (upper-snake of the field name)."""
    raw: dict[str, object] = {}
    for name, field in Settings.model_fields.items():
        env_val = os.environ.get(_ENV_PREFIX + name.upper())
        if env_val is None:
            continue
        ann = field.annotation
        if ann is bool:
            raw[name] = env_val.lower() in ("1", "true", "yes", "on")
        elif ann in (int, float):
            raw[name] = env_val
        elif ann == list[str]:
            raw[name] = (
                json.loads(env_val) if env_val.startswith("[") else env_val.split(",")
            )
        elif ann == list[int]:
            parts = (
                json.loads(env_val) if env_val.startswith("[")
                else env_val.split(",")
            )
            raw[name] = [int(p) for p in parts]
        else:
            raw[name] = env_val
    return Settings(**raw)


def get_settings() -> Settings:
    """Lazily build the process-wide settings (first call reads the env)."""
    global _settings
    if _settings is None:
        _settings = _from_env()
    return _settings


def set_settings(settings: Settings | None) -> None:
    """Inject (or reset with ``None``) settings — the test seam."""
    global _settings
    _settings = settings
