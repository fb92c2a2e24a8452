"""The port's control plane: submit, queue, monitor, promote and serve
fine-tuning jobs over HTTP.

Copies of the reference's ``controller/`` modules (``finetune_controller_tpu``
is the reference; nothing of it is imported), with these differences:

- the HTTP server is ``controller/web.py``, a stdlib asyncio server offering
  the part of ``aiohttp.web`` the handlers use (the WebSocket log follow
  included); the HTTP client of the S3 and GCS stores and of the remote
  state store is ``controller/httpclient.py``, on the standard library too;
- jobs run the port's trainer, ``python -m
  finetune_controller_tpu_torch.train.cli``, on the H100 (flavor ``h100``)
  or on the host (flavor ``cpu-test``);
- promoted jobs are served by the port's fleet and engine on the
  ``device`` setting (``FTC_DEVICE``);
- the substrate is the local backend or the k8s backend (JobSets on
  ``nvidia.com/gpu`` nodes, admitted by Kueue, through a stdlib client of
  the kube API); the state lives in sqlite or in the shared state service
  (``statestore_service.py``, ``statestore_main.py``), the objects in the
  local store, S3 or GCS (``s3.py``, ``gcs.py``); ``storage_cli.py`` is
  the pod-side storage CLI and ``monitor_main.py`` the standalone monitor
  daemon.  Multi-card meshes and multi-host jobs raise, naming ROADMAP
  Queue A item 7.
"""
