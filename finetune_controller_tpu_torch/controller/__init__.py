"""The port's control plane: submit, queue, monitor, promote and serve
fine-tuning jobs over HTTP.

Copies of the reference's ``controller/`` modules (``finetune_controller_tpu``
is the reference; nothing of it is imported), with these differences:

- the HTTP server is ``controller/web.py``, a stdlib asyncio server offering
  the part of ``aiohttp.web`` the handlers use;
- jobs run the port's trainer, ``python -m
  finetune_controller_tpu_torch.train.cli``, on the H100 (flavor ``h100``)
  or on the host (flavor ``cpu-test``);
- promoted jobs are served by the port's fleet and engine on the
  ``device`` setting (``FTC_DEVICE``);
- the local backend, the sqlite state store and the local object store
  are the substrate.  The k8s backend, GCS/S3, the HA state service, the
  WebSocket log follow, ``ctl.py``, ``monitor_main.py``,
  ``storage_cli.py``, warm workers and multi-card meshes raise or answer
  501, naming their ROADMAP Queue A items.
"""
