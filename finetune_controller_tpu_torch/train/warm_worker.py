"""Pre-warmed trainer process: pay the interpreter start, ``import torch``
and the training stack's imports *before* a job arrives (counterpart of the
reference's ``train/warm_worker.py``).

``python -m finetune_controller_tpu_torch.train.warm_worker`` imports torch
and the training stack, loads the kernel libraries that are already built
(``build/torch_kernels/``; it never starts ``nvcc``), then blocks on stdin
until the local backend hands it one request line::

    {"spec": "/path/job.json", "log": "/path/logs.txt", "cwd": "/sandbox",
     "env": {"CUDA_VISIBLE_DEVICES": "0", "FTC_TRACE_ID": ...},
     "argv": ["--device", "cpu"]}

It then applies the request's env, redirects stdout/stderr to the job's log
file (the file a cold-spawned trainer would write), chdirs into the sandbox
and runs the job through ``train.cli``.  One request per process: the pool
replaces used workers.

**The card is chosen by the request, not the pool.**  The local backend
grants a card only on admission (``CUDA_VISIBLE_DEVICES``), after this
process started, and CUDA reads that variable once, when it initialises.
So nothing here touches CUDA before the request line: loading a kernel
library only maps it (the CUDA runtime initialises at its first call), and
the job's first line in its log records the card it was given and that
CUDA was still uninitialised when the request arrived.

Closing stdin without a request is the shutdown signal (exit 0).
"""

from __future__ import annotations

import json
import os
import sys


def _load_built_kernels() -> list[str]:
    """Map the kernel libraries that are already built (no compile, no CUDA
    call); returns their names."""
    from ..ops.kernels import build, flash_attention, paged_attention

    loaders = {"flash_attention": flash_attention._library,
               "paged_attention": paged_attention._library}
    loaded = []
    for name, load in loaders.items():
        if build.library_path(name).exists():
            load()
            loaded.append(name)
    return loaded


def main() -> int:
    import torch

    # pre-import the training stack (models, data, checkpoints): torch alone
    # is under half the interpreter's import bill
    from ..data import loader, synthetic  # noqa: F401
    from ..models import multimodal  # noqa: F401
    from . import checkpoint, cli, trainer  # noqa: F401

    kernels = _load_built_kernels()
    ready = os.environ.get("FTC_WARM_READY_FILE")
    if ready:
        with open(ready, "w") as f:
            f.write("ready\n")

    line = sys.stdin.readline()
    # the sentinel's job is done once a request (or shutdown) arrives; the
    # worker owns its removal
    if ready:
        try:
            os.unlink(ready)
        except OSError:
            pass
    if not line.strip():
        return 0  # pool shutdown
    req = json.loads(line)

    cuda_before = torch.cuda.is_initialized()
    # the job's env (its card, its trace identity) arrives with the request:
    # this process was spawned before the job existed
    for k, v in (req.get("env") or {}).items():
        os.environ[k] = str(v)

    sys.stdout.flush()
    sys.stderr.flush()
    fd = os.open(req["log"], os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    if req.get("cwd"):
        os.chdir(req["cwd"])
    print(f"warm worker pid={os.getpid()}: CUDA_VISIBLE_DEVICES="
          f"{os.environ.get('CUDA_VISIBLE_DEVICES', '')} applied with CUDA initialised "
          f"before the request: {cuda_before}; kernel libraries loaded: "
          f"{', '.join(kernels) or 'none'}", flush=True)

    from .cli import main as cli_main

    return cli_main(["--spec", req["spec"], *(req.get("argv") or [])])


if __name__ == "__main__":
    raise SystemExit(main())
