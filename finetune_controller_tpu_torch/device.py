"""Device resolution for every entry point of the port.

The counterpart of the reference's ``platform.py``: where JAX picks its
backend from ``JAX_PLATFORMS``, the port asks for an explicit device.  The
default is the first CUDA card; a machine without one raises instead of
quietly running on the host.  ``"cpu"`` is honoured only when the caller
passes it, which is what the CPU tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda:0`` by default; an explicit ``device`` is taken as given.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is visible.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' explicitly to "
                "run the port's plain PyTorch path on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
