"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def fake_group_active() -> bool:
    """Whether this process holds the dry-run's fake process group
    (``repro_torch.launch.mesh``)."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "fake")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device with no GPU present raises:
    the port never carries on quietly on the CPU; pass ``device="cpu"``
    to ask for it.  A process that made a dry-run mesh
    (``repro_torch.launch.mesh``) is refused CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and fake_group_active():
        raise RuntimeError(
            "this process holds the dry-run's fake process group; run "
            "on the card in a process of its own")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
