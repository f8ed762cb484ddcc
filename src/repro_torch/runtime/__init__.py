"""Serving loops (torch port of ``repro.runtime.serve``)."""
from repro_torch.runtime.serve import BatchedServer, LockstepServer, Request

__all__ = ["BatchedServer", "LockstepServer", "Request"]
