"""Back-compat shim: the GP surrogate now lives in
:mod:`repro_torch.core.surrogates.gp` (vectorized, distance-caching rewrite;
the original scalar implementation is retained as
:class:`repro_torch.core.surrogates.reference.GPReference`)."""
from repro_torch.core.surrogates.gp import GP, matern52  # noqa: F401

__all__ = ["GP", "matern52"]
