"""Back-compat shim: the random-forest surrogate now lives in
:mod:`repro_torch.core.surrogates.rf` (vectorized split search + flattened-tree
batched predict; the original scalar implementation is retained as
:class:`repro_torch.core.surrogates.reference.RandomForestReference`)."""
from repro_torch.core.surrogates.rf import RandomForest  # noqa: F401

__all__ = ["RandomForest"]
