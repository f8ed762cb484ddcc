"""Search-space types of the port (copied from ``repro/core``)."""
