"""Cost models of a traced step (port of ``repro.analysis``)."""
