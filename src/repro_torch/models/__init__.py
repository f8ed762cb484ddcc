"""Dense-family model layers, blocks and assembly (torch port of ``repro.models``)."""
