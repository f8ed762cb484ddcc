"""Model layers, blocks and assembly for every family of the reference
(torch port of ``repro.models``)."""
