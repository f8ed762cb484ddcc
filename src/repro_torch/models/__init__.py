"""Model layers, blocks and assembly for the dense, moe and ssm families
(torch port of ``repro.models``)."""
