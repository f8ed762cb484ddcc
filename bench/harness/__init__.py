"""The benchmark harness: one cell of BENCHMARK.json, one run."""
