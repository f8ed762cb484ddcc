"""The port's search stack: the search domain, the method and objective
registries, the drivers, optimizers and surrogates, copied from
``repro/core`` (``tests/test_torch_search.py`` holds each copy to its
source)."""
