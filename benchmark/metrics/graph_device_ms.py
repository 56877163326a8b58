"""Graph channel (``ops/graph.py``): device ms per engine dispatch of
``engine/graph`` + ``engine/graph_pool``."""
from harness.trace import per_dispatch


def read(run):
    return per_dispatch(run.trace, ("engine/graph", "engine/graph_pool"))
