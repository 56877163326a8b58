"""Text channel (``ops/bm25.py``): device ms per engine dispatch of
``engine/bm25_pool`` + ``engine/bm25_rescore`` (+ ``engine/bm25_scatter``
where present)."""
from harness.trace import per_dispatch


def read(run):
    return per_dispatch(run.trace, ("engine/bm25_pool",
                                    "engine/bm25_rescore",
                                    "engine/bm25_scatter"))
