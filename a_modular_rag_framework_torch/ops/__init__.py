from .bm25 import bm25_rescore_pool, bm25_topk_sorted
from .fusion import fuse_pools_compact, minmax_rows, reorder_hits
from .graph import expand_frontier_weighted_compact, hop_decay_table
from .topk import (dense_topk, dense_topk_cuda, dense_topk_reference,
                   stable_topk)

__all__ = ["bm25_rescore_pool", "bm25_topk_sorted", "dense_topk",
           "dense_topk_cuda", "dense_topk_reference",
           "expand_frontier_weighted_compact", "fuse_pools_compact",
           "hop_decay_table", "minmax_rows", "reorder_hits", "stable_topk"]
