from .bm25 import (bm25_rescore_pool, bm25_scores, bm25_scores_batched,
                   bm25_topk_sorted)
from .fusion import (fuse_channels, fuse_pools_compact, minmax_normalize,
                     minmax_rows, reorder_hits)
from .graph import (expand_frontier, expand_frontier_weighted,
                    expand_frontier_weighted_batched,
                    expand_frontier_weighted_capped,
                    expand_frontier_weighted_compact,
                    expand_frontier_weighted_compact_core, hop_decay_table)
from .topk import (dense_topk, dense_topk_cuda, dense_topk_reference,
                   stable_topk)

__all__ = ["bm25_rescore_pool", "bm25_scores", "bm25_scores_batched",
           "bm25_topk_sorted", "dense_topk", "dense_topk_cuda",
           "dense_topk_reference", "expand_frontier",
           "expand_frontier_weighted", "expand_frontier_weighted_batched",
           "expand_frontier_weighted_capped",
           "expand_frontier_weighted_compact",
           "expand_frontier_weighted_compact_core", "fuse_channels",
           "fuse_pools_compact", "hop_decay_table", "minmax_normalize",
           "minmax_rows", "reorder_hits", "stable_topk"]
