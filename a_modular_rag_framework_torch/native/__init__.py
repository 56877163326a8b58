from .binding import (
    bm25_build_native,
    entity_graph_native,
    featurize_batch_native,
    hash_embed_batch_native,
    load_native,
    native_available,
    token_counts_native,
)

__all__ = [
    "bm25_build_native",
    "entity_graph_native",
    "featurize_batch_native",
    "hash_embed_batch_native",
    "load_native",
    "native_available",
    "token_counts_native",
]
