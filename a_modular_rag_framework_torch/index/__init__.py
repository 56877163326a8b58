from .bm25 import Bm25Index
from .builder import build_packed_index, build_sentence_graph
from .packed import PackedIndex, SentenceCorpus
from .reembed import (attach_learned_embeddings, embed_corpus_pipelined,
                      save_learned_embeddings)

__all__ = ["Bm25Index", "PackedIndex", "SentenceCorpus",
           "attach_learned_embeddings", "build_packed_index",
           "build_sentence_graph", "embed_corpus_pipelined",
           "save_learned_embeddings"]
