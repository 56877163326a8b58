from .bm25 import Bm25Index
from .builder import build_packed_index, build_sentence_graph
from .packed import PackedIndex, SentenceCorpus

__all__ = ["Bm25Index", "PackedIndex", "SentenceCorpus", "build_packed_index",
           "build_sentence_graph"]
