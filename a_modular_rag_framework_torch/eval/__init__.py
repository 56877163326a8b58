from .metrics import exact_match, f1_score, mrr, recall_at_k
from .harness import evaluate_retrieval, evaluate_system

__all__ = ["evaluate_retrieval", "evaluate_system", "exact_match", "f1_score",
           "mrr", "recall_at_k"]
