from .query_engine import (EngineConfig, HitBatch, PendingQuery, QueryResult,
                           TorchQueryEngine)

__all__ = ["EngineConfig", "HitBatch", "PendingQuery", "QueryResult",
           "TorchQueryEngine"]
