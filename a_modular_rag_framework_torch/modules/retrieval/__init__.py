from .flow import RetrievalAgentFlow
from .torch_backend import TorchHybridRetrievalBackend
from .retrieval_adapter import RetrievalAdapter

__all__ = ["RetrievalAdapter", "RetrievalAgentFlow", "TorchHybridRetrievalBackend"]
