"""LLM and embedding providers of the port (counterpart of
``a_modular_rag_framework_tpu/core/providers/__init__.py``; the Ollama and
transcript providers are not ported)."""
from .base import LLMProvider
from .mock_provider import MockProvider
from .openai_provider import OpenAIProvider
from .torch_embed_provider import TorchEmbedProvider

__all__ = [
    "LLMProvider",
    "MockProvider",
    "OpenAIProvider",
    "TorchEmbedProvider",
]
