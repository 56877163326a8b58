from .base import LLMProvider
from .mock_provider import MockProvider
from .ollama_provider import OllamaProvider
from .openai_provider import OpenAIProvider
from .torch_embed_provider import TorchEmbedProvider
from .transcript_provider import TranscriptRecorder, TranscriptReplayProvider

__all__ = [
    "LLMProvider",
    "MockProvider",
    "OllamaProvider",
    "OpenAIProvider",
    "TorchEmbedProvider",
    "TranscriptRecorder",
    "TranscriptReplayProvider",
]
