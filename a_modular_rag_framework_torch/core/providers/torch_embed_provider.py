"""Local embedding provider: the router's embedding path (port of
``a_modular_rag_framework_tpu/core/providers/tpu_embed_provider.py``).

Embeddings come from a batched encoder that runs where the provider was
told to: the same encoder class powers index build (`index.builder`) and
query-time embedding (`engine.query_engine`), so query and corpus vectors
always agree.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..._host import require_device


class TorchEmbedProvider:
    """Batched text encoder behind the `LLMProvider` protocol.

    Parameters
    ----------
    encoder : optional object with ``encode_texts(List[str]) -> np.ndarray``;
        defaults to the deterministic hash encoder (`models.hash_embed`),
        which needs no weights and embeds on the host. A
        `models.encoder.TextEncoder` embeds on its own device, which must
        be ``device``.
    device : ``"cuda"`` (the card, the default), ``"cuda:i"`` or ``"cpu"``;
        asking for CUDA where there is none raises.
    """

    def __init__(
        self,
        encoder: Optional[Any] = None,
        embed_dim: int = 64,
        max_batch: int = 1024,
        device="cuda",
        **_: Any,
    ):
        self.embed_dim = int(embed_dim)
        self.max_batch = int(max_batch)
        self.device = require_device(device)
        if encoder is None:
            from ...models.hash_embed import HashEmbedEncoder

            encoder = HashEmbedEncoder(dim=self.embed_dim)
        enc_device = getattr(encoder, "device", self.device)
        if enc_device != self.device:
            raise ValueError(f"the encoder's parameters are on {enc_device} "
                             f"but the provider was given {self.device}")
        self.encoder = encoder

    def complete(self, prompt: str, **kw: Any) -> Dict[str, Any]:
        raise NotImplementedError("TorchEmbedProvider is embeddings-only")

    def embed(self, texts: List[str], **kw: Any) -> Dict[str, Any]:
        texts = list(texts)
        chunks: List[np.ndarray] = []
        for i in range(0, len(texts), self.max_batch):
            vecs = self.encoder.encode_texts(texts[i : i + self.max_batch])
            chunks.append(np.asarray(vecs))
        if chunks:
            out = np.concatenate(chunks, axis=0)
        else:
            out = np.zeros((0, self.embed_dim), dtype=np.float32)
        return {"vectors": [v.tolist() for v in out]}
