"""ShardedDenseEngine: dense retrieval over a row-sharded corpus (port of
``a_modular_rag_framework_tpu/parallel/sharded_engine.py``).

The corpus embeddings are normalized as the single-device engine
normalizes them (`engine.query_engine.normalized_embeddings`, on the
mesh's first device) and split by rows over the ``axis`` of the mesh;
queries are replicated, each shard takes its local top-k through
`ops.topk.dense_topk` (the CUDA kernel on a card), and the shards' pairs
merge into the global top-k (`parallel.sharded.sharded_dense_topk`).
Same batch buckets and padding rules as the JAX engine.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from .._host import to_device
from ..core.dto import HitBatch
from ..engine.host_prep import pick_bucket
from ..engine.query_engine import normalized_embeddings
from ..index.packed import PackedIndex
from ..models.hash_embed import HashEmbedEncoder
from .mesh import DeviceMesh, build_mesh
from .sharded import shard_corpus_rows, sharded_dense_topk


class ShardedDenseEngine:
    def __init__(
        self,
        index: PackedIndex,
        *,
        mesh: Optional[DeviceMesh] = None,
        axis: str = "data",
        encoder: Optional[Any] = None,
        batch_buckets: Sequence[int] = (1, 8, 64, 256),
    ):
        self.index = index
        self.mesh = mesh or build_mesh({axis: -1})
        self.axis = axis
        self.device = self.mesh.groups(axis)[0][0]
        self.encoder = encoder or HashEmbedEncoder(dim=index.embed_dim or 64)
        self.batch_buckets = tuple(batch_buckets)
        self._n = index.n_docs
        self.rows = shard_corpus_rows(
            normalized_embeddings(index, self.device), self.mesh, axis)

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def embed_queries(self, texts: Sequence[str]) -> torch.Tensor:
        """[B, d] f32 query embeddings on the first shard's device: through
        the encoder's device seam when its parameters live on a device (a
        learned `TextEncoder`), through its kernel when it hashes on a
        card (the hash encoder's ``device_encode``), else its host
        ``encode_texts``."""
        enc = self.encoder
        if getattr(enc, "device", None) is not None:
            ids, mask = enc.host_featurize(list(texts))
            return enc.device_embed(to_device(ids, enc.device),
                                    to_device(mask, enc.device)
                                    ).to(self.device).contiguous()
        if self.device.type == "cuda" and hasattr(enc, "device_encode"):
            return enc.device_encode(*(
                to_device(a, self.device, non_blocking=True)
                for a in enc.pack_texts(list(texts))))
        return to_device(np.asarray(enc.encode_texts(list(texts)),
                                    dtype=np.float32), self.device)

    def query_batch(self, queries: Sequence[str], *, top_k: int = 10
                    ) -> HitBatch:
        B_real = len(queries)
        k = min(int(top_k), self._n)
        if B_real == 0 or self._n == 0:
            return HitBatch(ids=np.full((B_real, max(k, 1)), -1, np.int32),
                            scores=np.zeros((B_real, max(k, 1)), np.float32))
        B = pick_bucket(self.batch_buckets, B_real)
        q = self.embed_queries(list(queries) + [""] * (B - B_real))
        s, i = sharded_dense_topk(q, self.rows, k)
        return HitBatch(ids=i[:B_real].cpu().numpy().astype(np.int32),
                        scores=s[:B_real].cpu().numpy().astype(np.float32))
