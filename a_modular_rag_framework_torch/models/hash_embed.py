"""Deterministic hash-feature text encoder (port of
``a_modular_rag_framework_tpu/models/hash_embed.py``).

The host half is a jax-free copy of the original: the same tokenizer, the
same phrase augmentation, the same crc32 buckets and signs, and the same
native C++ featurizer when its library builds. The device half,
`device_embed`, is a torch function: a signed ``scatter_add_`` of the hashed
features into ``dim`` buckets, then L2 normalization with the same
``max(norm, 1e-9)`` floor. (The JAX version used a one-hot einsum only
because scatters serialize on a TPU.) Signs are +-1, so the bucket sums
are exact small integers and both versions give the same vectors.

A second device form hashes on the card itself: `pack_texts` packs a
batch's bytes and row offsets on the host, and
`HashEmbedEncoder.device_encode` turns them into the rows of
``encode_texts`` bit for bit (`ops.hash_embed`, the CUDA kernel on a CUDA
device).
"""
from __future__ import annotations

import re
import zlib
from typing import List, Tuple

import numpy as np
import torch

from ..native import binding as _native
from ..ops.hash_embed import hash_embed
from ..telemetry.stages import stage
from ..utils.textspan import capitalized_runs

_TOKEN_RE = re.compile(r"[^a-zA-Z0-9]+")


def tokenize(text: str) -> List[str]:
    """Same tokenizer as the BM25 index."""
    return [t for t in _TOKEN_RE.split((text or "").lower()) if t]


def phrase_augment(text: str) -> str:
    """Append joined capitalized-run phrase tokens to ``text``
    ("Ananan Belanan ..." gains "ananan00belanan")."""
    if not text or text.islower():
        return text
    runs = [r for r in capitalized_runs(text) if " " in r]
    if not runs:
        return text
    extra = ["00".join(tokenize(r)) for r in runs]
    return f"{text} {' '.join(extra)}"


def _features(text: str) -> List[str]:
    toks = tokenize(text)
    feats = list(toks)
    feats.extend(f"{a}_{b}" for a, b in zip(toks, toks[1:]))
    return feats


def _bucket_sign(feat: str, dim: int) -> Tuple[int, float]:
    h = zlib.crc32(feat.encode("utf-8"))
    bucket = h % dim
    sign = 1.0 if (h >> 16) & 1 else -1.0
    return bucket, sign


def hash_embed_numpy(texts: List[str], dim: int = 64) -> np.ndarray:
    """Host reference path: [N, dim] float32, L2-normalized rows."""
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, t in enumerate(texts):
        for feat in _features(t):
            b, s = _bucket_sign(feat, dim)
            out[i, b] += s
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-9)


def device_embed(buckets: torch.Tensor, signs: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """[B, L] int bucket ids + [B, L] f32 signs -> [B, dim] f32, unit rows.

    Padding features (bucket 0, sign 0) contribute nothing."""
    acc = torch.zeros((buckets.shape[0], dim), dtype=torch.float32,
                      device=buckets.device)
    acc.scatter_add_(1, buckets.long(), signs.float())
    norms = torch.sqrt(torch.sum(acc * acc, dim=1, keepdim=True))
    return acc / torch.clamp(norms, min=1e-9)


def pack_texts(texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """A batch's bytes, uint8 [nbytes], and row offsets, int32 [B + 1], as
    `ops.hash_embed` reads them: the rows joined by NUL separators (a row
    ends at its first NUL, the separator or one of its own).

    An all-ASCII batch is joined and encoded once (the kernel lowers ASCII
    itself) and its offsets are found from the separators in the bytes:
    no pass over the rows in Python, whose scattered string objects cost
    more than the bytes. Any other batch is lowered row by row with
    Python's full Unicode tables and encoded as utf-8 with
    ``errors="ignore"``, the bytes the native host path reads (some
    non-ASCII characters lower into ASCII letters: the Kelvin sign into
    'k'); that path runs inside the range ``engine/featurize/lower``."""
    joined = "\0".join(texts)
    if joined.isascii():
        data = np.frombuffer(joined.encode("ascii"), dtype=np.uint8)
        seps = np.flatnonzero(data == 0)
        if seps.size != len(texts) - 1:  # some row holds a NUL of its own
            seps = np.cumsum([len(t) + 1 for t in texts[:-1]]) - 1
    else:
        with stage("engine/featurize/lower"):
            rows = [t.lower().encode("utf-8", errors="ignore") for t in texts]
            data = np.frombuffer(b"\0".join(rows), dtype=np.uint8)
            seps = np.cumsum([len(r) + 1 for r in rows[:-1]]) - 1
    offsets = np.empty(len(texts) + 1, dtype=np.int32)
    offsets[0] = 0
    offsets[1:-1] = seps + 1
    offsets[-1] = data.size
    return data, offsets


class HashEmbedEncoder:
    """Host featurizer + torch device embedding (``device_embed``)."""

    def __init__(self, dim: int = 64, max_features: int = 256):
        self.dim = int(dim)
        self.max_features = int(max_features)

    def featurize(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Padded (buckets int32 [B, L], signs float32 [B, L]); native C++
        when its library builds (bit-exact), else the Python loop."""
        native = _native.featurize_batch_native(texts, self.dim,
                                                self.max_features)
        if native is not None:
            return native
        B, L = len(texts), self.max_features
        buckets = np.zeros((B, L), dtype=np.int32)
        signs = np.zeros((B, L), dtype=np.float32)
        for i, t in enumerate(texts):
            for j, feat in enumerate(_features(t)[:L]):
                buckets[i, j], signs[i, j] = _bucket_sign(feat, self.dim)
        return buckets, signs

    def host_featurize(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        return self.featurize(texts)

    def encode_token_batch(self, buckets: np.ndarray,
                           signs: np.ndarray) -> np.ndarray:
        """Host accumulation (per-row bincount + normalize)."""
        B = buckets.shape[0]
        acc = np.empty((B, self.dim), dtype=np.float32)
        for i in range(B):
            acc[i] = np.bincount(buckets[i], weights=signs[i],
                                 minlength=self.dim)[: self.dim]
        norms = np.linalg.norm(acc, axis=1, keepdims=True)
        return acc / np.maximum(norms, 1e-9)

    def device_embed(self, buckets: torch.Tensor,
                     signs: torch.Tensor) -> torch.Tensor:
        return device_embed(buckets, signs, self.dim)

    pack_texts = staticmethod(pack_texts)

    def device_encode(self, data: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
        """`pack_texts`'s arrays, uploaded -> [B, dim] f32 unit rows on
        their device, equal to ``encode_texts`` of the texts bit for bit."""
        return hash_embed(data, offsets, self.dim, self.max_features)

    def encode_texts(self, texts: List[str]) -> np.ndarray:
        """Host embedding of a batch: [B, dim] f32 numpy."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        out = _native.hash_embed_batch_native(texts, self.dim,
                                              self.max_features)
        if out is not None:
            return out
        return self.encode_token_batch(*self.featurize(texts))
