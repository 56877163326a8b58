"""Learned-embedding sidecars for packed indexes (port of
``a_modular_rag_framework_tpu/index/reembed.py``).

An index built with the hash encoder gets its dense channel from a learned
`TextEncoder` without a rebuild: the learned embeddings ride a sidecar next
to the index,

  embeddings_learned.npy   [N, d] uint16 bf16 bit patterns
  learned_embed.json       encoder config + checkpoint path + checksums

with the original's file names and contents, so a sidecar written by
either package attaches in the other. `attach_learned_embeddings` swaps a
loaded `PackedIndex`'s embedding matrix for the sidecar (in place) and
returns the query-side encoder, so engines built from the index score dense
against the learned space.
"""
from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .._host import to_device
from ..models.encoder import EncoderConfig, TextEncoder
from .packed import bf16_bits


def embed_corpus_pipelined(encoder, texts: List[str],
                           batch: int = 4096) -> np.ndarray:
    """Pipelined corpus embed on the encoder's device: the host featurize
    of batch i+1 overlaps the device's encode of batch i (the device call
    returns once queued; a batch is fetched only after the next one is
    dispatched); every batch pads to one shape with empty texts."""
    out: List[np.ndarray] = []
    pending, pend_rows = None, 0
    for i in range(0, len(texts), batch):
        b = texts[i:i + batch]
        rows = len(b)
        if rows < batch:
            b = b + [""] * (batch - rows)
        ids, mask = encoder.host_featurize(b)
        fut = encoder.device_embed(
            to_device(ids, encoder.device, non_blocking=True),
            to_device(mask, encoder.device, non_blocking=True))
        if pending is not None:
            out.append(pending[:pend_rows].cpu().numpy())
        pending, pend_rows = fut, rows
    if pending is not None:
        out.append(pending[:pend_rows].cpu().numpy())
    if not out:
        return np.zeros((0, encoder.dim), dtype=np.float32)
    return np.concatenate(out).astype(np.float32)


def save_learned_embeddings(cache_dir: str | Path, emb: np.ndarray,
                            encoder_ckpt: str, encoder_cfg: Any,
                            *, extra: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, Any]:
    """Write the sidecar pair into ``cache_dir``. Embeddings store as bf16
    bit patterns (the packed-index convention — halves disk and device
    memory)."""
    cache_dir = Path(cache_dir)
    np.save(cache_dir / "embeddings_learned.npy",
            bf16_bits(np.asarray(emb, dtype=np.float32)))
    ck = Path(encoder_ckpt)
    doc = {
        "encoder_checkpoint": str(ck),
        "encoder_sha256": hashlib.sha256(ck.read_bytes()).hexdigest()
        if ck.exists() else None,
        "encoder_config": {
            "vocab_size": encoder_cfg.vocab_size,
            "max_len": encoder_cfg.max_len,
            "d_model": encoder_cfg.d_model,
            "n_heads": encoder_cfg.n_heads,
            "n_layers": encoder_cfg.n_layers,
            "d_ff": encoder_cfg.d_ff,
            "subword_ngrams": encoder_cfg.subword_ngrams,
            "ngram_min": encoder_cfg.ngram_min,
            "ngram_max": encoder_cfg.ngram_max,
        },
        "rows": int(emb.shape[0]),
        "dim": int(emb.shape[1]),
        "embed_dtype": "bfloat16",
        "built_unix": time.time(),
        **(extra or {}),
    }
    (cache_dir / "learned_embed.json").write_text(json.dumps(doc, indent=1))
    return doc


def attach_learned_embeddings(idx, cache_dir: str | Path,
                              *, mmap: bool = True, device="cuda"
                              ) -> Optional[Tuple[Any, Dict[str, Any]]]:
    """If ``cache_dir`` holds a learned-embedding sidecar matching the
    index's row count, swap it in (in place) and return
    ``(TextEncoder on device, sidecar_doc)``; else None. The encoder
    checkpoint must exist — queries have to embed in the same space as the
    corpus."""
    cache_dir = Path(cache_dir)
    man = cache_dir / "learned_embed.json"
    npy = cache_dir / "embeddings_learned.npy"
    if not (man.exists() and npy.exists()):
        return None
    doc = json.loads(man.read_text())
    arr = np.load(npy, mmap_mode="r" if mmap else None)
    if int(arr.shape[0]) != idx.n_docs:
        return None
    ck = doc.get("encoder_checkpoint") or ""
    ck_path = Path(ck)
    if not ck_path.is_absolute():
        ck_path = cache_dir.parent.parent / ck  # repo-relative
        if not ck_path.exists():
            ck_path = Path(ck)
    if not ck_path.exists():
        return None
    cfg = EncoderConfig(**doc["encoder_config"])
    enc = TextEncoder.load(str(ck_path), cfg, device=device)
    idx.embeddings = arr
    idx.embed_dtype = doc.get("embed_dtype", "bfloat16")
    return enc, doc
