"""PackedIndex — the on-disk index artifact, uploaded as torch tensors.

Port of ``a_modular_rag_framework_tpu/index/packed.py`` with the SAME
directory layout, so an index saved by either package loads in the other:

  manifest.json      shapes, dtypes, sha256 checksums, build stats
  embeddings.npy     [N, d] f32 or bf16-as-uint16 corpus embeddings
  bm25_doc_ids.npy   [P] int32   flat CSR postings (doc row per posting)
  bm25_tfs.npy       [P] f32     term frequencies
  bm25_row_ptr.npy   [V+1] int32 postings offsets per term id
  bm25_df.npy        [V] f32     document frequency per term
  bm25_doc_lens.npy  [N] f32     tokens per sentence
  vocab.json         term -> term id
  graph_next.npy     [N, 2] int32 next-in-doc adjacency (-1 padded)
  graph_entity.npy   [N, deg] int32 shared-entity adjacency (-1 padded)
  docs.jsonl         row metadata
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._host import to_device
from .bm25 import Bm25Index
from .corpus import SentenceCorpus, write_docs_jsonl

_FILES = ("docs.jsonl", "embeddings.npy", "bm25_doc_ids.npy", "bm25_tfs.npy",
          "bm25_row_ptr.npy", "bm25_df.npy", "bm25_doc_lens.npy",
          "vocab.json", "graph_next.npy", "graph_entity.npy")


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def bf16_bits(emb: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (uint16, round-to-nearest-even); uint16
    input is taken as bit patterns already."""
    if emb.dtype == np.uint16:
        return emb
    u = np.ascontiguousarray(emb, dtype=np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


@dataclass(eq=False)  # identity eq/hash, as in the JAX PackedIndex
class PackedIndex:
    """Host numpy arrays (possibly memory-mapped); the ``device_*``
    methods upload them to an explicit device."""

    corpus: Any  # SentenceCorpus
    embeddings: np.ndarray  # [N, d] f32, or uint16 bf16 bit patterns
    embed_dtype: str
    bm25: Bm25Index
    graph_next: np.ndarray  # [N, 2] int32
    graph_entity: np.ndarray  # [N, deg] int32
    manifest: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_docs(self) -> int:
        return len(self.corpus)

    @property
    def embed_dim(self) -> int:
        return int(self.embeddings.shape[1]) if self.embeddings.size else 0

    @classmethod
    def from_arrays(cls, *, docs, embeddings: np.ndarray, embed_dtype: str,
                    bm25_doc_ids: np.ndarray, bm25_tfs: np.ndarray,
                    bm25_row_ptr: np.ndarray, bm25_df: np.ndarray,
                    bm25_doc_lens: np.ndarray, vocab: Dict[str, int],
                    k1: float = 1.5, b: float = 0.75,
                    bm25_scores: Optional[np.ndarray] = None,
                    graph_next: np.ndarray, graph_entity: np.ndarray,
                    manifest: Optional[Dict[str, Any]] = None,
                    ) -> "PackedIndex":
        """Build the port's index from another index's numpy fields (e.g.
        the JAX ``PackedIndex``): its corpus rows, embeddings, bm25 arrays
        and graph tables carry over unchanged."""
        bm25 = Bm25Index(doc_ids=np.asarray(bm25_doc_ids),
                         tfs=np.asarray(bm25_tfs),
                         row_ptr=np.asarray(bm25_row_ptr),
                         df=np.asarray(bm25_df),
                         doc_lens=np.asarray(bm25_doc_lens),
                         vocab=dict(vocab), k1=float(k1), b=float(b),
                         scores=(None if bm25_scores is None
                                 else np.asarray(bm25_scores)))
        return cls(corpus=SentenceCorpus(docs=list(docs)),
                   embeddings=np.asarray(embeddings), embed_dtype=embed_dtype,
                   bm25=bm25, graph_next=np.asarray(graph_next),
                   graph_entity=np.asarray(graph_entity),
                   manifest=dict(manifest or {}))

    # ---- persistence ----

    def save(self, root) -> Dict[str, Any]:
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        write_docs_jsonl(self.corpus.docs, root / "docs.jsonl")
        if self.embed_dtype == "bfloat16":
            np.save(root / "embeddings.npy", bf16_bits(self.embeddings))
        else:
            np.save(root / "embeddings.npy",
                    self.embeddings.astype(np.float32))
        np.save(root / "bm25_doc_ids.npy", self.bm25.doc_ids)
        np.save(root / "bm25_tfs.npy", self.bm25.tfs)
        np.save(root / "bm25_row_ptr.npy", self.bm25.row_ptr)
        np.save(root / "bm25_df.npy", self.bm25.df)
        np.save(root / "bm25_doc_lens.npy", self.bm25.doc_lens)
        (root / "vocab.json").write_text(json.dumps(self.bm25.vocab),
                                         encoding="utf-8")
        np.save(root / "graph_next.npy", self.graph_next)
        np.save(root / "graph_entity.npy", self.graph_entity)
        manifest = {
            "format_version": 1,
            "n_docs": self.n_docs,
            "embed_dim": self.embed_dim,
            "embed_dtype": self.embed_dtype,
            "bm25": {"k1": self.bm25.k1, "b": self.bm25.b,
                     "vocab_size": len(self.bm25.vocab),
                     "n_postings": int(self.bm25.doc_ids.shape[0])},
            "graph_max_degree": (int(self.graph_entity.shape[1])
                                 if self.graph_entity.size else 0),
            "checksums": {f: _sha256(root / f) for f in _FILES},
            **{k: v for k, v in self.manifest.items() if k != "checksums"},
        }
        (root / "manifest.json").write_text(json.dumps(manifest, indent=2),
                                            encoding="utf-8")
        self.manifest = manifest
        return manifest

    @classmethod
    def load(cls, root, *, mmap: bool = True,
             verify_checksums: bool = False) -> "PackedIndex":
        root = Path(root)
        manifest = json.loads((root / "manifest.json").read_text(
            encoding="utf-8"))
        if verify_checksums:
            for f, want in manifest.get("checksums", {}).items():
                got = _sha256(root / f)
                if got != want:
                    raise ValueError(
                        f"checksum mismatch for {f}: {got} != {want}")
        mode = "r" if mmap else None
        bm = manifest.get("bm25", {})
        bm25 = Bm25Index(
            doc_ids=np.load(root / "bm25_doc_ids.npy", mmap_mode=mode),
            tfs=np.load(root / "bm25_tfs.npy", mmap_mode=mode),
            row_ptr=np.load(root / "bm25_row_ptr.npy"),
            df=np.load(root / "bm25_df.npy"),
            doc_lens=np.load(root / "bm25_doc_lens.npy"),
            vocab=json.loads((root / "vocab.json").read_text(
                encoding="utf-8")),
            k1=float(bm.get("k1", 1.5)), b=float(bm.get("b", 0.75)),
        )
        return cls(
            corpus=SentenceCorpus.from_jsonl(root / "docs.jsonl"),
            embeddings=np.load(root / "embeddings.npy", mmap_mode=mode),
            embed_dtype=manifest.get("embed_dtype", "float32"),
            bm25=bm25,
            graph_next=np.load(root / "graph_next.npy", mmap_mode=mode),
            graph_entity=np.load(root / "graph_entity.npy", mmap_mode=mode),
            manifest=manifest,
        )

    # ---- device residency ----

    def device_embeddings(self, device) -> torch.Tensor:
        """[N, d] embeddings on ``device``: bf16 indexes go up as their
        uint16 bit patterns and are reinterpreted through an int16 view
        (exact round trip), f32 indexes as f32."""
        arr = np.ascontiguousarray(self.embeddings)
        if self.embed_dtype == "bfloat16":
            return to_device(bf16_bits(arr).view(np.int16),
                             device).view(torch.bfloat16)
        return to_device(arr.astype(np.float32, copy=False), device)

    def device_bm25(self, device) -> Dict[str, torch.Tensor]:
        return self.bm25.device_tensors(device)

    def device_graph(self, device, *, include_entity: bool = True
                     ) -> torch.Tensor:
        """Neighbor table: next-in-doc chains, plus entity links when
        ``include_entity``."""
        nbrs = np.asarray(self.graph_next, dtype=np.int32)
        if include_entity and self.graph_entity.size:
            nbrs = np.concatenate(
                [nbrs, np.asarray(self.graph_entity, dtype=np.int32)], axis=1)
        return to_device(nbrs, device)
