"""Sentence corpus: the docs.jsonl data plane.

The port's copy of ``a_modular_rag_framework_tpu/index/corpus.py``.
Schema parity with the reference ingest output
(the reference implementation's my_code/ingest_hotpotqa.py:73-81): one
JSON object per line,
``{"doc_id": "<title>#<sid>", "title": str, "sent_id": int, "text": str}``.
The packed index (`index.packed`) references sentences by row number in this
file, so the corpus file doubles as the id->metadata table.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Sequence


def flatten_hotpotqa_context(samples: Iterable[Dict[str, Any]]) -> Iterator[Dict[str, Any]]:
    """HotpotQA samples -> sentence docs, deduplicated by (title, sent_id).

    Distractor-mode samples repeat titles across samples; the first
    occurrence wins (texts are identical for a given title in HotpotQA).
    """
    seen = set()
    for sample in samples:
        for title, sentences in sample.get("context", []):
            for sid, text in enumerate(sentences):
                key = (title, sid)
                if key in seen:
                    continue
                seen.add(key)
                yield {"doc_id": f"{title}#{sid}", "title": title, "sent_id": sid, "text": text}


def write_docs_jsonl(docs: Iterable[Dict[str, Any]], path: str | Path) -> int:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for d in docs:
            f.write(json.dumps(d, ensure_ascii=False) + "\n")
            n += 1
    return n


def read_docs_jsonl(path: str | Path) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    p = Path(path)
    if not p.exists():
        return out
    with open(p, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


@dataclass
class SentenceCorpus:
    """In-memory corpus table: row index == packed-index id."""

    docs: List[Dict[str, Any]] = field(default_factory=list)

    @classmethod
    def from_jsonl(cls, path: str | Path) -> "SentenceCorpus":
        return cls(docs=read_docs_jsonl(path))

    @classmethod
    def from_hotpotqa(cls, samples: Iterable[Dict[str, Any]]) -> "SentenceCorpus":
        return cls(docs=list(flatten_hotpotqa_context(samples)))

    def __len__(self) -> int:
        return len(self.docs)

    def texts(self) -> List[str]:
        return [d.get("text", "") for d in self.docs]

    def hit_id(self, row: int) -> str:
        """Stable external hit id: ``sent::<title>::<sent_id>`` — the
        normalized id scheme of the reference backend
        (retrieval_backend.py:283-294)."""
        d = self.docs[row]
        return f"sent::{d.get('title') or d.get('doc_id') or 'doc'}::{d.get('sent_id', '')}"

    def hit_meta(self, row: int) -> Dict[str, Any]:
        d = self.docs[row]
        return {
            "kind": "sentence",
            "text": d.get("text"),
            "doc": d.get("title"),
            "sent_id": d.get("sent_id"),
        }

    def row_by_title_sid(self) -> Dict[tuple, int]:
        return {(d.get("title"), d.get("sent_id")): i for i, d in enumerate(self.docs)}
