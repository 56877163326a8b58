"""Recorded-transcript LLM provider: replay realistic LLM variance offline.

The port's copy of ``a_modular_rag_framework_tpu/core/providers/transcript_provider.py``.

The deterministic MockProvider cannot produce drafts that disagree, mixed
fact-check verdicts or plan variance, so the verifier's self-consistency
aggregation only ever sees unanimity under it. This provider replays
RECORDED responses (captured from a live deployment by wrapping any
provider in `TranscriptRecorder`, or hand-authored as a fixture), cycling
through each entry's response list call by call.

Transcript format (JSONL), one entry per line::

    {"purpose": "factcheck",            # routed call purpose
     "contains": "Marie Okafor",        # optional: substring of the prompt
     "prompt": "...",                   # optional: exact prompt (recorder)
     "responses": ["r1", "r2", ...]}    # cycled per call: k -> k % len

Matching precedence per purpose, in file order: exact ``prompt`` match
first, then first ``contains`` hit, then the first unconstrained entry.
Unmatched calls degrade to the deterministic MockProvider (or raise with
``strict=True``). Select it in the settings as a provider of type
``a_modular_rag_framework_torch.core.providers.transcript_provider:TranscriptReplayProvider``
with ``{"transcript_path": "<file>.jsonl"}`` as its kwargs.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

from .mock_provider import MockProvider


class TranscriptReplayProvider:
    """Offline LLM provider replaying a recorded JSONL transcript."""

    def __init__(self, transcript_path: str = "", *, strict: bool = False,
                 embed_dim: int = 64, **_: Any):
        self.strict = bool(strict)
        self._mock = MockProvider(embed_dim=embed_dim)
        # per-purpose entry lists, file order preserved
        self._entries: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
        self._calls: Dict[int, int] = defaultdict(int)  # id(entry) -> count
        self.path = str(transcript_path or "")
        if self.path:
            self._load(Path(self.path))

    def _load(self, path: Path) -> None:
        if not path.exists():
            if self.strict:
                raise FileNotFoundError(f"transcript not found: {path}")
            return
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            responses = entry.get("responses") or []
            if not responses:
                continue
            self._entries[str(entry.get("purpose") or "")].append(entry)

    # ---- matching ----

    def _match(self, purpose: str, prompt: str) -> Optional[Dict[str, Any]]:
        entries = self._entries.get(purpose, [])
        for e in entries:  # exact prompt (recorder output) first
            if e.get("prompt") and e["prompt"] == prompt:
                return e
        for e in entries:  # then substring matchers
            c = e.get("contains")
            if c and c in prompt:
                return e
        for e in entries:  # then purpose-level catch-alls
            if not e.get("prompt") and not e.get("contains"):
                return e
        return None

    # ---- provider surface ----

    def complete(self, prompt: str, **kw: Any) -> Dict[str, Any]:
        purpose = str(kw.get("purpose")
                      or MockProvider._sniff_purpose(prompt))
        entry = self._match(purpose, prompt)
        if entry is None:
            if self.strict:
                raise KeyError(
                    f"no transcript entry for purpose={purpose!r}")
            return self._mock.complete(prompt, **kw)
        responses = entry["responses"]
        k = self._calls[id(entry)]
        self._calls[id(entry)] = k + 1
        text = str(responses[k % len(responses)])
        return {"text": text, "tokens": len(text) // 4,
                "replayed": True, "call_index": k}

    def embed(self, texts: List[str], **kw: Any) -> Dict[str, Any]:
        return self._mock.embed(texts, **kw)


class TranscriptRecorder:
    """Wrap any provider; capture (purpose, prompt) -> responses to JSONL.

    Record once against a live provider, replay forever offline::

        rec = TranscriptRecorder(OpenAIProvider(...),
                                 out_path="runs/transcript.jsonl")
        ... run the system with `rec` as the provider ...
        rec.flush()

    Repeated calls with the same (purpose, prompt) append to ONE entry's
    response list, which is exactly what `TranscriptReplayProvider` cycles
    through — self-consistency variance round-trips losslessly.
    """

    def __init__(self, inner: Any, out_path: str, **_: Any):
        self.inner = inner
        self.out_path = str(out_path)
        # (purpose, prompt) -> responses, insertion-ordered
        self._log: Dict[Any, List[str]] = {}

    def complete(self, prompt: str, **kw: Any) -> Dict[str, Any]:
        out = self.inner.complete(prompt, **kw)
        purpose = str(kw.get("purpose") or "")
        text = out.get("text", "") if isinstance(out, dict) else str(out)
        self._log.setdefault((purpose, prompt), []).append(text)
        return out

    def embed(self, texts: List[str], **kw: Any) -> Dict[str, Any]:
        return self.inner.embed(texts, **kw)

    def flush(self) -> str:
        p = Path(self.out_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("w") as f:
            for (purpose, prompt), responses in self._log.items():
                f.write(json.dumps({"purpose": purpose, "prompt": prompt,
                                    "responses": responses}) + "\n")
        return str(p)

    def __enter__(self) -> "TranscriptRecorder":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.flush()
