"""Telemetry (cross-cutting): JSONL event sink, span context manager,
LLM/metric/run events, latency breakdown, Mermaid trace rendering.

The port's copy of ``a_modular_rag_framework_tpu/telemetry/sinks.py``.

Event-schema parity with the reference implementation's app/telemetry/sinks.py:48-235, with
one addition: ``device_timing`` events carrying the device wall time of an
engine batch (fed by `engine.query_engine` from its dispatch-to-fetch time).

Events written to ``runs/<trace_id>/events.jsonl`` (one JSON object per line):

  run_start / run_end / node_start / node_end / error / llm_call / metrics /
  device_timing

Final snapshot written to ``runs/<trace_id>/run.json``; an execution-trace
Mermaid diagram to ``runs/<trace_id>/assets/flow.mmd``.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Protocol


def now() -> float:
    return time.time()


class TelemetrySink(Protocol):
    def record(self, evt: Dict[str, Any]) -> None: ...

    def flush_run(self, trace_id: str, result: Dict[str, Any]) -> None: ...


class NullSink:
    def record(self, evt: Dict[str, Any]) -> None:  # noqa: D102
        pass

    def flush_run(self, trace_id: str, result: Dict[str, Any]) -> None:  # noqa: D102
        pass


class LocalJsonlSink:
    """Append-only local JSONL sink, one directory per trace."""

    def __init__(self, root_dir: str = "runs"):
        self.root = Path(root_dir)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def _dir(self, trace_id: str) -> Path:
        d = self.root / (trace_id or "trace-unknown")
        d.mkdir(parents=True, exist_ok=True)
        (d / "assets").mkdir(parents=True, exist_ok=True)
        return d

    def record(self, evt: Dict[str, Any]) -> None:
        d = self._dir(str(evt.get("trace_id") or "trace-unknown"))
        line = json.dumps(evt, ensure_ascii=False, default=str)
        with self._lock:
            with open(d / "events.jsonl", "a", encoding="utf-8") as f:
                f.write(line + "\n")

    def flush_run(self, trace_id: str, result: Dict[str, Any]) -> None:
        d = self._dir(trace_id)
        snap = {"trace_id": trace_id, "created_at": now(), "result": result}
        with self._lock:
            with open(d / "run.json", "w", encoding="utf-8") as f:
                json.dump(snap, f, ensure_ascii=False, indent=2, default=str)


@contextlib.contextmanager
def span(node: str, sink: Optional[TelemetrySink], trace_id: str):
    """Time a pipeline stage; emits node_start / node_end (or error)."""
    if sink is None:
        yield
        return
    t0 = now()
    sink.record(
        {"trace_id": trace_id, "ts": t0, "event": "node_start", "node": node,
         "status": "running", "payload": {}}
    )
    try:
        yield
        t1 = now()
        sink.record(
            {"trace_id": trace_id, "ts": t1, "event": "node_end", "node": node,
             "status": "ok", "duration_sec": t1 - t0, "payload": {}}
        )
    except Exception as e:  # pragma: no cover - error path
        t1 = now()
        sink.record(
            {"trace_id": trace_id, "ts": t1, "event": "error", "node": node,
             "status": "error", "duration_sec": t1 - t0, "error": repr(e),
             "payload": {}}
        )
        raise


def record_llm_call(sink: Optional[TelemetrySink], trace_id: str, usage: Dict[str, Any]) -> None:
    if sink is None:
        return
    sink.record(
        {"trace_id": trace_id, "ts": now(), "event": "llm_call", "node": None,
         "status": "error" if usage.get("error") else "ok",
         "payload": {"llm": usage}}
    )


def record_metrics(
    sink: Optional[TelemetrySink],
    trace_id: str,
    *,
    coverage: Optional[Dict[str, Any]] = None,
    path_match: Optional[Dict[str, Any]] = None,
    latency: Optional[Dict[str, Any]] = None,
    verifier: Optional[Dict[str, Any]] = None,
    retrieval: Optional[Dict[str, Any]] = None,
) -> None:
    if sink is None:
        return
    payload: Dict[str, Any] = {}
    if coverage:
        payload["coverage"] = coverage
    if path_match:
        payload["path_match"] = path_match
    if latency:
        payload["latency"] = latency
    if verifier:
        payload["verifier"] = verifier
    if retrieval:
        payload["retrieval"] = retrieval
    if payload:
        sink.record(
            {"trace_id": trace_id, "ts": now(), "event": "metrics", "node": None,
             "status": "ok", "payload": payload}
        )


def record_device_timing(
    sink: Optional[TelemetrySink],
    trace_id: str,
    *,
    kernel: str,
    device_ms: float,
    shape: Optional[str] = None,
    backend: Optional[str] = None,
) -> None:
    """Per-kernel device timing into the event stream."""
    if sink is None:
        return
    sink.record(
        {"trace_id": trace_id, "ts": now(), "event": "device_timing",
         "node": kernel, "status": "ok",
         "payload": {"device_ms": device_ms, "shape": shape, "backend": backend}}
    )


def record_run_start(sink: Optional[TelemetrySink], trace_id: str, payload: Optional[Dict[str, Any]] = None) -> None:
    if sink is None:
        return
    sink.record(
        {"trace_id": trace_id, "ts": now(), "event": "run_start", "node": None,
         "status": "running", "payload": payload or {}}
    )


def record_run_end(sink: Optional[TelemetrySink], trace_id: str, payload: Optional[Dict[str, Any]] = None) -> None:
    if sink is None:
        return
    sink.record(
        {"trace_id": trace_id, "ts": now(), "event": "run_end", "node": None,
         "status": "ok", "payload": payload or {}}
    )


# ---------- offline artifacts ----------


def _read_events(trace_dir: Path) -> List[Dict[str, Any]]:
    p = trace_dir / "events.jsonl"
    if not p.exists():
        return []
    evts: List[Dict[str, Any]] = []
    with open(p, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                evts.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return evts


def build_latency_breakdown(evts: List[Dict[str, Any]]) -> Dict[str, Any]:
    by_node: Dict[str, float] = {}
    for e in evts:
        if e.get("event") == "node_end" and e.get("node"):
            by_node[e["node"]] = by_node.get(e["node"], 0.0) + float(e.get("duration_sec") or 0.0)
    device_ms: Dict[str, float] = {}
    for e in evts:
        if e.get("event") == "device_timing" and e.get("node"):
            device_ms[e["node"]] = device_ms.get(e["node"], 0.0) + float(
                (e.get("payload") or {}).get("device_ms") or 0.0
            )
    out: Dict[str, Any] = {"by_node": by_node, "total_sec": sum(by_node.values())}
    if device_ms:
        out["device_ms_by_kernel"] = device_ms
    return out


def build_mermaid(evts: List[Dict[str, Any]]) -> str:
    """Render the execution trace (node_start order) as a Mermaid flowchart."""
    ordered = sorted(evts, key=lambda x: x.get("ts", 0.0))
    seen_order: List[str] = [e["node"] for e in ordered if e.get("event") == "node_start" and e.get("node")]
    if not seen_order:
        return "flowchart TD\n  A[Start] --> B[End]"

    def safe(n: str) -> str:
        return n.replace(" ", "_").replace("-", "_").replace("/", "_")

    lines = ["flowchart TD"]
    uniq: List[str] = []
    for n in seen_order:
        if n not in uniq:
            uniq.append(n)
    for n in uniq:
        lines.append(f'  {safe(n)}["{n}"]')
    for a, b in zip(seen_order, seen_order[1:]):
        lines.append(f"  {safe(a)} --> {safe(b)}")
    return "\n".join(lines)


def finalize_trace_artifacts(root_dir: str, trace_id: str, sink: TelemetrySink) -> None:
    """Post-run: emit a latency-breakdown metric event + write flow.mmd."""
    if not isinstance(sink, LocalJsonlSink):
        return
    trace_dir = Path(sink.root) / trace_id
    evts = _read_events(trace_dir)
    if not evts:
        return
    record_metrics(sink, trace_id, latency=build_latency_breakdown(evts))
    assets = trace_dir / "assets"
    assets.mkdir(parents=True, exist_ok=True)
    (assets / "flow.mmd").write_text(build_mermaid(evts), encoding="utf-8")
