"""System facade: the single public entry (port of
``a_modular_rag_framework_tpu/system.py``).

``init_system`` wires settings -> providers -> router -> engine -> modules
-> workflow, and ``answer_question`` runs one question with the trace
lifecycle and artifact finalization. The packed index and the query engine
are built once here and shared by retrieval, graph bootstrap and the
verifier's claim-check retriever; ``init_system`` results are cached, so a
batch job uploads the index to the device once, not per question.

Everything runs on the card unless the settings carry ``"device": "cpu"``
(or another device); without a card and without that key, building the
system raises.
"""
from __future__ import annotations

import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from .core.dataset_loader import build_dataset_loader
from .di.factory import build_modules, build_providers, build_router, load_settings
from .orchestrator.workflow import build_workflow
from .telemetry.sinks import (
    LocalJsonlSink,
    NullSink,
    finalize_trace_artifacts,
    record_run_end,
    record_run_start,
)

DEFAULT_SETTINGS_PATH = "config/settings_torch.json"

_SYSTEM_CACHE: Dict[str, Tuple[Any, Any]] = {}
_NODE_CTX_CACHE: Dict[str, Any] = {}


def new_trace_id() -> str:
    ts = time.strftime("%Y%m%d-%H%M%S", time.localtime())
    return f"trace-{ts}-{uuid.uuid4().hex[:8]}"


def init_system(
    settings_path: str = DEFAULT_SETTINGS_PATH,
    *,
    runs_dir: str = "runs",
    use_cache: bool = True,
):
    """Build (workflow, sink) from a settings file."""
    cache_key = f"{Path(settings_path).resolve()}::{runs_dir}"
    if use_cache and cache_key in _SYSTEM_CACHE:
        return _SYSTEM_CACHE[cache_key]

    settings = load_settings(settings_path)
    sink = (LocalJsonlSink(root_dir=runs_dir)
            if (settings.get("logging") or {}).get("trace", True) else NullSink())

    providers = build_providers(settings)
    router = build_router(settings, providers, sink=sink)
    node_ctx = build_modules(settings, router, sink=sink)

    # share the retrieval engine with the verifier's claim-check channel
    backend = getattr(node_ctx.retriever, "backend", None)
    verifier_impl = getattr(node_ctx.verifier, "impl", None)
    if backend is not None and verifier_impl is not None and \
            getattr(verifier_impl, "external_claim_retriever", None) is None:
        from .core.dto import RetrievalIn

        def claim_retriever(claim: str, _entities, trace_id: str):
            out = backend.retrieve(RetrievalIn(query=claim, graph_id="",
                                               top_k=5, trace_id=trace_id))
            return out.hits

        verifier_impl.external_claim_retriever = claim_retriever

    dataset_cfg = settings.get("dataset", {}) or {}
    dataset_loader = build_dataset_loader(dataset_cfg) if dataset_cfg else None

    wf = build_workflow(node_ctx, dataset_cfg=dataset_cfg,
                        dataset_loader=dataset_loader)
    if use_cache:
        _SYSTEM_CACHE[cache_key] = (wf, sink)
        _NODE_CTX_CACHE[cache_key] = node_ctx
    return wf, sink


def get_node_ctx(
    settings_path: str = DEFAULT_SETTINGS_PATH,
    *,
    runs_dir: str = "runs",
):
    """The NodeContext behind a cached ``init_system`` build (the module
    instances incl. the retrieval backend/engine). Builds the system if
    not cached yet — serving fronts use this to share ONE device-resident
    engine between the raw retrieval endpoints and ``answer_question``."""
    cache_key = f"{Path(settings_path).resolve()}::{runs_dir}"
    if cache_key not in _NODE_CTX_CACHE:
        init_system(settings_path, runs_dir=runs_dir)
    return _NODE_CTX_CACHE[cache_key]


def reset_system_cache() -> None:
    _SYSTEM_CACHE.clear()
    _NODE_CTX_CACHE.clear()


def answer_question(
    question: str,
    *,
    mode: str = "full",
    settings_path: str = DEFAULT_SETTINGS_PATH,
    runs_dir: str = "runs",
) -> Dict[str, Any]:
    """Run one question through the full pipeline; returns the packed result."""
    wf, sink = init_system(settings_path, runs_dir=runs_dir)
    trace_id = new_trace_id()

    init_state = {
        "external_context": {},
        "question": question,
        "trace_id": trace_id,
        "policy": {"mode": mode},
    }

    record_run_start(sink, trace_id, {"question": question, "mode": mode})
    final_state = wf.invoke(input=init_state)
    result = final_state["result"]
    record_run_end(sink, trace_id, {"status": "completed"})
    finalize_trace_artifacts(root_dir=runs_dir, trace_id=trace_id, sink=sink)
    sink.flush_run(trace_id, result)
    result["trace_id"] = trace_id
    return result
