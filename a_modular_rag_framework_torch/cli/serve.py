"""HTTP serving front: the QueryServer micro-batcher behind a JSON API.

The port of ``a_modular_rag_framework_tpu/cli/serve.py``: stdlib HTTP over
the port's `engine.server.QueryServer`, so many callers share one engine on
the card. Single queries micro-batch through ``submit``; ``submit_many``
sub-batches ride the dispatch loop as one unit each.

Endpoints (JSON in, JSON out):

- ``GET  /healthz``      -> {"ok": true, "corpus": N, "stats": {...}}
- ``POST /query``        {"query": str, "top_k"?, "mode"?: "single"|"iterative"}
                         -> {"hits": [{"id", "score", "meta"}, ...]}
- ``POST /query_batch``  {"queries": [str, ...], "top_k"?, "mode"?}
                         -> {"results": [[hit, ...], ...]}
- ``POST /answer``       {"question": str, "mode"?: "full"} -> full QA dict
                         (only with --qa; drives system.answer_question)

Engine source: ``--index <packed dir>`` loads a packed index directly;
otherwise ``--settings`` (default config/settings_torch.json) builds the
system through the DI factory and serves its retrieval engine, the
instance ``/answer`` shares. ``--device`` puts the engine (and, with
``--settings``, the whole system) on that device; without it everything
runs on the card and raises where there is none::

    python -m a_modular_rag_framework_torch.cli.serve --index <packed dir> \
        --device cpu --port 8080
"""
from __future__ import annotations

import argparse
import json
import logging
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


def _hit_to_dict(h) -> Dict[str, Any]:
    return {"id": h.id, "score": float(h.score), "meta": h.meta}


class _App:
    """Request-independent state: server, engine, optional QA facade."""

    def __init__(self, server, n_docs: int, settings_path: str = "",
                 qa: bool = False):
        self.server = server
        self.n_docs = n_docs
        self.settings_path = settings_path
        self.qa = qa
        self._qa_lock = threading.Lock()

    def handle(self, path: str, body: Optional[Dict[str, Any]]):
        if path == "/healthz":
            stats = dict(self.server.stats)
            stats.pop("batch_sizes", None)
            return 200, {"ok": True, "corpus": self.n_docs, "stats": stats}
        if path == "/query":
            q = (body or {}).get("query")
            if not isinstance(q, str) or not q.strip():
                return 400, {"error": "body must have a non-empty 'query'"}
            hits = self.server.submit(
                q, top_k=(body or {}).get("top_k"),
                mode=(body or {}).get("mode", "single")).result()
            return 200, {"hits": [_hit_to_dict(h) for h in hits]}
        if path == "/query_batch":
            qs = (body or {}).get("queries")
            if (not isinstance(qs, list) or
                    not all(isinstance(q, str) for q in qs)):
                return 400, {"error": "body must have 'queries': [str, ...]"}
            rows = self.server.submit_many(
                qs, top_k=(body or {}).get("top_k"),
                mode=(body or {}).get("mode", "single")).result()
            return 200, {"results": [[_hit_to_dict(h) for h in row]
                                     for row in rows]}
        if path == "/answer":
            if not self.qa:
                return 404, {"error": "QA endpoint disabled (run with --qa)"}
            q = (body or {}).get("question")
            if not isinstance(q, str) or not q.strip():
                return 400, {"error": "body must have a non-empty 'question'"}
            from ..system import answer_question

            # answer_question reuses the init_system cache (one engine);
            # the workflow itself is stateful per-call, so serialize
            with self._qa_lock:
                res = answer_question(q, mode=(body or {}).get("mode", "full"),
                                      settings_path=self.settings_path)
            return 200, res
        return 404, {"error": f"no route {path!r}"}


def _make_handler(app: _App):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # stdlib default spams stderr
            logger.debug("http: " + fmt, *args)

        def _reply(self, code: int, payload: Dict[str, Any]) -> None:
            data = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (stdlib API)
            code, payload = app.handle(self.path, None)
            self._reply(code, payload)

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._reply(400, {"error": "invalid JSON body"})
                return
            try:
                code, payload = app.handle(self.path, body)
            except Exception as e:  # surface engine errors as 500 JSON
                logger.exception("request failed")
                self._reply(500, {"error": repr(e)[:300]})
                return
            self._reply(code, payload)

    return Handler


class _Server(ThreadingHTTPServer):
    # the stdlib's listen backlog of 5 resets connections under a burst of
    # concurrent clients (19 of 76 at once on the CPU)
    request_queue_size = 128


def make_server(host: str, port: int, app: _App) -> ThreadingHTTPServer:
    """The threaded HTTP server of ``app`` (port 0: any free port), with a
    listen backlog of 128 connections."""
    return _Server((host, port), _make_handler(app))


def build_engine(args, work_dir=None):
    """-> (engine, n_docs, settings_path). --index wins; else DI factory.
    The engine runs on ``args.device`` (None: the card); with a device and
    no --index the system is built from a copy of the settings with the
    top-level ``device`` key, written into ``work_dir`` (which the caller
    removes)."""
    device = getattr(args, "device", None)
    if args.index:
        from ..engine.query_engine import EngineConfig, TorchQueryEngine
        from ..index.packed import PackedIndex

        idx = PackedIndex.load(args.index)
        eng = TorchQueryEngine(idx, device=device or "cuda", config=EngineConfig(
            top_k=args.top_k, graph_window=2,
            batch_buckets=(64, 256, args.max_batch),
            query_df_ratio_max=0.05, bm25_term_topm=32,
            graph_wave_dtype="bfloat16"))
        return eng, idx.n_docs, args.settings
    from ..di.factory import write_settings
    from ..system import get_node_ctx

    settings_path = args.settings
    if device:
        if work_dir is None:
            raise ValueError("a --device copy of the settings needs a work_dir")
        settings_path = write_settings(
            Path(work_dir) / "settings.json", base=args.settings, device=device)
    node_ctx = get_node_ctx(settings_path)
    backend = getattr(node_ctx.retriever, "backend", None)
    engine = getattr(backend, "engine", None)
    if engine is None:
        raise SystemExit("settings build no torch engine; pass --index")
    n_docs = getattr(getattr(engine, "index", None), "n_docs", 0)
    return engine, n_docs, settings_path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--settings", type=str, default="config/settings_torch.json")
    ap.add_argument("--index", type=str, default="",
                    help="packed-index dir (e.g. data/bench_cache); "
                         "bypasses the DI factory")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--top_k", type=int, default=10)
    ap.add_argument("--max_batch", type=int, default=2048)
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    ap.add_argument("--qa", action="store_true",
                    help="enable POST /answer (full QA workflow)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the engine (default: the card)")
    args = ap.parse_args(argv)

    from ..engine.server import QueryServer

    # the --device copy of the settings lives as long as the server
    with tempfile.TemporaryDirectory(prefix="serve_") as work_dir:
        engine, n_docs, settings_path = build_engine(args, work_dir)
        with QueryServer(engine, max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms) as qserver:
            app = _App(qserver, n_docs, settings_path=settings_path,
                       qa=args.qa)
            httpd = make_server(args.host, args.port, app)
            print(f"serving {n_docs} docs on http://{args.host}:{args.port} "
                  f"(qa={'on' if args.qa else 'off'})", flush=True)
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                httpd.shutdown()


if __name__ == "__main__":
    main()
