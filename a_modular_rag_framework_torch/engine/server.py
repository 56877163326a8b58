"""Concurrent query serving: a micro-batching front for the query engine
(port of ``a_modular_rag_framework_tpu/engine/server.py``, whose module
imports the pydantic ``Hit``; this copy resolves to the port's dataclass
``Hit`` and serves the iterative mode through the port's
``IterativePending``, and is otherwise the same code).

BASELINE.json config 5's serving story: many concurrent callers, one
device-resident index. Requests land in a queue; a dispatcher thread drains
up to ``max_batch`` queries at a time into a single engine call (bucketed
shapes mean no recompiles), and futures resolve per-caller. The host agent
loop never starves the device: while one batch executes, the next
accumulates.

Two client shapes:

- ``submit(query)`` -> Future[Sequence[Hit]] — one query per future (a
  lazy `LazyHits` view; Hit construction is deferred to first read). Each
  resolution wakes one waiting thread, so closed-loop single-query clients
  cap on Python thread-switch overhead long before the device does.
- ``submit_many(queries)`` -> Future[List[Sequence[Hit]]] — a sub-batch rides
  the dispatch loop as ONE unit: one queue entry, one future, one wakeup.
  This is the throughput surface for callers that have batches (agents
  fanning out expansions, bulk scorers), and what lets serving approach
  the pipelined-loop q/s instead of the thread-wakeup ceiling.
"""
from __future__ import annotations

import queue
import threading
import time
from collections.abc import Sequence as _SeqABC
from concurrent.futures import CancelledError, Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ..core.dto import Hit
from ..modules.retrieval.multihop import IterativePending


@dataclass
class _Request:
    """One dispatch unit: ``queries`` is a list (singular submits wrap)."""

    queries: List[str]
    expansions: Optional[List[List[str]]]
    seed_rows: Optional[List[List[int]]]
    top_k: Optional[int]
    graph_window: Optional[int]
    mode: str = "single"  # "single" | "iterative" (bridge-entity 2-hop)
    unwrap: bool = False  # True for submit(): resolve List[Hit], not [[Hit]]
    future: Future = field(default_factory=Future)


class _Resolved:
    """Adapter giving already-computed results the PendingQuery surface."""

    def __init__(self, result: Any):
        self._result = result

    def result(self) -> Any:
        return self._result


class LazyHits(_SeqABC):
    """List[Hit]-shaped view over one query's row of a ``QueryResult``.

    Hit/meta construction (~10 Hit objects + meta dicts per query) is
    the dominant HOST cost of serving a query — more than the query's share
    of the device program at scale. Under the GIL it costs the same total
    time no matter which thread runs it, so the only real win is not
    running it at all until (unless) the caller actually reads the hits.
    Completion-counting load generators and callers that only forward ids
    pay ~one small object per query; everything that iterates gets plain
    `Hit`s exactly as before (materialized once, cached)."""

    __slots__ = ("_engine", "_result", "_row", "_hits")

    def __init__(self, engine, result, row: int):
        self._engine = engine
        self._result = result
        self._row = row
        self._hits = None

    def _materialize(self) -> List[Hit]:
        if self._hits is None:
            self._hits = self._engine.hydrate_hits(self._result, self._row)
            self._engine = self._result = None  # release the batch arrays
        return self._hits

    def __len__(self) -> int:
        return len(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self) -> str:
        return repr(self._materialize())


class _ClientFuture:
    """Future-shaped handle resolving to LazyHits row views.

    The dispatcher resolves the inner future with ``(engine, QueryResult,
    row0, n_rows)``; ``result()`` wraps each row in a `LazyHits` so Hit
    construction happens only on access, in the reader's thread."""

    __slots__ = ("_inner", "_unwrap", "_value", "_has_value")

    def __init__(self, inner: Future, unwrap: bool):
        self._inner = inner
        self._unwrap = unwrap
        self._value = None
        self._has_value = False

    def result(self, timeout: Optional[float] = None):
        if not self._has_value:
            engine, res, row0, n_rows = self._inner.result(timeout)
            rows = [LazyHits(engine, res, row0 + j) for j in range(n_rows)]
            self._value = rows[0] if self._unwrap else rows
            self._has_value = True
        return self._value

    def done(self) -> bool:
        return self._inner.done()

    def exception(self, timeout: Optional[float] = None):
        return self._inner.exception(timeout)

    def cancel(self) -> bool:
        return self._inner.cancel()

    def cancelled(self) -> bool:
        return self._inner.cancelled()

    def add_done_callback(self, fn) -> None:
        self._inner.add_done_callback(lambda _f: fn(self))


class QueryServer:
    """Thread-safe micro-batching wrapper around `TorchQueryEngine`.

    Usage:
        server = QueryServer(engine, max_batch=64)
        server.start()
        fut = server.submit("who wrote x")
        hits = fut.result()   # List[Hit]
        futs = server.submit_many(["q1", "q2"])
        (h1, h2) = futs.result()
        server.stop()
    """

    def __init__(self, engine, *, max_batch: int = 64,
                 max_wait_ms: float = 2.0):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats: Dict[str, Any] = {"batches": 0, "queries": 0,
                                      "batch_sizes": []}

    # ---- lifecycle ----

    def start(self) -> "QueryServer":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="query-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # reject anything still queued so no caller hangs on .result()
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(
                    CancelledError("QueryServer stopped before dispatch")
                )

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- client API ----

    def submit(
        self,
        query: str,
        *,
        expansions: Optional[Sequence[str]] = None,
        seed_rows: Optional[Sequence[int]] = None,
        top_k: Optional[int] = None,
        graph_window: Optional[int] = None,
        mode: str = "single",
    ) -> Future:
        """Returns a Future resolving to List[Hit]. ``mode="iterative"``
        serves the bridge-entity 2-hop quality mode (multihop.py) through
        the same micro-batching dispatch loop."""
        return self._submit_unit(
            [query],
            expansions=[list(expansions)] if expansions else None,
            seed_rows=[list(seed_rows)] if seed_rows else None,
            top_k=top_k, graph_window=graph_window, mode=mode, unwrap=True)

    def submit_many(
        self,
        queries: Sequence[str],
        *,
        expansions: Optional[Sequence[Sequence[str]]] = None,
        seed_rows: Optional[Sequence[Sequence[int]]] = None,
        top_k: Optional[int] = None,
        graph_window: Optional[int] = None,
        mode: str = "single",
    ) -> Future:
        """Submit a sub-batch as one unit: one Future resolving to
        ``List[List[Hit]]`` (one hit list per query, in order). The unit
        joins the same micro-batch dispatch as singular submits but costs
        one queue entry and one waiter wakeup regardless of its size."""
        if not queries:
            f: Future = Future()
            f.set_result([])
            return f
        return self._submit_unit(
            list(queries),
            expansions=[list(e) for e in expansions] if expansions else None,
            seed_rows=[list(s) for s in seed_rows] if seed_rows else None,
            top_k=top_k, graph_window=graph_window, mode=mode, unwrap=False)

    def _submit_unit(self, queries, *, expansions, seed_rows, top_k,
                     graph_window, mode, unwrap):
        if mode not in ("single", "iterative"):
            raise ValueError(f"unknown mode {mode!r} "
                             "(expected single | iterative)")
        req = _Request(queries=queries, expansions=expansions,
                       seed_rows=seed_rows, top_k=top_k,
                       graph_window=graph_window, mode=mode, unwrap=unwrap)
        self._q.put(req)
        return _ClientFuture(req.future, unwrap)

    def query(self, query: str, **kw) -> List[Hit]:
        return self.submit(query, **kw).result()

    # ---- dispatcher ----

    def _drain(self) -> List[_Request]:
        """Collect units until ``max_batch`` queries are gathered or the
        wait budget expires. A unit is never split; one oversized unit is
        dispatched alone (the engine's buckets handle any batch size)."""
        batch: List[_Request] = []
        try:
            batch.append(self._q.get(timeout=0.05))
        except queue.Empty:
            return batch
        n = len(batch[0].queries)
        deadline = 0.0  # lazily armed: most sustained loads fill from backlog
        while n < self.max_batch:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                now = time.time()
                if deadline == 0.0:
                    deadline = now + self.max_wait_s
                timeout = deadline - now
                if timeout <= 0:
                    break
                try:
                    req = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
            batch.append(req)
            n += len(req.queries)
        return batch

    def _finish(self, pending: Any, reqs: List[_Request]) -> None:
        try:
            result = pending.result()
            row = 0
            for r in reqs:
                # hydration happens in the CLIENT's result() wait
                # (_ClientFuture) — the dispatcher only hands out row ranges
                r.future.set_result(
                    (self.engine, result, row, len(r.queries)))
                row += len(r.queries)
            self.stats["batches"] += 1
            self.stats["queries"] += row
            if len(self.stats["batch_sizes"]) < 10000:
                self.stats["batch_sizes"].append(row)
        except Exception as e:  # pragma: no cover
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    def _loop(self) -> None:
        import collections

        # keep one batch in flight: dispatch group i+1 before fetching
        # group i's results, so host hydration overlaps device execution
        # (engines without query_batch_async resolve synchronously)
        dispatch_async = getattr(self.engine, "query_batch_async", None)
        inflight: "collections.deque" = collections.deque()
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                while inflight:
                    self._finish(*inflight.popleft())
                continue
            # units sharing (top_k, window, seed-mode) can share a program;
            # group to keep shapes uniform
            groups: Dict[Any, List[_Request]] = {}
            for r in batch:
                key = (r.top_k, r.graph_window, r.seed_rows is not None,
                       r.mode)
                groups.setdefault(key, []).append(r)
            for (top_k, window, has_seeds, mode), reqs in groups.items():
                queries: List[str] = []
                expansions: List[List[str]] = []
                seeds: List[List[int]] = []
                for r in reqs:
                    queries.extend(r.queries)
                    expansions.extend(r.expansions or
                                      [[] for _ in r.queries])
                    if has_seeds:
                        seeds.extend(r.seed_rows or
                                     [[] for _ in r.queries])
                kwargs = dict(expansions=expansions,
                              seed_rows=seeds if has_seeds else None,
                              top_k=top_k, graph_window=window)
                try:
                    if mode == "iterative":
                        k_eff = int(top_k or self.engine.config.top_k)
                        p1 = (dispatch_async or self.engine.query_batch)(
                            queries, top_k=max(k_eff, 20),
                            expansions=kwargs["expansions"],
                            seed_rows=kwargs["seed_rows"],
                            graph_window=window)
                        if dispatch_async is None:
                            p1 = _Resolved(p1)
                        inflight.append((IterativePending(
                            self.engine, queries, p1, top_k=k_eff,
                            graph_window=window), reqs))
                    elif dispatch_async is not None:
                        inflight.append((dispatch_async(queries, **kwargs),
                                         reqs))
                    else:
                        result = self.engine.query_batch(queries, **kwargs)
                        self._finish(_Resolved(result), reqs)
                except Exception as e:  # pragma: no cover
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)
                # middle-stage the batches BEHIND the one just dispatched:
                # an iterative pending's advance() waits out its hop-1 and
                # dispatches hop-2 async, so the device queue interleaves
                # batch i's hop-2 with batch i+1's hop-1 instead of the
                # final result() wait serializing both hops per batch
                depth = 1
                for p, _ in list(inflight)[:-1]:
                    adv = getattr(p, "advance", None)
                    if adv is not None:
                        adv()
                        depth = 2  # 3 stages in flight for 2-hop batches
                while len(inflight) > depth:
                    self._finish(*inflight.popleft())
            # nothing else queued: resolve immediately rather than letting a
            # lone synchronous caller wait out the next drain timeout
            # (50 ms) — pipelining only pays under sustained load anyway
            if self._q.empty():
                while inflight:
                    self._finish(*inflight.popleft())
        while inflight:
            self._finish(*inflight.popleft())
