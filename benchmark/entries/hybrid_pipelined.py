"""``TorchQueryEngine.query_batches_pipelined``: the single-pass hybrid
program with one batch in flight while the next is prepared, closed loop.

Every ``query_batch_async`` call the pipelined loop makes runs inside the
span ``bench/host_enqueue``, each wait for the next result inside
``bench/fetch`` and each draw of a batch inside ``bench/generator``. The
window runs until the first result that comes back at or after its
length; ``qps`` is every question of every result fetched in it over the
time from its start to that result.
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from harness.window import WindowResult

GAP_SPANS = ("host_enqueue", "fetch", "generator")


def _traced_enqueue(engine, spans) -> None:
    """Wrap the engine's ``query_batch_async`` (looked up on the instance
    by its pipelined loop) in the ``host_enqueue`` span."""
    inner = engine.query_batch_async

    def enqueue(*a, **kw):
        with spans.span("host_enqueue"):
            return inner(*a, **kw)

    engine.query_batch_async = enqueue


def drive(engine, questions: Sequence[str], stream, mix: dict, spans,
          seconds: float, *, n_batches: int = 0) -> WindowResult:
    """``n_batches`` > 0: exactly that many batches (the warm-up), else a
    window of ``seconds``."""
    if not getattr(engine, "_bench_wrapped", False):
        _traced_enqueue(engine, spans)
        engine._bench_wrapped = True
    k = int(mix["top_k"])
    issued: List[np.ndarray] = []

    def batches():
        made = 0
        while not n_batches or made < n_batches:
            with spans.span("generator"):
                qidx = stream.next_batch()
                texts = [questions[i] for i in qidx]
            issued.append(qidx)
            made += 1
            yield texts

    out = WindowResult()
    it = engine.query_batches_pipelined(batches(), top_k=k)
    t0 = time.perf_counter()
    try:
        while True:
            with spans.span("fetch"):
                try:
                    res = next(it)
                except StopIteration:
                    break
            qidx = issued[out.calls]
            out.calls += 1
            out.questions += len(qidx)
            out.results.append((qidx, np.asarray(res.hits.ids),
                                np.asarray(res.hits.scores)))
            out.seconds = time.perf_counter() - t0
            out.at.append(out.seconds)
            if not n_batches and out.seconds >= seconds:
                break
    finally:
        it.close()
        engine.close()  # waits for the batches still being prepared
    out.values["qps"] = out.questions / out.seconds
    return out
