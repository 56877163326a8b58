"""``TorchQueryEngine.query_dense_batch``: exact dense top-k over the
whole corpus, one synchronous call per batch, closed loop.

Each call runs inside the span ``bench/dense_call`` and each draw of a
batch inside ``bench/generator``. The window runs until the first call
that returns at or after its length; ``qps`` is every question of every
call over the time from its start to that return.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from harness.window import WindowResult

GAP_SPANS = ("dense_call", "generator")


def drive(engine, questions: Sequence[str], stream, mix: dict, spans,
          seconds: float, *, n_batches: int = 0) -> WindowResult:
    """``n_batches`` > 0: exactly that many calls (the warm-up), else a
    window of ``seconds``."""
    k = int(mix["top_k"])
    out = WindowResult()
    t0 = time.perf_counter()
    while True:
        with spans.span("generator"):
            qidx = stream.next_batch()
            texts = [questions[i] for i in qidx]
        with spans.span("dense_call"):
            res = engine.query_dense_batch(texts, top_k=k)
        out.calls += 1
        out.questions += len(qidx)
        out.results.append((qidx, np.asarray(res.hits.ids),
                            np.asarray(res.hits.scores)))
        out.seconds = time.perf_counter() - t0
        out.at.append(out.seconds)
        if (n_batches and out.calls >= n_batches) or (
                not n_batches and out.seconds >= seconds):
            break
    out.values["qps"] = out.questions / out.seconds
    return out
