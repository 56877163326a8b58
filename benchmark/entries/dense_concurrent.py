"""``TorchQueryEngine.query_dense_batch`` from the mix's ``callers``
threads at once, closed loop: each caller sends its next batch when its
last result is back, so up to ``callers`` batches are in flight and one
caller's host work (tokenization, the result copy) overlaps another's
device work.

Each call runs inside the span ``bench/dense_call`` and each draw of a
batch inside ``bench/generator``. When the window's time is up no caller
sends another batch; the window closes when every batch sent has come
back, and ``qps`` is every question of every call over that time.
"""
from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np

from harness.window import WindowResult

GAP_SPANS = ("dense_call", "generator")


def drive(engine, questions: Sequence[str], stream, mix: dict, spans,
          seconds: float, *, n_batches: int = 0) -> WindowResult:
    """``n_batches`` > 0: exactly that many calls (the warm-up: the first
    alone, so the kernels build once, the rest from every caller), else a
    window of ``seconds``."""
    k = int(mix["top_k"])
    out = WindowResult()
    lock = threading.Lock()
    sent = [0]
    errors = []

    def one_call(qidx) -> None:
        texts = [questions[i] for i in qidx]
        with spans.span("dense_call"):
            res = engine.query_dense_batch(texts, top_k=k)
        ids, scores = np.asarray(res.hits.ids), np.asarray(res.hits.scores)
        t = time.perf_counter() - t0
        with lock:
            out.calls += 1
            out.questions += len(qidx)
            out.results.append((qidx, ids, scores))
            out.at.append(t)

    def caller() -> None:
        try:
            while True:
                with lock:
                    if errors or (n_batches and sent[0] >= n_batches) or (
                            not n_batches and
                            time.perf_counter() - t0 >= seconds):
                        return
                    sent[0] += 1
                    with spans.span("generator"):
                        qidx = stream.next_batch()
                one_call(qidx)
        except BaseException as e:  # noqa: BLE001  (raised after the join)
            errors.append(e)

    t0 = time.perf_counter()
    if n_batches:
        sent[0] += 1
        with spans.span("generator"):
            qidx = stream.next_batch()
        one_call(qidx)
    threads = [threading.Thread(target=caller, name=f"caller{i}")
               for i in range(int(mix["callers"]))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    out.seconds = time.perf_counter() - t0
    if errors:
        raise errors[0]
    out.at.sort()
    out.values["qps"] = out.questions / out.seconds
    return out
