"""Dense top-k's share of its roofline, in %, read at the program's own
range: the least time of the scoring and top-k from the shapes
(`harness.roofline.dense_topk_bound_s`: three bf16 passes of 2*B*N*d at
the bf16 peak, against the queries, rows and outputs at the memory rate)
per ``engine/dense_topk`` range (one per `query_dense_batch` call: the
query's plane split, the buffers and the launches of ``topk_partial``
and ``topk_merge``) over the device time of the ops launched inside
those ranges."""
from harness.roofline import dense_topk_bound_s


def read(run):
    t = run.trace
    if not t:
        return None
    calls = t["range_count"].get("engine/dense_topk", 0)
    work_ms = t["range_ms"].get("engine/dense_topk", 0.0)
    if not calls or work_ms <= 0:
        return None
    bound_ms = 1e3 * dense_topk_bound_s(run.batch, run.n_rows, run.dim,
                                        run.top_k)
    return 100.0 * calls * bound_ms / work_ms
