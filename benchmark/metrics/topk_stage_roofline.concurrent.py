"""Dense top-k's share of its roofline where several callers launch at
once, in %: the same reading as ``topk_stage_roofline`` (the least time
from the shapes per ``engine/dense_topk`` range over the device time of
the ops launched inside those ranges), each op tied to the range of the
caller thread that launched it."""
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
