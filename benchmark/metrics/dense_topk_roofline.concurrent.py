"""Dense top-k's share of its roofline where several callers launch at
once, in %: the least time of the scoring and top-k from the shapes
(`harness.roofline.dense_topk_bound_s`) over the device time of every op
of the traced window less those inside ``model/trunk``. The entry
launches nothing but its dense calls, so that is the scoring and top-k
work, whatever implements it, without tying each op to the thread whose
``bench/dense_call`` span launched it."""
from harness.roofline import dense_topk_bound_s


def read(run):
    t = run.trace
    if not t:
        return None
    calls = t["range_count"].get("bench/dense_call", 0)
    work_ms = (sum(t["kernel_ms"].values())
               - t["range_ms"].get("model/trunk", 0.0))
    if not calls or work_ms <= 0:
        return None
    bound_ms = 1e3 * dense_topk_bound_s(run.batch, run.n_rows, run.dim,
                                        run.top_k)
    return 100.0 * calls * bound_ms / work_ms
