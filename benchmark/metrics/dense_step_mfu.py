"""The whole dense step's share of the card's bf16 peak, in %: the trunk's
operations over the batch at its padded length (``run.trunk_flops``, the
configuration's encoder builder's ``flops``; none for the hash encoder)
plus the scoring's three bf16 passes (`harness.roofline`), per call, over
the host-clock window time per call of the traced window."""
from harness.roofline import PEAK_BF16_FLOPS, dense_topk_ops


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    flops = run.trunk_flops + dense_topk_ops(run.batch, run.n_rows, run.dim)
    return 100.0 * flops * run.calls / (run.window_s * PEAK_BF16_FLOPS)
