"""Mixture-of-experts layers (``ops/moe.py``, ``csrc/moe_gemm.cu``): device
ms of the ops launched inside the ``model/moe`` ranges (every MoE layer
of a forward: routing, the grouped expert kernel, the combine and the
shared experts) per ``model/trunk`` range (one per batch embedded)."""
from harness.trace import per_dispatch


def read(run):
    return per_dispatch(run.trace, ("model/moe",), per="model/trunk")
