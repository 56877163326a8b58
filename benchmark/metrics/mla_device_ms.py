"""Latent attention (``models/deepseek_v2.py::mla``): device ms of the ops
launched inside the ``model/mla`` ranges (every layer's attention: the
projections, RoPE and both attention products) per ``model/trunk`` range
(one per batch embedded)."""
from harness.trace import per_dispatch


def read(run):
    return per_dispatch(run.trace, ("model/mla",), per="model/trunk")
