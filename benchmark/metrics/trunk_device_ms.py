"""Encoder trunk (``models/encoder.py``): device ms per ``model/trunk``
range (one per batch of queries embedded)."""
from harness.trace import per_dispatch


def read(run):
    return per_dispatch(run.trace, ("model/trunk",), per="model/trunk")
