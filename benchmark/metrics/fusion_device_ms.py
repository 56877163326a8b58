"""Fusion and the dense pool (``ops/fusion.py``, ``engine/dense``):
device ms per engine dispatch of ``engine/fusion`` + ``engine/dense``."""
from harness.trace import per_dispatch


def read(run):
    return per_dispatch(run.trace, ("engine/fusion", "engine/dense"))
