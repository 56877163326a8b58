"""Shared helpers of the benchmark's own tests: the import path, and a
cell shrunk to a size the CPU holds."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_cell(name: str, samples: int = 300, batch: int = 64,
               check: int = 64):
    """The cell's files (listed in ``BENCHMARK.json`` or not yet), at
    ``samples`` questions and ``batch``-question calls, with its limits as
    committed."""
    from harness import spec

    cell = spec.find_cell(name, listed=False)
    cell.config["samples"] = samples
    cell.config["engine"]["batch_buckets"] = [batch]
    cell.traffic["batch"] = batch
    cell.traffic["warmup_batches"] = 1
    cell.traffic["check_questions"] = check
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")
    return "cuda"
