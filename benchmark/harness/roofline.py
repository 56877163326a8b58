"""Peaks of the card and the work of the dense top-k, counted from shapes
(an encoder's trunk is counted by its builder, ``encoders/<builder>.py``).

The peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity), which assume the card's full 700 W power limit; a run reports
the card's own limit beside its shares. The counts follow
``chip_smoke.py::bound_ms`` of the program at commit 7bd9f40: the dense
top-k's scores are float32-faithful (float32 queries against bfloat16
rows), which the tensor cores give in three bfloat16 passes, so its
operations are ``3 * 2 * B * N * d``; its bytes are the float32 queries
and the corpus read once and the float32 + int32 top-k written once.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16_PASSES = 3


def dense_topk_ops(B: int, N: int, d: int) -> float:
    return BF16_PASSES * 2.0 * B * N * d


def dense_topk_bytes(B: int, N: int, d: int, k: int,
                     row_bytes: int = 2) -> float:
    return B * d * 4 + N * d * row_bytes + B * k * 8


def dense_topk_bound_s(B: int, N: int, d: int, k: int) -> float:
    """The least time of the scoring and top-k on the card: the larger of
    its operations over the bf16 peak and its bytes over the memory rate."""
    return max(dense_topk_ops(B, N, d) / PEAK_BF16_FLOPS,
               dense_topk_bytes(B, N, d, k) / PEAK_BYTES)

