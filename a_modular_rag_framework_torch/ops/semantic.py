"""Semantic-similarity edges of a per-question graph, on one device (port
of ``a_modular_rag_framework_tpu/ops/semantic.py``).

One batched program instead of a Python loop over sentence pairs:
normalize the sentence embedding matrix, compute E_n @ E_n^T (in float64,
rounded to f32: never TF32), threshold, and optionally keep only the k strongest partners per node.
Host code extracts the surviving (i, j, sim) triplets for graph assembly.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .._host import require_device, to_device


def _gram(en: torch.Tensor) -> torch.Tensor:
    """en @ en.T, at least as exact as an f32 product, whatever the
    process-wide f32 matmul precision says: the 0.9 cosine cut must not see
    TF32's 10-bit mantissas, and no global switch is touched. The product
    is taken in float64 (which those switches do not reach, on the card or
    on the CPU) and rounded to f32 once."""
    e64 = en.to(torch.float64)
    return (e64 @ e64.T).to(torch.float32)


def semantic_sim_matrix(
    emb: torch.Tensor,  # [n, d] f32 sentence embeddings
    *,
    threshold: float,
    top_k_per_node: int = 0,
) -> torch.Tensor:
    """Return [n, n] f32 on ``emb``'s device: pairwise cosine where
    >= threshold, else 0.

    The diagonal, sub-threshold pairs and pairs with a zero-norm row are
    zeroed. With ``top_k_per_node`` > 0, each row keeps only the partners
    at or above its k-th strongest value."""
    emb = emb.to(torch.float32)
    norms = torch.sqrt(torch.sum(emb * emb, dim=1, keepdim=True))
    en = emb / torch.clamp(norms, min=1e-9)
    sims = _gram(en)
    n = sims.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=sims.device)
    keep = (sims >= threshold) & (~eye)
    zero_norm = norms[:, 0] <= 1e-9
    keep = keep & (~zero_norm[:, None]) & (~zero_norm[None, :])
    out = torch.where(keep, sims, torch.zeros((), dtype=sims.dtype,
                                              device=sims.device))
    if top_k_per_node and top_k_per_node < n:
        kth = torch.topk(out, top_k_per_node, dim=1).values[:, -1:]
        out = torch.where(out >= torch.clamp(kth, min=1e-30), out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def semantic_edges(
    emb: np.ndarray,
    *,
    threshold: float,
    top_k_per_node: int = 0,
    device="cuda",
) -> List[Tuple[int, int, float]]:
    """Host wrapper: unique upper-triangle (i, j, sim) pairs above
    threshold (i < j only), computed on ``device``."""
    n = emb.shape[0]
    if n < 2:
        return []
    dev = require_device(device)
    S = semantic_sim_matrix(
        to_device(np.asarray(emb, dtype=np.float32), dev),
        threshold=threshold, top_k_per_node=top_k_per_node).cpu().numpy()
    iu = np.triu_indices(n, k=1)
    vals = S[iu]
    mask = vals > 0
    return [(int(i), int(j), float(v)) for i, j, v in
            zip(iu[0][mask], iu[1][mask], vals[mask])]
