"""Cross-encoder reranker (port of
``a_modular_rag_framework_tpu/models/cross_encoder.py``).

Joint (query, passage) relevance: both texts share one sequence with
segment embeddings, so attention crosses between them, and a linear head
scores the mean-pooled state. A rerank call scores ``B`` queries x ``M``
candidates as one ``[B*M, L]`` batch through the encoder's blocks
(`models.encoder`), in chunks of a fixed pair budget.

Training: `listwise_loss` (softmax cross-entropy over each query's
candidate list) and `make_cross_train_step` (one AdamW step,
`models.optim`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._host import require_device, to_device
from ..telemetry.stages import stage
from .encoder import (EncoderConfig, embed_tokens, encode_tokens,
                      init_params, masked_mean, run_blocks, seeded_generator)
from .optim import make_step
from .params import load_params, save_params


@dataclass(frozen=True)
class CrossEncoderConfig(EncoderConfig):
    """Encoder hyperparameters + pair-packing policy."""

    max_query_len: int = 20  # query tokens before the passage starts


# ---------------- params ----------------


def init_cross_params(gen: torch.Generator,
                      cfg: CrossEncoderConfig) -> Dict[str, Any]:
    params = init_params(gen, cfg)
    scale = cfg.d_model ** -0.5
    dev = gen.device
    params["seg_emb"] = torch.randn((2, cfg.d_model), generator=gen,
                                    device=dev) * scale
    params["w_score"] = torch.randn((cfg.d_model,), generator=gen,
                                    device=dev) * scale
    params["b_score"] = torch.zeros((), device=dev)
    return params


# ---------------- host featurization ----------------


def encode_pairs(queries: Sequence[str], passages: Sequence[str],
                 cfg: CrossEncoderConfig
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (ids [N, L] or [N, L, G], mask f32 [N, L], seg int32 [N, L]).

    The query occupies the first ``max_query_len`` positions, the passage
    the rest; segment ids 0/1 tell the model which is which (there is no
    [SEP] vocabulary entry — the segment embedding carries the boundary).
    """
    assert len(queries) == len(passages)
    L, Lq = cfg.max_len, cfg.max_query_len
    q_ids, q_mask = encode_tokens(list(queries), cfg)
    p_ids, p_mask = encode_tokens(list(passages), cfg)
    N = len(queries)
    ids = np.zeros_like(q_ids)
    mask = np.zeros((N, L), dtype=np.float32)
    seg = np.zeros((N, L), dtype=np.int32)
    ids[:, :Lq] = q_ids[:, :Lq]
    mask[:, :Lq] = q_mask[:, :Lq]
    Lp = L - Lq
    ids[:, Lq:] = p_ids[:, :Lp]
    mask[:, Lq:] = p_mask[:, :Lp]
    seg[:, Lq:] = 1
    return ids, mask, seg


# ---------------- forward ----------------


def apply_cross_encoder(params: Dict[str, Any], token_ids: torch.Tensor,
                        mask: torch.Tensor, seg: torch.Tensor,
                        cfg: CrossEncoderConfig) -> torch.Tensor:
    """(ids, mask, seg) [N, L] -> relevance logits [N] f32."""
    with stage("model/cross_encoder"):
        # seg_emb[seg] for the two segments, as a select: the same values,
        # and a backward pass that is two masked sums (the gather's backward
        # over a two-row table was not repeatable bit for bit on the card)
        seg_emb = params["seg_emb"]
        x = embed_tokens(params, token_ids) + torch.where(
            seg[..., None] != 0, seg_emb[1], seg_emb[0])
        x = run_blocks(params, x, mask, cfg)
        return masked_mean(x, mask) @ params["w_score"] + params["b_score"]


# ---------------- training ----------------


def listwise_loss(params, batch, cfg: CrossEncoderConfig):
    """Softmax CE over each query's M candidates (label = positive's
    slot) -> (loss, accuracy). batch: ids/mask/seg [B, M, ...], label
    int32 [B]."""
    B, M = batch["label"].shape[0], batch["ids"].shape[1]
    logits = apply_cross_encoder(
        params, batch["ids"].flatten(0, 1), batch["mask"].flatten(0, 1),
        batch["seg"].flatten(0, 1), cfg).reshape(B, M)
    label = batch["label"].long()
    loss = -torch.log_softmax(logits, dim=-1).gather(
        1, label[:, None]).mean()
    acc = (torch.argmax(logits, dim=-1) == label).float().mean()
    return loss, acc


def make_cross_train_step(cfg: CrossEncoderConfig,
                          learning_rate: float = 1e-3):
    """-> (init_state, train_step): one AdamW step on `listwise_loss`
    (`models.optim.make_step`: the trees are updated in place and
    returned; metrics ``loss`` and ``accuracy``)."""
    def loss_fn(params, batch):
        loss, acc = listwise_loss(params, batch, cfg)
        return loss, {"accuracy": acc}

    return make_step(loss_fn, learning_rate)


# ---------------- inference wrapper ----------------


class CrossEncoderReranker:
    """Scores (query, passage) pairs on ``device``; reranks candidate
    lists. ``pair_budget`` bounds one forward pass ([budget, L] rows); the
    tail chunk of a longer stream is padded to the budget, so every pass
    of the stream has one shape."""

    def __init__(self, cfg: Optional[CrossEncoderConfig] = None, params=None,
                 seed: int = 0, pair_budget: int = 4096, *, device="cuda"):
        self.cfg = cfg or CrossEncoderConfig()
        self.device = require_device(device)
        if params is None:
            params = init_cross_params(seeded_generator(seed, self.device),
                                       self.cfg)
        self.params = params
        self.pair_budget = int(pair_budget)

    @torch.no_grad()
    def score_pairs(self, queries: Sequence[str],
                    passages: Sequence[str]) -> np.ndarray:
        """-> relevance logits [N] f32 (higher = more relevant)."""
        N = len(queries)
        if N == 0:
            return np.zeros((0,), dtype=np.float32)
        ids, mask, seg = encode_pairs(queries, passages, self.cfg)
        step = self.pair_budget
        chunks = []
        for a in range(0, N, step):
            n = min(N, a + step) - a
            pad = step - n if (N > step and n < step) else 0
            args = []
            for arr in (ids, mask, seg):
                c = arr[a:a + n]
                if pad:
                    c = np.concatenate([c, np.zeros_like(arr[:pad])])
                args.append(to_device(c, self.device, non_blocking=True))
            chunks.append(apply_cross_encoder(self.params, *args,
                                              self.cfg)[:n])
        return torch.cat(chunks).cpu().numpy()

    def rerank(self, query: str, passages: Sequence[str],
               top_m: Optional[int] = None) -> List[int]:
        """-> candidate indices reordered by model relevance (desc,
        ties by original rank). ``top_m`` limits scoring to the first m
        candidates; the tail keeps its original order after them."""
        m = len(passages) if top_m is None else min(top_m, len(passages))
        if m == 0:
            return list(range(len(passages)))
        scores = self.score_pairs([query] * m, list(passages[:m]))
        head = sorted(range(m), key=lambda i: (-scores[i], i))
        return head + list(range(m, len(passages)))

    def rerank_batch(self, queries: Sequence[str],
                     cand_texts: Sequence[Sequence[str]],
                     ) -> List[List[int]]:
        """Batched rerank: B queries x per-query candidate lists scored
        as one flattened pair stream (chunked by pair_budget)."""
        flat_q: List[str] = []
        flat_p: List[str] = []
        offsets = [0]
        for q, cands in zip(queries, cand_texts):
            flat_q.extend([q] * len(cands))
            flat_p.extend(cands)
            offsets.append(len(flat_p))
        scores = self.score_pairs(flat_q, flat_p)
        orders = []
        for bi in range(len(queries)):
            s = scores[offsets[bi]:offsets[bi + 1]]
            orders.append(sorted(range(len(s)), key=lambda i: (-s[i], i)))
        return orders

    # ---- persistence (the encoder's checkpoint layout) ----

    def save(self, path: str) -> None:
        save_params(path, self.params)

    @classmethod
    def load(cls, path: str, cfg: Optional[CrossEncoderConfig] = None, *,
             device="cuda", **kw) -> "CrossEncoderReranker":
        cfg = cfg or CrossEncoderConfig()
        device = require_device(device)
        template = init_cross_params(seeded_generator(0, device), cfg)
        params = load_params(path, template, device=device,
                             hint="check CrossEncoderConfig")
        return cls(cfg, params=params, device=device, **kw)

    # ---- training batch helper ----

    @staticmethod
    def make_listwise_batch(queries: Sequence[str],
                            cand_lists: Sequence[Sequence[str]],
                            labels: Sequence[int],
                            cfg: CrossEncoderConfig) -> Dict[str, np.ndarray]:
        """ids/mask/seg [B, M, ...] + label [B]; every list must share M."""
        B = len(queries)
        M = len(cand_lists[0])
        assert all(len(c) == M for c in cand_lists)
        flat_q = [q for q, c in zip(queries, cand_lists) for _ in c]
        flat_p = [p for c in cand_lists for p in c]
        ids, mask, seg = encode_pairs(flat_q, flat_p, cfg)
        return {
            "ids": ids.reshape((B, M) + ids.shape[1:]),
            "mask": mask.reshape(B, M, -1),
            "seg": seg.reshape(B, M, -1),
            "label": np.asarray(labels, dtype=np.int32),
        }
