"""SPLADE-style learned sparse expansion head (port of
``a_modular_rag_framework_tpu/models/splade.py``).

The encoder's trunk (`models.encoder.encode_hidden`) followed by an
MLM-style expansion head tied to the token embedding, plus a learned
lexical prior:

    t      = LayerNorm(gelu(h @ W_t))                  # [B, L, D]
    logits = g_exp * (t @ tok_emb^T) + bias            # [B, L, V]
    logits[l, whole-word bucket of position l] += b0 * lex_w[bucket]
    w(v)   = max_l  mask_l * log1p(relu(logits))       # SPLADE-max pooling

The prior lands only on each position's whole-word bucket (slot 0 of the
subword features); the char n-gram buckets stay available to the learned
expansion through the tied decoder.

The [B, L, V] logits never exist at once: positions are folded into a
[B, V] running max in groups sized to a fixed budget of temporary bytes
(one group for small inputs, a few positions per group at B 4096 x V
8192). `sparsify_topk` orders by (weight descending, term id ascending),
``lax.top_k``'s order.

Training: `splade_loss` (in-batch InfoNCE over the top-k-truncated
expansions plus the two FLOPS regularizers) and `make_splade_train_step`
(one AdamW step, `models.optim`). The head is differentiated as it stands.
Its in-place steps are safe under autograd: the prior is added into, and
the relu applied to, a tile that no earlier operation saved, and the relu's
and the log1p's backward read the tile as it is afterwards. Under autograd
every group's [B, g, V] tiles are kept for the backward pass.

Subgradients at ties, against JAX. JAX folds positions one at a time with
``jnp.maximum`` (0.5 to each side at equality); here a group's positions
go through ``amax`` (an even split over all tied positions) and the groups
through ``torch.maximum`` (0.5 each); ``clamp(min=0)`` in `_topk_dense`
passes 1 at 0 where ``jnp.maximum(vals, 0)`` passes 0.5. The conventions
differ only at exact ties, and the ties that occur are exact zeros: a
padded position (its mask factor zeroes the gradient on both sides), a
relu output of 0 (the relu's own gradient is 0 there) and the running
max's zero start (not a parameter). Two positions whose positive weights
for one term are equal to the last bit would show the difference; none
has been seen, and the gradient tests include short texts and a fully
padded row.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._host import require_device, to_device
from ..ops.topk import stable_topk
from ..telemetry.stages import stage
from .encoder import (EncoderConfig, _dot, _in_batch_nce, _layer_norm,
                      encode_hidden, encode_tokens, gather_rows,
                      init_params, seeded_generator)
from .optim import make_step
from .params import load_params, save_params

# bytes of [B, positions, V] f32 temporaries one fold of the max-pool holds
_POOL_GROUP_BYTES = 256 << 20

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


@dataclass(frozen=True)
class SpladeConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    # budgets are in hash BUCKETS, not words: with subword_ngrams=8 each
    # word expands to ~8 buckets, so 32 query terms ~ 4 words
    doc_top_terms: int = 128    # expansion terms kept per document
    query_top_terms: int = 32   # expansion terms kept per query
    flops_lambda: float = 3e-4  # FLOPS regularizer weight (doc side)
    flops_lambda_q: float = 1e-4  # FLOPS regularizer weight (query side)

    @property
    def vocab_size(self) -> int:
        return self.encoder.vocab_size


# ---------------- params ----------------


def init_splade_params(gen: torch.Generator,
                       cfg: SpladeConfig) -> Dict[str, Any]:
    """Encoder trunk params + the expansion head (transform + tied decoder
    bias). The decoder weight IS ``tok_emb``."""
    params = init_params(gen, cfg.encoder)
    d, dev = cfg.encoder.d_model, gen.device
    params["splade_head"] = {
        "wt": torch.randn((d, d), generator=gen, device=dev) * (d ** -0.5),
        "ln": {"g": torch.ones(d, device=dev),
               "b": torch.zeros(d, device=dev)},
        "bias": torch.zeros(cfg.vocab_size, device=dev),
        # lexical-prior boost on each position's own whole-word bucket
        "b0": torch.tensor(2.0, device=dev),
        # expansion gate: scales the tied-decoder logits; starts small so
        # a fresh model's expansion is ~purely lexical
        "g_exp": torch.tensor(0.1, device=dev),
        # per-bucket lexical impact, multiplied into the b0 boost
        "lex_w": torch.ones(cfg.vocab_size, device=dev),
    }
    return params


def idf_lexical_prior(texts: List[str], cfg: SpladeConfig,
                      batch: int = 1024) -> np.ndarray:
    """Per-bucket idf over ``texts``' WHOLE-WORD buckets (the only slots
    the lexical prior scatters onto — module docstring), normalized to
    mean 1 over the observed buckets so b0 stays the scale knob. Unseen
    buckets get the maximum idf — novel entity tokens at held-out time
    score like the rarest training terms, not like noise.

    -> float32 [vocab_size], drop-in value for params["splade_head"]["lex_w"].
    """
    V = cfg.vocab_size
    df = np.zeros((V,), dtype=np.int64)
    n = 0
    for start in range(0, len(texts), batch):
        ids, mask = encode_tokens(list(texts[start:start + batch]),
                                  cfg.encoder)
        ids = np.asarray(ids)
        if ids.ndim == 3:
            ids = ids[:, :, 0]
        mask = np.asarray(mask)
        for row in range(ids.shape[0]):
            df[np.unique(ids[row][mask[row] > 0])] += 1
            n += 1
    idf = np.log1p(n / (1.0 + df)).astype(np.float32)
    seen = df > 0
    if seen.any():
        idf /= float(idf[seen].mean())
    return idf


# ---------------- forward ----------------


def splade_from_hidden(params: Dict[str, Any], h: torch.Tensor,
                       mask: torch.Tensor, cfg: SpladeConfig,
                       token_ids: torch.Tensor) -> torch.Tensor:
    """Expansion head over precomputed trunk hidden states [B, L, D], so a
    hybrid program runs the trunk once for the dense pooling head and this
    one. -> [B, V] f32 term weights (>= 0; all zero for a fully padded
    row).

    ``token_ids`` ([B, L] or [B, L, G]) carries each position's own hash
    buckets for the b0 lexical-prior add."""
    with stage("model/splade_head"):
        ecfg = cfg.encoder
        head = params["splade_head"]
        t = _dot(h, head["wt"], ecfg.dtype)
        t = _layer_norm(F.gelu(t, approximate="tanh"), head["ln"]["g"],
                        head["ln"]["b"])

        emb_t = params["tok_emb"].T  # [D, V] (tied decoder)
        # prior target = the whole-word bucket only (slot 0 in subword mode)
        word_ids = (token_ids if token_ids.dim() == 2
                    else token_ids[:, :, 0]).long()
        prior = head["b0"] * gather_rows(head["lex_w"], word_ids)  # [B, L]
        B, L, _ = h.shape
        V = cfg.vocab_size
        group = max(1, min(L, _POOL_GROUP_BYTES // max(B * V * 4, 1)))
        w = torch.zeros((B, V), dtype=torch.float32, device=h.device)
        for a in range(0, L, group):
            b = min(L, a + group)
            logits = head["g_exp"] * _dot(t[:, a:b], emb_t, ecfg.dtype) \
                + head["bias"]  # [B, g, V]
            # one index per row per position, so the add has no collisions
            logits.scatter_add_(2, word_ids[:, a:b, None], prior[:, a:b, None])
            part = torch.log1p(torch.relu_(logits)) * mask[:, a:b, None]
            w = torch.maximum(w, part.amax(dim=1))
        return w


def apply_splade(params: Dict[str, Any], token_ids: torch.Tensor,
                 mask: torch.Tensor, cfg: SpladeConfig) -> torch.Tensor:
    """token ids [B, L] (or [B, L, G]) -> sparse term weights [B, V] f32."""
    h = encode_hidden(params, token_ids, mask, cfg.encoder)
    return splade_from_hidden(params, h, mask, cfg, token_ids)


def sparsify_topk(w: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, V] dense expansion -> (term ids [B, k] int32 with -1 padding,
    weights [B, k] f32). Zero-weight slots pad to -1 so the posting
    machinery's valid-mask drops them. Equal weights keep ascending term
    ids (`stable_topk`), so the kept set at the cut is the same on every
    device."""
    with stage("model/sparsify_topk"):
        vals, ids = stable_topk(w, k, dim=1)
        keep = vals > 0
        ids = torch.where(keep, ids, torch.full_like(ids, -1)).to(torch.int32)
        return ids, torch.where(keep, vals, torch.zeros_like(vals))


# ---------------- training ----------------


def _topk_dense(w: torch.Tensor, k: int) -> torch.Tensor:
    """Zero every entry of [B, V] outside each row's top-k (the serving
    sparsification, kept dense for the in-batch score matmul). Gradients
    flow through the surviving entries only. The kept set at the cut is
    `stable_topk`'s: the lower term id first among equal weights, as
    ``lax.top_k`` keeps it."""
    vals, ids = stable_topk(w, k, dim=1)
    return torch.zeros_like(w).scatter(1, ids, vals.clamp(min=0.0))


def splade_loss(params, batch, cfg: SpladeConfig, temperature: float = 1.0):
    """In-batch InfoNCE over SPARSIFIED dot products + FLOPS regularizers
    -> (loss, {"accuracy", "nce", "doc_nnz"}).

    Raw dot products (temperature 1.0, the SPLADE convention). The InfoNCE
    scores use the same top-k truncation as serving (query_top_terms /
    doc_top_terms), so training optimizes the representation the index
    holds; the FLOPS terms (sum_t (mean_batch w_t)^2) see the untruncated
    expansions.

    batch: q_ids/q_mask/p_ids/p_mask as produced by
    `TextEncoder.make_pair_batch` (same host featurizer)."""
    wq = apply_splade(params, batch["q_ids"], batch["q_mask"], cfg)
    wp = apply_splade(params, batch["p_ids"], batch["p_mask"], cfg)
    wq_s = _topk_dense(wq, min(cfg.query_top_terms, cfg.vocab_size))
    wp_s = _topk_dense(wp, min(cfg.doc_top_terms, cfg.vocab_size))
    nce, acc = _in_batch_nce(torch.matmul(wq_s, wp_s.T) / temperature)
    flops_p = torch.sum(torch.mean(wp, dim=0) ** 2)
    flops_q = torch.sum(torch.mean(wq, dim=0) ** 2)
    loss = nce + cfg.flops_lambda * flops_p + cfg.flops_lambda_q * flops_q
    nnz = (wp > 0).float().sum(dim=-1).mean()
    return loss, {"accuracy": acc, "nce": nce, "doc_nnz": nnz}


def make_splade_train_step(cfg: SpladeConfig, learning_rate: float = 1e-3):
    """-> (init_state, train_step): one AdamW step on `splade_loss`
    (`models.optim.make_step`: the trees are updated in place and
    returned; metrics ``loss``, ``accuracy``, ``nce``, ``doc_nnz``)."""
    return make_step(lambda params, batch: splade_loss(params, batch, cfg),
                     learning_rate)


# ---------------- inference wrapper ----------------


class SpladeEncoder:
    """Host tokenize + device expand. `expand_texts` returns the sparse
    (ids, weights) pairs that feed the CSR posting scorer."""

    def __init__(self, cfg: Optional[SpladeConfig] = None, params=None,
                 seed: int = 0, *, device="cuda"):
        self.cfg = cfg or SpladeConfig()
        self.device = require_device(device)
        if params is None:
            params = init_splade_params(seeded_generator(seed, self.device),
                                        self.cfg)
        self.params = params

    def host_featurize(self, texts: List[str]):
        return encode_tokens(list(texts), self.cfg.encoder)

    def _upload(self, texts: List[str]):
        ids, mask = self.host_featurize(texts)
        return (to_device(ids, self.device, non_blocking=True),
                to_device(mask, self.device, non_blocking=True))

    @torch.no_grad()
    def expand_texts(self, texts: List[str], k: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (term ids [B, k] int32, weights [B, k] f32), -1-padded."""
        k = k or self.cfg.query_top_terms
        if not texts:
            return (np.zeros((0, k), np.int32), np.zeros((0, k), np.float32))
        t_ids, t_w = sparsify_topk(
            apply_splade(self.params, *self._upload(texts), self.cfg), k)
        return t_ids.cpu().numpy(), t_w.cpu().numpy()

    @torch.no_grad()
    def dense_expand(self, texts: List[str]) -> np.ndarray:
        """[B, V] dense expansion weights (tests / evaluation)."""
        return apply_splade(self.params, *self._upload(texts),
                            self.cfg).cpu().numpy()

    def save(self, path: str) -> None:
        """The checkpoint carries its own architecture (``__config__``, a
        uint8 JSON document), as the JAX package's does."""
        doc = dataclasses.asdict(self.cfg)
        for key in ("dtype", "attn_dtype"):
            value = doc["encoder"][key]
            if value is not None:
                doc["encoder"][key] = str(value).rsplit(".", 1)[1]
        save_params(path, self.params, extra={"__config__": np.frombuffer(
            json.dumps(doc).encode("utf-8"), dtype=np.uint8)})

    @classmethod
    def load(cls, path: str, cfg: Optional[SpladeConfig] = None, *,
             device="cuda") -> "SpladeEncoder":
        device = require_device(device)
        if cfg is None:
            with np.load(path) as data:
                if "__config__" in data:
                    doc = json.loads(bytes(data["__config__"]).decode("utf-8"))
                    enc_doc = dict(doc.pop("encoder"))
                    enc_doc["dtype"] = _DTYPES[enc_doc.get("dtype",
                                                           "bfloat16")]
                    if enc_doc.get("attn_dtype") is not None:
                        enc_doc["attn_dtype"] = _DTYPES[enc_doc["attn_dtype"]]
                    cfg = SpladeConfig(encoder=EncoderConfig(**enc_doc), **doc)
        cfg = cfg or SpladeConfig()
        template = init_splade_params(seeded_generator(0, device), cfg)
        params = load_params(
            path, template, device=device,
            hint="check SpladeConfig matches the checkpoint")
        return cls(cfg, params=params, device=device)
