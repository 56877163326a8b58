"""TextEncoder — the learned sentence-embedding model (port of
``a_modular_rag_framework_tpu/models/encoder.py``).

A compact pre-norm transformer over hashed word / subword buckets: the
mean of a word's feature embeddings plus a position embedding, ``n_layers``
blocks of masked softmax attention and a tanh-GELU MLP, a final LayerNorm,
a masked mean-pool and L2 normalization. The host tokenizer (crc32
buckets, no vocabulary file) is a copy of the original's; the parameters
are the JAX tree with torch leaves (`models.params`), so the committed
``data/encoder*.npz`` checkpoints load unchanged.

Arithmetic, as in the original: every dense layer rounds its two operands
to ``cfg.dtype`` (bfloat16 by default) and accumulates in float32 with a
float32 result (`_dot`); attention products and the softmax are float32
unless ``cfg.attn_dtype`` says otherwise; masked keys are filled with
``finfo(float32).min``, not -inf, so a fully padded row gives a uniform
softmax and a zero pooled vector, never NaN. With ``dtype=torch.float32``
the whole path is plain float32.

Training: `info_nce_loss` (in-batch contrastive), `make_train_step` (one
AdamW step, `models.optim`) and `infonce_scan_trainer` (``chunk`` steps
over a pair set that lives on the device, no host fetch in between).
Gradients come from autograd; the card's form of a dense layer carries
its own backward (`_MatmulF32`), which rounds each operand's cotangent to
the operand's dtype as JAX's transpose rule of ``dot_general`` does and as
autograd does for the CPU's form. `param_partition_specs` is the original's
tensor-parallel layout; `shard_train_step` runs the step over a (data,
model) mesh (`parallel.train`).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._host import require_device, to_device
from ..native import binding as _native
from ..telemetry.stages import stage
from .hash_embed import tokenize
from .optim import make_step
from .params import load_params, save_params


@dataclass(frozen=True)
class EncoderConfig:
    """The JAX ``EncoderConfig``'s fields and defaults; the dtypes are
    torch dtypes."""

    vocab_size: int = 8192
    max_len: int = 64
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    dtype: Any = torch.bfloat16  # compute dtype; params stay f32
    # subword features per word position: the word plus char n-grams of
    # its <word>-wrapped form, each hashed into the same vocab; a word's
    # input vector is the mean of its feature embeddings. 1 = whole word
    subword_ngrams: int = 1
    ngram_min: int = 3
    ngram_max: int = 5
    # dtype of the attention products (QK^T and attn @ V); None = float32
    attn_dtype: Any = None


# ---------------- tokenizer (host) ----------------


def _word_feature_ids(tok: str, cfg: EncoderConfig) -> List[int]:
    """Hash buckets for one word: the word plus its char n-grams (wrapped
    in boundary markers), capped at cfg.subword_ngrams features."""
    feats = [zlib.crc32(tok.encode()) % cfg.vocab_size]
    G = cfg.subword_ngrams
    if G > 1:
        wrapped = f"<{tok}>"
        for n in range(cfg.ngram_min, cfg.ngram_max + 1):
            for a in range(len(wrapped) - n + 1):
                if len(feats) >= G:
                    return feats
                feats.append(zlib.crc32(wrapped[a:a + n].encode())
                             % cfg.vocab_size)
    return feats


def encode_tokens(texts: List[str], cfg: EncoderConfig
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (token_ids int32 [B, L] or [B, L, G] when subword_ngrams > 1,
    mask f32 [B, L]); bucket = crc32 % vocab. With subwords, a word's
    trailing feature slots repeat its features cyclically.

    Batches of 64 texts or more take the native C path when its library
    builds (the same arrays, bit for bit); the Python loop otherwise."""
    if len(texts) >= 64:
        out = _native.encoder_tokens_native(
            texts, cfg.max_len, cfg.vocab_size, cfg.subword_ngrams,
            cfg.ngram_min, cfg.ngram_max)
        if out is not None:
            return out
    B, L, G = len(texts), cfg.max_len, cfg.subword_ngrams
    mask = np.zeros((B, L), dtype=np.float32)
    if G <= 1:
        ids = np.zeros((B, L), dtype=np.int32)
        for i, t in enumerate(texts):
            for j, tok in enumerate(tokenize(t)[:L]):
                ids[i, j] = zlib.crc32(tok.encode()) % cfg.vocab_size
                mask[i, j] = 1.0
        return ids, mask
    ids = np.zeros((B, L, G), dtype=np.int32)
    for i, t in enumerate(texts):
        for j, tok in enumerate(tokenize(t)[:L]):
            feats = _word_feature_ids(tok, cfg)
            ids[i, j, :] = (feats * ((G // len(feats)) + 1))[:G]
            mask[i, j] = 1.0
    return ids, mask


# ---------------- params ----------------


def init_params(gen: torch.Generator, cfg: EncoderConfig) -> Dict[str, Any]:
    """A fresh parameter tree (the JAX tree's keys, shapes and scales) on
    ``gen``'s device. The values come from ``gen``, not from JAX's PRNG."""
    dev = gen.device

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def ln():
        return {"g": torch.ones(cfg.d_model, device=dev),
                "b": torch.zeros(cfg.d_model, device=dev)}

    d, f = cfg.d_model, cfg.d_ff
    scale = d ** -0.5
    return {
        "tok_emb": normal((cfg.vocab_size, d), scale),
        "pos_emb": normal((cfg.max_len, d), scale),
        "layers": [{
            "ln1": ln(),
            "wqkv": normal((d, 3 * d), scale),
            "wo": normal((d, d), scale),
            "ln2": ln(),
            "w1": normal((d, f), scale),
            "w2": normal((f, d), f ** -0.5),
        } for _ in range(cfg.n_layers)],
        "out_ln": ln(),
    }


def param_partition_specs(cfg: EncoderConfig) -> Dict[str, Any]:
    """Tensor-parallel layout, the parameter tree with a
    `parallel.mesh.PartitionSpec` per leaf (JAX's axes leaf for leaf):
    attention and MLP products split over ``model`` (``wqkv`` and ``w1``
    by columns, ``wo`` and ``w2`` by rows), embeddings over the feature
    dim, norms replicated."""
    from ..parallel.mesh import PartitionSpec as P

    def ln():
        return {"g": P(), "b": P()}

    return {
        "tok_emb": P(None, "model"),
        "pos_emb": P(None, "model"),
        "layers": [{"ln1": ln(), "wqkv": P(None, "model"),
                    "wo": P("model", None), "ln2": ln(),
                    "w1": P(None, "model"), "w2": P("model", None)}
                   for _ in range(cfg.n_layers)],
        "out_ln": ln(),
    }


def seeded_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


# ---------------- forward ----------------


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two reduced-precision tensors (2-D, or 3-D batched)
    with a float32 accumulator and result, on the tensor cores.

    ``torch.mm / bmm(..., out_dtype=float32)`` is the forward; that form
    has no autograd formula (torch 2.11), so the backward is written out:
    the products ``g @ b^T`` and ``a^T @ g`` of the
    float32 cotangent with the widened operand, in full float32, each
    rounded to its operand's dtype. That is where JAX rounds (the
    transpose rule of ``dot_general`` casts a cotangent to the operand's
    dtype) and where autograd rounds for the CPU's form (the backward of
    ``.float()`` on a bfloat16 tensor), so the card's gradients differ
    from theirs in summation order only."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def _dot(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``dtype`` and a float32
    accumulator and result (JAX's ``preferred_element_type=float32``);
    ``w`` is [in, out] or batched like ``x``. On a CUDA device the rounded
    operands go to the tensor cores as they are (`_MatmulF32`); on the CPU
    they are widened back and multiplied in float32. The products of two
    bfloat16 values are exact in float32 either way, so the two forms
    differ only in summation order, forward and backward."""
    if dtype == torch.float32:
        return torch.matmul(x, w)
    xr, wr = x.to(dtype), w.to(dtype)
    if x.device.type != "cuda":
        return torch.matmul(xr.float(), wr.float())
    if wr.dim() == 2:
        out = _MatmulF32.apply(xr.reshape(-1, xr.shape[-1]), wr)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    out = _MatmulF32.apply(xr.reshape(-1, *xr.shape[-2:]),
                           wr.reshape(-1, *wr.shape[-2:]))
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim: biased variance, eps inside the root."""
    return F.layer_norm(x, x.shape[-1:], g, b, eps)


def _attention(x, wqkv, wo, mask, n_heads: int, dtype, attn_dtype=None):
    return _dot(attend(_dot(x, wqkv, dtype), mask, n_heads, attn_dtype), wo,
                dtype)


def attend(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int,
           attn_dtype=None) -> torch.Tensor:
    """Masked multi-head softmax attention from the fused projection
    ``qkv`` [B, L, 3D] (q, k, v in that order) -> [B, L, D], before the
    output projection."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    ad = attn_dtype if attn_dtype is not None else torch.float32
    q, k, v = torch.split(qkv, D, dim=-1)
    dh = D // n_heads

    def heads(t):
        return t.reshape(B, L, n_heads, dh).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    # the scale is applied to the f32 product, as in the original
    logits = _dot(q, k.transpose(-1, -2), ad) / (dh ** 0.5)
    neg = torch.finfo(torch.float32).min
    logits = torch.where(mask[:, None, None, :] > 0, logits,
                         torch.full_like(logits, neg))
    attn = torch.softmax(logits, dim=-1)
    return _dot(attn, v, ad).transpose(1, 2).reshape(B, L, D)


def _block(x, layer, mask, cfg: EncoderConfig):
    """One pre-norm block: attention, then the tanh-GELU MLP."""
    h = _layer_norm(x, layer["ln1"]["g"], layer["ln1"]["b"])
    x = x + _attention(h, layer["wqkv"], layer["wo"], mask, cfg.n_heads,
                       cfg.dtype, cfg.attn_dtype)
    h = _layer_norm(x, layer["ln2"]["g"], layer["ln2"]["b"])
    h = F.gelu(_dot(h, layer["w1"], cfg.dtype), approximate="tanh")
    return x + _dot(h, layer["w2"], cfg.dtype)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for an integer id tensor of any shape (``table`` [V, d]
    or [V]), through ``F.embedding``: the same values as advanced indexing,
    but a backward pass that adds the repeated rows of a batch in a fixed
    order. The backward of ``table[ids]`` is ``index_put_(accumulate=True)``,
    which on the CPU adds from several threads at once, so two runs of one
    step would differ in the last bits."""
    if table.dim() == 1:
        return F.embedding(ids, table[:, None])[..., 0]
    return F.embedding(ids, table)


def embed_tokens(params, token_ids: torch.Tensor) -> torch.Tensor:
    """Token ids [B, L] (or [B, L, G]: the mean over a word's G subword
    features) -> [B, L, d] input vectors plus the position embedding."""
    x = gather_rows(params["tok_emb"], token_ids)
    if token_ids.dim() == 3:
        x = x.mean(dim=2)
    return x + params["pos_emb"][None, : token_ids.shape[1], :]


def run_blocks(params, x: torch.Tensor, mask: torch.Tensor,
               cfg: EncoderConfig) -> torch.Tensor:
    """The transformer blocks and the final LayerNorm over [B, L, d]."""
    x = x.float()
    for layer in params["layers"]:
        x = _block(x, layer, mask, cfg)
    return _layer_norm(x, params["out_ln"]["g"], params["out_ln"]["b"])


def encode_hidden(params: Dict[str, Any], token_ids: torch.Tensor,
                  mask: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """Transformer trunk: token ids [B, L] (or [B, L, G] subword features)
    -> per-token hidden states [B, L, d_model] f32 (after the final
    LayerNorm). Shared by the sentence encoder and the SPLADE head. A named
    profiler range (``model/trunk``), as the heads are."""
    with stage("model/trunk"):
        return run_blocks(params, embed_tokens(params, token_ids), mask, cfg)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L, d] hidden states -> [B, d] mean over the unmasked positions
    (zero for a fully padded row)."""
    m = mask[:, :, None]
    return torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                 min=1e-6)


def pool_normalize(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean-pool, then L2 normalization with a 1e-9 floor."""
    pooled = masked_mean(x, mask)
    norms = torch.sqrt(torch.sum(pooled * pooled, dim=-1, keepdim=True))
    return pooled / torch.clamp(norms, min=1e-9)


def apply_encoder(params: Dict[str, Any], token_ids: torch.Tensor,
                  mask: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """token ids [B, L] (or [B, L, G]) -> L2-normalized embeddings
    [B, d_model] f32."""
    return pool_normalize(encode_hidden(params, token_ids, mask, cfg), mask)


# ---------------- training ----------------


def _in_batch_nce(logits: torch.Tensor):
    """(mean cross-entropy with the diagonal as labels, top-1 accuracy) of
    in-batch scores [B, B]."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = -torch.log_softmax(logits, dim=-1).diagonal().mean()
    acc = (torch.argmax(logits, dim=-1) == labels).float().mean()
    return loss, acc


def info_nce_loss(params, batch, cfg: EncoderConfig,
                  temperature: float = 0.05):
    """In-batch contrastive loss over (query, positive-passage) pairs ->
    (loss, accuracy). ``batch``: q_ids / q_mask / p_ids / p_mask tensors
    (`TextEncoder.make_pair_batch`, uploaded)."""
    q = apply_encoder(params, batch["q_ids"], batch["q_mask"], cfg)
    p = apply_encoder(params, batch["p_ids"], batch["p_mask"], cfg)
    return _in_batch_nce(torch.matmul(q, p.T) / temperature)


def make_train_step(cfg: EncoderConfig, learning_rate: float = 1e-3):
    """-> (init_state, train_step): one AdamW step on `info_nce_loss`
    (`models.optim.make_step`: the trees are updated in place and
    returned; metrics ``loss`` and ``accuracy``)."""
    def loss_fn(params, batch):
        loss, acc = info_nce_loss(params, batch, cfg)
        return loss, {"accuracy": acc}

    return make_step(loss_fn, learning_rate)


def shard_train_step(cfg: EncoderConfig, mesh, learning_rate: float = 1e-3):
    """The train step over a (data, model) ``parallel.mesh.DeviceMesh`` ->
    ``(place_params, place_batch, init_state, step)``; see
    `parallel.train.shard_train_step`."""
    from ..parallel.train import shard_train_step as sharded

    return sharded(cfg, mesh, learning_rate)


def sample_batch_indices(n: int, batch: int, gen: torch.Generator
                         ) -> torch.Tensor:
    """``batch`` uniform row indices in [0, n), with replacement, drawn
    from ``gen`` on its device."""
    return torch.randint(0, n, (batch,), generator=gen, device=gen.device)


def infonce_scan_trainer(cfg: EncoderConfig, *, batch: int, chunk: int,
                         learning_rate: float = 1e-3,
                         temperature: float = 0.05):
    """Chunked device-resident training -> (init_state, run_chunk).

    ``run_chunk(params, opt_state, data, gen)`` runs ``chunk`` InfoNCE
    steps; ``data`` holds the WHOLE featurized pair set as tensors on the
    parameters' device {q_ids, q_mask, p_ids, p_mask}, and every step
    gathers its batch there from ``batch`` indices drawn by ``gen`` (a
    ``torch.Generator`` on that device, in the place of JAX's key;
    `sample_batch_indices`). The loop makes no host fetch: the steps are
    queued one after another and the last step's metrics come back as
    0-dim tensors. The trees are updated in place and returned.

    In-batch sampling uses independent uniform indices; duplicate rows in
    a batch add ~batch²/2n label-noise pairs (two copies of the same
    positive compete in the softmax), negligible at the pair-set sizes
    this trains on."""
    def loss_fn(params, b):
        loss, acc = info_nce_loss(params, b, cfg, temperature)
        return loss, {"accuracy": acc}

    init_state, train_step = make_step(loss_fn, learning_rate)

    def run_chunk(params, opt_state, data, gen: torch.Generator):
        n = data["q_ids"].shape[0]
        metrics = {}
        for _ in range(chunk):
            idx = sample_batch_indices(n, batch, gen)
            b = {name: v[idx] for name, v in data.items()}
            params, opt_state, metrics = train_step(params, opt_state, b)
        return params, opt_state, metrics

    return init_state, run_chunk


# ---------------- inference wrapper ----------------


class TextEncoder:
    """Drop-in encoder object: tokenizes on the host, embeds on ``device``
    (the card unless the caller passes ``"cpu"``)."""

    # rows per forward pass of encode_texts (bounds the activations)
    encode_batch = 4096

    def __init__(self, cfg: Optional[EncoderConfig] = None, params=None,
                 seed: int = 0, *, device="cuda"):
        self.cfg = cfg or EncoderConfig()
        self.device = require_device(device)
        if params is None:
            params = init_params(seeded_generator(seed, self.device),
                                 self.cfg)
        self.params = params

    @property
    def dim(self) -> int:
        return self.cfg.d_model

    def host_featurize(self, texts: List[str]):
        return encode_tokens(list(texts), self.cfg)

    @torch.no_grad()
    def device_embed(self, ids: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        """Featurized batch (tensors on this encoder's device) ->
        embeddings [B, d] on the device; the engine's in-program seam."""
        return apply_encoder(self.params, ids, mask, self.cfg)

    def encode_texts(self, texts: List[str]) -> np.ndarray:
        """[B, d] f32 numpy, ``encode_batch`` rows per forward pass."""
        texts = list(texts)
        if not texts:
            return np.zeros((0, self.cfg.d_model), dtype=np.float32)
        out = []
        for i in range(0, len(texts), self.encode_batch):
            ids, mask = self.host_featurize(texts[i:i + self.encode_batch])
            out.append(self.device_embed(to_device(ids, self.device),
                                         to_device(mask, self.device)).cpu())
        return torch.cat(out).numpy()

    def save(self, path: str) -> None:
        save_params(path, self.params)

    @classmethod
    def load(cls, path: str, cfg: Optional[EncoderConfig] = None, *,
             device="cuda") -> "TextEncoder":
        """Restore weights saved by either package's ``save``."""
        cfg = cfg or EncoderConfig()
        device = require_device(device)
        template = init_params(seeded_generator(0, device), cfg)
        params = load_params(path, template, device=device,
                             hint="check EncoderConfig matches the checkpoint")
        return cls(cfg, params=params, device=device)

    # training-pair helper for the contrastive recipe
    @staticmethod
    def make_pair_batch(queries: List[str], passages: List[str],
                        cfg: EncoderConfig) -> Dict[str, np.ndarray]:
        q_ids, q_mask = encode_tokens(queries, cfg)
        p_ids, p_mask = encode_tokens(passages, cfg)
        return {"q_ids": q_ids, "q_mask": q_mask,
                "p_ids": p_ids, "p_mask": p_mask}
