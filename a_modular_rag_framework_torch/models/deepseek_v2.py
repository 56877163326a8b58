"""DeepSeek-V2-Lite as the trunk of a dense text embedder.

The architecture is DeepSeek-V2's (arXiv:2405.04434; the published
``modeling_deepseek.py`` and ``config.json`` of deepseek-ai/DeepSeek-V2-Lite),
used as an LLM embedder the way E5-Mistral is (arXiv:2401.00368): causal
attention, an EOS token appended to every text, the final hidden state of
that last token L2-normalized, and queries (never rows) prefixed with a
task instruction.

Per layer, pre-norm residual blocks with RMSNorm (eps 1e-6):

- multi-head latent attention (MLA) with no query LoRA: ``q_proj``
  H -> heads x (nope + rope); ``kv_a_proj_with_mqa`` H -> kv_lora_rank +
  rope, an RMSNorm on the latent, ``kv_b_proj`` kv_lora_rank -> heads x
  (nope + v); the rope part of the key is shared by the heads. YaRN RoPE
  on the rope dims, which are de-interleaved before ``rotate_half`` as in
  the published code; softmax scale (nope + rope)^-0.5 x mscale^2.
- the first ``first_k_dense_replace`` layers: a SwiGLU MLP of
  ``intermediate_size``; the others: a mixture of experts
  (``ops/moe.py``): softmax router over ``n_routed_experts``, greedy
  top-``num_experts_per_tok``, weights not renormalized, times
  ``routed_scaling_factor``; routed SwiGLU experts of
  ``moe_intermediate_size`` and ``n_shared_experts`` shared ones run as
  one SwiGLU of n_shared x moe_intermediate_size.
- a final RMSNorm.

Precision: every product takes bfloat16 operands with float32 sums (the
projections, both attention products, the experts); the residual stream,
the RMSNorms, the RoPE tables, both softmaxes and the router run in
float32. Weights are stored in bfloat16, norms and the router in float32.

Tokens: the real BPE vocabulary is not in the repository, so a stand-in
maps each word or punctuation mark (``\\w+|[^\\w\\s]``) to an id by crc32
into the ordinary ids below DeepSeek's special tokens, plus the EOS id.
Queries are padded to ``query_len`` and rows to ``row_len``; a longer text
raises (nothing is truncated). Attention masks the padding keys, and the
padding positions never reach the routed experts.

The encoder seam is `TextEncoder`'s: ``dim``, ``host_featurize`` (the
queries, with the instruction), ``device_embed`` and ``encode_texts``
(rows, without it). Ranges: ``model/trunk`` around a forward, inside it
``model/mla`` per layer's attention and ``model/moe`` per MoE layer (with
``ops/moe.py``'s ``model/moe/route``, ``/experts`` and ``/shared``).
"""
from __future__ import annotations

import math
import re
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._host import require_device, to_device
from ..ops.moe import matmul_t, moe_layer, swiglu
from ..telemetry.stages import stage

_WORD = re.compile(r"\w+|[^\w\s]")


@dataclass(frozen=True)
class DeepseekV2Config:
    """The trunk's widths (the published config's names) and the
    embedder's settings."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    num_attention_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position_embeddings: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    # the stand-in tokenizer: ids crc32 mod `word_ids`, then EOS
    word_ids: int = 100000
    eos_token_id: int = 100001
    query_len: int = 48
    row_len: int = 48
    query_instruction: str = ""

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# ---------------- tokens ----------------


def token_ids(text: str, cfg: DeepseekV2Config) -> List[int]:
    """The stand-in tokenizer: one id per word or punctuation mark, then
    EOS."""
    return [zlib.crc32(w.encode("utf-8")) % cfg.word_ids
            for w in _WORD.findall(text)] + [cfg.eos_token_id]


def featurize(texts: Sequence[str], length: int, cfg: DeepseekV2Config
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids int64 [B, length], lengths int64 [B]), padded with id 0;
    raises where a text needs more than ``length`` tokens."""
    rows = [token_ids(t, cfg) for t in texts]
    lens = np.array([len(r) for r in rows], dtype=np.int64)
    if len(rows) and lens.max() > length:
        raise ValueError(f"a text of {int(lens.max())} tokens does not fit "
                         f"the padded length {length}")
    ids = np.zeros((len(rows), length), dtype=np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return ids, lens


# ---------------- weights ----------------


def param_shapes(cfg: DeepseekV2Config) -> List[Tuple[str, tuple, float]]:
    """(path, shape, scale) of every drawn leaf, in drawing order; a
    matrix [out, in] is scaled by in^-0.5, the embedding by 1."""
    H, nh = cfg.hidden_size, cfg.num_attention_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    E, Fm = cfg.n_routed_experts, cfg.moe_intermediate_size
    Fs = cfg.n_shared_experts * Fm
    out = [("embed", (cfg.vocab_size, H), 1.0)]
    for i in range(cfg.num_hidden_layers):
        a = f"layers.{i}.attn."
        out += [(a + "q_proj", (nh * cfg.q_head_dim, H), H ** -0.5),
                (a + "kv_a_proj_with_mqa", (r + dr, H), H ** -0.5),
                (a + "kv_b_proj", (nh * (cfg.qk_nope_head_dim
                                         + cfg.v_head_dim), r), r ** -0.5),
                (a + "o_proj", (H, nh * cfg.v_head_dim),
                 (nh * cfg.v_head_dim) ** -0.5)]
        if i < cfg.first_k_dense_replace:
            m, Fd = f"layers.{i}.mlp.", cfg.intermediate_size
            out += [(m + "w_gate", (Fd, H), H ** -0.5),
                    (m + "w_up", (Fd, H), H ** -0.5),
                    (m + "w_down", (H, Fd), Fd ** -0.5)]
        else:
            m = f"layers.{i}."
            out += [(m + "router", (cfg.n_routed_experts, H), H ** -0.5),
                    (m + "experts.w_gate", (E, Fm, H), H ** -0.5),
                    (m + "experts.w_up", (E, Fm, H), H ** -0.5),
                    (m + "experts.w_down", (E, H, Fm), Fm ** -0.5),
                    (m + "shared.w_gate", (Fs, H), H ** -0.5),
                    (m + "shared.w_up", (Fs, H), H ** -0.5),
                    (m + "shared.w_down", (H, Fs), Fs ** -0.5)]
    return out


def init_params(cfg: DeepseekV2Config, seed: int, device) -> Dict[str, Any]:
    """The weight tree drawn from ``seed`` on ``device``: each leaf of
    `param_shapes` in order, normal times its scale, stored in bfloat16
    (the router in float32); the RMSNorm weights at ones."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: Dict[str, Any] = {"layers": [{} for _ in
                                       range(cfg.num_hidden_layers)]}
    for path, shape, scale in param_shapes(cfg):
        leaf = torch.randn(shape, generator=gen, device=device).mul_(scale)
        leaf = leaf if path.endswith("router") else leaf.to(torch.bfloat16)
        keys = path.split(".")
        node = tree if keys[0] != "layers" else tree["layers"][int(keys[1])]
        for k in (keys[2:-1] if keys[0] == "layers" else keys[:-1]):
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    H, r = cfg.hidden_size, cfg.kv_lora_rank
    for lay in tree["layers"]:
        lay["input_norm"] = torch.ones(H, device=device)
        lay["post_norm"] = torch.ones(H, device=device)
        lay["attn"]["kv_a_norm"] = torch.ones(r, device=device)
    tree["norm"] = torch.ones(H, device=device)
    return tree


# ---------------- the trunk ----------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 RMSNorm over the last dim."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """(nope + rope)^-0.5 x mscale(factor, mscale_all_dim)^2."""
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return cfg.q_head_dim ** -0.5 * m * m


def yarn_tables(length: int, cfg: DeepseekV2Config
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 [length, rope dims] of YaRN RoPE, computed on the
    host in float32 as the published ``DeepseekV2YarnRotaryEmbedding``."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    factor = cfg.rope_factor
    orig = cfg.rope_original_max_position_embeddings

    def correction_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (
            2 * math.log(base))

    low = max(math.floor(correction_dim(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.rope_beta_slow)), dim - 1)
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (factor * base ** exps)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    inv_freq = freq_inter * (1 - keep) + freq_extra * keep
    t = torch.arange(length, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = (yarn_mscale(factor, cfg.rope_mscale)
         / yarn_mscale(factor, cfg.rope_mscale_all_dim))
    return emb.cos() * m, emb.sin() * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, heads, d]: de-interleave the last dim (even positions,
    then odd), then x cos + rotate_half(x) sin, with cos / sin [L, d]."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    half = torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)
    return x * cos[:, None, :] + half * sin[:, None, :]


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] on bfloat16 operands with float32
    sums and result."""
    lead = a.shape[:-2]
    a3 = a.reshape(-1, *a.shape[-2:]).to(torch.bfloat16)
    b3 = b.reshape(-1, *b.shape[-2:]).to(torch.bfloat16)
    if a3.device.type == "cuda":
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
    else:
        out = torch.bmm(a3.float(), b3.float())
    return out.reshape(*lead, *out.shape[-2:])


def mla(h: torch.Tensor, p: Dict[str, torch.Tensor], allowed: torch.Tensor,
        cos: torch.Tensor, sin: torch.Tensor,
        cfg: DeepseekV2Config) -> torch.Tensor:
    """Multi-head latent attention over h [B, L, H] (normed), ``allowed``
    [B, L, L] bool (causal and not padding), -> [B, L, H] f32."""
    B, L, _ = h.shape
    nh, dn, dr = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                  cfg.qk_rope_head_dim)
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    q = matmul_t(h, p["q_proj"]).view(B, L, nh, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c_kv, k_pe = matmul_t(h, p["kv_a_proj_with_mqa"]).split([r, dr], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_a_norm"], cfg.rms_norm_eps)
    kv = matmul_t(c_kv, p["kv_b_proj"]).view(B, L, nh, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)
    q = torch.cat((q_nope, q_pe), dim=-1).to(torch.bfloat16).transpose(1, 2)
    k = torch.cat((k_nope, k_pe.expand(B, L, nh, dr)), dim=-1).to(
        torch.bfloat16).transpose(1, 2)
    logits = bmm_f32(q, k.transpose(-1, -2)) * softmax_scale(cfg)
    logits = logits.masked_fill_(~allowed[:, None],
                                 torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    o = bmm_f32(probs, v.to(torch.bfloat16).transpose(1, 2))
    o = o.transpose(1, 2).reshape(B, L, nh * dv)
    return matmul_t(o, p["o_proj"])


def forward(params: Dict[str, Any], ids: torch.Tensor, lengths: torch.Tensor,
            cfg: DeepseekV2Config, rope=None,
            routes: Optional[list] = None) -> torch.Tensor:
    """ids [B, L] int64, lengths [B] (each text's tokens, EOS last) ->
    the last token's final hidden state, L2-normalized, [B, H] f32.
    ``rope``: `yarn_tables` of length L on the device (made when None).
    ``routes``, when a list, receives each MoE layer's routing (the
    experts chosen [real tokens, top_k], real tokens in row-major order)."""
    B, L = ids.shape
    H = cfg.hidden_size
    with stage("model/trunk"):
        dev = ids.device
        cos, sin = rope if rope is not None else (
            t.to(dev) for t in yarn_tables(L, cfg))
        pos = torch.arange(L, device=dev)
        valid = pos[None, :] < lengths[:, None]
        allowed = (pos[None, :, None] >= pos[None, None, :]) & valid[:, None]
        real = valid.reshape(-1).nonzero().squeeze(1)
        x = params["embed"][ids].float()
        for i, lay in enumerate(params["layers"]):
            h = rms_norm(x, lay["input_norm"], cfg.rms_norm_eps)
            with stage("model/mla"):
                x = x + mla(h, lay["attn"], allowed, cos, sin, cfg)
            h = rms_norm(x, lay["post_norm"], cfg.rms_norm_eps)
            if "mlp" in lay:
                x = x + swiglu(h, lay["mlp"])
                continue
            with stage("model/moe"):
                out = moe_layer(
                    h.view(B * L, H), lay["router"], lay["experts"],
                    lay["shared"], cfg.num_experts_per_tok, real=real,
                    scaling=cfg.routed_scaling_factor,
                    counter=f"model/moe/layer{i}", routes=routes)
                x = x + out.view(B, L, H)
        last = x[torch.arange(B, device=dev), lengths - 1]
        last = rms_norm(last, params["norm"], cfg.rms_norm_eps)
        n = torch.sqrt((last * last).sum(-1, keepdim=True))
        return last / n.clamp(min=1e-9)


class DeepseekV2Encoder:
    """The encoder seam over the trunk: queries (with the instruction)
    through ``host_featurize`` + ``device_embed``, rows through
    ``encode_texts``, on ``device``."""

    # rows per forward pass of encode_texts (bounds the activations)
    encode_batch = 4096

    def __init__(self, cfg: DeepseekV2Config, params: Dict[str, Any], *,
                 device="cuda"):
        self.cfg = cfg
        self.device = require_device(device)
        self.params = params
        self._rope: Dict[int, tuple] = {}

    @property
    def dim(self) -> int:
        return self.cfg.hidden_size

    def _tables(self, length: int):
        if length not in self._rope:
            self._rope[length] = tuple(
                t.to(self.device) for t in yarn_tables(length, self.cfg))
        return self._rope[length]

    def host_featurize(self, texts: List[str]):
        """Queries: the instruction, the text and EOS, padded to
        ``query_len``."""
        instr = self.cfg.query_instruction
        return featurize([instr + t for t in texts], self.cfg.query_len,
                         self.cfg)

    @torch.no_grad()
    def device_embed(self, ids: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
        """Featurized batch (tensors on this encoder's device) -> unit
        embeddings [B, H] f32 on the device."""
        return forward(self.params, ids, lengths, self.cfg,
                       self._tables(ids.shape[1]))

    def encode_texts(self, texts: List[str]) -> np.ndarray:
        """Rows (no instruction, padded to ``row_len``) -> [B, H] f32
        numpy, ``encode_batch`` rows per forward pass."""
        texts = list(texts)
        out = [np.zeros((0, self.dim), dtype=np.float32)]
        for i in range(0, len(texts), self.encode_batch):
            ids, lens = featurize(texts[i:i + self.encode_batch],
                                  self.cfg.row_len, self.cfg)
            out.append(self.device_embed(to_device(ids, self.device),
                                         to_device(lens, self.device))
                       .cpu().numpy())
        return np.concatenate(out)
