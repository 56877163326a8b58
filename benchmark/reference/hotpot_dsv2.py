"""Plain reference for the hotpot258k-dsv2lite configuration: the hotpot
reference (`hotpot.py`) with DeepSeek-V2-Lite's trunk as its embedder.

It imports neither JAX nor the program. The trunk is written out from the
published architecture (arXiv:2405.04434 and deepseek-ai/DeepSeek-V2-Lite's
``modeling_deepseek.py``) as the configuration uses it, an E5-Mistral
style embedder (arXiv:2401.00368): the stand-in tokenizer (one id per word
or punctuation mark by crc32, then EOS), causal attention, the last
token's final hidden state L2-normalized. Per layer: RMSNorm, multi-head
latent attention with YaRN RoPE on de-interleaved rope dims, RMSNorm, then
a SwiGLU MLP (the leading dense layers) or the experts: a float32 softmax
router, greedy top-k, each routed expert's SwiGLU as its own product over
the tokens routed to it, plus the shared experts' SwiGLU. Padding is never
routed (it cannot reach a real token through causal attention either).

Precision: every product takes operands rounded to the block's ``dtype``
(`hotpot.round_operand`) with float32 sums; the residual stream, the
RMSNorms, the RoPE tables, both softmaxes and the router in float32. On
CUDA a bfloat16 product is ``torch.mm(a, b, out_dtype=float32)`` with the
reduced-precision reduction off: a product of two bfloat16 values is exact
in float32, so that is the float32 reference's arithmetic in another order
of the sum. An 8-bit control rounds each operand with its per-tensor scale
(exact in bfloat16 then) and applies the scales after the product.
Texts run in blocks of rows.
"""
from __future__ import annotations

import math
import re
import zlib
from typing import Sequence

import torch

from hotpot import *  # noqa: F401,F403  (the hotpot reference)
from hotpot import round_operand

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

_WORD = re.compile(r"\w+|[^\w\s]")
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def tokens(text: str, enc: dict):
    return [zlib.crc32(w.encode("utf-8")) % int(enc["word_ids"])
            for w in _WORD.findall(text)] + [int(enc["eos_token_id"])]


def _operand(x: torch.Tensor, dtype) -> tuple:
    """(x rounded to ``dtype`` as a float32 or, on CUDA, bfloat16 tensor
    holding the same values, the scale to divide the product by)."""
    if dtype in _FP8:
        scale = torch.finfo(dtype).max / x.abs().amax().clamp(min=1e-30)
        r = (x.float() * scale).to(dtype)
        return (r.to(torch.bfloat16) if x.is_cuda else r.float()), scale
    if x.is_cuda and dtype == torch.bfloat16:
        return x.to(torch.bfloat16), None
    return round_operand(x.float(), dtype), None


def product(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] (or [K, N]) on operands rounded to
    ``dtype``, float32 sums and result."""
    (ar, sa), (br, sb) = _operand(a, dtype), _operand(b, dtype)
    if ar.dtype == torch.bfloat16:
        if br.dim() == 2:
            out = torch.mm(ar.reshape(-1, ar.shape[-1]), br,
                           out_dtype=torch.float32).reshape(
                *a.shape[:-1], b.shape[-1])
        else:
            out = torch.bmm(ar.reshape(-1, *ar.shape[-2:]),
                            br.reshape(-1, *br.shape[-2:]),
                            out_dtype=torch.float32).reshape(
                *a.shape[:-1], b.shape[-1])
    else:
        out = torch.matmul(ar, br)
    if sa is not None:
        out = out / (sa * sb)
    return out


def linear(x, w, dtype):
    """x @ w^T for a weight [out, in]."""
    return product(x, w.t(), dtype)


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def swiglu(x, p, dtype):
    h = torch.nn.functional.silu(linear(x, p["w_gate"], dtype)) * linear(
        x, p["w_up"], dtype)
    return linear(h, p["w_down"], dtype)


def _mscale(scale, m):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_tables(L: int, enc: dict):
    """YaRN cos / sin [L, rope dims] in float32, as the published
    ``DeepseekV2YarnRotaryEmbedding``."""
    rs = enc["rope_scaling"]
    dim, base = int(enc["qk_rope_head_dim"]), float(enc["rope_theta"])
    factor, orig = float(rs["factor"]), int(
        rs["original_max_position_embeddings"])

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(corr(float(rs["beta_fast"]))), 0)
    high = min(math.ceil(corr(float(rs["beta_slow"]))), dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra, inter = 1.0 / base ** exps, 1.0 / (factor * base ** exps)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    inv = inter * ramp + extra * (1 - ramp)
    freqs = torch.outer(torch.arange(L, dtype=torch.float32), inv)
    emb = torch.cat((freqs, freqs), -1)
    m = _mscale(factor, float(rs["mscale"])) / _mscale(
        factor, float(rs["mscale_all_dim"]))
    return emb.cos() * m, emb.sin() * m


def rope(x, cos, sin):
    """x [B, L, heads, d]: even dims then odd, then x cos + rotate_half(x)
    sin."""
    d = x.shape[-1]
    x = torch.cat((x[..., 0::2], x[..., 1::2]), -1)
    rot = torch.cat((-x[..., d // 2:], x[..., :d // 2]), -1)
    return x * cos[:, None] + rot * sin[:, None]


def attention(h, p, allowed, cos, sin, enc, dtype):
    B, L, _ = h.shape
    nh, dn = int(enc["num_attention_heads"]), int(enc["qk_nope_head_dim"])
    dr, dv = int(enc["qk_rope_head_dim"]), int(enc["v_head_dim"])
    r, eps = int(enc["kv_lora_rank"]), float(enc["rms_norm_eps"])
    q = linear(h, p["q_proj"], dtype).view(B, L, nh, dn + dr)
    ckv = linear(h, p["kv_a_proj_with_mqa"], dtype)
    c, k_pe = ckv[..., :r], ckv[..., r:]
    kv = linear(rms(c, p["kv_a_norm"], eps), p["kv_b_proj"], dtype).view(
        B, L, nh, dn + dv)
    q = torch.cat((q[..., :dn], rope(q[..., dn:], cos, sin)), -1)
    k_pe = rope(k_pe[:, :, None], cos, sin).expand(B, L, nh, dr)
    k = torch.cat((kv[..., :dn], k_pe), -1)
    v = kv[..., dn:]
    m = _mscale(float(enc["rope_scaling"]["factor"]),
                float(enc["rope_scaling"]["mscale_all_dim"]))
    scale = (dn + dr) ** -0.5 * m * m
    logits = product(q.transpose(1, 2), k.permute(0, 2, 3, 1), dtype) * scale
    logits = logits.masked_fill(~allowed[:, None],
                                torch.finfo(torch.float32).min)
    o = product(torch.softmax(logits, -1), v.transpose(1, 2), dtype)
    return linear(o.transpose(1, 2).reshape(B, L, nh * dv), p["o_proj"],
                  dtype)


def experts(x, lay, enc, dtype, routes=None):
    """The routed experts over the real tokens ``x`` [T, H]: float32
    router, greedy top-k of the softmax, each expert's product over its
    tokens, weighted and added back. ``routes``, when a list, receives the
    experts chosen [T, top_k]."""
    k = int(enc["num_experts_per_tok"])
    scores = torch.softmax(x @ lay["router"].float().t(), -1)
    w, chosen = torch.topk(scores, k, -1)
    if routes is not None:
        routes.append(chosen)
    w = w * float(enc["routed_scaling_factor"])
    out = torch.zeros_like(x)
    ex = lay["experts"]
    for e in range(ex["w_gate"].shape[0]):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x[tok], {n: t[e] for n, t in ex.items()}, dtype)
        out.index_add_(0, tok, y * w[tok, slot, None])
    return out


def trunk(params: dict, ids: torch.Tensor, lengths: torch.Tensor,
          enc: dict, dtype, routes=None) -> torch.Tensor:
    """ids [B, L], lengths [B] -> the last token's unit embedding [B, H]
    (``routes``: see `experts`; real tokens in row-major order)."""
    B, L = ids.shape
    H, eps = int(enc["hidden_size"]), float(enc["rms_norm_eps"])
    dev = ids.device
    cos, sin = (t.to(dev) for t in rope_tables(L, enc))
    pos = torch.arange(L, device=dev)
    valid = pos[None] < lengths[:, None]
    allowed = (pos[None, :, None] >= pos[None, None, :]) & valid[:, None]
    real = valid.reshape(-1)
    x = params["embed"][ids].float()
    for i, lay in enumerate(params["layers"]):
        x = x + attention(rms(x, lay["input_norm"], eps), lay["attn"],
                          allowed, cos, sin, enc, dtype)
        h = rms(x, lay["post_norm"], eps)
        if i < int(enc["first_k_dense_replace"]):
            x = x + swiglu(h, lay["mlp"], dtype)
            continue
        flat = h.reshape(B * L, H)
        add = swiglu(flat, lay["shared"], dtype)
        add[real] += experts(flat[real], lay, enc, dtype, routes)
        x = x + add.view(B, L, H)
    last = rms(x[torch.arange(B, device=dev), lengths - 1], params["norm"],
               eps)
    return last / torch.sqrt((last * last).sum(-1, keepdim=True)).clamp(
        min=1e-9)


def embed_texts(params: dict, texts: Sequence[str], enc: dict, device,
                operand_dtype, block: int = 4096, routes=None
                ) -> torch.Tensor:
    """[len(texts), H] float32 unit embeddings on ``device``, the trunk run
    in blocks of rows, each padded to its longest text (``routes``: see
    `experts`, block by block)."""
    out = []
    with torch.no_grad():
        for i in range(0, len(texts), block):
            toks = [tokens(t, enc) for t in texts[i:i + block]]
            L = max(len(t) for t in toks)
            ids = torch.zeros((len(toks), L), dtype=torch.long)
            for j, t in enumerate(toks):
                ids[j, :len(t)] = torch.tensor(t)
            lengths = torch.tensor([len(t) for t in toks])
            out.append(trunk(params, ids.to(device), lengths.to(device), enc,
                             operand_dtype, routes))
    return torch.cat(out) if out else torch.zeros(
        (0, int(enc["hidden_size"])), device=device)
