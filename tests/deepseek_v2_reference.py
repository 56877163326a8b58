"""Plain reference of DeepSeek-V2's trunk as a last-token embedder, for the
port's tests (``tests/test_torch_deepseek_v2.py``).

Plain torch in float32 with TF32 off; it imports nothing of the port.
Written from the published ``modeling_deepseek.py`` of
deepseek-ai/DeepSeek-V2-Lite: RMSNorm (float32), multi-head latent
attention with YaRN RoPE on de-interleaved rope dims, a SwiGLU MLP or the
experts (float32 softmax router over every expert, greedy top-k, each
routed expert's SwiGLU over its tokens, the shared experts' SwiGLU), a
final RMSNorm, the last token's state L2-normalized. Every product rounds
its operands to ``operand`` (bfloat16: the precision the port states; None:
plain float32) and sums in float32. It reads the port's weight tree
layout (weights [out, in]) and takes the widths as plain keyword values.
"""
from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rnd(x, operand):
    return x.float() if operand is None else x.to(operand).float()


def mm(a, b, operand):
    """a @ b on rounded operands, float32."""
    return torch.matmul(rnd(a, operand), rnd(b, operand))


def linear(x, w, operand):
    return mm(x, w.t(), operand)


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn(L, dim, base, factor, orig, beta_fast, beta_slow, mscale,
         mscale_all_dim):
    """(cos, sin) [L, dim] of DeepseekV2YarnRotaryEmbedding."""
    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    def get_mscale(s, m):
        return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0

    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2).float() / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2).float()
                                          / dim))
    ramp = ((torch.arange(dim // 2).float() - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    freqs = torch.outer(torch.arange(L).float(), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
    return emb.cos() * m, emb.sin() * m


def rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat((-x[..., d:], x[..., :d]), dim=-1)


def apply_rope(x, cos, sin):
    """x [B, heads, L, d] as the published apply_rotary_pos_emb: the pairs
    (2i, 2i + 1) de-interleaved, then rotate_half."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + rotate_half(x) * sin


def mla(h, p, valid, cos, sin, w, operand):
    """Attention of h [B, L, H]; ``valid`` [B, L] real tokens; ``w`` the
    widths (heads, nope, rope, v, rank, eps, softmax scale)."""
    B, L, _ = h.shape
    nh, dn, dr, dv, r = w["heads"], w["nope"], w["rope"], w["v"], w["rank"]
    q = linear(h, p["q_proj"], operand).view(B, L, nh, dn + dr).transpose(1,
                                                                          2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = linear(h, p["kv_a_proj_with_mqa"], operand)
    c, k_pe = ckv[..., :r], ckv[..., r:].view(B, L, 1, dr).transpose(1, 2)
    kv = linear(rms_norm(c, p["kv_a_norm"], w["eps"]), p["kv_b_proj"],
                operand).view(B, L, nh, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe, cos, sin)
    q = torch.cat((q_nope, q_pe), -1)
    k = torch.cat((k_nope, k_pe.expand(B, nh, L, dr)), -1)
    scores = mm(q, k.transpose(2, 3), operand) * w["scale"]
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    allowed = causal[None, None] & valid[:, None, None, :]
    scores = scores.masked_fill(~allowed, torch.finfo(torch.float32).min)
    o = mm(torch.softmax(scores, -1), v, operand)
    return linear(o.transpose(1, 2).reshape(B, L, nh * dv), p["o_proj"],
                  operand)


def swiglu(x, p, operand):
    h = torch.nn.functional.silu(linear(x, p["w_gate"], operand)) * linear(
        x, p["w_up"], operand)
    return linear(h, p["w_down"], operand)


def router(x, router_w, top_k):
    """(weights, experts) of the float32 softmax's greedy top-k."""
    scores = torch.softmax(x.float() @ router_w.float().t(), -1)
    return torch.topk(scores, top_k, -1)


def moe(x, lay, top_k, operand, scaling=1.0):
    """The whole (uncut) expert layer on tokens x [T, H]: shared experts
    plus every routed expert's weighted SwiGLU over its tokens."""
    wts, chosen = router(x, lay["router"], top_k)
    out = swiglu(x, lay["shared"], operand)
    ex = lay["experts"]
    for e in range(ex["w_gate"].shape[0]):
        for j in range(top_k):
            sel = chosen[:, j] == e
            if sel.any():
                y = swiglu(x[sel], {n: t[e] for n, t in ex.items()}, operand)
                out[sel] += scaling * wts[sel, j, None] * y
    return out


def embed(params, ids, lengths, w, operand=torch.bfloat16):
    """ids [B, L], lengths [B] -> unit last-token embeddings [B, H]; the
    experts see the real tokens only."""
    B, L = ids.shape
    valid = torch.arange(L)[None] < lengths[:, None]
    cos, sin = yarn(L, w["rope"], *w["yarn"])
    x = params["embed"][ids].float()
    for i, lay in enumerate(params["layers"]):
        x = x + mla(rms_norm(x, lay["input_norm"], w["eps"]), lay["attn"],
                    valid, cos, sin, w, operand)
        h = rms_norm(x, lay["post_norm"], w["eps"])
        if "mlp" in lay:
            x = x + swiglu(h, lay["mlp"], operand)
        else:
            flat = h.reshape(B * L, -1)
            real = valid.reshape(-1)
            add = swiglu(flat, lay["shared"], operand)
            add[real] = moe(flat[real], lay, w["top_k"], operand)
            x = x + add.view(B, L, -1)
    last = rms_norm(x[torch.arange(B), lengths - 1], params["norm"],
                    w["eps"])
    return last / last.norm(dim=-1, keepdim=True).clamp(min=1e-9)
