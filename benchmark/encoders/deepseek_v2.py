"""The program's DeepSeek-V2 embedder (``models/deepseek_v2.py``), built
from a configuration's ``encoder`` block with weights drawn from the seed
here (`seeded_params`: the tree the program and the reference both get),
and the counts of its work.

The block's keys are the published config's names (``hidden_size``,
``num_hidden_layers``, ``n_routed_experts``, ``rope_scaling``, ...), the
stand-in tokenizer's ``word_ids`` and ``eos_token_id``, the padded lengths
``query_len`` and ``row_len``, the ``query_instruction`` and the operand
``dtype``.

Real tokens of a query batch. Every seed draws the same question sizes,
and with the stand-in tokenizer a query is the instruction's 19 tokens,
the question's words and its question mark (14-22 words plus a two-word
name, 14.6-25 tokens) and EOS: 34-45 tokens. Over the 6,464 questions of
the cell's configuration they total 255,976 (seed 1) and 256,077 (seed
2**31 + 5), 39.60-39.62 a question; `QUERY_TOKENS` is 39.6.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

QUERY_TOKENS = 39.6


def leaf_shapes(enc: Dict[str, Any]) -> List[Tuple[str, tuple, float]]:
    """(path, shape, scale) of every drawn leaf, in drawing order: the
    embedding [vocab, H] at scale 1; per layer the attention's ``q_proj``,
    ``kv_a_proj_with_mqa``, ``kv_b_proj`` and ``o_proj``, then the dense
    layers' ``mlp`` or the MoE layers' ``router``, routed ``experts`` [E,
    out, in] and ``shared`` experts (one SwiGLU of n_shared x width); a
    matrix [.., out, in] at scale in^-0.5."""
    H, nh = int(enc["hidden_size"]), int(enc["num_attention_heads"])
    dn, dr = int(enc["qk_nope_head_dim"]), int(enc["qk_rope_head_dim"])
    dv, r = int(enc["v_head_dim"]), int(enc["kv_lora_rank"])
    E, Fm = int(enc["n_routed_experts"]), int(enc["moe_intermediate_size"])
    Fd, Fs = int(enc["intermediate_size"]), int(enc["n_shared_experts"]) * Fm
    out = [("embed", (int(enc["vocab_size"]), H), 1.0)]
    for i in range(int(enc["num_hidden_layers"])):
        a = f"layers.{i}.attn."
        out += [(a + "q_proj", (nh * (dn + dr), H), H ** -0.5),
                (a + "kv_a_proj_with_mqa", (r + dr, H), H ** -0.5),
                (a + "kv_b_proj", (nh * (dn + dv), r), r ** -0.5),
                (a + "o_proj", (H, nh * dv), (nh * dv) ** -0.5)]
        m = f"layers.{i}."
        if i < int(enc["first_k_dense_replace"]):
            out += [(m + "mlp.w_gate", (Fd, H), H ** -0.5),
                    (m + "mlp.w_up", (Fd, H), H ** -0.5),
                    (m + "mlp.w_down", (H, Fd), Fd ** -0.5)]
        else:
            out += [(m + "router", (E, H), H ** -0.5),
                    (m + "experts.w_gate", (E, Fm, H), H ** -0.5),
                    (m + "experts.w_up", (E, Fm, H), H ** -0.5),
                    (m + "experts.w_down", (E, H, Fm), Fm ** -0.5),
                    (m + "shared.w_gate", (Fs, H), H ** -0.5),
                    (m + "shared.w_up", (Fs, H), H ** -0.5),
                    (m + "shared.w_down", (H, Fs), Fs ** -0.5)]
    return out


def seeded_params(enc: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The weight tree drawn on ``device`` from ``seed``: each leaf of
    `leaf_shapes` in order, normal times its scale, stored in bfloat16
    (the router in float32); the RMSNorm weights (``input_norm``,
    ``post_norm``, the latent's ``attn.kv_a_norm``, the final ``norm``)
    at ones. ``{"embed", "layers": [{"attn", "mlp" | "router", "experts",
    "shared", ...}], "norm"}``, the leaves [out, in]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    H, r = int(enc["hidden_size"]), int(enc["kv_lora_rank"])
    layers = [{"input_norm": torch.ones(H, device=device),
               "post_norm": torch.ones(H, device=device),
               "attn": {"kv_a_norm": torch.ones(r, device=device)}}
              for _ in range(int(enc["num_hidden_layers"]))]
    tree: Dict[str, Any] = {"layers": layers,
                            "norm": torch.ones(H, device=device)}
    for path, shape, scale in leaf_shapes(enc):
        leaf = torch.randn(shape, generator=gen, device=device).mul_(scale)
        if not path.endswith("router"):
            leaf = leaf.to(torch.bfloat16)
        keys = path.split(".")
        if keys[0] == "embed":
            tree["embed"] = leaf
            continue
        node = layers[int(keys[1])]
        for k in keys[2:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def config(enc: Dict[str, Any]):
    """The program's ``DeepseekV2Config`` of the block."""
    from a_modular_rag_framework_torch.models.deepseek_v2 import \
        DeepseekV2Config

    rs = enc["rope_scaling"]
    return DeepseekV2Config(
        vocab_size=int(enc["vocab_size"]),
        hidden_size=int(enc["hidden_size"]),
        intermediate_size=int(enc["intermediate_size"]),
        moe_intermediate_size=int(enc["moe_intermediate_size"]),
        num_hidden_layers=int(enc["num_hidden_layers"]),
        first_k_dense_replace=int(enc["first_k_dense_replace"]),
        num_attention_heads=int(enc["num_attention_heads"]),
        qk_nope_head_dim=int(enc["qk_nope_head_dim"]),
        qk_rope_head_dim=int(enc["qk_rope_head_dim"]),
        v_head_dim=int(enc["v_head_dim"]),
        kv_lora_rank=int(enc["kv_lora_rank"]),
        n_routed_experts=int(enc["n_routed_experts"]),
        n_shared_experts=int(enc["n_shared_experts"]),
        num_experts_per_tok=int(enc["num_experts_per_tok"]),
        routed_scaling_factor=float(enc["routed_scaling_factor"]),
        rms_norm_eps=float(enc["rms_norm_eps"]),
        rope_theta=float(enc["rope_theta"]),
        rope_factor=float(rs["factor"]),
        rope_original_max_position_embeddings=int(
            rs["original_max_position_embeddings"]),
        rope_beta_fast=float(rs["beta_fast"]),
        rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=float(rs["mscale"]),
        rope_mscale_all_dim=float(rs["mscale_all_dim"]),
        word_ids=int(enc["word_ids"]), eos_token_id=int(enc["eos_token_id"]),
        query_len=int(enc["query_len"]), row_len=int(enc["row_len"]),
        query_instruction=str(enc["query_instruction"]))


def build(enc: Dict[str, Any], seed: int, device):
    """(the program's encoder on ``device``, its weight tree: the one
    `seeded_params` draws)."""
    from a_modular_rag_framework_torch.models.deepseek_v2 import \
        DeepseekV2Encoder

    params = seeded_params(enc, seed, device)
    return DeepseekV2Encoder(config(enc), params, device=device), params


def flops(batch: int, enc: Dict[str, Any]) -> float:
    """Multiply-adds x 2 the program computes for a query batch: at every
    padded position (``query_len`` a query) the attention projections,
    both attention products over all ``query_len`` keys, the dense layers'
    MLP and the shared experts; at the real tokens (`QUERY_TOKENS` a
    query) the router and the ``num_experts_per_tok`` routed experts."""
    H, L = int(enc["hidden_size"]), int(enc["query_len"])
    nh, dn = int(enc["num_attention_heads"]), int(enc["qk_nope_head_dim"])
    dr, dv = int(enc["qk_rope_head_dim"]), int(enc["v_head_dim"])
    r, Fm = int(enc["kv_lora_rank"]), int(enc["moe_intermediate_size"])
    E, k = int(enc["n_routed_experts"]), int(enc["num_experts_per_tok"])
    layers, dense = int(enc["num_hidden_layers"]), int(
        enc["first_k_dense_replace"])
    moe = layers - dense
    attn = (H * nh * (dn + dr) + H * (r + dr) + r * nh * (dn + dv)
            + nh * dv * H + L * nh * (dn + dr) + L * nh * dv)
    per_pos = (layers * attn + dense * 3 * H * int(enc["intermediate_size"])
               + moe * 3 * H * int(enc["n_shared_experts"]) * Fm)
    per_tok = moe * (H * E + k * 3 * H * Fm)
    return 2.0 * batch * (L * per_pos + QUERY_TOKENS * per_tok)


def expert_gemm_ops(slots: float, hidden: int, width: int) -> float:
    """The grouped kernel's operations: 2 x 3 x hidden x width per routed
    slot (gate, up and down)."""
    return 2.0 * 3 * hidden * width * slots


def expert_gemm_bytes(slots: float, batches: int, held: int, hidden: int,
                      width: int) -> float:
    """The grouped kernel's bytes: the held experts' weights (3 x hidden
    x width bf16 each) read once per layer and batch, the gathered bf16
    activations in and the f32 expert outputs out, once a slot."""
    return (2.0 * 3 * hidden * width * held * batches
            + slots * (2 * hidden + 4 * hidden))
