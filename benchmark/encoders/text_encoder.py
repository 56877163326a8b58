"""The program's ``TextEncoder`` (``models/encoder.py``), built from a
configuration's ``encoder`` block with weights drawn from the seed.

The block's keys are the trunk's widths (``vocab_size``, ``max_len``,
``d_model``, ``n_heads``, ``n_layers``, ``d_ff``), its subword features
(``subword_ngrams``, ``ngram_min``, ``ngram_max``) and the dense layers'
operand ``dtype``. A block that names no ``builder`` is built here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def seeded_params(enc: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The TextEncoder's parameter tree, drawn on ``device`` from ``seed``
    in one call: normal leaves scaled by d^-0.5 (``w2`` by d_ff^-0.5),
    layer norms at ones and zeros."""
    V, L, d = int(enc["vocab_size"]), int(enc["max_len"]), int(enc["d_model"])
    f, n_layers = int(enc["d_ff"]), int(enc["n_layers"])
    shapes = [("tok_emb", (V, d), d ** -0.5), ("pos_emb", (L, d), d ** -0.5)]
    for i in range(n_layers):
        shapes += [(f"wqkv{i}", (d, 3 * d), d ** -0.5),
                   (f"wo{i}", (d, d), d ** -0.5),
                   (f"w1{i}", (d, f), d ** -0.5),
                   (f"w2{i}", (f, d), f ** -0.5)]
    total = sum(a * b for _, (a, b), _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    leaves, pos = {}, 0
    for name, (a, b), scale in shapes:
        leaves[name] = flat[pos:pos + a * b].view(a, b) * scale
        pos += a * b

    def ln():
        return {"g": torch.ones(d, device=device),
                "b": torch.zeros(d, device=device)}

    return {
        "tok_emb": leaves["tok_emb"], "pos_emb": leaves["pos_emb"],
        "layers": [{"ln1": ln(), "wqkv": leaves[f"wqkv{i}"],
                    "wo": leaves[f"wo{i}"], "ln2": ln(),
                    "w1": leaves[f"w1{i}"], "w2": leaves[f"w2{i}"]}
                   for i in range(n_layers)],
        "out_ln": ln(),
    }


def build(enc: Dict[str, Any], seed: int, device):
    """(the program's TextEncoder on ``device``, its parameter tree)."""
    from a_modular_rag_framework_torch.models.encoder import (EncoderConfig,
                                                              TextEncoder)

    params = seeded_params(enc, seed, device)
    cfg = EncoderConfig(
        vocab_size=int(enc["vocab_size"]), max_len=int(enc["max_len"]),
        d_model=int(enc["d_model"]), n_heads=int(enc["n_heads"]),
        n_layers=int(enc["n_layers"]), d_ff=int(enc["d_ff"]),
        dtype=_DTYPES[enc["dtype"]],
        subword_ngrams=int(enc["subword_ngrams"]),
        ngram_min=int(enc["ngram_min"]), ngram_max=int(enc["ngram_max"]))
    return TextEncoder(cfg, params=params, device=device), params


def flops(batch: int, enc: Dict[str, Any]) -> float:
    """Multiply-adds x 2 of the trunk over a batch at its padded length:
    per layer and position the four projections (qkv, out, MLP in and
    out) and the two attention products."""
    L, d, f = int(enc["max_len"]), int(enc["d_model"]), int(enc["d_ff"])
    per_pos = 2 * (3 * d * d + d * d + 2 * d * f) + 4 * L * d
    return float(batch) * L * int(enc["n_layers"]) * per_pos
