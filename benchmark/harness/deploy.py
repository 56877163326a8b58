"""Set-up of the program under test for a configuration file: the
generated samples, the program's corpus, index and engine.

The program is ``a_modular_rag_framework_torch``; it is imported here and
in `entries` only. The benchmark hands it the generated samples and, for a
learned encoder, weights made on the device from the seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from . import spec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generate_samples(config: Dict[str, Any], seed: int,
                     root=spec.BENCH) -> List[dict]:
    """The configuration's samples from ``seed``, by the corpus generator
    its ``corpus`` block names (``corpora/<generator>.py``)."""
    c = config["corpus"]
    return spec.load_module("corpora", c["generator"], root).generate(
        c, int(config["samples"]), int(seed))


def seeded_encoder_params(enc: Dict[str, Any], seed: int,
                          device) -> Dict[str, Any]:
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


@dataclass
class Deployment:
    samples: List[dict]
    engine: Any
    index: Any
    encoder_params: Optional[Dict[str, Any]]

    def close(self) -> None:
        self.engine.close()


def build(config: Dict[str, Any], seed: int, device,
          samples: Optional[List[dict]] = None) -> Deployment:
    """Samples -> the program's corpus, packed index (in memory) and
    engine on ``device``, at the configuration's operating point."""
    from a_modular_rag_framework_torch.engine.query_engine import (
        EngineConfig, TorchQueryEngine)
    from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                     build_packed_index)

    samples = samples if samples is not None else generate_samples(config,
                                                                  seed)
    idx_cfg = config["index"]
    encoder, params = None, None
    enc = config.get("encoder")
    if enc is not None:
        from a_modular_rag_framework_torch.models.encoder import (
            EncoderConfig, TextEncoder)
        params = seeded_encoder_params(enc, seed, device)
        ecfg = EncoderConfig(
            vocab_size=int(enc["vocab_size"]), max_len=int(enc["max_len"]),
            d_model=int(enc["d_model"]), n_heads=int(enc["n_heads"]),
            n_layers=int(enc["n_layers"]), d_ff=int(enc["d_ff"]),
            dtype=_DTYPES[enc["dtype"]],
            subword_ngrams=int(enc["subword_ngrams"]),
            ngram_min=int(enc["ngram_min"]), ngram_max=int(enc["ngram_max"]))
        encoder = TextEncoder(ecfg, params=params, device=device)
    index = build_packed_index(
        SentenceCorpus.from_hotpotqa(samples), encoder=encoder,
        embed_dim=int(idx_cfg["embed_dim"]),
        embed_dtype=idx_cfg["embed_dtype"],
        bm25_k1=float(idx_cfg["bm25_k1"]), bm25_b=float(idx_cfg["bm25_b"]),
        bm25_phrase_tokens=bool(idx_cfg["phrase_tokens"]),
        graph_max_degree=int(idx_cfg["graph_max_degree"]))
    eng_cfg = dict(config["engine"])
    for key in ("batch_buckets", "order_alphas"):
        if eng_cfg.get(key) is not None:
            eng_cfg[key] = tuple(eng_cfg[key])
    engine = TorchQueryEngine(index, device=device, encoder=encoder,
                              config=EngineConfig(**eng_cfg))
    return Deployment(samples=samples, engine=engine, index=index,
                      encoder_params=params)
