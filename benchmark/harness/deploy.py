"""Set-up of the program under test for a configuration file: the
generated samples, the program's corpus, index and engine.

The program is ``a_modular_rag_framework_torch``; it is imported here, in
`entries` and in `encoders` only. The benchmark hands it the generated
samples and, for a model encoder, the model its configuration's builder
made (``encoders/<builder>.py``: the weights drawn on the device from the
seed).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from . import spec


def generate_samples(config: Dict[str, Any], seed: int,
                     root=spec.BENCH) -> List[dict]:
    """The configuration's samples from ``seed``, by the corpus generator
    its ``corpus`` block names (``corpora/<generator>.py``)."""
    c = config["corpus"]
    return spec.load_module("corpora", c["generator"], root).generate(
        c, int(config["samples"]), int(seed))


def encoder_builder(enc: Dict[str, Any], root=spec.BENCH):
    """The module that builds the configuration's encoder: the one its
    ``encoder`` block names under ``builder`` (``encoders/<builder>.py``),
    ``text_encoder`` where the block names none."""
    return spec.load_module("encoders", enc.get("builder", "text_encoder"),
                            root)


@dataclass
class Deployment:
    samples: List[dict]
    engine: Any
    index: Any
    encoder_params: Optional[Dict[str, Any]]

    def close(self) -> None:
        self.engine.close()


def build(config: Dict[str, Any], seed: int, device,
          samples: Optional[List[dict]] = None,
          root=spec.BENCH) -> Deployment:
    """Samples -> the program's corpus, packed index (in memory) and
    engine on ``device``, at the configuration's operating point. The
    encoder is the one the configuration's builder makes (`encoder_builder`,
    weights from ``seed``); without an ``encoder`` block, the program's
    hash encoder of ``index.embed_dim``."""
    from a_modular_rag_framework_torch.engine.query_engine import (
        EngineConfig, TorchQueryEngine)
    from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                     build_packed_index)

    samples = samples if samples is not None else generate_samples(config,
                                                                  seed, root)
    idx_cfg = config["index"]
    encoder, params = None, None
    enc = config.get("encoder")
    if enc is not None:
        encoder, params = encoder_builder(enc, root).build(enc, seed, device)
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
