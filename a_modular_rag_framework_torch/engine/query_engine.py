"""TorchQueryEngine — the hybrid index-and-query engine on one device
(port of ``a_modular_rag_framework_tpu/engine/query_engine.py``).

Two entry points, as in the JAX engine:

1. ``query_batch`` / ``query_batch_async`` / ``query_batches_pipelined``
   run the single-pass hybrid program: in-program hash embedding of the
   query; the BM25 text pool; dense cosine over the pool; frontier
   expansion seeded by BM25 (or by explicit rows); fusion and the optional
   two-stage re-rank. The program has the JAX engine's two forms, chosen
   by the same rule (`use_compact_graph`):
   - compact, N-independent: BM25 phase-1 pool selection + exact
     re-score, compact frontier waves, pool-union fusion;
   - dense [B, N]: graph waves over the whole corpus (`ops.graph`'s dense
     forms), an exact top-k graph pool, and either pool-union fusion or
     the dense [B, 3, N] fusion oracle; optionally the scatter BM25
     (``bm25_impl="scatter"``) and the [B, N] dense product
     (``dense_impl="matmul"``).
2. ``query_dense_batch``: exact dense top-k over the whole corpus, through
   the hand-written CUDA kernel on a CUDA device (`ops.topk.dense_topk`).

Pool semantics are the JAX engine's: the text pool is the top ``pool_k``
BM25 candidates with score > 0, the dense channel scores the text pool,
the graph pool is the top ``pool_k`` expansion scores > 0, min-max is per
channel over its own pool, and absent channels contribute 0.

The graph pool of the dense form is always an exact top-k: the JAX
engine's ``approx_max_k`` above ``graph_pool_approx_from`` rows is a TPU
primitive, so ``graph_pool_exact`` and ``graph_pool_approx_from`` are
accepted and have no effect.

``sparse_impl="splade"`` swaps the text channel's scorer: the postings are
SPLADE doc expansions (`ops.splade.SpladeDeviceIndex`, built at
construction or passed as ``splade_index=``), and the query's expansion
head runs inside the program, its term ids and weights feeding the same
pool + re-score machinery through the ``term_weights`` seam.

``AMRF_DEBUG_NANS=1`` in the environment when an engine is built (the JAX
package's switch for ``jax_debug_nans``) makes that engine check every
program's scores for finiteness (``query_batch``, its async and pipelined
forms, ``query_dense_batch``) and raise `FloatingPointError` naming the
call and the stage, and check the index embeddings once at upload. The
hybrid program returns one flag per row and stage (`NAN_STAGES`), fetched
with its outputs: a NaN in a channel can vanish before the output
(min-max normalization drops a channel whose range is not finite), so the
outputs alone would not show it. On the card the dense top-k kernel never
selects a NaN score, so ``query_dense_batch`` shows a NaN only through the
upload check. It sets no global state.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._host import require_device, to_device
from ..core.dto import Hit, HitBatch
from ..index.packed import PackedIndex
from ..models.hash_embed import HashEmbedEncoder, tokenize
from ..models.splade import SpladeEncoder, apply_splade, sparsify_topk
from ..native import binding as _native
from ..ops.bm25 import (bm25_rescore_pool, bm25_scores_batched,
                        bm25_topk_sorted)
from ..ops.fusion import fuse_channels, fuse_pools_compact, reorder_hits
from ..ops.graph import (expand_frontier, expand_frontier_weighted,
                         expand_frontier_weighted_batched,
                         expand_frontier_weighted_capped,
                         expand_frontier_weighted_compact)
from ..ops.splade import SpladeRetriever, splade_engine_arrays
from ..ops.topk import dense_topk, stable_topk
from ..telemetry.sinks import TelemetrySink, record_device_timing
from ..telemetry.stages import reset_stage_table, stage, stage_table
from .host_prep import (build_high_df_terms, encode_query_term_ids,
                        pick_bucket, prepare_query_variants, prune_query,
                        trim_term_bucket)


@dataclass
class EngineConfig:
    """The JAX ``EngineConfig``'s fields and defaults, unchanged (see its
    docstrings for each knob)."""

    top_k: int = 30
    pool_k: int = 200
    qe_variants: int = 4  # 1 original + up to 3 expansions
    max_query_terms: int = 32
    max_seed_rows: int = 64
    bm25_posting_cap: int = 4096
    bm25_impl: str = "sorted"
    bm25_term_topm: int = 128
    bm25_doc_cap: int = 64
    fusion_impl: str = "compact"
    graph_window: int = 1
    hop2_graph_window: Optional[int] = None
    hop2_max_bridges: Optional[int] = None
    hop2_pool_k: Optional[int] = None
    include_entity_graph: bool = True
    alpha_text: float = 0.4
    alpha_graph: float = 0.2
    alpha_dense: float = 0.4
    order_alphas: Optional[Tuple[float, float, float]] = None
    graph_seed_weighted: bool = True
    batch_buckets: Tuple[int, ...] = (1, 8, 64, 256)
    frontier_cap: Optional[int] = None
    graph_impl: str = "auto"
    graph_compact_cap: int = 256
    graph_wave_dtype: str = "bfloat16"  # dense [B, N] waves only
    graph_pool_approx_from: int = 4096  # dense [B, N] graph pool only
    graph_pool_exact: bool = False  # dense [B, N] graph pool only
    dense_impl: str = "auto"
    query_df_ratio_max: float = 0.0
    sparse_impl: str = "bm25"  # bm25 | splade (learned-sparse postings)
    splade_weights: str = ""  # SpladeEncoder checkpoint path

    def __post_init__(self):
        if self.order_alphas is not None:
            oa = tuple(float(a) for a in self.order_alphas)
            if len(oa) != 3:
                raise ValueError(
                    f"order_alphas must be 3 weights (text, graph, dense), "
                    f"got {self.order_alphas!r}")
            object.__setattr__(self, "order_alphas", oa)


def check_config(cfg: EngineConfig) -> None:
    """Reject typos and contradictions (ValueError)."""
    for name, value, known in (
            ("sparse_impl", cfg.sparse_impl, ("bm25", "splade")),
            ("bm25_impl", cfg.bm25_impl, ("sorted", "scatter")),
            ("fusion_impl", cfg.fusion_impl, ("compact", "dense")),
            ("graph_impl", cfg.graph_impl, ("auto", "dense", "compact")),
            ("dense_impl", cfg.dense_impl, ("auto", "pool", "matmul"))):
        if value not in known:
            raise ValueError(f"unknown {name} {value!r} "
                             f"(expected {' | '.join(known)})")
    if cfg.sparse_impl == "splade":
        if cfg.bm25_impl != "sorted":
            raise ValueError("sparse_impl='splade' requires "
                             "bm25_impl='sorted' (term_weights ride the "
                             "sort-aggregate path only)")
        if not cfg.splade_weights:
            raise ValueError("sparse_impl='splade' requires "
                             "splade_weights (SpladeEncoder checkpoint)")
    if cfg.graph_impl == "compact" and cfg.fusion_impl != "compact":
        raise ValueError(
            "graph_impl='compact' requires fusion_impl='compact' "
            "(the dense fusion oracle needs [B, N] graph scores)")


def use_compact_graph(cfg: EngineConfig, B: int, n: int) -> bool:
    """The JAX engine's rule: the compact form when asked for, or under
    ``auto`` when the [B, N] f32 buffers exceed 256 MB (with pool-compact
    fusion). ``dense_impl="matmul"`` materializes [B, N] dense scores, so
    it cannot run with the compact form (ValueError)."""
    compact = cfg.fusion_impl == "compact" and (
        cfg.graph_impl == "compact"
        or (cfg.graph_impl == "auto" and B * n * 4 > 256 << 20))
    if cfg.dense_impl == "matmul" and compact:
        raise ValueError(
            "dense_impl='matmul' materializes [B, N] dense scores and "
            "cannot be combined with the compact graph path; use "
            "dense_impl='pool' (or 'auto') at corpus scale")
    return compact


@dataclass
class QueryResult:
    """Host-side view of one query batch's output."""

    hits: HitBatch
    channel_norms: np.ndarray  # [C=3, B, K] normalized channel scores at hits
    diagnostics: Dict[str, Any] = field(default_factory=dict)


class PendingQuery:
    """A dispatched batch: the program's kernels are queued on the device
    but the outputs are not fetched yet. ``result()`` copies them to the
    host (waiting for the device) and unpacks."""

    def __init__(self, *, engine=None, outputs=None, B: int = 0,
                 B_real: int = 0, k: int = 0, pool_k: int = 0,
                 window: int = 0, graph_impl: str = "", t0: float = 0.0,
                 trace_id: str = "", done: Optional[QueryResult] = None):
        self._engine = engine
        self._outputs = outputs
        self._B, self._B_real, self._k = B, B_real, k
        self._pool_k, self._window = pool_k, window
        self._graph_impl = graph_impl
        self._t0, self._trace_id = t0, trace_id
        self._done = done
        # dispatch -> fetch time is the device time only when fetched at
        # once (query_batch); pipelined fetches are deliberately late
        self._sync_timing = False

    def result(self) -> QueryResult:
        if self._done is not None:
            return self._done
        eng = self._engine
        cfg = eng.config
        B_real = self._B_real
        outs = self._outputs
        with stage("engine/fetch"):
            top_s, top_i, norms_at, counts = (t[:B_real].cpu().numpy()
                                              for t in outs[:4])
            if eng._check_nans:
                flags = outs[4][:B_real].cpu().numpy().any(axis=0)
                check_finite("engine/query_batch",
                             stages=[n for n, f in zip(NAN_STAGES, flags)
                                     if f])
        dt_ms = ((time.time() - self._t0) * 1000.0
                 if self._sync_timing else None)
        if eng.sink and self._trace_id and dt_ms is not None:
            record_device_timing(
                eng.sink, self._trace_id, kernel="engine/query_batch",
                device_ms=dt_ms, shape=f"B{self._B}xN{eng._n}k{self._k}",
                backend=eng.device.type,
            )
        self._done = QueryResult(
            hits=HitBatch(ids=top_i, scores=top_s),
            channel_norms=np.moveaxis(norms_at, 1, 0),
            diagnostics={
                "bm25_candidates": int(counts[:, 0].sum()),
                "graph_candidates": int(counts[:, 1].sum()),
                "dense_scored": int(counts[:, 2].sum()),
                "weights": {"alpha_text": cfg.alpha_text,
                            "alpha_graph": cfg.alpha_graph,
                            "alpha_dense": cfg.alpha_dense},
                "pool": {"bm25_pool_k": self._pool_k, "final_top_k": self._k},
                "graph_window_used": self._window,
                "graph_impl": self._graph_impl,
                "device_ms": round(dt_ms, 3) if dt_ms is not None else None,
                "batch_bucket": self._B,
            },
        )
        self._outputs = None  # release the device tensors
        return self._done


# the hybrid program's stages whose scores the NaN check watches
NAN_STAGES = ("text pool", "dense pool", "graph pool", "fused scores",
              "channel norms")


def nan_flags(*stage_scores: torch.Tensor) -> torch.Tensor:
    """[B, len(stage_scores)] bool: whether a row of each stage's scores
    holds a NaN or an infinity."""
    return torch.stack([~torch.isfinite(s.reshape(s.shape[0], -1)).all(dim=1)
                        for s in stage_scores], dim=1)


def check_index_finite(emb: torch.Tensor) -> None:
    """The NaN check at upload: the normalized index embeddings (a NaN or
    infinite row would otherwise be dropped silently by the dense
    channel's normalization)."""
    if emb.numel() and not bool(torch.isfinite(emb).all()):
        check_finite("engine upload", stages=["index embeddings"])


def check_finite(call: str, *arrays: np.ndarray, stages=()) -> None:
    """Raise FloatingPointError naming ``call`` when a fetched array holds a
    NaN or an infinity, or ``stages`` names stages that did (the engine's
    ``AMRF_DEBUG_NANS`` check)."""
    bad = list(stages) + ["output"] * any(not np.isfinite(a).all()
                                          for a in arrays)
    if bad:
        raise FloatingPointError(
            f"{call}: non-finite values in {', '.join(dict.fromkeys(bad))} "
            f"(AMRF_DEBUG_NANS=1)")


def normalized_embeddings(index: PackedIndex, device) -> torch.Tensor:
    """The index's [N, d] embeddings on ``device``, L2-normalized in f32
    and cast back to their storage dtype, as the JAX engine does."""
    emb = index.device_embeddings(device)
    if emb.numel():
        e32 = emb.float()
        norms = torch.sqrt(torch.sum(e32 * e32, dim=1, keepdim=True))
        emb = (e32 / torch.clamp(norms, min=1e-9)).to(emb.dtype)
    return emb


def _empty_result(B_real: int, k: int, **diagnostics) -> QueryResult:
    return QueryResult(
        hits=HitBatch(ids=np.full((B_real, k), -1, np.int32),
                      scores=np.zeros((B_real, k), np.float32)),
        channel_norms=np.zeros((3, B_real, k), np.float32),
        diagnostics=diagnostics)


class TorchQueryEngine:
    """Holds the packed index on ``device`` and serves query batches.

    ``device`` is the card (``"cuda"``, the current CUDA device) unless
    the caller passes ``"cpu"`` or another ``"cuda:i"``; asking for CUDA
    where there is none raises. ``AMRF_DEBUG_NANS=1`` at construction turns
    on the finiteness check of every fetched score (module docstring)."""

    # query_batch_async accepts prepruned=True: the iterative mode's native
    # bridge emits hop-2 variants already pruned
    _supports_prepruned = True

    def __init__(self, index: PackedIndex, *, device="cuda",
                 encoder: Optional[Any] = None,
                 config: Optional[EngineConfig] = None,
                 sink: Optional[TelemetrySink] = None,
                 splade_index: Optional[Any] = None):
        self.device = require_device(device)
        self.index = index
        self.sink = sink
        self._check_nans = os.environ.get("AMRF_DEBUG_NANS") == "1"
        self.config = config or EngineConfig()
        check_config(self.config)
        self.encoder = encoder or HashEmbedEncoder(dim=index.embed_dim or 64)
        enc_device = getattr(self.encoder, "device", self.device)
        if enc_device != self.device:
            raise ValueError(f"the encoder's parameters are on {enc_device} "
                             f"but the engine runs on {self.device}")
        self._n = index.n_docs
        cfg = self.config
        self._alphas = torch.tensor(
            [cfg.alpha_text, cfg.alpha_graph, cfg.alpha_dense],
            dtype=torch.float32, device=self.device)
        self._splade_enc: Optional[SpladeEncoder] = None
        self._splade_index = None
        if cfg.sparse_impl == "splade":
            # learned-sparse text channel: SPLADE doc expansions replace
            # the BM25 postings on the device, the query expansion runs in
            # the program; the head owns term weighting, so idf pruning of
            # the query is off
            self._splade_enc = SpladeEncoder.load(cfg.splade_weights,
                                                  device=self.device)
            if splade_index is None and self._n:
                splade_index = self._build_splade_index()
            self._splade_index = splade_index
            self._high_df_terms = None
        else:
            self._high_df_terms = build_high_df_terms(
                index.bm25, cfg.query_df_ratio_max, self._n)
        self._upload()
        vocab = _native.NativeVocab(index.bm25.vocab)
        self._native_vocab = vocab if vocab.available else None
        self._prep_pool: Optional[ThreadPoolExecutor] = None

    def _upload(self) -> None:
        """Index -> device (`normalized_embeddings`, the neighbor table and
        the text channel's postings)."""
        self._emb = normalized_embeddings(self.index, self.device)
        self._nbrs = self.index.device_graph(
            self.device, include_entity=self.config.include_entity_graph)
        if self._splade_enc is None:
            self._bm25 = self.index.device_bm25(self.device)
        elif self._splade_index is None:
            self._bm25 = {}
        else:
            self._bm25 = splade_engine_arrays(
                self._splade_index, self._splade_enc.cfg.doc_top_terms,
                self.device)
        if self._check_nans:
            check_index_finite(self._emb)

    def reload(self) -> None:
        """Upload the packed index (and the SPLADE postings) again, e.g.
        after the index's arrays were swapped or the device was reset."""
        self._upload()

    def _build_splade_index(self):
        """Expand the corpus through the SPLADE encoder in device batches
        (in memory; a caller that caches the result passes it back as
        ``splade_index=``)."""
        r = SpladeRetriever(self._splade_enc)
        r.build(self.index.corpus.texts())
        return r.index

    def _upload_batch(self, a: np.ndarray) -> torch.Tensor:
        """Per-batch inputs go up without waiting for queued device work,
        so the next batch's prep overlaps the current program."""
        return to_device(a, self.device, non_blocking=True)

    def device_bytes(self) -> int:
        """Bytes of the index tensors resident on the device."""
        tensors = [self._emb, self._nbrs, *self._bm25.values()]
        return int(sum(t.numel() * t.element_size() for t in tensors))

    def close(self) -> None:
        """Stop the pipelining worker thread, if one was started."""
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=True)
            self._prep_pool = None

    # ------------- host-side encoding -------------

    def _bucket(self, b: int) -> int:
        return pick_bucket(self.config.batch_buckets, b)

    def _compact_form(self, B: int) -> bool:
        """Whether a bucket of ``B`` rows takes the compact graph form."""
        return use_compact_graph(self.config, B, self._n)

    @property
    def _hash_on_device(self) -> bool:
        """Whether queries are hashed on the card: a CUDA engine whose
        encoder has a kernel for it (the hash encoder's ``device_encode``)."""
        return self.device.type == "cuda" and hasattr(self.encoder,
                                                      "device_encode")

    def _embed_queries(self, texts: Sequence[str], *, fused: bool = True,
                       pad_to: int = 0) -> torch.Tensor:
        """[B, d] f32 query embeddings on the device, ``texts`` padded
        with empty strings to ``pad_to`` rows. A hash encoder on a CUDA
        engine hashes on the card: host packing (``engine/featurize``),
        then the uploads and the kernel (``engine/embed``, the kernel in
        ``engine/hash_embed``). Else through the encoder's fused seam when
        it has one and ``fused``: host featurize (``engine/featurize``),
        then the uploads and the device embed (``engine/embed``); else its
        host ``encode_texts`` (``engine/featurize``) and the upload
        (``engine/embed``)."""
        enc = self.encoder
        packed = self._hash_on_device
        fused = fused and hasattr(enc, "host_featurize") and hasattr(
            enc, "device_embed")
        with stage("engine/featurize"):
            texts = list(texts) + [""] * (pad_to - len(texts))
            if packed:
                feats = enc.pack_texts(texts)
            elif fused:
                feats = enc.host_featurize(texts)
            else:
                feats = (np.asarray(enc.encode_texts(texts),
                                    dtype=np.float32),)
        with stage("engine/embed"):
            up = [self._upload_batch(f) for f in feats]
            if packed:
                with stage("engine/hash_embed"):
                    return enc.device_encode(*up)
            return enc.device_embed(*up) if fused else up[0]

    def encode_queries(self, variants: Sequence[Sequence[str]],
                       n_variants: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (q_emb [B, d] f32, term_ids [B, E, T] int32), on the host.

        ``variants[b]`` = [original, expansion1, ...]; the dense channel uses
        the ORIGINAL query embedding only, BM25 max-merges over all
        variants (the JAX engine's contract)."""
        originals = [v[0] if v else "" for v in variants]
        q_emb = np.asarray(self.encoder.encode_texts(list(originals)),
                           dtype=np.float32)
        return q_emb, self.encode_term_ids(variants, n_variants=n_variants)

    def encode_term_ids(self, variants: Sequence[Sequence[str]],
                        n_variants: Optional[int] = None) -> np.ndarray:
        """[B, E, T] int32 BM25 term ids."""
        cfg = self.config
        return encode_query_term_ids(
            variants, n_variants or cfg.qe_variants, cfg.max_query_terms,
            self.index.bm25.vocab, self._native_vocab)

    def qmatch_seed_rows(self, query: str,
                         candidate_rows: Sequence[int]) -> List[int]:
        """Host q_match: candidate rows sharing >= 1 token with the query
        (the EdgeBuilder's q_match semantics)."""
        q_terms = set(tokenize(query))
        out = []
        for r in candidate_rows:
            text = self.index.corpus.docs[r].get("text", "")
            if q_terms & set(tokenize(text)):
                out.append(int(r))
        return out

    # ------------- the device program -------------

    def _program(self, q_emb: torch.Tensor, term_ids: torch.Tensor,
                 seed_rows: Optional[torch.Tensor], *, pool_k: int, k: int,
                 window: int, compact: bool,
                 term_w: Optional[torch.Tensor] = None):
        """The single-pass hybrid program. Returns device tensors (top_s
        [B, k], top_i [B, k], norms_at [B, 3, k], counts [B, 3]). Each
        stage is a named profiler range (``engine/<stage>``): a few
        microseconds when no profiler runs. ``term_w`` [B, E, T] weights
        the term occurrences (the learned-sparse channel)."""
        cfg = self.config
        n = self._n
        bm = self._bm25
        emb = self._emb
        cap = min(cfg.bm25_posting_cap, max(int(bm["doc_ids"].shape[0]), 1))

        # ---- text channel ----
        text_scores = None  # [B, N] only for the scatter form
        if cfg.bm25_impl == "sorted":
            # BM25 pool + exact re-score
            with stage("engine/bm25_pool"):
                pool_s, pool_i = bm25_topk_sorted(
                    term_ids, bm["doc_ids"], bm["scores"], bm["row_ptr"],
                    n_docs=n, term_topm=min(cfg.bm25_term_topm, cap),
                    pool_k=pool_k, posting_packed=bm.get("posting_packed"),
                    term_weights=term_w)
                pad = pool_k - pool_s.shape[1]
                if pad > 0:
                    pool_s = torch.nn.functional.pad(pool_s, (0, pad))
                    pool_i = torch.nn.functional.pad(pool_i, (0, pad),
                                                     value=-1)
            with stage("engine/bm25_rescore"):
                pool_s = bm25_rescore_pool(pool_i, term_ids,
                                           bm["doc_terms_padded"],
                                           bm["doc_scores_padded"], n_docs=n,
                                           term_weights=term_w)
            pool_valid = (pool_s > 0) & (pool_i >= 0)
        else:
            with stage("engine/bm25_scatter"):
                text_scores = bm25_scores_batched(
                    term_ids, bm["doc_ids"], bm["scores"], bm["row_ptr"],
                    n_docs=n, cap=cap, merge="max")
                pool_s, pool_pos = stable_topk(text_scores, pool_k, dim=1)
                pool_i = pool_pos.to(torch.int32)
            pool_valid = pool_s > 0
        safe_pool = torch.where(pool_valid, pool_i,
                                torch.zeros_like(pool_i)).long()

        # ---- dense channel: cosine(q, pool rows) ----
        with stage("engine/dense"):
            qn = q_emb / torch.clamp(
                torch.sqrt(torch.sum(q_emb * q_emb, dim=1, keepdim=True)),
                min=1e-9)
            if cfg.dense_impl == "matmul":
                # [B, N] = Q @ E^T (dense form only), then a gather at the
                # pool ids
                dense_pool = torch.gather(qn @ emb.float().T, 1, safe_pool)
            else:
                dense_pool = torch.einsum("bd,bkd->bk", qn,
                                          emb[safe_pool].float())
            dense_pool = torch.where(pool_valid, dense_pool,
                                     torch.zeros_like(dense_pool))

        # ---- graph channel ----
        P_g = min(pool_k, n)
        S_eff = min(cfg.max_seed_rows, pool_k)
        with stage("engine/graph"):
            if seed_rows is None:
                # seeds = the strongest BM25 pool entries
                top_seed_s, seed_pos = stable_topk(pool_s, S_eff, dim=1)
                seed_ids = torch.gather(pool_i, 1, seed_pos)
                seed_ok = (top_seed_s > 0) & (seed_ids >= 0)
                if cfg.graph_seed_weighted:
                    # seed strength = bm25 / max(bm25): the strongest is 1.0
                    denom = torch.clamp(top_seed_s[:, :1], min=1e-9)
                    seed_vals = torch.where(seed_ok, top_seed_s / denom,
                                            torch.zeros_like(top_seed_s))
                else:
                    seed_vals = seed_ok.float()
            else:
                seed_ids = seed_rows
                seed_ok = seed_rows >= 0
                seed_vals = seed_ok.float()
            if compact:
                g_pool_s, g_pool_i = expand_frontier_weighted_compact(
                    self._nbrs, seed_ids, seed_vals, window=window,
                    cap=cfg.graph_compact_cap, out_k=P_g)
                g_valid = (g_pool_s > 0) & (g_pool_i >= 0)
            else:
                graph_scores = self._dense_graph(
                    seed_ids, seed_ok, seed_vals,
                    uniform=seed_rows is not None
                    or not cfg.graph_seed_weighted, window=window)
        if not compact:
            with stage("engine/graph_pool"):
                g_pool_s, g_pos = stable_topk(graph_scores, P_g, dim=1)
                g_pool_i = g_pos.to(torch.int32)
                g_valid = g_pool_s > 0

        # ---- fusion ----
        with stage("engine/fusion"):
            n_text = pool_valid.sum(dim=1)
            counts = torch.stack([n_text, g_valid.sum(dim=1), n_text], dim=1)
            if cfg.fusion_impl == "dense":
                top_s, top_i, norms_at = self._fuse_dense(
                    pool_s, safe_pool, pool_valid, text_scores, dense_pool,
                    graph_scores, g_pool_i, g_valid, k=k)
            else:
                if compact:
                    # graph value at text-pool ids = membership in the
                    # graph pool
                    eq = pool_i[:, :, None] == torch.where(
                        g_valid, g_pool_i,
                        torch.full_like(g_pool_i, -2))[:, None, :]
                    t_graph_raw = torch.amax(
                        torch.where(eq, g_pool_s[:, None, :],
                                    torch.zeros((), device=eq.device)),
                        dim=2)
                else:
                    t_graph_raw = torch.gather(
                        graph_scores, 1, pool_i.long().clamp(0, max(n - 1, 0)))
                top_s, top_i, norms_at = fuse_pools_compact(
                    pool_s, pool_i, pool_valid, dense_pool, t_graph_raw,
                    g_pool_s, g_pool_i, g_valid, alphas=self._alphas, k=k,
                    n=n)
            if cfg.order_alphas is not None:
                top_s, top_i, norms_at = reorder_hits(top_s, top_i, norms_at,
                                                      cfg.order_alphas)
        outputs = (top_s, top_i, norms_at, counts.to(torch.int32))
        if self._check_nans:
            outputs += (nan_flags(pool_s, dense_pool, g_pool_s, top_s,
                                  norms_at),)
        return outputs

    def _dense_graph(self, seed_ids: torch.Tensor, seed_ok: torch.Tensor,
                     seed_vals: torch.Tensor, *, uniform: bool,
                     window: int) -> torch.Tensor:
        """[B, N] graph scores of the dense form, by the JAX engine's
        choice of expansion: the per-degree-column batched form when the
        [B, N, deg] view would exceed 2 GB (and no ``frontier_cap``), the
        boolean BFS for uniform seeds, else the weighted form (capped when
        ``frontier_cap`` is set). Uniform seeds through the weighted
        batched form give exactly decay(min distance)."""
        cfg = self.config
        n = self._n
        nbrs = self._nbrs
        B = seed_ids.shape[0]
        deg = int(nbrs.shape[1])
        batched = (cfg.frontier_cap is None
                   and B * n * max(deg, 1) * 4 > 2 << 30)
        ok = seed_ok & (seed_ids < n)
        slot = torch.where(ok, seed_ids, n).long()  # slot n is the dump
        if uniform and not batched:
            mask = torch.zeros((B, n + 1), dtype=torch.bool,
                               device=seed_ids.device)
            mask.scatter_(1, slot, True)
            scores, _ = expand_frontier(nbrs, mask[:, :n], window=window,
                                        frontier_cap=cfg.frontier_cap)
            return scores
        seed_scores = torch.zeros((B, n + 1), dtype=torch.float32,
                                  device=seed_ids.device)
        seed_scores.scatter_reduce_(1, slot, torch.where(
            ok, seed_vals, torch.zeros_like(seed_vals)), "amax")
        seed_scores = seed_scores[:, :n]
        if batched:
            return expand_frontier_weighted_batched(
                nbrs, seed_scores, window=window,
                wave_dtype=cfg.graph_wave_dtype)
        if cfg.frontier_cap:
            return expand_frontier_weighted_capped(
                nbrs, seed_scores, window=window,
                frontier_cap=cfg.frontier_cap)
        return expand_frontier_weighted(nbrs, seed_scores, window=window,
                                        wave_dtype=cfg.graph_wave_dtype)

    def _fuse_dense(self, pool_s, safe_pool, pool_valid, text_scores,
                    dense_pool, graph_scores, g_pool_i, g_valid, *, k: int):
        """The dense fusion oracle: the three channels scattered into
        [B, 3, N] buffers with presence masks, then `fuse_channels`."""
        n = self._n
        B = pool_s.shape[0]
        dev = pool_s.device
        slot = torch.where(pool_valid, safe_pool, n)

        def scatter(values, index):
            out = torch.zeros((B, n + 1), dtype=values.dtype, device=dev)
            return out.scatter_(1, index, values)[:, :n]

        text_present = scatter(torch.ones_like(pool_valid), slot)
        if text_scores is None:
            text_dense = scatter(torch.where(pool_valid, pool_s,
                                             torch.zeros_like(pool_s)), slot)
        else:
            text_dense = torch.where(text_present, text_scores,
                                     torch.zeros_like(text_scores))
        dense_scores = scatter(dense_pool, slot)
        graph_present = scatter(torch.ones_like(g_valid), torch.where(
            g_valid, g_pool_i.long(), n))
        graph_channel = torch.where(graph_present, graph_scores,
                                    torch.zeros_like(graph_scores))
        top_s, top_i, normed = fuse_channels(
            torch.stack([text_dense, graph_channel, dense_scores], dim=1),
            torch.stack([text_present, graph_present, text_present], dim=1),
            self._alphas, k=k)
        # padded hits read the norms at id 0, as in the JAX engine
        safe_i = torch.where(top_i >= 0, top_i, 0).long()
        norms_at = torch.gather(normed, 2, safe_i[:, None, :].expand(B, 3, k))
        return top_s, top_i, norms_at

    # ------------- public API -------------

    def query_batch(self, queries: Sequence[str], *,
                    expansions: Optional[Sequence[Sequence[str]]] = None,
                    seed_rows: Optional[Sequence[Sequence[int]]] = None,
                    top_k: Optional[int] = None,
                    graph_window: Optional[int] = None,
                    trace_id: str = "",
                    prepruned: bool = False,
                    pool_k: Optional[int] = None) -> QueryResult:
        """Synchronous query: dispatch + fetch in one call."""
        pending = self.query_batch_async(
            queries, expansions=expansions, seed_rows=seed_rows,
            top_k=top_k, graph_window=graph_window, trace_id=trace_id,
            prepruned=prepruned, pool_k=pool_k)
        pending._sync_timing = True
        return pending.result()

    def query_batches_pipelined(self, batches: Sequence[Sequence[str]], **kw):
        """Generator over query batches with one batch in flight: host prep
        + dispatch run on a worker thread while this thread waits on the
        previous batch's fetch (which releases the GIL)."""
        if self._prep_pool is None:
            self._prep_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="amrf-torch-prep")
        pending: deque = deque()
        for b in batches:
            pending.append(self._prep_pool.submit(self.query_batch_async,
                                                  b, **kw))
            if len(pending) >= 3:
                yield pending.popleft().result().result()
        while pending:
            yield pending.popleft().result().result()

    def query_batch_async(self, queries: Sequence[str], *,
                          expansions: Optional[Sequence[Sequence[str]]] = None,
                          seed_rows: Optional[Sequence[Sequence[int]]] = None,
                          top_k: Optional[int] = None,
                          graph_window: Optional[int] = None,
                          trace_id: str = "",
                          prepruned: bool = False,
                          pool_k: Optional[int] = None) -> PendingQuery:
        """Prepare the batch on the host, queue the program on the device
        and return without waiting; ``.result()`` fetches the QueryResult.

        ``trace_id`` is kept in the handle. ``prepruned=True``: the caller
        already applied ``prune_query``. ``pool_k`` overrides
        ``config.pool_k`` for this dispatch."""
        cfg = self.config
        B_real = len(queries)
        if self._n == 0 or B_real == 0:
            return PendingQuery(done=_empty_result(
                B_real, top_k or cfg.top_k, empty_index=self._n == 0))

        k = min(int(top_k or cfg.top_k), self._n)
        window = (cfg.graph_window if graph_window is None
                  else max(0, int(graph_window)))
        pool_k = max(min(int(pool_k or cfg.pool_k), self._n), k)
        B = self._bucket(B_real)
        compact = self._compact_form(B)

        with stage("engine/host_prep"):
            if self._high_df_terms and not prepruned:
                queries = [prune_query(q, self._high_df_terms)
                           for q in queries]
                if expansions is not None:
                    expansions = [[prune_query(e, self._high_df_terms)
                                   for e in ex] for ex in expansions]
            variants, E = prepare_query_variants(queries, expansions, B,
                                                 cfg.qe_variants)
            q_emb = self._embed_queries([v[0] if v else "" for v in variants])
            term_w = None
            if self._splade_enc is not None:
                # every variant row goes through the expansion head (one
                # trunk pass over the B*E rows); no vocab lookup on the host
                sp = self._splade_enc
                flat = [v[e] if e < len(v) else ""
                        for v in variants for e in range(E)]
                sp_ids, sp_mask = sp.host_featurize(flat)
                with torch.no_grad(), stage("engine/splade_expand"):
                    t_ids, t_w = sparsify_topk(
                        apply_splade(sp.params, self._upload_batch(sp_ids),
                                     self._upload_batch(sp_mask), sp.cfg),
                        int(sp.cfg.query_top_terms))
                term_ids = t_ids.reshape(B, E, -1)
                term_w = t_w.reshape(B, E, -1)
            else:
                term_ids = self._upload_batch(trim_term_bucket(
                    self.encode_term_ids(variants, n_variants=E),
                    cfg.max_query_terms))
            seeds = None
            if seed_rows is not None:
                S = cfg.max_seed_rows
                seed_arr = np.full((B, S), -1, dtype=np.int32)
                for i in range(min(B_real, B)):
                    rows = list(seed_rows[i])[:S]
                    seed_arr[i, : len(rows)] = rows
                seeds = self._upload_batch(seed_arr)

        t0 = time.time()
        outputs = self._program(q_emb, term_ids, seeds, pool_k=pool_k, k=k,
                                window=window, compact=compact,
                                term_w=term_w)
        return PendingQuery(engine=self, outputs=outputs, B=B, B_real=B_real,
                            k=k, pool_k=pool_k, window=window,
                            graph_impl="compact" if compact else "dense",
                            t0=t0, trace_id=trace_id)

    def embed_dense_queries(self, texts: Sequence[str], *,
                            pad_to: int = 0) -> torch.Tensor:
        """The dense-only path's query embeddings [B, d] on the device
        (``texts`` padded to ``pad_to`` rows). An encoder whose parameters
        live on the device (a learned `TextEncoder`) embeds there through
        the fused seam, the hash encoder on a CUDA engine through its
        kernel; the hash encoder on the CPU embeds on the host, where its
        one native call beats featurize + device accumulate."""
        on_device = getattr(self.encoder, "device", None) is not None
        return self._embed_queries(texts, fused=on_device,
                                   pad_to=pad_to).contiguous()

    def query_dense_batch(self, queries: Sequence[str], *,
                          top_k: Optional[int] = None) -> QueryResult:
        """Exact dense retrieval over the FULL corpus: cosine top-k through
        `ops.topk.dense_topk` (the CUDA kernel on a CUDA device). Its
        stages are the ranges ``engine/featurize``, ``engine/embed`` (on
        the card with the hash encoder, ``engine/hash_embed`` inside it),
        ``engine/dense_topk`` (the kernel's launches) and ``engine/fetch``
        (waiting for the device and both copies to the host)."""
        B_real = len(queries)
        k = min(int(top_k or self.config.top_k), self._n)
        if self._n == 0 or B_real == 0:
            return _empty_result(B_real, k or 1, empty_index=self._n == 0)
        B = self._bucket(B_real)
        q = self.embed_dense_queries(queries, pad_to=B)
        with stage("engine/dense_topk"):
            s, i = dense_topk(q, self._emb, k)
        with stage("engine/fetch"):
            s = s[:B_real].cpu().numpy()
            i = i[:B_real].cpu().numpy()
            if self._check_nans:
                check_finite("engine/query_dense_batch", s)
        return QueryResult(
            hits=HitBatch(ids=i, scores=s),
            channel_norms=np.zeros((3, B_real, k), dtype=np.float32),
            diagnostics={"mode": "dense_only", "batch_bucket": B})

    # ------------- ops -------------

    @contextlib.contextmanager
    def profile(self, trace_dir: str):
        """Context manager: a `torch.profiler` trace of the engine's activity
        (host ops and, on the card, its kernels; the ``engine/<stage>``
        ranges name the program's stages), written as a chrome trace
        ``engine.<pid>.<ns>.pt.trace.json`` into ``trace_dir`` on exit,
        and beside it the stage table of the same window (each range's
        count and host seconds, `telemetry.stages`) as
        ``engine.<pid>.<ns>.stages.json``. Yields the profiler."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        out = Path(trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        reset_stage_table()
        with profile(activities=activities) as prof:
            yield prof
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        stem = out / f"engine.{os.getpid()}.{time.time_ns()}"
        prof.export_chrome_trace(f"{stem}.pt.trace.json")
        Path(f"{stem}.stages.json").write_text(json.dumps(
            {name: {"count": n, "seconds": sec}
             for name, (n, sec) in sorted(stage_table().items())},
            indent=1), encoding="utf-8")

    # ------------- host hydration -------------

    def hydrate_hits(self, result: QueryResult, row: int,
                     extra_meta: Optional[Dict[str, Any]] = None
                     ) -> List[Hit]:
        """QueryResult row -> [Hit] with corpus meta and channel norms (the
        norms win key collisions with ``extra_meta``, as in JAX)."""
        corpus = self.index.corpus
        norms = np.asarray(result.channel_norms)
        nt, ng, nd = (norms[0, row].tolist(), norms[1, row].tolist(),
                      norms[2, row].tolist())
        hits: List[Hit] = []
        for i, (rid, s) in enumerate(zip(
                np.asarray(result.hits.ids)[row].tolist(),
                np.asarray(result.hits.scores)[row].tolist())):
            if rid < 0:
                continue
            meta = corpus.hit_meta(rid)
            if extra_meta:
                meta.update(extra_meta)
            meta["score_text_norm"] = nt[i]
            meta["score_graph_norm"] = ng[i]
            meta["score_dense_norm"] = nd[i]
            hits.append(Hit(id=corpus.hit_id(rid), score=float(s), meta=meta))
        return hits
