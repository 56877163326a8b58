"""ShardedHybridEngine: BM25 + graph + dense over a row-sharded corpus
(port of ``a_modular_rag_framework_tpu/parallel/sharded_hybrid.py``).

All three channels of the hybrid program are sharded over the ``axis`` of
a `parallel.mesh.DeviceMesh`; one process drives every position:

- **BM25**: the CSR postings are split by document row range (each term's
  postings keep their contribution order); each shard selects its phase-1
  pool and re-scores it exactly against its own doc-major rows, and the
  shards' pools merge into the global pool (`all_gather` + stable top-k,
  s * pool_k candidates per query, never [B, N]);
- **dense**: each shard scores the pool ids it owns against its local
  embedding rows; `all_reduce_sum` assembles the pool's cosines (one
  owner per id, so the sum is exact);
- **graph**, compact form (`ops.graph.expand_frontier_weighted_compact_core`,
  the single-device trace): each hop's adjacency rows come from their
  owners (the local gather, -1 elsewhere) through `all_reduce_max`;
- **graph**, dense [B, n_pad] form: per hop each shard gathers the wave at
  its rows' neighbors and max-folds (one column gather per neighbor slot,
  no [B, n_local, deg] buffer), and `all_gather` rebuilds the wave;
  ``graph_wave_dtype`` rounds at the single-device form's points;
- **fusion**: `ops.fusion.fuse_pools_compact` / `reorder_hits` over the
  merged pools.

What the JAX program computes replicated after a merge (seeds, the compact
expansion, the dense form's graph pool, fusion) runs once, on the lead
(first) device of each data-parallel group; only the row-owned pieces loop
over the shards. Mesh axes other than ``axis`` (the outermost
``dcn_axes``) split the query batch: each group holds its own copy of the
shards (shared where it lands on the same device) and runs its block of
rows.

Ties resolve as on one device: per-shard pools are (score desc, local id
asc) and shards concatenate in row order, so the merge orders equal scores
by ascending global id.

Exactness: the phase-1 windows run over LOCAL postings, so each term
contributes up to ``bm25_term_topm`` candidates PER SHARD, a superset of
the single-device window. With ``bm25_term_topm`` at least the longest
posting list both engines are exact and agree bit for bit (`dryrun_check`);
below it (the scale operating point's 16) the sharded pool can hold a doc
that the single-device window cut, so the two may differ.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._host import require_device, to_device
from ..engine.host_prep import build_high_df_terms
from ..engine.query_engine import (EngineConfig, PendingQuery, QueryResult,
                                   TorchQueryEngine, check_index_finite,
                                   nan_flags, normalized_embeddings)
from ..index.packed import PackedIndex
from ..models.hash_embed import HashEmbedEncoder
from ..native import binding as _native
from ..ops.bm25 import bm25_rescore_pool, bm25_topk_sorted
from ..ops.fusion import fuse_pools_compact, reorder_hits
from ..ops.graph import (expand_frontier_weighted_compact_core,
                         hop_decay_table)
from ..ops.topk import stable_topk
from ..telemetry.stages import stage
from .collectives import all_gather, all_reduce_max, all_reduce_sum
from .mesh import DeviceMesh, build_mesh
from .sharded import merge_topk


def shard_hybrid_arrays(index: PackedIndex, n_shards: int, *,
                        doc_cap: int = 64, include_entity: bool = True,
                        device="cpu") -> Dict[str, Any]:
    """The packed index split for ``n_shards`` (the JAX layout): row arrays
    padded to a shard multiple (``n_pad`` rows, ``n_local`` per shard); the
    CSR re-cut per document range and stacked on a leading shard axis,
    each term's postings in their contribution order. ``emb`` is a tensor
    on ``device``: normalized as the single-device engine does, in the
    index's storage dtype, zero rows past N. The rest is host numpy."""
    bm = index.bm25
    N = index.n_docs
    V = max(len(bm.row_ptr) - 1, 0)
    n_pad = -(-max(N, 1) // n_shards) * n_shards
    n_local = n_pad // n_shards

    emb = normalized_embeddings(index, device)
    d = emb.shape[1] if emb.dim() == 2 and emb.numel() else (
        index.embed_dim or 64)
    emb_pad = torch.zeros((n_pad, d), dtype=emb.dtype, device=emb.device)
    if emb.numel():
        emb_pad[:N] = emb

    doc_ids = np.asarray(bm.doc_ids, dtype=np.int64)
    scores = np.asarray(bm.ensure_scores(), dtype=np.float32)
    row_ptr = np.asarray(bm.row_ptr, dtype=np.int64)
    term_of = (np.repeat(np.arange(V), np.diff(row_ptr))
               if doc_ids.size else np.zeros(0, dtype=np.int64))
    csr_ids: List[np.ndarray] = []
    csr_scores: List[np.ndarray] = []
    csr_rp: List[np.ndarray] = []
    for sh in range(n_shards):
        lo, hi = sh * n_local, (sh + 1) * n_local
        mask = (doc_ids >= lo) & (doc_ids < hi)
        csr_ids.append((doc_ids[mask] - lo).astype(np.int32))
        csr_scores.append(scores[mask])
        rp = np.zeros(V + 1, dtype=np.int32)
        if V:
            rp[1:] = np.cumsum(np.bincount(term_of[mask], minlength=V))
        csr_rp.append(rp)
    nnz_max = max((a.shape[0] for a in csr_ids), default=0) + 1
    ids_stack = np.zeros((n_shards, nnz_max), dtype=np.int32)
    sc_stack = np.zeros((n_shards, nnz_max), dtype=np.float32)
    for sh in range(n_shards):
        ids_stack[sh, : csr_ids[sh].shape[0]] = csr_ids[sh]
        sc_stack[sh, : csr_scores[sh].shape[0]] = csr_scores[sh]

    dt, ds = bm.doc_major_padded(doc_cap)
    dt_pad = np.full((n_pad, dt.shape[1] if dt.ndim == 2 else doc_cap), -2,
                     dtype=np.int32)
    ds_pad = np.zeros_like(dt_pad, dtype=np.float32)
    if dt.size:
        dt_pad[:N] = dt
        ds_pad[:N] = ds

    nxt = np.ascontiguousarray(index.graph_next)
    if include_entity and index.graph_entity.size:
        nbrs = np.concatenate(
            [nxt, np.ascontiguousarray(index.graph_entity)], axis=1)
    else:
        nbrs = nxt
    deg = nbrs.shape[1] if nbrs.ndim == 2 and nbrs.size else 1
    nbrs_pad = np.full((n_pad, deg), -1, dtype=np.int32)
    if nbrs.size:
        nbrs_pad[:N] = nbrs

    return {
        "emb": emb_pad, "csr_doc_ids": ids_stack, "csr_scores": sc_stack,
        "csr_row_ptr": np.stack(csr_rp, axis=0), "doc_terms": dt_pad,
        "doc_scores": ds_pad, "nbrs": nbrs_pad, "n_docs": N, "n_pad": n_pad,
        "n_local": n_local, "vocab_size": V,
    }


class _ShardedPending:
    """A dispatched sharded batch: `PendingQuery` plus the shard count in
    the diagnostics."""

    def __init__(self, inner: PendingQuery, n_shards: int):
        self._inner = inner
        self._n_shards = n_shards

    @property
    def _sync_timing(self):
        return self._inner._sync_timing

    @_sync_timing.setter
    def _sync_timing(self, v):
        self._inner._sync_timing = v

    def result(self) -> QueryResult:
        r = self._inner.result()
        r.diagnostics["n_shards"] = self._n_shards
        return r


class ShardedHybridEngine(TorchQueryEngine):
    """`TorchQueryEngine`'s query semantics and public API (``query_batch``,
    ``query_batch_async`` with ``prepruned`` and ``pool_k``,
    ``query_batches_pipelined``, ``hydrate_hits``), the index rows sharded
    over the mesh's ``axis`` (dense-only retrieval over shards is
    `parallel.sharded_engine.ShardedDenseEngine`). ``device`` is the
    first position's; the encoder embeds there. The text channel is BM25
    (``sparse_impl="splade"`` is single-device). Its own ``__init__`` and
    `_upload` place the index on the shards; the base class's upload the
    whole index to one device and are not called."""

    def __init__(self, index: PackedIndex, *,
                 mesh: Optional[DeviceMesh] = None, axis: str = "data",
                 encoder: Optional[Any] = None,
                 config: Optional[EngineConfig] = None,
                 sink: Optional[Any] = None):
        self.index = index
        self.sink = sink
        self._check_nans = os.environ.get("AMRF_DEBUG_NANS") == "1"
        self.mesh = mesh or build_mesh({axis: -1})
        self.axis = axis
        self.dp_axes = tuple(a for a in self.mesh.axis_names if a != axis)
        self._groups = self.mesh.groups(axis)
        self._dp_size = len(self._groups)
        self.device = require_device(self._groups[0][0])
        self.config = config or EngineConfig()
        cfg = self.config
        if cfg.graph_impl not in ("auto", "dense", "compact"):
            raise ValueError(f"unknown graph_impl {cfg.graph_impl!r}")
        if cfg.sparse_impl != "bm25":
            raise ValueError("the sharded engine's text channel is BM25 "
                             f"(sparse_impl={cfg.sparse_impl!r})")
        self.encoder = encoder or HashEmbedEncoder(dim=index.embed_dim or 64)
        enc_device = getattr(self.encoder, "device", self.device)
        if enc_device != self.device:
            raise ValueError(f"the encoder's parameters are on {enc_device} "
                             f"but the engine's lead device is {self.device}")
        self._n = index.n_docs
        self._splade_enc = None
        self._splade_index = None
        self._high_df_terms = build_high_df_terms(
            index.bm25, cfg.query_df_ratio_max, self._n)
        self._upload()
        vocab = _native.NativeVocab(index.bm25.vocab)
        self._native_vocab = vocab if vocab.available else None
        self._prep_pool = None

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def _upload(self) -> None:
        """Each shard's rows to its position's device, once per (device,
        shard) however many groups share it."""
        cfg = self.config
        host = shard_hybrid_arrays(self.index, self.n_shards,
                                   doc_cap=cfg.bm25_doc_cap,
                                   include_entity=cfg.include_entity_graph,
                                   device=self.device)
        if self._check_nans:
            check_index_finite(host["emb"])
        self._n_local, self._n_pad = host["n_local"], host["n_pad"]
        self._topm = min(cfg.bm25_term_topm,
                         max(int(host["csr_doc_ids"].shape[1]), 1))
        nl = self._n_local
        placed: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        self._shards: List[List[Dict[str, Any]]] = []
        for group in self._groups:
            row = []
            for sh, dev in enumerate(group):
                key = (dev, sh)
                if key not in placed:
                    rows = slice(sh * nl, (sh + 1) * nl)
                    placed[key] = {
                        "device": dev,
                        "emb": host["emb"][rows].to(dev),
                        "csr_ids": to_device(host["csr_doc_ids"][sh], dev),
                        "csr_sc": to_device(host["csr_scores"][sh], dev),
                        "csr_rp": to_device(host["csr_row_ptr"][sh], dev),
                        "doc_terms": to_device(host["doc_terms"][rows], dev),
                        "doc_scores": to_device(host["doc_scores"][rows],
                                                dev),
                        "nbrs": to_device(host["nbrs"][rows], dev),
                    }
                row.append(placed[key])
            self._shards.append(row)
        self._alphas = {
            g[0]["device"]: torch.tensor(
                [cfg.alpha_text, cfg.alpha_graph, cfg.alpha_dense],
                dtype=torch.float32, device=g[0]["device"])
            for g in self._shards}

    def device_bytes(self) -> int:
        """Bytes of the index tensors over all positions (each placed
        shard counted once)."""
        seen = {id(a): a for g in self._shards for a in g}
        return int(sum(t.numel() * t.element_size() for a in seen.values()
                       for name, t in a.items() if name != "device"))

    def _bucket(self, b: int) -> int:
        B = super()._bucket(b)
        return -(-B // self._dp_size) * self._dp_size

    def _compact_form(self, B: int) -> bool:
        """The JAX sharded engine's rule: fusion is always pool-compact, so
        only the [B, N] buffer size decides under ``auto``."""
        cfg = self.config
        return cfg.graph_impl == "compact" or (
            cfg.graph_impl == "auto" and B * self._n * 4 > 256 << 20)

    # ---------------- the sharded program ----------------

    def _program(self, q_emb, term_ids, seed_rows, *, pool_k: int, k: int,
                 window: int, compact: bool, term_w=None):
        """The query batch's rows split over the data-parallel groups; each
        group's block through `_group_program`; the outputs concatenated
        on the lead device."""
        G = self._dp_size
        b = q_emb.shape[0] // G
        outs = []
        for g, shards in enumerate(self._shards):
            lead = shards[0]["device"]
            rows = slice(g * b, (g + 1) * b)
            outs.append(self._group_program(
                shards, q_emb[rows].to(lead), term_ids[rows].to(lead),
                None if seed_rows is None else seed_rows[rows].to(lead),
                pool_k=pool_k, k=k, window=window, compact=compact))
        if G == 1:
            return outs[0]
        return tuple(all_gather(parts, self.device, dim=0)
                     for parts in zip(*outs))

    def _group_program(self, shards, q_emb, term_ids, seed_rows, *,
                       pool_k: int, k: int, window: int, compact: bool):
        cfg = self.config
        n, nl, n_pad = self._n, self._n_local, self._n_pad
        lead = shards[0]["device"]

        # ---- text: local pool + exact local re-score, merged ----
        p_loc = min(pool_k, nl)
        loc_s, loc_i = [], []
        for sh, a in enumerate(shards):
            dev, lo = a["device"], sh * nl
            t_ids = term_ids.to(dev)
            with stage("engine/bm25_pool"):
                p_s, p_i = bm25_topk_sorted(
                    t_ids, a["csr_ids"], a["csr_sc"], a["csr_rp"],
                    n_docs=nl, term_topm=self._topm, pool_k=p_loc)
                pad = p_loc - p_s.shape[1]
                if pad > 0:
                    p_i = torch.nn.functional.pad(p_i, (0, pad), value=-1)
            with stage("engine/bm25_rescore"):
                p_s = bm25_rescore_pool(p_i, t_ids, a["doc_terms"],
                                        a["doc_scores"], n_docs=nl)
            lvalid = (p_s > 0) & (p_i >= 0)
            ls = torch.where(lvalid, p_s, torch.zeros_like(p_s))
            gl_i = torch.where(lvalid, p_i + lo, torch.full_like(p_i, -1))
            if pool_k > p_loc:
                ls = torch.nn.functional.pad(ls, (0, pool_k - p_loc))
                gl_i = torch.nn.functional.pad(gl_i, (0, pool_k - p_loc),
                                               value=-1)
            loc_s.append(ls)
            loc_i.append(gl_i)
        with stage("engine/merge"):
            pool_s, pool_i = merge_topk(loc_s, loc_i, pool_k, lead)
        pool_valid = (pool_s > 0) & (pool_i >= 0)

        # ---- dense: owned pool rows scored locally, summed ----
        with stage("engine/dense"):
            qn = q_emb / torch.clamp(
                torch.sqrt(torch.sum(q_emb * q_emb, dim=1, keepdim=True)),
                min=1e-9)
            parts = []
            for sh, a in enumerate(shards):
                dev, lo = a["device"], sh * nl
                pi = pool_i.to(dev)
                owned = pool_valid.to(dev) & (pi >= lo) & (pi < lo + nl)
                rows = torch.where(owned, pi - lo, torch.zeros_like(pi))
                dense = torch.einsum("bd,bkd->bk", qn.to(dev),
                                     a["emb"][rows.long()].float())
                parts.append(torch.where(owned, dense,
                                         torch.zeros_like(dense)))
            dense_pool = all_reduce_sum(parts, lead)

        # ---- graph seeds (the single-device engine's) ----
        S_eff = min(cfg.max_seed_rows, pool_k)
        if seed_rows is None:
            top_seed_s, seed_pos = stable_topk(pool_s, S_eff, dim=1)
            seed_ids = torch.gather(pool_i, 1, seed_pos)
            seed_ok = (top_seed_s > 0) & (seed_ids >= 0)
            if cfg.graph_seed_weighted:
                denom = torch.clamp(top_seed_s[:, :1], min=1e-9)
                seed_vals = torch.where(seed_ok, top_seed_s / denom,
                                        torch.zeros_like(top_seed_s))
            else:
                seed_vals = seed_ok.float()
        else:
            seed_ids = seed_rows
            seed_ok = seed_rows >= 0
            seed_vals = seed_ok.float()

        with stage("engine/graph"):
            if compact:
                def gather_rows(src_ids):
                    # each node's adjacency row lives on one shard: gather
                    # it there (-1 elsewhere) and max-reduce the shards
                    rows_parts = []
                    for sh, a in enumerate(shards):
                        dev, lo = a["device"], sh * nl
                        ids = src_ids.to(dev)
                        owned = (ids >= lo) & (ids < lo + nl)
                        local = torch.where(owned, ids - lo,
                                            torch.zeros_like(ids))
                        r = a["nbrs"][local.long()]
                        rows_parts.append(torch.where(
                            owned[:, :, None], r, torch.full_like(r, -1)))
                    return all_reduce_max(rows_parts, lead)

                g_pool_s, g_pool_i = expand_frontier_weighted_compact_core(
                    gather_rows, seed_ids, seed_vals, n_nodes=n,
                    window=window, cap=cfg.graph_compact_cap,
                    out_k=min(pool_k, n))
                g_valid = (g_pool_s > 0) & (g_pool_i >= 0)
                eq = pool_i[:, :, None] == torch.where(
                    g_valid, g_pool_i, torch.full_like(g_pool_i, -2)
                )[:, None, :]
                t_graph_raw = torch.amax(
                    torch.where(eq, g_pool_s[:, None, :],
                                torch.zeros((), device=eq.device)), dim=2)
            else:
                best = self._dense_waves(shards, seed_ids, seed_ok,
                                         seed_vals, window)
                g_pool_s, g_pos = stable_topk(best, min(pool_k, n_pad),
                                              dim=1)
                g_pool_i = g_pos.to(torch.int32)
                g_valid = (g_pool_s > 0) & (g_pool_i < n)
                t_graph_raw = torch.gather(
                    best, 1, pool_i.long().clamp(0, n_pad - 1))

        with stage("engine/fusion"):
            n_text = pool_valid.sum(dim=1)
            counts = torch.stack([n_text, g_valid.sum(dim=1), n_text], dim=1)
            top_s, top_i, norms_at = fuse_pools_compact(
                pool_s, pool_i, pool_valid, dense_pool, t_graph_raw,
                g_pool_s, g_pool_i, g_valid, alphas=self._alphas[lead], k=k,
                n=n)
            if cfg.order_alphas is not None:
                top_s, top_i, norms_at = reorder_hits(top_s, top_i, norms_at,
                                                      cfg.order_alphas)
        outputs = (top_s, top_i, norms_at, counts.to(torch.int32))
        if self._check_nans:
            outputs += (nan_flags(pool_s, dense_pool, g_pool_s, top_s,
                                  norms_at),)
        return outputs

    def _dense_waves(self, shards, seed_ids, seed_ok, seed_vals,
                     window: int) -> torch.Tensor:
        """[B, n_pad] f32 hop-decay scores of the dense form: the seed wave
        on the lead device, then per hop every shard's gather-max at its
        own rows and an `all_gather` of the new wave. The wave is cast to
        ``graph_wave_dtype`` once, before the hops; maxes are exact."""
        n, nl, n_pad = self._n, self._n_local, self._n_pad
        lead = shards[0]["device"]
        B = seed_ids.shape[0]
        decay = hop_decay_table(max(window, 0)).tolist()
        ok = seed_ok & (seed_ids < n)
        slot = torch.where(ok, seed_ids, torch.full_like(seed_ids, n_pad))
        wave = torch.zeros((B, n_pad + 1), dtype=torch.float32, device=lead)
        wave.scatter_reduce_(1, slot.long(), torch.where(
            ok, seed_vals, torch.zeros_like(seed_vals)), "amax")
        wave = wave[:, :n_pad]
        best = wave * decay[0]
        wdt = getattr(torch, self.config.graph_wave_dtype)
        wave = wave.to(wdt)
        # per shard, one column of neighbor ids per slot; -1 -> the dump
        # column n_pad, which holds 0
        cols = [torch.where(a["nbrs"] >= 0, a["nbrs"],
                            torch.full_like(a["nbrs"], n_pad)).long().T
                for a in shards]
        for h in range(1, max(window, 0) + 1):
            parts = []
            for a, shard_cols in zip(shards, cols):
                dev = a["device"]
                wp = torch.cat([wave.to(dev), torch.zeros(
                    (B, 1), dtype=wdt, device=dev)], dim=1)
                new = torch.zeros((B, nl), dtype=wdt, device=dev)
                for col in shard_cols:
                    torch.maximum(new, torch.index_select(wp, 1, col),
                                  out=new)
                parts.append(new)
            wave = all_gather(parts, lead, dim=1)
            best = torch.maximum(best, wave.float() * decay[h])
        return best

    # ---------------- public API ----------------

    def query_batch_async(self, queries, **kw) -> _ShardedPending:
        """`TorchQueryEngine.query_batch_async` over the shards; the result's
        diagnostics add ``n_shards``."""
        return _ShardedPending(super().query_batch_async(queries, **kw),
                               self.n_shards)


# ---------------- the dryrun contract ----------------


def _tie_free_corpus(n_docs: int = 40, seed: int = 11):
    """Random distinct-length sentences: BM25, dense and graph scores carry
    no exact tie groups, so pool membership is deterministic and the
    single-device and sharded engines must agree bit for bit. (The JAX
    package's copy builds the same corpus and queries.)"""
    import random

    from ..index.corpus import SentenceCorpus

    rng = random.Random(seed)
    words = [f"w{chr(97 + i % 26)}{i}" for i in range(160)]
    docs = []
    for di in range(n_docs):
        title = f"Doc {di}"
        for si in range(rng.randrange(2, 6)):
            n_tok = rng.randrange(4, 14)
            text = " ".join(rng.choice(words) for _ in range(n_tok))
            docs.append({"doc_id": f"{title}#{si}", "title": title,
                         "sent_id": si, "text": text})
    queries = []
    for _ in range(8):
        queries.append(" ".join(rng.choice(words)
                                for _ in range(rng.randrange(3, 7))))
    return SentenceCorpus(docs=docs), queries


DRYRUN_CONFIGS = (("dense", "float32", None), ("compact", "float32", None),
                  ("dense", "bfloat16", None),
                  ("compact", "float32", (0.4, 0.2, 0.4)))


def dryrun_config(graph_impl: str, wave_dtype: str, order) -> EngineConfig:
    """`dryrun_check`'s exact settings: ``bm25_term_topm`` covers every
    posting list; the fourth case is two-stage fusion."""
    kw = dict(top_k=10, pool_k=64, graph_window=2, bm25_term_topm=4096,
              batch_buckets=(8,), graph_pool_exact=True,
              graph_impl=graph_impl, graph_compact_cap=64,
              graph_wave_dtype=wave_dtype)
    if order:
        kw.update(alpha_text=0.15, alpha_graph=0.7, alpha_dense=0.15,
                  order_alphas=order)
    return EngineConfig(**kw)


def dryrun_check(mesh: DeviceMesh, *, atol: float = 1e-5) -> None:
    """Sharded hybrid == single-device engine on a tie-free corpus, in the
    four configurations of `DRYRUN_CONFIGS` and both seed modes (derived
    and explicit): identical ids, scores within ``atol``. The single
    engine runs on the mesh's first device. RuntimeError on a mismatch."""
    from ..index.builder import build_packed_index

    corpus, queries = _tie_free_corpus()
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    lead = mesh.devices.flat[0]
    seeds = [[(3 * i) % idx.n_docs, (7 * i + 1) % idx.n_docs]
             for i in range(len(queries))]
    for graph_impl, wave_dtype, order in DRYRUN_CONFIGS:
        cfg = dryrun_config(graph_impl, wave_dtype, order)
        single = TorchQueryEngine(idx, device=lead, config=cfg)
        sharded = ShardedHybridEngine(idx, mesh=mesh, config=cfg)
        for kw, mode in (({}, "derived seeds"),
                         ({"seed_rows": seeds}, "explicit seeds")):
            r1 = single.query_batch(queries, top_k=10, **kw)
            r2 = sharded.query_batch(queries, top_k=10, **kw)
            if not np.array_equal(r1.hits.ids, r2.hits.ids):
                raise RuntimeError(
                    f"sharded hybrid ids diverge from single-device "
                    f"({mode}, graph_impl={graph_impl}, "
                    f"wave {wave_dtype}, order {order})")
            if not np.allclose(r1.hits.scores, r2.hits.scores, atol=atol):
                raise RuntimeError(
                    f"sharded hybrid scores diverge from single-device "
                    f"({mode}, graph_impl={graph_impl}, "
                    f"wave {wave_dtype}, order {order})")
