"""Plain reference for the hotpot configurations: the same retrieval
semantics as the program under test, written out from their definitions
and computed from the generated samples alone.

It imports neither JAX nor the program. Everything the program derives
from the corpus (BM25 statistics and postings order, the entity and
next-in-doc graph, the hash and learned row embeddings) is worked out here
again from the samples the benchmark generated. Work that does not depend
on the question is done once per run (`HotpotReference`); the per-question
work touches only the rows a question reaches.

Precision. Every score is computed in the precision the configuration
states (float32 scores; embeddings stored in bfloat16; the learned trunk's
dense layers on bfloat16 operands with float32 sums) and the arithmetic is
routed through a rounding function ``rnd``. With ``rnd = bf16`` the same
code is the lower-precision control of the correctness check.

Semantics of the hybrid query (single pass, compact form), per question:

1. The query keeps its tokens whose document frequency is at most
   ``query_df_ratio_max * N`` plus the joined phrase tokens of its
   multi-word capitalized runs; its BM25 terms are the in-vocabulary tokens
   of that text, in order, at most ``max_query_terms``.
2. Text pool: each term occurrence contributes its first ``term_topm``
   postings (contribution descending, row ascending); a row's phase-1
   score is the sum of its contributions there; the pool is the best
   ``min(pool_k, T_eff * term_topm)`` rows by that score (row ascending on
   ties), ``T_eff`` being the batch's term width (a power of two, >= 8).
   Pool rows are then scored exactly (the sum over the query's term slots,
   in slot order).
3. Dense: cosine of the query's hash embedding against the pool rows.
4. Graph: the best 64 pool rows (pool order on ties) seed a frontier with
   strength score / best score; every hop propagates the best ``cap``
   wave rows (row ascending on ties) along the neighbour table; a row's
   graph score is the best seed strength times decay(hop) (1, 0.7, 0.5)
   over the hops that reach it; the graph pool is the best ``pool_k``.
5. Fusion: per-channel min-max over each channel's pool, alpha-weighted
   sum over the union of the text and graph pools (a text-pool row reads
   its graph value when it is in the graph pool), best ``top_k`` by fused
   score (row ascending on ties), then re-ordered by ``order_alphas``.
"""
from __future__ import annotations

import math
import os
import zlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hotpot_text import (augment, cap_runs, flatten, hash_counts,
                         phrase_tokens, scan, tokenize, word_ids)

F32 = np.float32
DECAY = (F32(1.0), F32(0.7), F32(0.5))


# ---------------- precision ----------------

def f32(x):
    return np.asarray(x, dtype=F32)


def bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), held in float32."""
    u = np.ascontiguousarray(np.asarray(x, dtype=F32)).view(np.uint32)
    r = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
         & np.uint32(0xFFFF0000))
    return r.view(F32).reshape(np.shape(x))


ROUNDING = {"float32": f32, "bfloat16": bf16}

# the engine settings whose semantics the hybrid reference writes out
SEMANTICS = {"bm25_impl": "sorted", "fusion_impl": "compact",
             "graph_impl": "compact", "dense_impl": "pool",
             "sparse_impl": "bm25", "include_entity_graph": True,
             "graph_seed_weighted": True, "frontier_cap": None}


# ---------------- hash embedding ----------------

def hash_vector(text: str, dim: int) -> np.ndarray:
    """Signed crc32 buckets of the tokens and token bigrams, as float32
    counts (exact small integers)."""
    toks = tokenize(text)
    acc = [0] * dim
    for feat in toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]:
        h = zlib.crc32(feat.encode("utf-8"))
        acc[h % dim] += 1 if (h >> 16) & 1 else -1
    return np.array(acc, dtype=F32)


def unit_f32(v: np.ndarray) -> np.ndarray:
    """v / max(||v||, 1e-9) in float32, the norm rounded once from an
    exact sum of squares (v holds small integers)."""
    norm = F32(math.sqrt(float(np.sum(v.astype(np.float64) ** 2))))
    return (v / max(norm, F32(1e-9))).astype(F32)


def hash_matrix(texts: Sequence[str], dim: int,
                stored: bool = False) -> np.ndarray:
    """[len(texts), dim] float32 unit hash embeddings (`unit_f32` row by
    row), with ``stored`` as the index stores rows (`stored_rows`)."""
    workers = min(8, os.cpu_count() or 1) if len(texts) >= 200_000 else 1
    counts = hash_counts(list(texts), dim, workers)
    norm = np.sqrt(np.sum(counts.astype(np.float64) ** 2, axis=1)).astype(F32)
    unit = (counts.astype(F32) / np.maximum(norm, F32(1e-9))[:, None])
    return stored_rows(unit) if stored else unit.astype(F32)


def renormalize(rows: np.ndarray) -> np.ndarray:
    """[M, d] float32 rows normalized in float32 with a 1e-9 floor."""
    t = torch.from_numpy(np.ascontiguousarray(rows, dtype=F32))
    n = torch.sqrt(torch.sum(t * t, dim=1, keepdim=True))
    return (t / torch.clamp(n, min=1e-9)).numpy()


def stored_rows(rows: np.ndarray) -> np.ndarray:
    """Unit float32 rows as the index stores them: rounded to bfloat16,
    normalized again in float32 and rounded to bfloat16."""
    return bf16(renormalize(bf16(rows)))


# ---------------- the corpus-wide tables ----------------

class HotpotReference:
    """The reference's own index over the generated samples.

    ``needed_terms``: the tokens whose document frequency the questions can
    ask for (every token and phrase token of every question: a batch's
    term width depends on all of its questions); ``posting_terms``: those
    whose postings the questions to be answered ask for (by default the
    same). The scan records those alone."""

    ROUNDING = ROUNDING

    def __init__(self, samples: Sequence[dict], config: dict,
                 needed_terms: Optional[set] = None,
                 posting_terms: Optional[set] = None):
        idx, eng = config["index"], config["engine"]
        for key, want in SEMANTICS.items():
            if eng.get(key) != want:
                raise ValueError(f"the reference covers {key}={want!r}, "
                                 f"not {eng.get(key)!r}")
        self.cfg, self.eng = config, eng
        self.rows = flatten(samples)
        self.n = len(self.rows)
        self.row_of = {(t, s): i for i, (t, s, _) in enumerate(self.rows)}
        self.k1, self.b = float(idx["bm25_k1"]), float(idx["bm25_b"])
        self.max_degree = int(idx["graph_max_degree"])
        self.chain_cap = int(idx.get("entity_chain_cap", 64))
        if needed_terms is None:
            needed_terms = set()
            for s in samples:
                q = s["question"]
                needed_terms.update(tokenize(q))
                needed_terms.update(phrase_tokens(q))
        self._scan(needed_terms, needed_terms if posting_terms is None
                   else posting_terms & needed_terms)
        self._hash_cache: Dict[int, np.ndarray] = {}

    def _scan(self, needed: set, post_terms: set) -> None:
        """One pass over the rows (`hotpot_text.scan`): token-stream
        lengths, document frequencies and postings of the needed terms
        (none for a term past the pruning threshold: it never scores), and
        each entity's first ``entity_chain_cap`` rows."""
        n = self.n
        ratio = float(self.eng.get("query_df_ratio_max", 0.0))
        workers = min(8, os.cpu_count() or 1) if n >= 200_000 else 1
        dl, dfs, post, ent_rows = scan(
            [t for _, _, t in self.rows], needed, post_terms,
            ratio * n if ratio else float("inf"), self.chain_cap, workers)
        self.dl = np.array(dl, dtype=np.int64)
        self.avgdl = (float(self.dl.sum()) / n) if n else 1.0
        self.dfs = dfs
        self.post = post
        self.post_terms = post_terms
        self.ent_rows = ent_rows
        self.ent_order = {e: j for j, e in enumerate(ent_rows)}
        self._nbr_cache: Dict[int, List[int]] = {}
        self._sorted_post: Dict[str, List[Tuple[float, int]]] = {}

    def row_entities(self, row: int) -> List[str]:
        """The row's entities that list it among their first rows."""
        return [e for e in dict.fromkeys(cap_runs(self.rows[row][2]))
                if row in self.ent_rows[e]]

    # ---- BM25 ----

    def df(self, term: str) -> int:
        return self.dfs.get(term, 0)

    def contribution(self, term: str, row: int, tf: int) -> F32:
        """BM25 contribution, in double and rounded once to float32."""
        df = float(self.df(term))
        idf = math.log((self.n - df + 0.5) / (df + 0.5) + 1.0)
        denom = tf + self.k1 * (1.0 - self.b + self.b * float(self.dl[row])
                                / (self.avgdl if self.avgdl > 0 else 1.0))
        return F32(idf * tf * (self.k1 + 1.0) / (denom or 1.0))

    def postings(self, term: str) -> List[Tuple[F32, int]]:
        """The term's postings, contribution descending, row ascending."""
        got = self._sorted_post.get(term)
        if got is None:
            if self.high_df(term):
                raise ValueError(f"{term!r} passes the pruning threshold; "
                                 f"the reference keeps no postings for it")
            if term not in self.post_terms:
                raise KeyError(f"the scan recorded no postings of {term!r}")
            # `contribution` over every posting at once: the same double
            # operations in the same order, rounded once to float32
            rows_tf = self.post.get(term, {})
            rows = np.fromiter(rows_tf.keys(), np.int64, len(rows_tf))
            tf = np.fromiter(rows_tf.values(), np.float64, len(rows_tf))
            df = float(self.df(term))
            idf = math.log((self.n - df + 0.5) / (df + 0.5) + 1.0)
            avg = self.avgdl if self.avgdl > 0 else 1.0
            denom = tf + self.k1 * (1.0 - self.b + self.b
                                    * self.dl[rows].astype(np.float64) / avg)
            c = (idf * tf * (self.k1 + 1.0) / denom).astype(F32)
            order = np.lexsort((rows, -c))
            got = list(zip(c[order].tolist(), rows[order].tolist()))
            got = [(F32(v), r) for v, r in got]
            self._sorted_post[term] = got
        return got

    def row_contribution(self, term: str, row: int) -> F32:
        if term not in self.post_terms:
            raise KeyError(f"the scan recorded no postings of {term!r}")
        tf = self.post.get(term, {}).get(row, 0)
        return self.contribution(term, row, tf) if tf else F32(0.0)

    def high_df(self, term: str) -> bool:
        ratio = float(self.eng.get("query_df_ratio_max", 0.0))
        return bool(ratio) and self.df(term) > ratio * self.n

    def prune(self, q: str) -> str:
        if not float(self.eng.get("query_df_ratio_max", 0.0)) or not q:
            return q
        kept = [t for t in tokenize(q) if not self.high_df(t)]
        if not q.islower():
            kept += [p for p in phrase_tokens(q) if not self.high_df(p)]
        return " ".join(kept) if kept else q

    def terms(self, pruned: str) -> List[str]:
        return [t for t in tokenize(augment(pruned))
                if self.df(t) > 0][: int(self.eng["max_query_terms"])]

    def term_width(self, most_terms: int) -> int:
        """A batch's term width: the smallest power of two >= 8 that holds
        its longest question's ``most_terms`` terms, at most
        ``max_query_terms``."""
        t = 8
        while t < most_terms:
            t *= 2
        return min(t, int(self.eng["max_query_terms"]))

    # ---- graph ----

    def neighbours(self, row: int) -> List[int]:
        """The row's neighbour list: its next-in-doc links (two slots) then
        its entity links (at most ``graph_max_degree``), each list the first
        distinct rows in the order the links are made."""
        got = self._nbr_cache.get(row)
        if got is not None:
            return got
        title, sid, _ = self.rows[row]
        links = []  # (step at which the link is made, other row)
        prev = self.row_of.get((title, sid - 1))
        nxt = self.row_of.get((title, sid + 1))
        if prev is not None and prev != row:
            links.append((prev, prev))
        if nxt is not None and nxt != row:
            links.append((row, nxt))
        nd: List[int] = []
        for _, other in sorted(links):
            if len(nd) < 2 and (not nd or nd[0] != other):
                nd.append(other)
        ent: List[int] = []
        # entities in order of first appearance; each links its first row
        # (the hub) to every later row, then each row to the next one
        for e in sorted(self.row_entities(row),
                        key=self.ent_order.__getitem__):
            rows = self.ent_rows[e]
            j = rows.index(row)
            if j == 0:
                seq = rows[1:]
            else:
                seq = [rows[0], rows[j - 1]] + rows[j + 1:j + 2]
            for other in seq:
                if other != row and len(ent) < self.max_degree \
                        and other not in ent:
                    ent.append(other)
        got = nd + ent
        self._nbr_cache[row] = got
        return got

    # ---- embeddings ----

    def hash_rows(self, rows: Sequence[int], dim: int) -> np.ndarray:
        """[M, dim] stored hash embeddings of corpus rows."""
        miss = [r for r in rows if r not in self._hash_cache]
        if miss:
            vecs = np.stack([unit_f32(hash_vector(self.rows[r][2], dim))
                             for r in miss])
            for r, v in zip(miss, stored_rows(vecs)):
                self._hash_cache[r] = v
        return np.stack([self._hash_cache[r] for r in rows]) if rows else \
            np.zeros((0, dim), F32)

    # ---- the hybrid query ----

    def hybrid(self, question: str, term_width: int, *,
               rnd: Callable = f32) -> dict:
        """One question through the hybrid semantics (module docstring).
        Returns the fused and order score of every union row and the
        ``top_k`` hits: {"fused": {row: f}, "order": {row: o},
        "hits": [rows], "scores": [order scores]}."""
        eng = self.eng
        m = int(eng["bm25_term_topm"])
        pool_k = int(eng["pool_k"])
        k = int(eng["top_k"])
        pruned = self.prune(question)
        terms = self.terms(pruned)

        # text pool: phase-1 windows, then the exact re-score
        p1: Dict[int, F32] = defaultdict(lambda: F32(0.0))
        for t in terms:
            for c, r in self.postings(t)[:m]:
                p1[r] = rnd(p1[r] + rnd(c))
        K = min(pool_k, term_width * m)
        pool = sorted((r for r, s in p1.items() if s > 0),
                      key=lambda r: (-p1[r], r))[:K]
        exact = []
        for r in pool:
            acc = F32(0.0)
            for t in terms:
                acc = rnd(acc + rnd(self.row_contribution(t, r)))
            exact.append(acc)
        exact = np.array(exact, dtype=F32)
        valid = exact > 0

        # dense channel over the pool
        dim = int(self.cfg["index"]["embed_dim"])
        q = renormalize(unit_f32(hash_vector(pruned, dim))[None, :])[0]
        q = rnd(q)
        emb = rnd(self.hash_rows(pool, dim))
        dense = (rnd(np.sum(rnd(emb * q[None, :]), axis=1)) if pool
                 else np.zeros(0, F32))
        dense = np.where(valid, dense, F32(0.0)).astype(F32)

        # graph channel
        seed_order = sorted(range(len(pool)), key=lambda j: -exact[j])
        seed_order = [j for j in seed_order if valid[j]][
            : min(int(eng.get("max_seed_rows", 64)), pool_k)]
        graph: Dict[int, F32] = {}
        if seed_order:
            top = max(exact[seed_order[0]], F32(1e-9))
            wave = [(pool[j], rnd(exact[j] / top)) for j in seed_order]
            cap = int(eng["graph_compact_cap"])
            window = int(eng["graph_window"])
            best: Dict[int, F32] = {}

            def keep(r, v):
                if v > best.get(r, F32(-1.0)):
                    best[r] = v

            for r, v in wave:
                if v > 0:
                    keep(r, rnd(v * DECAY[0]))
            for h in range(1, window + 1):
                src = sorted(wave, key=lambda x: -x[1])[:cap]
                reached: Dict[int, F32] = {}
                for r, v in src:
                    if v <= 0:
                        continue
                    for o in self.neighbours(r):
                        if v > reached.get(o, F32(-1.0)):
                            reached[o] = v
                wave = sorted(reached.items())
                for r, v in wave:
                    keep(r, rnd(v * DECAY[h]))
            graph = dict(sorted(best.items(), key=lambda x: (-x[1], x[0]))
                         [: min(pool_k, self.n)])
            graph = {r: v for r, v in graph.items() if v > 0}

        return self._fuse(pool, exact, valid, dense, graph, k, rnd)

    def _fuse(self, pool, exact, valid, dense, graph, k, rnd) -> dict:
        eng = self.eng
        a_t, a_g, a_d = (F32(eng["alpha_text"]), F32(eng["alpha_graph"]),
                         F32(eng["alpha_dense"]))

        def minmax(vals: np.ndarray):
            if not len(vals):
                return vals
            lo, hi = vals.min(), vals.max()
            span = rnd(hi - lo)
            if not span > 0:
                return np.zeros_like(vals)
            return rnd(rnd(vals - lo) / span)

        nt = np.zeros(len(pool), F32)
        nd = np.zeros(len(pool), F32)
        nt[valid] = minmax(exact[valid])
        nd[valid] = minmax(dense[valid])
        g_ids = list(graph)
        g_vals = np.array([graph[r] for r in g_ids], F32)
        ng_pool = minmax(g_vals)
        norms: Dict[int, Tuple[F32, F32, F32]] = {}
        fused: Dict[int, F32] = {}
        if len(g_vals):
            g_lo, g_hi = g_vals.min(), g_vals.max()
            g_span = rnd(g_hi - g_lo)
        for j, r in enumerate(pool):
            if not valid[j]:
                continue
            raw = graph.get(r, F32(0.0))
            ng = F32(0.0)
            if raw > 0 and len(g_vals) and raw >= g_lo and g_span > 0:
                ng = rnd(rnd(raw - g_lo) / g_span)
            fused[r] = rnd(rnd(rnd(a_t * nt[j]) + rnd(a_g * ng))
                           + rnd(a_d * nd[j]))
            norms[r] = (nt[j], ng, nd[j])
        for r, ng in zip(g_ids, ng_pool):
            if r not in fused:
                fused[r] = rnd(a_g * ng)
                norms[r] = (F32(0.0), ng, F32(0.0))
        top = sorted(fused, key=lambda r: (-fused[r], r))[:k]
        o_t, o_g, o_d = (F32(a) for a in eng.get("order_alphas")
                         or (eng["alpha_text"], eng["alpha_graph"],
                             eng["alpha_dense"]))
        order = {r: rnd(rnd(rnd(norms[r][0] * o_t) + rnd(norms[r][1] * o_g))
                        + rnd(norms[r][2] * o_d)) for r in fused}
        hits = sorted(top, key=lambda r: -order[r])  # stable: fused order
        return {"fused": fused, "order": order, "hits": hits,
                "scores": [order[r] for r in hits]}


# ---------------- the learned encoder ----------------

def word_features(word: str, vocab: int, G: int, nmin: int, nmax: int
                  ) -> List[int]:
    """A word's G feature buckets: the word, then the char n-grams of
    "<word>" (n = nmin..nmax, left to right), repeated cyclically to G."""
    feats = [zlib.crc32(word.encode()) % vocab]
    wrapped = f"<{word}>"
    for n in range(nmin, nmax + 1):
        for a in range(len(wrapped) - n + 1):
            if len(feats) >= G:
                break
            feats.append(zlib.crc32(wrapped[a:a + n].encode()) % vocab)
        if len(feats) >= G:
            break
    return (feats * (G // len(feats) + 1))[:G]


class EncoderTokens:
    """Texts -> (ids [B, L, G] int64, mask [B, L] float32): each word's G
    feature buckets (`word_features`), looked up by word."""

    def __init__(self, enc: dict):
        self.V, self.L = int(enc["vocab_size"]), int(enc["max_len"])
        self.G = int(enc["subword_ngrams"])
        self.nmin, self.nmax = int(enc["ngram_min"]), int(enc["ngram_max"])

    def word_ids(self, texts: Sequence[str], workers: int = 1):
        """(feature table [W + 1, G] int64 with row 0 for padding, word
        ids [B, L] int64, mask [B, L] float32)."""
        words, wid, lens = word_ids(list(texts), self.L, workers)
        table = torch.tensor(
            [[0] * self.G] + [word_features(w, self.V, self.G, self.nmin,
                                            self.nmax) for w in words],
            dtype=torch.int64)
        mask = (torch.arange(self.L)[None, :]
                < torch.from_numpy(lens)[:, None]).float()
        return table, torch.from_numpy(wid).long(), mask

    def __call__(self, texts: Sequence[str]) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        table, wid, mask = self.word_ids(texts)
        return table[wid], mask


def round_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32; an 8-bit float
    scales the tensor by its largest magnitude first (per tensor, as an
    fp8 GEMM path does)."""
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        scale = torch.finfo(dtype).max / x.abs().amax().clamp(min=1e-30)
        return (x * scale).to(dtype).float() / scale
    return x.to(dtype).float()


def encoder_forward(params: dict, ids: torch.Tensor, mask: torch.Tensor,
                    enc: dict, operand_dtype: torch.dtype) -> torch.Tensor:
    """The TextEncoder's forward in plain torch float32: every dense layer
    on operands rounded to ``operand_dtype`` with float32 sums, attention
    and softmax in float32, pre-norm blocks with a tanh-GELU MLP, a final
    LayerNorm (eps 1e-6), masked mean-pool and L2 normalization."""
    H = int(enc["n_heads"])

    def dense(x, w):
        return torch.matmul(round_operand(x, operand_dtype),
                            round_operand(w, operand_dtype))

    def ln(x, p):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-6) * p["g"] + p["b"]

    x = params["tok_emb"][ids].mean(dim=2) + params["pos_emb"][None,
                                                               : ids.shape[1]]
    B, L, D = x.shape
    dh = D // H
    neg = torch.finfo(torch.float32).min
    for lay in params["layers"]:
        h = ln(x, lay["ln1"])
        q, k, v = dense(h, lay["wqkv"]).split(D, dim=-1)
        q, k, v = (t.reshape(B, L, H, dh).transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(q, k.transpose(-1, -2)) / (dh ** 0.5)
        logits = torch.where(mask[:, None, None, :] > 0, logits,
                             torch.full_like(logits, neg))
        att = torch.matmul(torch.softmax(logits, dim=-1), v)
        x = x + dense(att.transpose(1, 2).reshape(B, L, D), lay["wo"])
        h = ln(x, lay["ln2"])
        u = dense(h, lay["w1"])
        u = 0.5 * u * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                        * (u + 0.044715 * u ** 3)))
        x = x + dense(u, lay["w2"])
    x = ln(x, params["out_ln"])
    m = mask[:, :, None]
    pooled = (x * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
    n = torch.sqrt((pooled * pooled).sum(-1, keepdim=True))
    return pooled / torch.clamp(n, min=1e-9)


def embed_texts(params: dict, texts: Sequence[str], enc: dict, device,
                operand_dtype, block: int = 16384) -> torch.Tensor:
    """[len(texts), d] float32 unit embeddings on ``device``, the trunk run
    in blocks of rows."""
    workers = min(8, os.cpu_count() or 1) if len(texts) >= 200_000 else 1
    table, wid, mask = EncoderTokens(enc).word_ids(texts, workers)
    table = table.to(device)
    out = []
    with torch.no_grad():
        for i in range(0, len(texts), block):
            out.append(encoder_forward(params, table[wid[i:i + block]
                                                     .to(device)],
                                       mask[i:i + block].to(device), enc,
                                       operand_dtype))
    return torch.cat(out) if out else torch.zeros(
        (0, int(enc["d_model"])), device=device)


def store_bf16(rows: torch.Tensor) -> torch.Tensor:
    """Unit float32 rows as the index stores them (bfloat16, normalized
    again in float32, bfloat16)."""
    e = rows.to(torch.bfloat16).float()
    n = torch.sqrt(torch.sum(e * e, dim=1, keepdim=True))
    return (e / torch.clamp(n, min=1e-9)).to(torch.bfloat16)


def dense_scores(q: torch.Tensor, rows_bf16: torch.Tensor, k: int,
                 query_dtype: torch.dtype = torch.float32,
                 block: int = 1 << 18) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k cosine of float32 queries (rounded to ``query_dtype``)
    against bfloat16 rows, in float32 (no TF32), over row blocks:
    (scores [B, k], ids [B, k]), best first, row ascending on ties."""
    qn = q / torch.clamp(torch.sqrt((q * q).sum(1, keepdim=True)), min=1e-9)
    qn = qn.to(query_dtype).float()
    best_s = best_i = None
    for s in range(0, rows_bf16.shape[0], block):
        sc = qn @ rows_bf16[s:s + block].float().T
        ids = torch.arange(s, s + sc.shape[1], device=sc.device).expand_as(sc)
        if best_s is not None:
            sc = torch.cat([best_s, sc], 1)
            ids = torch.cat([best_i, ids], 1)
        # ties: the lower row first (ids ascend along the concatenation)
        o = torch.sort(sc, dim=1, descending=True, stable=True).indices[:, :k]
        best_s, best_i = sc.gather(1, o), ids.gather(1, o)
    return best_s, best_i


def row_scores(q: torch.Tensor, rows_bf16: torch.Tensor,
               hit_ids: torch.Tensor) -> torch.Tensor:
    """float32 cosine of each query against its own hit rows [B, k]."""
    qn = q / torch.clamp(torch.sqrt((q * q).sum(1, keepdim=True)), min=1e-9)
    e = rows_bf16[hit_ids.clamp(min=0)].float()
    return torch.einsum("bd,bkd->bk", qn, e)
