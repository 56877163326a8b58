"""Iterative multi-hop retrieval: bridge-entity query reformulation (port
of ``a_modular_rag_framework_tpu/modules/retrieval/multihop.py``, whose
module imports the jax hash encoder for ``tokenize``; this copy takes the
port's ``tokenize`` and ``prune_query`` and returns the port's
``QueryResult``, and is otherwise the same code, quirks included: a falsy
``hop2_max_bridges`` means 4, and ``hop2_pool_k`` reaches the engine as
``pool_k``).

Single-pass hybrid retrieval structurally misses hop-2 evidence whose text
shares nothing with the question ("A worked with B" is findable; "B was born
in X" is not). This module adds the standard multi-hop dense-retrieval
recipe (cf. Multi-Hop Dense Retrieval / TreeHop, PAPERS.md): after hop 1,
extract the NEW entities its top hits introduce, reformulate a hop-2 query
per original question, run ONE more batched engine call, and max-merge the
decayed hop-2 hits into the result.

Everything stays batched: B questions produce B hop-2 queries executed as a
single device program; the host work is entity extraction over the top-H
hit texts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...core.dto import HitBatch
from ...engine.host_prep import prune_query
from ...engine.query_engine import QueryResult
from ...models.hash_embed import tokenize
from ...utils.textspan import capitalized_runs

_QUESTION_WORDS = {"Where", "What", "Who", "Which", "When", "Why", "How",
                   "In", "The", "Is", "Was", "Were", "Are", "Did", "Does",
                   "Do", "A", "An"}


def doc_bridge_runs(text: str, known_titles: Optional[set]) -> List[tuple]:
    """Query-INDEPENDENT half of bridge extraction for one document text:
    capitalized runs filtered to corpus titles (a bridge is by definition
    the name of another document) minus question-word false starts, each
    paired with its frozen token set. `_prep_and_dispatch_hop2` caches this
    per doc id — re-deriving it per (query, text) pair was the dominant
    host cost of the iterative mode (~20 texts x B extractions per
    batch)."""
    out = []
    for e in capitalized_runs(text or ""):
        if e in _QUESTION_WORDS:
            continue
        if known_titles is not None and e not in known_titles:
            continue
        out.append((e, frozenset(tokenize(e))))
    return out


def bridge_entities(query: str, hit_texts: Sequence[str],
                    max_entities: int = 4,
                    known_titles: Optional[set] = None,
                    text_runs: Optional[Sequence[Sequence[tuple]]] = None,
                    q_ents: Optional[List[str]] = None,
                    q_tokens: Optional[set] = None,
                    hit_titles: Optional[Sequence[str]] = None,
                    ) -> List[str]:
    """Bridge candidates: proper-noun spans co-occurring with a FULL question
    entity phrase in hop-1 evidence.

    Two filters kill the noise that sinks naive frequency ranking:
      - the sentence must be ANCHORED to a question entity: the entity
        phrase appears in the text, or (when ``hit_titles`` is given)
        overlaps the sentence's own document title. The title clause is
        what natural discourse needs — a document's later sentences
        rarely repeat their subject ("The black-and-white horror classic
        was directed by Alfred Hitchcock" never says "Psycho"), but they
        live in the document the question names;
      - when ``known_titles`` is given, the span must be a document title in
        the corpus — a bridge is by definition the name of another document
        (this also drops sentence-initial capitalized words like "Later").
    Ranked by (co-occurrence count, earliest hit).

    ``text_runs`` (parallel to ``hit_texts``) carries each text's
    pre-extracted `doc_bridge_runs`; when given, the per-text extraction
    and the title/question-word filters are skipped here (already applied
    at cache build)."""
    if q_ents is None:
        q_ents = [e for e in capitalized_runs(query)
                  if e not in _QUESTION_WORDS]
    if q_tokens is None:
        q_tokens = set(tokenize(query))
    counts: Dict[str, int] = {}
    first_seen: Dict[str, int] = {}
    for rank, text in enumerate(hit_texts):
        text = text or ""
        if q_ents and not any(qe in text for qe in q_ents):
            title = (hit_titles[rank] or "") if hit_titles is not None \
                else ""
            if not (title and any(qe in title or title in qe
                                  for qe in q_ents)):
                continue  # not a true hop-1 sentence
        if text_runs is not None:
            cands = text_runs[rank]
        else:
            cands = doc_bridge_runs(text, known_titles)
        for e, e_tokens in cands:
            if e in q_ents:
                continue
            if any(e in qe or qe in e for qe in q_ents):
                continue  # substring of a question entity, not a bridge
            if e_tokens <= q_tokens:
                continue
            counts[e] = counts.get(e, 0) + 1
            first_seen.setdefault(e, rank)
    ranked = sorted(counts, key=lambda e: (-counts[e], first_seen[e]))
    return ranked[:max_entities]


def hop2_queries_for(query: str, bridges: Sequence[str],
                     max_variants: int = 3,
                     q_ents: Optional[Sequence[str]] = None) -> List[str]:
    """One hop-2 query PER bridge entity (bridge + the question's predicate
    words); the engine max-merges them as BM25 variants, so a wrong bridge
    can't dilute a right one."""
    if q_ents is None:
        q_ents = [e for e in capitalized_runs(query)
                  if e not in _QUESTION_WORDS]
    ent_tokens = set(tokenize(" ".join(q_ents)))
    predicates = [t for t in tokenize(query)
                  if t not in ent_tokens and len(t) > 2]
    pred = " ".join(predicates)
    return [f"{b} {pred}".strip() for b in list(bridges)[:max_variants]]


def iterative_retrieve(
    engine,
    queries: Sequence[str],
    *,
    top_k: int,
    hop1_inspect: int = 20,
    hop_decay: float = 0.5,
    hop2_reserve: Optional[int] = None,
    max_bridge_entities: Optional[int] = None,
    expansions: Optional[Sequence[Sequence[str]]] = None,
    seed_rows: Optional[Sequence[Sequence[int]]] = None,
    graph_window: Optional[int] = None,
    trace_id: str = "",
):
    """Two-hop batched retrieval. Returns (ids [B, K], scores [B, K],
    norms [B, 3, K], diagnostics) with hop-2 hits folded in at ``hop_decay``
    of their score (max-merge on duplicates)."""
    r1 = engine.query_batch(list(queries), expansions=expansions,
                            seed_rows=seed_rows, top_k=max(top_k, hop1_inspect),
                            graph_window=graph_window, trace_id=trace_id)
    ctx, p2 = _prep_and_dispatch_hop2(
        engine, list(queries), r1, top_k=top_k, hop1_inspect=hop1_inspect,
        max_bridge_entities=max_bridge_entities, graph_window=graph_window,
        trace_id=trace_id)
    return _merge_hop2(list(queries), ctx,
                       p2.result() if p2 is not None else None,
                       top_k=top_k, hop_decay=hop_decay,
                       hop2_reserve=hop2_reserve)


def iterative_retrieve_pipelined(
    engine,
    batches: Sequence[Sequence[str]],
    *,
    top_k: int,
    hop1_inspect: int = 20,
    hop_decay: float = 0.5,
    hop2_reserve: Optional[int] = None,
    max_bridge_entities: Optional[int] = None,
    graph_window: Optional[int] = None,
    trace_id: str = "",
):
    """Pipelined `iterative_retrieve` over a stream of query batches.

    Three stages, one batch deep each — hop-1 dispatch, hop-2 dispatch,
    merge — so the device queue always holds the NEXT batch's hop-1
    program while the host does bridge extraction / merging for the
    previous one. The hop-2 stage (hop-1 fetch + bridge extraction +
    hop-2 dispatch, the dominant per-batch host work) runs on
    a single worker thread: the caller thread's fetch/merge waits release
    the GIL, so the prep genuinely overlaps — the same one-in-flight
    prep-ahead discipline as `TorchQueryEngine.query_batches_pipelined`
    (where a 2nd worker loses to GIL contention). Yields one
    ``(ids, scores, norms, diagnostics)`` tuple per input batch, in order.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    pool = getattr(engine, "_mh_prep_pool", None)
    if pool is None:
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="amrf-mh-prep")
        try:
            engine._mh_prep_pool = pool
        except AttributeError:
            pass

    kw1 = dict(top_k=top_k, hop1_inspect=hop1_inspect,
               max_bridge_entities=max_bridge_entities,
               graph_window=graph_window, trace_id=trace_id)
    q1: deque = deque()  # (queries, pending hop-1)
    q2: deque = deque()  # (queries, future -> (ctx, pending hop-2|None))

    def _stage2(qs0, p10):
        return _prep_and_dispatch_hop2(engine, qs0, p10.result(), **kw1)

    def advance1():
        qs0, p10 = q1.popleft()
        q2.append((qs0, pool.submit(_stage2, qs0, p10)))

    def flush2():
        qs0, fut = q2.popleft()
        ctx, p2 = fut.result()
        return _merge_hop2(qs0, ctx,
                           p2.result() if p2 is not None else None,
                           top_k=top_k, hop_decay=hop_decay,
                           hop2_reserve=hop2_reserve)

    for qs in batches:
        q1.append((list(qs), engine.query_batch_async(
            list(qs), top_k=max(top_k, hop1_inspect),
            graph_window=graph_window, trace_id=trace_id)))
        if len(q1) >= 2:
            advance1()
        if len(q2) >= 2:
            yield flush2()
    while q1:
        advance1()
    while q2:
        yield flush2()


# one NativeBridge per INDEX (not per engine: the bench builds several
# engines over one index, and a duck-typed engine without attribute
# assignment must not re-register the corpus every batch). WeakKey so a
# dropped index releases the native copy. None entry = gated off.
_NATIVE_BRIDGES: "weakref.WeakKeyDictionary" = None  # type: ignore[assignment]

# registration copies the corpus text into native memory; above this
# total, or when the corpus is mostly non-simple (every query would take
# the Python fallback anyway), stay on the Python path
_NATIVE_BRIDGE_MAX_BYTES = 1 << 30
_NATIVE_BRIDGE_SIMPLE_SAMPLE = 512
_NATIVE_BRIDGE_MIN_SIMPLE = 0.5


def _native_bridge_for(index, docs):
    global _NATIVE_BRIDGES
    if _NATIVE_BRIDGES is None:
        import weakref

        _NATIVE_BRIDGES = weakref.WeakKeyDictionary()
    try:
        if index in _NATIVE_BRIDGES:
            return _NATIVE_BRIDGES[index]
    except TypeError:  # unhashable/unweakrefable index: no caching, no copy
        return None

    nb = None
    sample = docs[:_NATIVE_BRIDGE_SIMPLE_SAMPLE]
    n_simple = sum(
        1 for d in sample
        if (t := (d.get("text") or "")).isascii()
        and "'" not in t and "-" not in t)
    total_bytes = sum(len(d.get("text") or "") for d in docs)
    if (total_bytes <= _NATIVE_BRIDGE_MAX_BYTES and sample
            and n_simple >= _NATIVE_BRIDGE_MIN_SIMPLE * len(sample)):
        from ...native.binding import NativeBridge

        cand = NativeBridge(docs, _QUESTION_WORDS)
        if cand.available:
            nb = cand
    try:
        _NATIVE_BRIDGES[index] = nb
    except TypeError:
        pass
    return nb


def _prep_and_dispatch_hop2(
    engine,
    queries: Sequence[str],
    r1,
    *,
    top_k: int,
    hop1_inspect: int,
    max_bridge_entities: Optional[int],
    graph_window: Optional[int],
    trace_id: str,
):
    """Stage 2: bridge-entity extraction over hop-1 hits + async hop-2
    dispatch. Returns ``(ctx, pending_or_None)``."""
    # None = engine-config default (EngineConfig.hop2_max_bridges), else 4:
    # every caller (engine eval, pipelined loop, QueryServer) picks up a
    # tuned bridge budget without plumbing it through each surface
    if max_bridge_entities is None:
        max_bridge_entities = getattr(
            getattr(engine, "config", None), "hop2_max_bridges", None) or 4
    ids1 = np.asarray(r1.hits.ids)
    scores1 = np.asarray(r1.hits.scores)
    norms1 = np.asarray(r1.channel_norms)  # [3, B, K1]

    # O(N) over the corpus — cache on the engine, keyed on the index object
    # so a reload()/swapped index invalidates it; it sits on the pipelined
    # host critical path once per batch otherwise
    cached = getattr(engine, "_mh_known_titles", None)
    if cached is not None and cached[0] is engine.index:
        known_titles = cached[1]
    else:
        known_titles = {d.get("title") for d in engine.index.corpus.docs}
        known_titles.discard(None)
        try:
            engine._mh_known_titles = (engine.index, known_titles)
        except AttributeError:
            pass

    # per-doc bridge-run cache (query-independent extraction), same
    # index-keyed invalidation discipline as the titles cache above
    rcached = getattr(engine, "_mh_doc_runs", None)
    if rcached is not None and rcached[0] is engine.index:
        doc_runs: Dict[int, List[tuple]] = rcached[1]
    else:
        doc_runs = {}
        try:
            engine._mh_doc_runs = (engine.index, doc_runs)
        except AttributeError:
            pass

    docs = engine.index.corpus.docs

    # native C++ fast path: the whole bridge scan + hop-2 construction in
    # one call (binding.NativeBridge); per-query None = Python fallback
    # (non-ASCII / quote / hyphen texts, where byte-level caps detection
    # would diverge from Python's Unicode tables)
    native_out = None
    nb = _native_bridge_for(engine.index, docs)
    # when the engine prunes queries, have the native stage emit the
    # hop-2 variants ALREADY pruned (prune_query semantics in C++) and
    # dispatch with prepruned=True — the engine-side re-prune of B
    # queries (+ expansions) is a large share of the per-batch host work
    hd = getattr(engine, "_high_df_terms", None)
    prepruned = bool(
        nb is not None and hd
        and getattr(engine, "_supports_prepruned", False))
    high_df_blob = None
    if prepruned:
        bcached = getattr(engine, "_mh_highdf_blob", None)
        if bcached is not None and bcached[0] is hd:
            high_df_blob = bcached[1]
        else:
            high_df_blob = "\n".join(sorted(hd)).encode("utf-8")
            try:
                engine._mh_highdf_blob = (hd, high_df_blob)
            except AttributeError:
                pass
    if nb is not None:
        native_out = nb.hop2_batch(list(queries), ids1[:, :hop1_inspect],
                                   max_entities=max_bridge_entities,
                                   max_variants=3,
                                   high_df_blob=high_df_blob)

    hop2_queries: List[str] = []
    hop2_expansions: List[List[str]] = []
    active: List[bool] = []
    # one C-speed conversion instead of B*hop1_inspect numpy-scalar int()
    # casts inside the loop
    ids_rows = ids1[:, :hop1_inspect].tolist()
    for b, q in enumerate(queries):
        if native_out is not None and native_out[b] is not None:
            variants = native_out[b]
            if variants:
                hop2_queries.append(variants[0])
                hop2_expansions.append(variants[1:])
                active.append(True)
            else:
                hop2_queries.append("")
                hop2_expansions.append([])
                active.append(False)
            continue
        texts: List[str] = []
        runs: List[List[tuple]] = []
        titles: List[str] = []
        for ii in ids_rows[b]:
            if ii < 0:
                continue
            entry = doc_runs.get(ii)
            text = docs[ii].get("text", "")
            if entry is None:
                entry = doc_runs[ii] = doc_bridge_runs(text, known_titles)
            texts.append(text)
            titles.append(docs[ii].get("title") or "")
            runs.append(entry)
        # query-side derivations shared by bridge ranking and hop-2 query
        # construction (each used to re-extract runs + re-tokenize)
        q_ents = [e for e in capitalized_runs(q)
                  if e not in _QUESTION_WORDS]
        bridges = bridge_entities(q, texts, max_entities=max_bridge_entities,
                                  known_titles=known_titles, text_runs=runs,
                                  q_ents=q_ents,
                                  q_tokens=set(tokenize(q)),
                                  hit_titles=titles)
        variants = (hop2_queries_for(q, bridges, q_ents=q_ents)
                    if bridges else [])
        if prepruned and variants:
            # native rows in this batch are emitted pruned; Python
            # fallback rows must match (the whole batch dispatches with
            # prepruned=True)
            variants = [prune_query(v, hd) for v in variants]
        if variants:
            hop2_queries.append(variants[0])
            hop2_expansions.append(variants[1:])
            active.append(True)
        else:
            hop2_queries.append("")
            hop2_expansions.append([])
            active.append(False)

    diagnostics = dict(r1.diagnostics)
    diagnostics["hop2_active"] = int(sum(active))
    diagnostics["hop2_queries"] = hop2_queries
    ctx = {"ids1": ids1, "scores1": scores1, "norms1": norms1,
           "active": active, "diagnostics": diagnostics}
    if not any(active):
        return ctx, None
    # hop-2 may run a narrower graph wave than hop-1 (EngineConfig.
    # hop2_graph_window): hop-2 queries name the bridge entity, so the
    # cross-doc second wave is redundant device work there
    hop2_window = getattr(getattr(engine, "config", None),
                          "hop2_graph_window", None)
    if hop2_window is None:
        hop2_window = graph_window
    kw = dict(expansions=hop2_expansions, top_k=top_k,
              graph_window=hop2_window,
              trace_id=f"{trace_id}-hop2" if trace_id else "")
    if prepruned:
        kw["prepruned"] = True
    # narrower hop-2 pool (EngineConfig.hop2_pool_k); only added when set
    # so duck-typed / sharded engines without the kwarg stay compatible
    hop2_pool = getattr(getattr(engine, "config", None), "hop2_pool_k", None)
    if hop2_pool is not None:
        kw["pool_k"] = int(hop2_pool)
    dispatch = getattr(engine, "query_batch_async", None)
    if dispatch is None:  # duck-typed engines without the async surface
        return ctx, _Done(engine.query_batch(hop2_queries, **kw))
    return ctx, dispatch(hop2_queries, **kw)


class _Done:
    """Pre-resolved pending handle (sync-engine fallback)."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class IterativePending:
    """PendingQuery-shaped handle for an in-flight iterative retrieval.

    Hop 1 is already dispatched (async); ``result()`` runs the remaining
    stages — bridge extraction, hop-2 dispatch, merge — and returns a
    `QueryResult`, so `QueryServer` can serve the iterative quality mode
    through the same one-in-flight dispatch loop as single-shot queries."""

    def __init__(self, engine, queries, p1, *, top_k: int,
                 hop1_inspect: int = 20, hop_decay: float = 0.5,
                 hop2_reserve: Optional[int] = None,
                 max_bridge_entities: Optional[int] = None,
                 graph_window: Optional[int] = None, trace_id: str = ""):
        self._engine = engine
        self._queries = list(queries)
        self._p1 = p1
        self._kw = dict(top_k=top_k, hop1_inspect=hop1_inspect,
                        max_bridge_entities=max_bridge_entities,
                        graph_window=graph_window, trace_id=trace_id)
        self._hop_decay = hop_decay
        self._hop2_reserve = hop2_reserve
        self._done = None
        self._ctx = None
        self._p2 = None

    def advance(self) -> None:
        """Run the middle stage NOW: wait out hop-1, extract bridges, and
        dispatch hop-2 (async) — leaving only the merge for ``result()``.
        `QueryServer`'s loop calls this on the previous in-flight batch
        right after dispatching the next one, so batch i's hop-2 program
        queues behind batch i+1's hop-1 instead of serializing inside the
        final result wait (the server-side analogue of
        `iterative_retrieve_pipelined`'s 3-stage pipeline)."""
        if self._done is not None or self._ctx is not None:
            return
        self._ctx, self._p2 = _prep_and_dispatch_hop2(
            self._engine, self._queries, self._p1.result(), **self._kw)

    def result(self):
        if self._done is not None:
            return self._done
        self.advance()
        ctx, p2 = self._ctx, self._p2
        ids, scores, norms, diag = _merge_hop2(
            self._queries, ctx, p2.result() if p2 is not None else None,
            top_k=self._kw["top_k"], hop_decay=self._hop_decay,
            hop2_reserve=self._hop2_reserve)
        self._done = QueryResult(
            hits=HitBatch(ids=ids, scores=scores),
            channel_norms=np.moveaxis(norms, 1, 0),
            diagnostics=diag)
        return self._done


def _merge_hop2(
    queries: Sequence[str],
    ctx: Dict,
    r2,
    *,
    top_k: int,
    hop_decay: float,
    hop2_reserve: Optional[int],
):
    """Stage 3: decay + reserve-aware max-merge of hop-2 into hop-1.

    Fully vectorized: the python dict merge sits on the critical host
    path of the pipelined loop.
    Semantics oracle: `_merge_hop2_py`, asserted equal in tests including
    exact score ties (both implementations break ties by ascending id, so
    results are deterministic and identical).

    The reserve rule vectorizes through an equivalence: "ranked, minus the
    `drop` weakest non-hop-2-only entries, plus the `drop` best missing
    hop-2-only ones" == "top (n_h2 + drop) hop-2-only entries + top
    (top_k - n_h2 - drop) others", because the entries of each class
    inside `ranked` are exactly that class's score-ranked prefix."""
    ids1, scores1, norms1 = ctx["ids1"], ctx["scores1"], ctx["norms1"]
    active, diagnostics = ctx["active"], ctx["diagnostics"]
    B = len(queries)
    if r2 is None:
        return (ids1[:, :top_k], scores1[:, :top_k],
                np.moveaxis(norms1, 0, 1)[:, :, :top_k], diagnostics)

    ids2 = np.asarray(r2.hits.ids)
    scores2 = np.asarray(r2.hits.scores) * hop_decay
    norms2 = np.asarray(r2.channel_norms)

    reserve = (max(2, top_k // 4) if hop2_reserve is None
               else max(0, int(hop2_reserve)))
    reserve = min(reserve, max(0, top_k - 2))

    K1, K2 = ids1.shape[1], ids2.shape[1]
    BIG = np.iinfo(np.int32).max
    act = np.asarray(active, dtype=bool)[:, None]
    v1 = ids1 >= 0
    v2 = act & (ids2 >= 0)
    # hop-2-only flag: the id appears in none of hop-1's TOP-K slots of
    # its row. Membership deeper in the hop-1 window (rows are inspected
    # to hop1_inspect > top_k) must NOT disqualify an id from the
    # reserve: such an id was about to be displaced by hop-1's distractor
    # tail anyway, which is exactly what the reserve exists to prevent.
    h1_top = np.where(v1, ids1, -9)[:, None, :top_k]
    in_h1 = (ids2[:, :, None] == h1_top).any(2)

    cat_ids = np.concatenate(
        [np.where(v1, ids1, BIG), np.where(v2, ids2, BIG)], axis=1)
    cat_s = np.concatenate(
        [np.where(v1, scores1, -np.inf), np.where(v2, scores2, -np.inf)],
        axis=1)
    cat_n = np.concatenate([norms1, norms2], axis=2)  # [3, B, K1+K2]
    # the hop-2-only CLASS of an id = (appears in hop-2) & (absent from
    # hop-1's top_k). The dedup below keeps one element per id, and its
    # flag must carry the id's class regardless of which copy wins — so a
    # deep-hop-1 copy of a hop-2 id gets the flag too.
    in_h2 = (ids1[:, :, None] == np.where(v2, ids2, -9)[:, None, :]).any(2)
    in_h1top_self = (ids1[:, :, None] == h1_top).any(2)
    cat_flag = np.concatenate(
        [v1 & act & in_h2 & ~in_h1top_self, v2 & ~in_h1], axis=1)
    src = np.concatenate(
        [np.zeros((B, K1), np.int8), np.ones((B, K2), np.int8)], axis=1)

    # dedup-max by id: sort (id asc, score desc, hop-1 first) and keep run
    # starts — the same sort-aggregate primitive as the device programs
    order = np.lexsort((src, -cat_s, cat_ids), axis=1)
    ids_s = np.take_along_axis(cat_ids, order, 1)
    s_s = np.take_along_axis(cat_s, order, 1)
    flag_s = np.take_along_axis(cat_flag, order, 1)
    first = np.ones_like(ids_s, dtype=bool)
    first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    uniq = first & (ids_s < BIG) & np.isfinite(s_s)
    u_s = np.where(uniq, s_s, -np.inf)

    # rank unique entries by score desc
    rk = np.argsort(-u_s, axis=1, kind="stable")
    r_ids = np.take_along_axis(ids_s, rk, 1)
    r_s = np.take_along_axis(u_s, rk, 1)
    r_flag = np.take_along_axis(flag_s & uniq, rk, 1)
    r_valid = np.isfinite(r_s)
    r_pos = np.take_along_axis(order, rk, 1)  # index into cat arrays

    # reserve quotas (see docstring equivalence)
    in_ranked = (np.cumsum(r_valid, axis=1) <= top_k) & r_valid
    n_h2 = (r_flag & in_ranked).sum(1)
    f_total = (r_flag & r_valid).sum(1)
    drop = np.maximum(
        0, np.minimum(np.minimum(reserve, f_total - n_h2),
                      reserve - n_h2)) if reserve else np.zeros(B, np.int64)
    q_f = n_h2 + drop
    q_n = top_k - q_f

    f_cum = np.cumsum(r_flag & r_valid, axis=1)
    n_cum = np.cumsum(~r_flag & r_valid, axis=1)
    select = r_valid & ((r_flag & (f_cum <= q_f[:, None]))
                        | (~r_flag & (n_cum <= q_n[:, None])))
    # compact selected entries forward, preserving score order; W < top_k
    # when the engine clamped hit widths below top_k (tiny corpora) — pad
    # the output back to top_k like the loop implementation does
    W = min(top_k, select.shape[1])
    sel_ord = np.argsort(~select, axis=1, kind="stable")[:, :W]
    if W < top_k:
        sel_ord = np.pad(sel_ord, ((0, 0), (0, top_k - W)), mode="edge")
    n_sel = np.minimum(select.sum(1), top_k)
    slot_ok = np.arange(top_k)[None, :] < n_sel[:, None]

    out_ids = np.where(slot_ok, np.take_along_axis(r_ids, sel_ord, 1),
                       -1).astype(np.int32)
    out_scores = np.where(slot_ok, np.take_along_axis(r_s, sel_ord, 1),
                          0.0).astype(np.float32)
    final_pos = np.take_along_axis(r_pos, sel_ord, 1)  # [B, top_k]
    out_norms = np.take_along_axis(
        np.moveaxis(cat_n, 0, 1), final_pos[:, None, :].repeat(3, axis=1), 2
    ).astype(np.float32)  # [B, 3, top_k]
    out_norms = np.where(slot_ok[:, None, :], out_norms, 0.0)
    return out_ids, out_scores, out_norms, diagnostics


def _merge_hop2_py(
    queries: Sequence[str],
    ctx: Dict,
    r2,
    *,
    top_k: int,
    hop_decay: float,
    hop2_reserve: Optional[int],
):
    """Reference implementation of the stage-3 merge (the oracle for
    `_merge_hop2`; kept host-side and loop-shaped on purpose)."""
    ids1, scores1, norms1 = ctx["ids1"], ctx["scores1"], ctx["norms1"]
    active, diagnostics = ctx["active"], ctx["diagnostics"]
    B = len(queries)
    if r2 is None:
        return (ids1[:, :top_k], scores1[:, :top_k],
                np.moveaxis(norms1, 0, 1)[:, :, :top_k], diagnostics)

    ids2 = np.asarray(r2.hits.ids)
    scores2 = np.asarray(r2.hits.scores) * hop_decay
    norms2 = np.asarray(r2.channel_norms)

    # hop-2 hits are decayed, so a pure score merge lets hop-1's distractor
    # TAIL (scores ~0.5) squeeze out exactly the evidence hop 2 exists to
    # find ("B was born in X" at 0.84 * 0.5 = 0.42). Reserve a few merged
    # slots for the best hop-2-only hits — but never so many that hop-1's
    # anchors get evicted (clamped to top_k - 2 so at least the two
    # strongest hop-1 hits always survive).
    reserve = (max(2, top_k // 4) if hop2_reserve is None
               else max(0, int(hop2_reserve)))
    reserve = min(reserve, max(0, top_k - 2))
    out_ids = np.full((B, top_k), -1, dtype=np.int32)
    out_scores = np.zeros((B, top_k), dtype=np.float32)
    out_norms = np.zeros((B, 3, top_k), dtype=np.float32)
    for b in range(B):
        merged: Dict[int, Tuple[float, np.ndarray]] = {}
        h1_ids = set()
        for j, (i, s) in enumerate(zip(ids1[b].tolist(), scores1[b].tolist())):
            if i >= 0 and (i not in merged or s > merged[i][0]):
                merged[i] = (float(s), norms1[:, b, j])
                if j < top_k:
                    h1_ids.add(i)  # reserve keys on hop-1's top_k only
        hop2_only: List[int] = []
        if active[b]:
            for j, (i, s) in enumerate(zip(ids2[b].tolist(), scores2[b].tolist())):
                if i < 0:
                    continue
                if i not in merged or s > merged[i][0]:
                    merged[i] = (float(s), norms2[:, b, j])
                if i not in h1_ids:
                    hop2_only.append(i)
        ranked = sorted(merged.items(),
                        key=lambda kv: (-kv[1][0], kv[0]))[:top_k]
        if active[b] and reserve:
            have = {i for i, _ in ranked}
            missing = sorted(
                (i for i in set(hop2_only) if i not in have),
                key=lambda i: (-merged[i][0], i))[:reserve]
            n_h2 = sum(1 for i, _ in ranked if i in set(hop2_only))
            drop = max(0, min(len(missing), reserve - n_h2))
            if drop:
                keep = [kv for kv in ranked if kv[0] not in set(hop2_only)]
                h2_kv = [kv for kv in ranked if kv[0] in set(hop2_only)]
                keep = keep[: top_k - len(h2_kv) - drop]
                ranked = sorted(
                    keep + h2_kv + [(i, merged[i]) for i in missing[:drop]],
                    key=lambda kv: (-kv[1][0], kv[0]))[:top_k]
        for j, (i, (s, nrm)) in enumerate(ranked):
            out_ids[b, j] = i
            out_scores[b, j] = s
            out_norms[b, :, j] = nrm
    return out_ids, out_scores, out_norms, diagnostics
