"""Reasoning strategies: evidence selection, neighbor expansion, citations,
answer normalization, majority voting.

The port's copy of ``a_modular_rag_framework_tpu/modules/reasoning/strategies.py``.

Behavior parity with the reference implementation's app/modules/reasoning/strategies.py:
  - overlap_score(a, b) = |A∩B| / (1 + ln(1 + |B|)) (short-evidence bias)
  - per-step evidence score = 0.6*lexical + 0.4*(0.5*text + 0.3*dense +
    0.2*graph normalized channel scores), falling back to pure lexical when
    no channel norms are present (strategies.py:229-255)
  - entity hard-filter, neighbor expansion over (doc, sent_id) continuity,
  - coverage floor backfill from the global score order,
  - stable citation blocks and normalized-majority voting.

The per-step evidence scoring is vectorized with numpy over the whole hit
list instead of per-hit python loops.
"""
from __future__ import annotations

import math
import os
import re
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ...utils.textspan import capitalized_runs

_TOKEN_RE = re.compile(r"[^a-zA-Z0-9]+")

# function/question words excluded from entity anchors, carried entity
# tokens, and predicate boosting (sentence-initial capitals like "In" or
# "The" otherwise reach cap_re and make the anchor filter vacuous)
_ANCHOR_STOP = {"the", "in", "a", "an", "of", "which", "what", "who",
                "where", "when", "why", "how", "was", "is", "did",
                "does", "to", "for", "at", "on", "by", "later", "and"}


def tokenize(text: str) -> List[str]:
    return [t for t in _TOKEN_RE.split((text or "").lower()) if t]


def _stems(tokens) -> List[str]:
    """6-char prefix stems (len >= 4) so inflection variants meet:
    "collaborator" / "collaborated" / "collaboration" -> "collab"."""
    return [t[:6] if len(t) >= 4 else t for t in tokens]


def overlap_score(a: str, b: str) -> float:
    """Term-overlap score favoring concise evidence."""
    A, B = set(tokenize(a)), set(tokenize(b))
    if not B:
        return 0.0
    return len(A & B) / (1.0 + math.log(1.0 + len(B)))


def normalize_answer(s: str) -> str:
    """Lowercase, strip inline [#k] citations + punctuation, squeeze spaces."""
    s = re.sub(r"\[[^\]]+\]", " ", s or "")
    s = re.sub(r"[^a-zA-Z0-9]+", " ", s)
    return re.sub(r"\s+", " ", s.strip().lower())


def coerce_text(out: Any) -> str:
    """Collapse assorted provider output shapes to a string.

    Providers in this framework return ``{"text": str}`` (core/providers),
    but the adapter seam tolerates OpenAI-style nests too
    (choices[0].message.content etc). Rather than enumerate every shape by
    hand, run a small depth-bounded first-string search under text-ish
    keys, preferring ``text``/``content`` over wrapper keys."""
    keys = ("text", "content", "output_text", "data",
            "message", "delta", "choices")

    def find(node: Any, depth: int) -> Any:
        if isinstance(node, str):
            return node
        if depth <= 0:
            return None
        if isinstance(node, dict):
            for k in keys:
                if k in node:
                    got = find(node[k], depth - 1)
                    if isinstance(got, str):
                        return got
        elif isinstance(node, list):
            for item in node[:4]:
                got = find(item, depth - 1)
                if isinstance(got, str):
                    return got
        return None

    got = find(out, 4)
    return got if isinstance(got, str) else ""


# ---- hit helpers ----


def _hit_meta(hit: Any) -> Dict[str, Any]:
    meta = getattr(hit, "meta", None)
    if meta is None and isinstance(hit, dict):
        meta = hit.get("meta")
    return meta if isinstance(meta, dict) else {}


def _hit_text(hit: Any) -> str:
    meta = _hit_meta(hit)
    text = meta.get("text") or meta.get("content") or ""
    if not text and isinstance(hit, dict):
        text = hit.get("text") or hit.get("content") or ""
    return str(text or "")


def _hit_score(hit: Any) -> float:
    s = getattr(hit, "score", None)
    if s is None and isinstance(hit, dict):
        s = hit.get("score")
    try:
        return float(s or 0.0)
    except (TypeError, ValueError):
        return 0.0


def _hit_doc_sid(hit: Any) -> Tuple[str, Optional[int]]:
    meta = _hit_meta(hit)
    doc = str(meta.get("doc") or "")
    try:
        sid = int(meta.get("sent_id")) if meta.get("sent_id") is not None else None
    except (TypeError, ValueError):
        sid = None
    return doc, sid


# ---- neighbor expansion ----


def expand_with_neighbors(
    used: Set[int],
    hits: Sequence[Any],
    window: int = 1,
    max_expand: int = 5,
) -> Set[int]:
    """Grow the used-evidence set with (doc, sent_id±d) neighbors present in
    the hit list, up to ``max_expand`` additions within ``window`` hops."""
    if not hits or not used or window <= 0 or max_expand <= 0:
        return set(used)

    sid2idx: Dict[Tuple[str, int], int] = {}
    for idx, h in enumerate(hits):
        doc, sid = _hit_doc_sid(h)
        if sid is not None and sid >= 0:
            sid2idx.setdefault((doc, sid), idx)

    expanded = set(used)
    added = 0
    for idx in sorted(used):
        if added >= max_expand:
            break
        doc, sid = _hit_doc_sid(hits[idx])
        if sid is None or sid < 0:
            continue
        for d in range(1, window + 1):
            for sign in (-1, 1):
                j = sid2idx.get((doc, sid + d * sign))
                if j is not None and j not in expanded:
                    expanded.add(j)
                    added += 1
                    if added >= max_expand:
                        return expanded
    return expanded


# ---- per-step evidence selection ----


def select_evidence_for_steps(
    steps: Sequence[str],
    hits: Iterable[Any],
    per_step_k: int = 2,
    min_score: float = 0.0,
    require_entities: Optional[List[str]] = None,
    neighbor_window: int = 1,
    neighbor_max_expand: int = 5,
    entity_phrases: Optional[List[str]] = None,
) -> Tuple[List[List[int]], set]:
    """Pick top-K evidence per plan step.

    Vectorized scoring: lexical overlap fused with channel norms where
    present; entity hard-filter; neighbor expansion; coverage-floor backfill.
    Returns (per-step index lists, union of used indices).

    ``entity_phrases``: full multi-word entity strings from the question
    ("Tove Kelanan"). A text that PARTIALLY matches a phrase (some tokens
    but not the full string) is penalized as a suspected twin distractor
    ("Tove Norlorcor was born in..."), and its entities are never learned
    into the carry: token-level overlap can't distinguish the question
    person from a first-name twin whose text also matches the predicate
    words, and one mis-pick poisons the carry for every later step
    (measured as the dominant e2e failure mode on the hard corpus).
    Texts fully containing any phrase are exempt from the penalty.
    """
    H = list(hits)
    n = len(H)
    step_evidences: List[List[int]] = []
    used: set = set()
    if n == 0:
        return [[] for _ in steps], used

    texts = [_hit_text(h) for h in H]
    text_tokens = [set(_stems(tokenize(t))) for t in texts]
    text_lens = np.array([len(tt) for tt in text_tokens], dtype=np.float32)
    log_lens = 1.0 + np.log(1.0 + text_lens)

    metas = [_hit_meta(h) for h in H]
    # doc-title coreference: natural prose names its subject by pronoun
    # ("He was born in Cincinnati") and leaves the entity in the document
    # title — the HotpotQA convention (title identifies the doc's subject,
    # the reference implementation's my_code/ingest_hotpotqa.py:73-81). A sentence
    # inherits its title's entity tokens for anchoring / carry matching;
    # lexical overlap scoring stays text-only so titles don't inflate
    # relevance.
    titles = [str(m.get("doc") or m.get("title") or "") for m in metas]
    title_tokens = [set(_stems(tokenize(t))) - _ANCHOR_STOP for t in titles]
    full_tokens = [tt | dt for tt, dt in zip(text_tokens, title_tokens)]
    st = np.array([float(m.get("score_text_norm") or 0.0) for m in metas], np.float32)
    sd = np.array([float(m.get("score_dense_norm") or 0.0) for m in metas], np.float32)
    sg = np.array([float(m.get("score_graph_norm") or 0.0) for m in metas], np.float32)
    has_channels = (st + sd + sg) > 0.0
    fused_chan = 0.5 * st + 0.3 * sd + 0.2 * sg

    # entity ANCHOR filter (token-level): a candidate must share at least
    # one entity token with the question — or, in later steps, with a
    # carried bridge entity. The reference's substring filter was vacuous
    # (sentence-initial capitals like "The"/"In" match inside any text);
    # stopword-cleaned token matching makes it real, which keeps
    # anchorless "P was born in C" strangers out of the picks (their
    # entities would otherwise poison the carry for every later step).
    ent_anchor = set()
    for e in list(require_entities or []) + list(entity_phrases or []):
        ent_anchor |= set(_stems(tokenize(e)))
    ent_anchor -= _ANCHOR_STOP

    has_text = text_lens > 0
    global_order = sorted(range(n), key=lambda i: _hit_score(H[i]), reverse=True)

    # capitalized runs per text, pre-stemmed once: used for the answer-slot
    # bonus (below) and the carry update. A SINGLE capitalized word at the
    # start of the text is ordinary sentence capitalization ("Later in
    # life ... retired"), not an answer span or an entity — counting it
    # gave biography filler a spurious slot bonus that outscored the true
    # collaboration sentence by 0.003 and poisoned the carry (the two
    # plain-corpus twin misses). Only the TEXT-INITIAL occurrence is
    # dropped (runs come back in positional order, so that is the first
    # entry): a recurring entity that happens to open the text keeps its
    # later mid-sentence mentions ("Dunmore is a town ... visited
    # Dunmore."). Multi-word runs keep their status anywhere, including
    # sentence-initial names ("Alden Kelholan was born in ...").
    def _runs_with_stems(t: str):
        rs = capitalized_runs(t)
        if rs and " " not in rs[0] and t.startswith(rs[0]):
            rs = rs[1:]
        return [(r, set(_stems(tokenize(r)))) for r in rs]

    text_runs = [_runs_with_stems(t) for t in texts]

    carry: set = set()  # bridge-entity tokens discovered in earlier steps
    carry_sources: Dict[str, set] = {}  # carry token -> hit idxs that added it
    carry_phrases: set = set()  # full bridge-entity strings (lowercased)
    q_phrases = {p.lower() for p in (entity_phrases or []) if " " in p}
    # phrase containment checks (twin-penalty exemption) see text + title:
    # a sentence in the doc titled by the full phrase is NOT a twin
    texts_lower = [f"{t.lower()} ‖ {d.lower()}"
                   for t, d in zip(texts, titles)]
    steps_lower = " \n ".join(str(s) for s in steps).lower()
    # predicate tokens discriminate WITHIN a document: every sentence of
    # the question entity's doc matches the entity tokens, so the relation
    # words ("collaborator", "born", "city") are what separates the bridge
    # sentence from biography filler — count them double
    ent_stems = set()
    for p in (entity_phrases or []) + list(require_entities or []):
        ent_stems |= set(_stems(tokenize(p)))

    for step in steps:
        s_tokens = set(_stems(tokenize(step)))
        # multi-hop chains name the bridge entity only in evidence, never
        # in the question: entities found in earlier steps' picks join the
        # lexical query (and count double — the bridge link is the signal).
        # Partial-phrase PENALTY: a text sharing some tokens of an entity
        # phrase but not the full phrase is a twin distractor ("Tove
        # Norlorcor ..." vs "Tove Kelanan") — its token overlap is
        # anti-signal, so subtract it back out; full-phrase matches and
        # phrase-free texts score exactly as before
        phrases = q_phrases | carry_phrases
        ptoks = [(set(_stems(tokenize(p))), p) for p in phrases]
        # relation words only — function words would boost short filler
        pred_tokens = s_tokens - ent_stems - _ANCHOR_STOP
        # partial-phrase penalty counts, computed ONCE per step; a text
        # FULLY containing any phrase (question or carried bridge) is
        # exempt — a bridge sharing the question entity's first name must
        # not be penalized for the partial match against the OTHER phrase
        pen_counts = np.array(
            [0 if any(p in tl for _, p in ptoks)
             else sum(1 for pt, p in ptoks if pt & tt)
             for tt, tl in zip(full_tokens, texts_lower)],
            dtype=np.float32,
        )
        penalized = pen_counts > 0
        # a carried token vouches for a candidate only if someone ELSE
        # contributed it: tokens a sentence itself introduced must not
        # boost that same sentence in later steps (self-carry — the
        # "Kestrel Point" tokens carried from doc-1 filler re-selected the
        # filler forever on zero-predicate-overlap hops). Capped at 2
        # tokens — one person name's worth: matching a bridge IS the
        # signal, matching MORE of the carry is not more bridge. Uncapped,
        # a short distractor echoing several carried non-person runs
        # ("Nobel Prize", "Literature" learned from the work doc's own
        # filler) outscored the long gold birth sentence on the natural
        # corpus (dominant evidence_selection miss, e2e_failure_anatomy).
        def _carry_overlap(i: int, tt: set) -> int:
            return min(2, sum(1 for tok in carry & tt
                              if carry_sources.get(tok, set()) != {i}))

        # answer-slot bonus: evidence holding a capitalized run that is
        # NOT a question/carried entity contains a candidate answer span
        # ("... worked for Gildencorp Works") — the only lexical signal
        # left when the step's predicate is a pure paraphrase of the
        # evidence ("employed" vs "worked for"). Equivalent to one token
        # of overlap; answer-free continuations ("retired to the
        # countryside") don't get it.
        known = ent_anchor | carry
        slot_bonus = np.array(
            [1.0 if any(not (rs_ & known) for _, rs_ in text_runs[i])
             else 0.0 for i in range(n)],
            dtype=np.float32,
        )
        inter = np.array(
            [len(s_tokens & tt) + len(pred_tokens & tt)
             + 2 * _carry_overlap(i, full_tokens[i])
             for i, tt in enumerate(text_tokens)],
            dtype=np.float32,
        ) + slot_bonus - 2.0 * pen_counts
        lex = np.where(has_text, inter / log_lens, 0.0)
        score = np.where(has_channels, 0.6 * lex + 0.4 * fused_chan, lex)
        # the anchor set grows with the carry: hop-2 evidence ("B was born
        # in X") never mentions the question entity A — it anchors through
        # the carried bridge entity B (measured on the hard corpus: 55% of
        # e2e misses had the birth sentence retrieved but never selected)
        anchor = ent_anchor | carry
        if anchor:
            anchored = np.array([bool(anchor & tt) for tt in full_tokens],
                                dtype=bool)
        else:
            anchored = np.ones(n, dtype=bool)
        eligible = anchored & has_text & (score >= min_score) & (score > 0)

        order = np.argsort(-score, kind="stable")

        def _greedy_pick(cands: List[int], k: int) -> List[int]:
            # marginal-gain (MMR / facility-location) selection: relation
            # tokens already covered by earlier picks stop counting, so the
            # k-th pick adds NOVEL coverage of the step's relations instead
            # of restating the strongest one. With empty coverage the
            # formula equals `score`, so pick 1 is the plain argmax and
            # single-pick steps are unchanged. (The dominant natural-corpus
            # miss: picks 1-2 both restate the hop-1 relation "directed"
            # while the answer sentence covering "born" ranked 3rd by
            # absolute score.) The reference ships the same idea as
            # mmr_diversify (the reference implementation's app/utils/similarity.py:44-62).
            sel: List[int] = []
            while cands and len(sel) < k:
                covered: set = set()
                for j in sel:
                    covered |= full_tokens[j]
                best, best_s = None, None
                for i in cands:
                    if i in sel:
                        continue
                    carry_nov = min(2, sum(
                        1 for tok in (carry & full_tokens[i]) - covered
                        if carry_sources.get(tok, set()) != {i}))
                    inter_i = (len((s_tokens - covered) & text_tokens[i])
                               + len((pred_tokens - covered) & text_tokens[i])
                               + 2 * carry_nov
                               + slot_bonus[i] - 2.0 * pen_counts[i])
                    lex_i = inter_i / log_lens[i] if has_text[i] else 0.0
                    sc = (0.6 * lex_i + 0.4 * fused_chan[i]
                          if has_channels[i] else lex_i)
                    if best_s is None or sc > best_s + 1e-9:
                        best, best_s = i, sc
                if best is None:
                    break
                sel.append(best)
            return sel

        elig_order = [int(i) for i in order if eligible[i]]
        picked = _greedy_pick(elig_order, max(1, per_step_k))

        if os.environ.get("AMRF_DEBUG_SELECT"):  # pragma: no cover
            print(f"--- step: {step!r}")
            print(f"    anchor={sorted(anchor)[:12]} carry={sorted(carry)[:12]}")
            for i in order[:10]:
                i = int(i)
                print(f"    {'*' if i in picked else ' '} "
                      f"s={score[i]:.3f} inter={inter[i]:.1f} "
                      f"slot={slot_bonus[i]:.0f} pen={pen_counts[i]:.0f} "
                      f"anch={bool(anchored[i])} elig={bool(eligible[i])} "
                      f"| {titles[i][:22]} :: {texts[i][:58]}")

        if picked:
            grown = expand_with_neighbors(
                set(picked), H, window=neighbor_window,
                max_expand=max(neighbor_max_expand, per_step_k),
            )
            # neighbors join the same marginal-gain competition (a
            # higher-scoring neighbor can still displace a pick, as before,
            # but novelty of coverage is respected in the re-trim too)
            grown_order = sorted(grown, key=lambda i: float(score[i]),
                                 reverse=True)
            picked = _greedy_pick(grown_order, max(1, per_step_k))

        if len(picked) < per_step_k:  # coverage floor
            for gi in global_order:
                if gi not in picked:
                    picked.append(gi)
                if len(picked) >= per_step_k:
                    break

        step_evidences.append(picked)
        used.update(picked)
        for i in picked:
            if penalized[i]:
                # never learn entities from a suspected twin: once picked,
                # its own phrase would enter the carry and erase its
                # penalty (self-legitimization), poisoning later steps
                continue
            # the picked hit's doc title is an entity mention too (its
            # sentences may only ever say "he"/"she"); disambiguators like
            # "(film)" are title furniture, not entity tokens
            title_ent = re.sub(r"\s*\(.*?\)", "", titles[i]).strip()
            title_run = ([(title_ent, set(_stems(tokenize(title_ent)))
                           - _ANCHOR_STOP)] if title_ent else [])
            for ent, ent_stems_i in text_runs[i] + title_run:
                # keep only the NOVEL tokens of each entity: a bridge
                # person sharing the question entity's first name ("Brisa
                # Venanan collaborated with Brisa Wynanan") must still
                # contribute the surname
                novel = ent_stems_i - s_tokens - _ANCHOR_STOP
                carry.update(novel)
                for tok in novel:
                    carry_sources.setdefault(tok, set()).add(i)
                # carry full phrases only for MULTI-WORD entities (person
                # names) novel to the question: single capitalized words
                # ("Critics", a city) are too noisy for the phrase bonus.
                # Novelty = the phrase never appears in the plan text —
                # NOT a substring test against require_entities, whose
                # single-word tokens ("In") match inside names ("corIN")
                if novel and " " in ent and ent.lower() not in steps_lower:
                    carry_phrases.add(ent.lower())

    return step_evidences, used


# ---- citations ----


def build_citation_block(hits: Sequence[Any], indices: Iterable[int]) -> str:
    """Stable, reproducible citation block: deduped ascending indices,
    '[#j] (doc=..., sent_id=...) "text"' lines (the verifier extracts the
    [#j] numbering from answers)."""
    try:
        idx_list = sorted(set(int(i) for i in indices))
    except (TypeError, ValueError):
        seen: set = set()
        idx_list = [i for i in indices if not (i in seen or seen.add(i))]

    lines = []
    for j, i in enumerate(idx_list, 1):
        if i < 0 or i >= len(hits):
            continue
        meta = _hit_meta(hits[i])
        doc = str(meta.get("doc") or meta.get("title") or "")
        sid = str(meta.get("sent_id") if meta.get("sent_id") is not None else "")
        text = _hit_text(hits[i]).replace('"', "“")
        lines.append(f'[#{j}] (doc={doc}, sent_id={sid}) "{text}"')
    return "\n".join(lines)


# ---- voting ----


def majority_vote(candidates: Sequence[str]) -> Tuple[str, Dict[str, int]]:
    """Return the draft whose normalized form is most common."""
    votes = Counter(normalize_answer(c) for c in candidates if c and c.strip())
    if not votes:
        return "", {}
    best_norm, _ = votes.most_common(1)[0]
    for c in candidates:
        if normalize_answer(c) == best_norm:
            return c, dict(votes)
    return candidates[0], dict(votes)
