"""Text rules of the hotpot reference, and its pass over the corpus rows.

Kept apart from ``hotpot.py`` (which imports torch) so that the worker
processes of `scan` start in a fraction of a second: each reads one
contiguous chunk of rows and the chunks are merged in row order, which
gives what one pass over all rows would give.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

_TOKEN_RE = re.compile(r"[^a-zA-Z0-9]+")
_ALNUM_RE = re.compile(r"[a-z0-9]+")
_CAP = r"[A-Z][A-Za-z]*[a-z][A-Za-z]*"
_RUN_RE = re.compile(rf"(?<![A-Za-z]){_CAP}(?: (?:[A-Z]\.? )*{_CAP})*")


def tokenize(text: str) -> List[str]:
    return [t for t in _TOKEN_RE.split((text or "").lower()) if t]


def cap_runs(text: str) -> List[str]:
    """Maximal runs of capitalized words (an initial may sit inside a run).
    The generated corpus is plain ASCII without apostrophes or hyphens;
    other text is refused rather than guessed at."""
    if not text.isascii() or "'" in text or "-" in text:
        raise ValueError(f"the reference handles plain ASCII text: {text!r}")
    return _RUN_RE.findall(text)


def phrase_tokens(text: str) -> List[str]:
    return ["00".join(tokenize(r)) for r in cap_runs(text) if " " in r]


def augment(text: str) -> str:
    """The text with its multi-word capitalized runs appended as joined
    phrase tokens ("Ananan Belanan" gains "ananan00belanan")."""
    if not text or text.islower():
        return text
    extra = phrase_tokens(text)
    return f"{text} {' '.join(extra)}" if extra else text


def flatten(samples: Iterable[dict]) -> List[Tuple[str, int, str]]:
    """HotpotQA samples -> sentence rows (title, sentence id, text), the
    first occurrence of each (title, sentence id) in sample order."""
    seen, rows = set(), []
    for s in samples:
        for title, sents in s["context"]:
            for sid, text in enumerate(sents):
                if (title, sid) not in seen:
                    seen.add((title, sid))
                    rows.append((title, sid, text))
    return rows


def scan_chunk(args) -> tuple:
    """Rows ``base .. base + len(texts)``: (lengths of the phrase-augmented
    token streams, document frequencies of the needed terms, the postings
    {term: {row: tf}} of those also in ``post_terms`` (none for a term
    whose frequency in this chunk alone passes ``limit``), entities
    {entity: its first ``cap`` rows} in order of first appearance)."""
    texts, base, needed, post_terms, limit, cap = args
    dl: List[int] = []
    dfs: Dict[str, int] = {}
    post: Dict[str, Dict[int, int]] = {}
    ent_rows: Dict[str, List[int]] = {}
    find_tokens = _ALNUM_RE.findall
    for j, text in enumerate(texts):
        i = base + j
        runs = cap_runs(text)
        toks = find_tokens(text.lower())
        toks += ["00".join(find_tokens(r.lower())) for r in runs if " " in r]
        dl.append(len(toks))
        for t in needed.intersection(toks):
            c = dfs[t] = dfs.get(t, 0) + 1
            if c <= limit and t in post_terms:
                post.setdefault(t, {})[i] = toks.count(t)
            elif t in post:
                del post[t]
        for e in dict.fromkeys(runs):
            lst = ent_rows.setdefault(e, [])
            if len(lst) < cap:
                lst.append(i)
    return dl, dfs, post, ent_rows


def scan(texts: List[str], needed: set, post_terms: set, limit: float,
         cap: int, workers: int = 1) -> tuple:
    """`scan_chunk` over all rows, in ``workers`` processes when more than
    one, merged in row order."""
    n = len(texts)
    step = -(-n // max(workers, 1)) if n else 1
    jobs = [(texts[a:a + step], a, needed, post_terms, limit, cap)
            for a in range(0, n, step)]
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(len(jobs)) as pool:
            parts = pool.map(scan_chunk, jobs)
    else:
        parts = [scan_chunk(j) for j in jobs]
    dl: List[int] = []
    dfs: Dict[str, int] = {}
    post: Dict[str, Dict[int, int]] = {}
    ent_rows: Dict[str, List[int]] = {}
    for p_dl, p_dfs, p_post, p_ent in parts:
        dl += p_dl
        for t, c in p_dfs.items():
            dfs[t] = dfs.get(t, 0) + c
        for t, rows in p_post.items():
            post.setdefault(t, {}).update(rows)
        for e, rows in p_ent.items():
            lst = ent_rows.setdefault(e, [])
            if len(lst) < cap:
                lst += rows[:cap - len(lst)]
    post = {t: rows for t, rows in post.items() if dfs[t] <= limit}
    return dl, dfs, post, ent_rows


def word_ids_chunk(args) -> tuple:
    """Texts -> (their distinct words in order of first use, word ids
    [n, max_len] int32 into that list plus one (0 pads), token counts)."""
    import numpy as np

    texts, max_len = args
    index: Dict[str, int] = {}
    lookup = index.setdefault
    flat: List[int] = []
    lens = np.zeros(len(texts), dtype=np.int64)
    find_tokens = _ALNUM_RE.findall
    for i, t in enumerate(texts):
        toks = find_tokens(t.lower())[:max_len]
        lens[i] = len(toks)
        flat.extend(lookup(w, len(index) + 1) for w in toks)
    wid = np.zeros((len(texts), max_len), dtype=np.int32)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    wid[np.repeat(np.arange(len(texts)), lens),
        np.arange(len(flat)) - starts] = flat
    return list(index), wid, lens


def word_ids(texts: List[str], max_len: int, workers: int = 1) -> tuple:
    """`word_ids_chunk` over all texts, in ``workers`` processes when more
    than one: (words, ids [n, max_len] into ``[""] + words``, counts)."""
    import numpy as np

    step = -(-len(texts) // max(workers, 1)) if texts else 1
    jobs = [(texts[a:a + step], max_len) for a in range(0, len(texts), step)]
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(len(jobs)) as pool:
            parts = pool.map(word_ids_chunk, jobs)
    else:
        parts = [word_ids_chunk(j) for j in jobs]
    index: Dict[str, int] = {}
    wids, lens = [], []
    for words, wid, n in parts:
        remap = np.array([0] + [index.setdefault(w, len(index) + 1)
                                for w in words], dtype=np.int32)
        wids.append(remap[wid])
        lens.append(n)
    if not parts:
        return [], np.zeros((0, max_len), np.int32), np.zeros(0, np.int64)
    return list(index), np.concatenate(wids), np.concatenate(lens)


def hash_counts_chunk(args) -> "object":
    """Texts -> [n, dim] int16: each text's signed crc32 buckets of its
    tokens and token bigrams (the hash encoder's counts)."""
    import zlib

    import numpy as np

    texts, dim = args
    out = np.zeros((len(texts), dim), dtype=np.int16)
    crc = zlib.crc32
    seen: Dict[str, Tuple[int, int]] = {}
    for i, text in enumerate(texts):
        toks = tokenize(text)
        acc = [0] * dim
        for t in toks:
            hs = seen.get(t)
            if hs is None:
                h = crc(t.encode("utf-8"))
                hs = seen[t] = (h % dim, 1 if (h >> 16) & 1 else -1)
            acc[hs[0]] += hs[1]
        for a, b in zip(toks, toks[1:]):
            h = crc(f"{a}_{b}".encode("utf-8"))
            acc[h % dim] += 1 if (h >> 16) & 1 else -1
        out[i] = acc
    return out


def hash_counts(texts: List[str], dim: int, workers: int = 1):
    """`hash_counts_chunk` over all texts, in ``workers`` processes when
    more than one, in text order."""
    import numpy as np

    step = -(-len(texts) // max(workers, 1)) if texts else 1
    jobs = [(texts[a:a + step], dim) for a in range(0, len(texts), step)]
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(len(jobs)) as pool:
            parts = pool.map(hash_counts_chunk, jobs)
    else:
        parts = [hash_counts_chunk(j) for j in jobs]
    return (np.concatenate(parts) if parts
            else np.zeros((0, dim), dtype=np.int16))
