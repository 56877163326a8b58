"""Synthetic questions and paragraphs at the widths of HotpotQA's
distractor setting (Yang et al., EMNLP 2018, arXiv:1809.09600).

    generate(params, samples, seed) -> [sample, ...]

Each sample has the HotpotQA schema (``_id``, ``question``, ``answer``,
``type``, ``level``, ``context`` = [[title, [sentence, ...]], ...],
``supporting_facts`` = [[title, sentence id], ...]) and ``paragraphs``
paragraphs: its 2 gold ones and the rest distractors. The widths come from
the configuration's ``corpus`` block: sentences per paragraph, words per
sentence and per question (each drawn uniformly from a closed range), the
share of comparison questions, the vocabulary and its Zipf exponent, the
share of function words and of sentences that name a place or an
organisation.

Two kinds of question, as in HotpotQA:

- bridge: "In which city was the <profession> born who collaborated with
  <A> on <words of A's sentence>?" A's paragraph names B in its sentence 1,
  B's names the city in its sentence 0; the supporting facts are those two
  sentences.
- comparison: "Who was born first, the <profession> <X> of <words> or <Y>
  of <words>?" X's and Y's sentence 0 give their years.

Every seed draws the same sizes (sentences, words, question lengths and
kinds come from a stream that does not depend on the seed) and other
words, names and orders, so seeds change the text and not the work.
Person names are the repository generator's collide-entities names (first
and last name tokens shared by many people, full names unique); the text
is plain ASCII without apostrophes or hyphens.
"""
from __future__ import annotations

import functools
import hashlib
import os
import sys
from typing import Any, Dict, List

import numpy as np

SYLLABLES = ["an", "bel", "cor", "dra", "el", "fen", "gar", "hol", "in",
             "jor", "kel", "lor", "mar", "nor", "or", "pel", "quin", "rav",
             "sel", "tor", "ul", "ven", "wyn", "xan", "yor", "zel"]
# content words and place names: strict consonant-vowel syllables, which
# no person name token can equal (those hold consonant pairs or end in a
# consonant after a vowel-initial syllable); place names end in "th",
# which neither holds
_CONS = "bdfgklmnprstvz"
_VOWELS = "aeiou"
FUNCTION_WORDS = ["the", "of", "and", "in", "a", "to", "was", "is", "for",
                  "by", "with", "as", "on", "from", "at", "his", "her", "an",
                  "which", "that"]
KINDS = ["University", "River", "Valley", "Museum", "Company", "Hall",
         "Island", "County", "Society", "Orchestra"]
PROFESSION = ["architect", "botanist", "cartographer", "drummer",
              "engineer", "falconer", "glassblower", "historian",
              "illustrator", "jeweler", "kayaker", "librarian",
              "mathematician", "novelist", "organist", "photographer"]
# the size stream: one fixed key, so every seed draws the same sizes
_SIZE_KEY = 0x5EED_51E5
# samples are made in chunks of this many, each from a stream of its own,
# so the samples do not depend on how many processes make them
CHUNK = 1024


def _cv_word(idx: int, syllables: int) -> str:
    out = []
    for _ in range(syllables):
        c, idx = idx % len(_CONS), idx // len(_CONS)
        v, idx = idx % len(_VOWELS), idx // len(_VOWELS)
        out.append(_CONS[c] + _VOWELS[v])
    return "".join(out)


def _synth_name(idx: int) -> str:
    s = SYLLABLES
    parts = [s[idx % 26], s[(idx // 26) % 26], s[(idx // 676) % 26]]
    idx //= 26 ** 3
    while idx:
        parts.append(s[idx % 26])
        idx //= 26
    return "".join(parts).capitalize()


def _zipf_cdf(n: int, exponent: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** exponent
    return np.cumsum(w) / w.sum()


def _stem(i: int) -> str:
    """The i-th consonant-vowel stem: 4,900 of two syllables, then three."""
    return _cv_word(i, 2) if i < 70 * 70 else _cv_word(i, 3)


@functools.lru_cache(maxsize=4)
def _stems(n: int) -> np.ndarray:
    return np.array([_stem(i) for i in range(n)], dtype=object)


class _Words:
    """Filler words drawn in bulk: function words (Zipf over the list)
    with probability ``function_share``, else content words (Zipf over
    ``vocabulary`` consonant-vowel stems)."""

    BLOCK = 1 << 18

    def __init__(self, rng: np.random.Generator, p: Dict[str, Any]):
        self.rng = rng
        v = int(p["vocabulary"])
        self.content = _stems(v)
        self.content_cdf = _zipf_cdf(v, float(p["zipf_exponent"]))
        self.function = np.array(FUNCTION_WORDS, dtype=object)
        self.function_cdf = _zipf_cdf(len(FUNCTION_WORDS), 1.0)
        self.function_share = float(p["function_share"])
        self.buf: List[str] = []
        self.pos = 0

    def _refill(self) -> None:
        n = self.BLOCK
        u = self.rng.random(n)
        fn = self.rng.random(n) < self.function_share
        out = np.where(
            fn, self.function[np.minimum(np.searchsorted(
                self.function_cdf, u), len(FUNCTION_WORDS) - 1)],
            self.content[np.minimum(np.searchsorted(self.content_cdf, u),
                                    len(self.content) - 1)])
        self.buf = self.buf[self.pos:] + out.tolist()
        self.pos = 0

    def draw(self, n: int) -> List[str]:
        if self.pos + n > len(self.buf):
            self._refill()
        self.pos += n
        return self.buf[self.pos - n:self.pos]


def content_of(words: List[str]) -> List[str]:
    fw = set(FUNCTION_WORDS)
    return [w for w in words if w not in fw]


def _sizes(p: Dict[str, Any], samples: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng([_SIZE_KEY, samples])
    P = int(p["paragraphs"])
    s_lo, s_hi = p["sentences_per_paragraph"]
    w_lo, w_hi = p["words_per_sentence"]
    q_lo, q_hi = p["question_words"]
    return {
        "sents": rng.integers(s_lo, s_hi + 1, size=(samples, P)),
        "words": rng.integers(w_lo, w_hi + 1, size=(samples, P, s_hi)),
        "qwords": rng.integers(q_lo, q_hi + 1, size=samples),
        "comparison": rng.random(samples) < float(p["comparison_share"]),
        "mention": rng.random((samples, P, s_hi)) < float(p["mention_share"]),
    }


def rows_of(p: Dict[str, Any], samples: int) -> int:
    """Sentence rows of ``samples`` samples (the same for every seed)."""
    return int(_sizes(p, samples)["sents"].sum())


def generate(p: Dict[str, Any], samples: int, seed: int) -> List[dict]:
    """``samples`` samples from ``seed``: chunks of `CHUNK` samples, in up
    to 8 worker processes at a large count (the same samples either way)."""
    jobs = [(p, samples, int(seed), a, min(a + CHUNK, samples))
            for a in range(0, samples, CHUNK)]
    workers = min(8, os.cpu_count() or 1, len(jobs))
    if workers > 1 and samples >= 4 * CHUNK:
        import multiprocessing as mp

        # the workers import this module by its file name
        here = os.path.dirname(os.path.abspath(__file__))
        if here not in sys.path:
            sys.path.insert(0, here)
        import hotpot_distractor as by_name

        with mp.get_context("spawn").Pool(workers) as pool:
            parts = pool.map(by_name.generate_chunk, jobs, chunksize=1)
    else:
        parts = [generate_chunk(j) for j in jobs]
    return [x for part in parts for x in part]


def generate_chunk(job) -> List[dict]:
    """Samples ``start .. stop`` of ``samples`` from ``seed``."""
    p, samples, seed, start, stop = job
    size = _sizes(p, samples)
    P, s_hi = int(p["paragraphs"]), int(p["sentences_per_paragraph"][1])
    key = int(seed) % (1 << 63)
    rng = np.random.default_rng([key, 11, start])
    words = _Words(rng, p)
    n_places = int(p["places"])
    place_cdf = _zipf_cdf(n_places, float(p["zipf_exponent"]))
    places = [w.capitalize() + "th" for w in _stems(n_places)]
    # the places named (at most one per sentence and one per paragraph)
    # and a uniform per sentence for its mention's kind and position
    n_draw = (stop - start) * P * (s_hi + 1)
    place_at = iter(np.minimum(np.searchsorted(
        place_cdf, rng.random(n_draw)), n_places - 1).tolist())
    mention_u = iter(rng.random(n_draw).tolist())
    first_pool, last_pool = int(p["first_pool"]), int(p["last_pool"])
    pool = first_pool * last_pool
    # person numbers: one base from the seed, then P a sample in order
    counter = [int(np.random.default_rng([key, 12]).integers(pool))
               + start * P]

    def person() -> str:
        # the collide-entities names: a Knuth mix of a counter (a bijection
        # mod the power-of-two pool), first names from even indices and
        # surnames from odd ones
        m = (counter[0] * 2654435761) % pool
        counter[0] += 1
        return (f"{_synth_name(2 * (m % first_pool))} "
                f"{_synth_name(2 * (m // first_pool) + 1)}")

    def place() -> str:
        return places[next(place_at)]

    def sentence(core: List[str], core_words: int, n_words: int,
                 mention: bool):
        """(text, its filler words): ``core`` (``core_words`` words) and
        filler words up to ``n_words`` words."""
        fill = words.draw(max(n_words - core_words, 4))
        if mention:
            # "of <place>" or "of <place> <Kind>" in place of two filler
            # words, with lowercase words on both sides
            u = next(mention_u)
            name = place()
            if u < 0.5:
                name += " " + KINDS[int(u * 2 * len(KINDS))]
            at = 1 + int(u * 2 % 1 * (len(fill) - 3))
            fill[at:at + 2] = ["of", name]
        return " ".join(core + fill) + ".", fill

    out: List[dict] = []
    for i in range(start, stop):
        n_s, n_w, ment = size["sents"][i], size["words"][i], size["mention"][i]
        comparison = bool(size["comparison"][i])
        people = [person() for _ in range(P)]
        a, b = people[0], people[1]
        years = rng.choice(np.arange(1700, 2000), size=P, replace=False)
        cities = [place() for _ in range(P)]
        prof = PROFESSION[int(rng.integers(len(PROFESSION)))]
        context, fills = [], {}
        for j, name in enumerate(people):
            sents = []
            for s in range(int(n_s[j])):
                # names are two words, places one
                if s == 0:
                    core, nc = [name, "was", "born", "in", str(years[j]),
                                "in", cities[j]], 8
                elif s == 1 and j == 0 and not comparison:
                    core, nc = [a, "collaborated", "closely", "with", b], 7
                else:
                    core, nc = [name], 2
                text, fills[j, s] = sentence(core, nc, int(n_w[j][s]),
                                             bool(ment[j][s]) and s > 0)
                sents.append(text)
            context.append([name, sents])
        q_len = int(size["qwords"][i])
        if comparison:
            head = ["Who", "was", "born", "first", "the", prof, a, "of"]
            mid = ["or", b, "of"]
            need = max(q_len - len(head) - len(mid), 2)
            wa, wb = content_of(fills[0, 0]), content_of(fills[1, 0])
            na = (need + 1) // 2
            question = " ".join(head + wa[:na] + mid + wb[:need - na]) + "?"
            answer = a if years[0] < years[1] else b
            facts = [[a, 0], [b, 0]]
            kind = "comparison"
        else:
            head = ["In", "which", "city", "was", "the", prof, "born", "who",
                    "collaborated", "with", a, "on"]
            need = max(q_len - len(head), 1)
            wa = content_of(fills[0, 1])
            question = " ".join(head + wa[:need]) + "?"
            answer = cities[1]
            facts = [[a, 1], [b, 0]]
            kind = "bridge"
        order = rng.permutation(P)
        out.append({
            "_id": hashlib.sha1(f"{seed}:{i}".encode()).hexdigest()[:24],
            "question": question, "answer": answer, "type": kind,
            "level": "medium",
            "context": [context[int(k)] for k in order],
            "supporting_facts": facts,
        })
    return out
