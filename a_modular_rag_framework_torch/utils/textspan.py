"""Unicode-aware capitalized-span extraction (shared NER-lite helper).

The port's copy of ``a_modular_rag_framework_tpu/utils/textspan.py``.
Replaces the ASCII-only ``\\b[A-Z][a-z]+(?: [A-Z][a-z]+)*\\b`` pattern used
throughout the reference implementation (e.g. its
app/modules/graph_construction/node_builder.py:80 and
app/utils/entity_linker.py) with a
tokenizer that also handles diacritics (Çelik), apostrophes (O'Brien),
internal caps (McDonald), and hyphens (Jean-Luc), and can optionally bridge
lowercase name particles (de / van / of ...) inside a run.
"""
from __future__ import annotations

import re
from typing import List

# word = letters (any script) possibly joined by apostrophes/hyphens
_TOKEN_RE = re.compile(r"[^\W\d_](?:[^\W\d_]|['’\-])*", re.UNICODE)

# lowercase particles allowed *inside* a capitalized run when particles=True
_PARTICLES = frozenset({
    "de", "del", "della", "der", "den", "da", "das", "dos", "do", "di",
    "du", "van", "von", "la", "le", "al", "bin", "ibn", "of", "ter",
    "ten", "y", "e",
})


def _is_cap_word(tok: str) -> bool:
    """Capitalized word: upper-initial, len >= 2, and not an all-caps
    acronym — mirrors what the old ASCII pattern accepted, minus its
    blindness to non-ASCII letters and internal capitals."""
    return (len(tok) >= 2 and tok[0].isupper()
            and any(c.islower() for c in tok))


# ASCII fast path: one compiled regex matches a whole run at once instead
# of walking every token in Python (the loop below costs ~11us per short
# query — 22ms of a 2048-query batch's host budget; this regex ~2ms).
# A cap word = upper initial + at least one lowercase somewhere
# ("McDonald", "ABc"); runs extend over " Word", " D. Word", " D Word"
# segments so middle initials ride along exactly like the general loop.
# The lookbehind rejects starts glued inside a preceding token ("xJohn
# Smith" must not yield "John Smith" — the tokenizer sees one word
# "xJohn"). Texts with apostrophes or hyphens take the general loop: a
# quote char is a token BREAK before a word ("'Tis") but a JOINER inside
# one ("O'Brien"), which a fixed-width lookbehind cannot distinguish.
_ASCII_CAP = r"[A-Z][A-Za-z]*[a-z][A-Za-z]*"
_ASCII_RUN_RE = re.compile(
    rf"(?<![A-Za-z]){_ASCII_CAP}(?: (?:[A-Z]\.? )*{_ASCII_CAP})*")
_ASCII_CAP_RE = re.compile(_ASCII_CAP)


def _runs_ascii(text: str, min_words: int) -> List[str]:
    runs = _ASCII_RUN_RE.findall(text)
    if min_words > 1:
        runs = [r for r in runs
                if len(_ASCII_CAP_RE.findall(r)) >= min_words]
    return runs


def capitalized_runs(text: str, *, min_words: int = 1,
                     particles: bool = False) -> List[str]:
    """Return maximal runs of adjacent capitalized words in ``text``.

    Words must be separated by plain spaces (any other character breaks the
    run, like the old regex's single-space separator). With
    ``particles=True``, lowercase name particles may sit between capitalized
    words of one run ("Vincent van Gogh"); a run still must start and end on
    a capitalized word. ``min_words`` counts capitalized words only.
    """
    if (not particles and text.isascii()
            and "'" not in text and "-" not in text):
        return _runs_ascii(text, min_words)
    return _runs_general(text, min_words, particles)


def _runs_general(text: str, min_words: int, particles: bool) -> List[str]:
    runs: List[str] = []
    run_start = run_end = -1   # char span of current run (ends on cap word)
    caps_in_run = 0
    pending_particle_ok = False
    prev_initial = False       # previous token was a middle initial ("D")
    prev_end = -1

    def flush() -> None:
        nonlocal run_start, run_end, caps_in_run, pending_particle_ok
        nonlocal prev_initial
        if caps_in_run >= min_words and run_start >= 0:
            # the English possessive clitic is not part of the name:
            # "Persona's director" names "Persona" (the reference's ASCII
            # pattern never captured the clitic either, node_builder.py:80)
            run = text[run_start:run_end]
            if run.endswith(("'s", "’s")):
                run = run[:-2]
            runs.append(run.rstrip("'’"))
        run_start = run_end = -1
        caps_in_run = 0
        pending_particle_ok = False
        prev_initial = False

    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        start = m.start()
        # adjacency = single-space gap (or ". " after a middle initial);
        # positional compare avoids allocating a gap substring per token
        adjacent = run_start >= 0 and prev_end >= 0 and (
            (start - prev_end == 1 and text[prev_end] == " ")
            or (prev_initial and start - prev_end == 2
                and text[prev_end] == "." and text[prev_end + 1] == " "))
        is_initial = len(tok) == 1 and tok.isupper()
        if _is_cap_word(tok):
            if not adjacent:
                flush()
                run_start = m.start()
                caps_in_run = 0
            run_end = m.end()
            caps_in_run += 1
            pending_particle_ok = particles
            prev_initial = False
        elif adjacent and is_initial:
            # "John D. Rockefeller": the initial rides along; the run only
            # extends (through run_end) if a cap word follows
            prev_initial = True
        elif adjacent and pending_particle_ok and tok.lower() in _PARTICLES:
            # particle rides along; run only extends if a cap word follows
            prev_initial = False
        else:
            flush()
        prev_end = m.end()
    flush()
    return runs
