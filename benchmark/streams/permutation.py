"""Closed-loop batches of questions: every question of the corpus once,
in an order drawn from the seed, then a fresh order. Every seed sends the
same number of questions per call from the same set, so seeds change the
order and not the work.

The mix's ``batch`` is the questions per call; the entry sends the next
batch when a result comes back.
"""
from __future__ import annotations

import numpy as np

from harness.seeds import seed_rng


class Permutation:
    """Batches of question indices in ``[0, n_questions)``."""

    def __init__(self, batch: int, n_questions: int, seed: int):
        self.batch = int(batch)
        self.n = int(n_questions)
        self._rng = seed_rng(seed, 1)
        self._perm = self._rng.permutation(self.n)
        self._pos = 0

    def next_batch(self) -> np.ndarray:
        out = []
        need = self.batch
        while need:
            take = self._perm[self._pos:self._pos + need]
            out.append(take)
            need -= len(take)
            self._pos += len(take)
            if self._pos == self.n:
                self._perm = self._rng.permutation(self.n)
                self._pos = 0
        return np.concatenate(out)


def make(mix: dict, n_questions: int, seed: int) -> Permutation:
    return Permutation(mix["batch"], n_questions, seed)
