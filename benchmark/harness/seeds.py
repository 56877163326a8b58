"""Independent random streams drawn from a run's ``--seed``."""
from __future__ import annotations

import numpy as np


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream per use of the seed (any whole number:
    it is taken modulo 2**63)."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])
