"""What an entry's window gives back (`entries/<entry>.py::drive`)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class WindowResult:
    seconds: float = 0.0
    questions: int = 0
    calls: int = 0
    # host clock at each result, from the window's start
    at: List[float] = field(default_factory=list)
    # per call: (question indices, hit ids [B, k], hit scores [B, k])
    results: List[tuple] = field(default_factory=list)
    # the end-to-end values the entry measured over the window, by metric
    # name (``setup_s`` is the harness's)
    values: Dict[str, float] = field(default_factory=dict)
