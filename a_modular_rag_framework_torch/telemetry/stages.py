"""Named ranges of the program's stages, and a table of their host time.

``with stage("engine/fetch"):`` is the one way the port opens a named
range. It is a ``torch.profiler`` ``record_function`` range, so a
profiler puts it on its timeline, on the device trace's clock, and ties
the device work launched inside it to it. While a profiler records in
the process (torch's own flag, one test per range), the range also adds
its host-clock duration to a table ``{name: (count, seconds)}``; with no
profiler it costs what a ``record_function`` range costs and that test.

The table keeps counts and sums, no timeline. Each thread sums into a
dict of its own, without a lock; `stage_table` merges them when read,
those of threads that have ended included, and `reset_stage_table`
empties them (call it while no profiler records).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_local = threading.local()
# every thread's dict {name: [count, seconds]}; the lock guards the list
_tables: List[Dict[str, list]] = []
_tables_lock = threading.Lock()


def _thread_table() -> Dict[str, list]:
    table = getattr(_local, "table", None)
    if table is None:
        table = _local.table = {}
        with _tables_lock:
            _tables.append(table)
    return table


class stage(record_function):
    """A named range of the program (see the module docstring)."""

    def __enter__(self):
        super().__enter__()
        self._t0 = (time.perf_counter() if _profiler._is_profiler_enabled
                    else None)
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            table = _thread_table()
            acc = table.get(self.name)
            if acc is None:
                table[self.name] = [1, dt]
            else:
                acc[0] += 1
                acc[1] += dt
        return super().__exit__(*exc)


def stage_table() -> Dict[str, Tuple[int, float]]:
    """{range name: (count, host seconds)} over every thread, since the
    last `reset_stage_table`; only ranges timed while a profiler
    recorded."""
    with _tables_lock:
        tables = list(_tables)
    out: Dict[str, Tuple[int, float]] = {}
    for table in tables:
        for name, (n, s) in list(table.items()):
            count, seconds = out.get(name, (0, 0.0))
            out[name] = (count + n, seconds + s)
    return out


def reset_stage_table() -> None:
    """Empty the table (every thread's sums)."""
    with _tables_lock:
        for table in _tables:
            table.clear()
