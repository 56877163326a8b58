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

Beside it, `moe_table` counts what a mixture-of-experts layer routed
while a profiler recorded (`count_moe`, called by ``ops/moe.py``): for
each layer, the batches seen, the routed token slots and the largest
slots one expert took in a batch, with the layer's widths. The sums stay
on the device until the table is read, so counting adds a few small
device ops and no wait.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Tuple

import torch
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


# layer name -> [batches, device sums [slots, largest expert's slots],
# (experts held, expert width, hidden)]
_moe: Dict[str, list] = {}
_moe_lock = threading.Lock()


def count_moe(name: str, counts: torch.Tensor, expert_shape) -> None:
    """Add one batch of layer ``name`` to `moe_table` while a profiler
    records: ``counts`` [experts held] are the routed slots of each held
    expert (on the device), ``expert_shape`` its gate weights' (experts
    held, expert width, hidden)."""
    if not _profiler._is_profiler_enabled:
        return
    pair = torch.stack([counts.sum(), counts.max()]) if counts.numel() else (
        torch.zeros(2, dtype=torch.long, device=counts.device))
    with _moe_lock:
        acc = _moe.get(name)
        if acc is None:
            _moe[name] = [1, pair, tuple(int(v) for v in expert_shape)]
        else:
            acc[0] += 1
            acc[1] = torch.stack([acc[1][0] + pair[0],
                                  torch.maximum(acc[1][1], pair[1])])


def moe_table() -> Dict[str, Dict[str, Any]]:
    """{layer: {"batches", "slots", "max_expert_slots", "experts_held",
    "expert_width", "hidden"}} since the last `reset_moe_table`, counted
    while a profiler recorded (reading it waits for the device)."""
    with _moe_lock:
        items = [(n, b, s, shape) for n, (b, s, shape) in _moe.items()]
    out = {}
    for name, batches, sums, (held, width, hidden) in items:
        slots, largest = (int(v) for v in sums.tolist())
        out[name] = {"batches": batches, "slots": slots,
                     "max_expert_slots": largest, "experts_held": held,
                     "expert_width": width, "hidden": hidden}
    return out


def reset_moe_table() -> None:
    """Empty `moe_table`."""
    with _moe_lock:
        _moe.clear()
