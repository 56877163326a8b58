"""Spans of the benchmark and the reading of a ``torch.profiler`` window.

`span(name)` is a ``record_function`` range named ``bench/<name>`` that
also keeps its host-clock duration; it is on in every run, traced or not,
so the timed path is the same code in both. `Window` profiles the
measured window of a ``--trace 1`` run (CPU and CUDA activities) and
reduces the kineto events to what the per-layer metrics read:

- device ops: kernels, memcpys and memsets on the card, with their
  launching thread and host time (through the runtime call's correlation
  id);
- ``range_ms[name]``: device ms of the ops launched inside each instance
  of a host range (``engine/*`` and ``model/*`` ranges of the program,
  ``bench/*`` spans of the benchmark), with ``range_count[name]``;
- ``busy_s``: the union of the device ops' intervals; ``window_s``;
- ``device_ops``: device seconds by op name; ``idle_gaps``: idle device
  seconds by the benchmark span the host was in (the first of the entry's
  ``GAP_SPANS`` that holds the gap's midpoint, else any ``bench/`` span,
  else "other").

The parsing follows ``tools/profile_torch_engine.py::window`` of the
program at commit 7bd9f40 (device-side events only; the ranges'
own device annotations are not counted as work), with times taken per
event instead of from ``key_averages``.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

class Spans:
    """Host-clock durations of the benchmark's spans, by name."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with record_function(f"bench/{name}"):
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)


def _device_events(events) -> Tuple[list, dict]:
    """(device ops [(name, start_ns, end_ns, correlation)], runtime
    correlation -> (thread, host start_ns))."""
    ops, launches = [], {}
    for e in events:
        dt = e.device_type()
        if dt == torch.autograd.DeviceType.CUDA:
            name = e.name()
            if name.startswith(("bench/", "engine/", "model/")):
                continue
            ops.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id()))
        elif dt == torch.autograd.DeviceType.CPU:
            cid = e.correlation_id()
            if cid and e.name().startswith(("cuda", "cu")):
                launches[cid] = (e.start_thread_id(), e.start_ns())
    return ops, launches


def _ranges(events) -> Dict[str, Dict[int, Tuple[list, list]]]:
    """name -> thread -> (sorted starts, ends) of the host ranges."""
    out: Dict[str, Dict[int, list]] = defaultdict(lambda: defaultdict(list))
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        name = e.name()
        if name.startswith(("bench/", "engine/", "model/")):
            out[name][e.start_thread_id()].append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    res = {}
    for name, by_thread in out.items():
        res[name] = {}
        for tid, iv in by_thread.items():
            iv.sort()
            res[name][tid] = ([a for a, _ in iv], [b for _, b in iv])
    return res


def _inside(ranges: Tuple[list, list], t: int) -> bool:
    starts, ends = ranges
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


class Window:
    """A profiled window; `summary()` after it closed. ``device_only``
    traces the card's ops alone (no host ranges, so nothing is attributed
    to a range): what an end-to-end metric read from the device trace
    needs, at the least cost to the host."""

    def __init__(self, enabled: bool, device_only: bool = False):
        self.enabled = enabled
        self.device_only = device_only
        self._prof = None
        self.wall_s = 0.0

    def __enter__(self):
        if self.enabled and self.device_only:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        elif self.enabled:
            from torch.profiler import ProfilerActivity, profile
            # every thread's ranges: the pipelined loop prepares and
            # launches its batches on a worker thread
            self._prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                experimental_config=torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True))
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def summary(self, gap_spans=()) -> Optional[dict]:
        if self._prof is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        ops, launches = _device_events(events)
        ranges = _ranges(events)
        range_ms: Dict[str, float] = defaultdict(float)
        by_op: Dict[str, float] = defaultdict(float)
        intervals = []
        for name, a, b, cid in ops:
            by_op[name] += (b - a) / 1e9
            intervals.append((a, b))
            launch = launches.get(cid)
            if launch is None:
                continue
            tid, t = launch
            for rname, by_thread in ranges.items():
                iv = by_thread.get(tid)
                if iv is not None and _inside(iv, t):
                    range_ms[rname] += (b - a) / 1e6
        intervals.sort()
        busy_ns, gaps = 0, []
        cur_a = cur_b = None
        for a, b in intervals:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy_ns += cur_b - cur_a
                    gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy_ns += cur_b - cur_a
        idle_by_span: Dict[str, float] = defaultdict(float)
        order = [f"bench/{n}" for n in gap_spans] + sorted(
            n for n in ranges if n.startswith("bench/")
            and n[len("bench/"):] not in gap_spans)
        for a, b in gaps:
            mid = (a + b) // 2
            label = "other"
            for sname in order:
                if any(_inside(iv, mid)
                       for iv in ranges.get(sname, {}).values()):
                    label = sname[len("bench/"):]
                    break
            idle_by_span[label] += (b - a) / 1e9
        counts = {name: sum(len(iv[0]) for iv in by_thread.values())
                  for name, by_thread in ranges.items()}
        top = sorted(by_op.items(), key=lambda x: -x[1])[:10]
        idle = sorted(idle_by_span.items(), key=lambda x: -x[1])[:10]
        return {"busy_s": busy_ns / 1e9, "window_s": self.wall_s,
                "range_ms": dict(range_ms), "range_count": counts,
                "kernel_ms": {n: s * 1e3 for n, s in by_op.items()},
                "device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in idle]}


def per_dispatch(summary: Optional[dict], names, per: str = "engine/fusion"
                 ) -> Optional[float]:
    """Device ms of the ops launched inside the ranges ``names`` over a
    traced window, per ``per`` range (one per program dispatch); None
    where the trace holds none of them."""
    if not summary:
        return None
    count = summary["range_count"].get(per, 0)
    got = [summary["range_ms"][n] for n in names if n in summary["range_ms"]]
    if not count or not got:
        return None
    return sum(got) / count
