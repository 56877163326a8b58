"""Finding a cell's files by name.

A cell is ``cells/<name>.json``: ``{"config": <config>, "traffic": <mix>,
"judge": <judge>, "limits": {<number compared>: <limit>}, "control": <the
lower precision the limits were set against>}``. The configuration and
the mix are data files beside it; the metrics the cell reports come from
the checkout's ``BENCHMARK.json`` (an end-to-end metric without a
``workloads`` key is reported by every cell; one with the key, and every
per-layer metric, by the cells it lists).

Code is found by name too, one module per name (`load_module`):

- ``corpora/<generator>.py``: ``generate(params, samples, seed)``, the
  samples of a configuration (its ``corpus`` block names the generator);
- ``streams/<stream>.py``: ``make(mix, n_questions, seed)``, the order
  and timing of a mix's requests (the mix names its stream);
- ``entries/<entry>.py``: ``drive(...)``, the program's entry a window
  drives and the end-to-end values it measures (the mix names it);
- ``judges/<judge>.py``: ``make(ctx)``, the comparison that decides
  ``correct`` (the cell names it);
- ``encoders/<builder>.py``: ``build(block, seed, device)`` -> (the
  program's encoder, the parameter tree the reference reads) and
  ``flops(batch, block)``, the trunk's operations for one batch at its
  padded length (a configuration's ``encoder`` block names the builder
  under ``builder``; a block without it means ``text_encoder``, no block
  the program's hash encoder);
- ``reference/<reference>.py``: the plain reference (the configuration
  names it);
- ``metrics/<metric>.py``: ``read(run)``, a per-layer metric (a number or
  None).
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    judge: str
    limits: Dict[str, float]
    control: str = ""
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)


def _listed(metric: Dict[str, Any], cell: str, default: bool) -> bool:
    cells = metric.get("workloads")
    return default if cells is None else cell in cells


def find_cell(name: str, bench_json: Optional[Path] = None,
              root: Path = BENCH, listed: bool = True) -> Cell:
    """The cell's configuration, mix, limits and metric entries. Raises
    FileNotFoundError when a file is missing and, with ``listed``,
    KeyError when ``BENCHMARK.json`` does not list the cell (its files
    may wait there for a program fix: tests run them unlisted)."""
    cell = load_json(root / "cells" / f"{name}.json")
    config = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    spec = load_json(bench_json or root.parent / "BENCHMARK.json")
    if listed and name not in {w["name"] for w in spec["workloads"]}:
        raise KeyError(f"BENCHMARK.json lists no workload {name!r}")
    return Cell(
        name=name, config=config, traffic=traffic, judge=cell["judge"],
        limits=dict(cell.get("limits", {})), control=cell.get("control", ""),
        end_to_end=[m for m in spec["end_to_end"] if _listed(m, name, True)],
        per_layer=[m for m in spec["per_layer"] if _listed(m, name, False)])


def load_module(kind: str, name: str, root: Path = BENCH):
    """``<kind>/<name>.py`` of the benchmark, loaded by path (names may
    hold dots). A reference's folder goes on the import path: a reference
    keeps its helpers beside it and imports nothing of the harness."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    if kind == "reference" and str(path.parent) not in sys.path:
        sys.path.insert(0, str(path.parent))
    key = "".join(c if c.isalnum() else "_" for c in f"bench_{kind}_{name}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

