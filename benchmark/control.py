"""Readings that set a cell's correctness limits: the program's numbers
and the control's, on the same sample of answers, seed by seed.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--controls bfloat16] [--out <file.jsonl>]

Each seed is one set-up and one window of the cell's own traffic at its
own size (as ``benchmark/run.py``), then the plain reference judges the
program's answers and, for each control, the reference computed in that
lower precision put in the program's place. One JSON line per seed goes
to standard output and, with ``--out``, to that file. The benchmark's own
runs never run the control. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402  (sets the caches and the import path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=None,
                    help="reference precisions put in the program's place "
                         "(default: the cell's own control): bfloat16, "
                         "float8_e4m3fn (the dense cell's trunk)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from harness import spec

    if not torch.cuda.is_available():
        run.log("control: needs a CUDA device; no CPU fallback")
        return 3
    cell = spec.find_cell(args.workload)
    controls = (args.controls if args.controls is not None
                else [cell.control])
    run.log(f"card: {run.card_line()} | torch {torch.__version__}")
    for seed in args.seeds:
        torch.cuda.reset_peak_memory_stats()
        result, compared, notes, ctl = run.run_cell(
            cell, seed, args.seconds, False, "cuda", time.time(),
            controls=controls)
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {n: v for n, (v, _) in compared.items()},
            "controls": ctl, "metrics": result["metrics"],
            "notes": notes})
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
