"""Run CLI: batch QA over a dataset slice with eval metrics.

The port's copy of ``a_modular_rag_framework_tpu/cli/run_system.py``.

Role parity with the reference implementation's my_code/run_system.py (loop dataset slice
through answer_question, write results.json) plus the eval harness the
reference lacked: per-run EM / relaxed-EM / F1 and verdict distribution.

Usage:
  python -m a_modular_rag_framework_torch.cli.run_system \
      --settings config/settings_torch.json --mode full --output results.json
"""
from __future__ import annotations

import argparse
import functools
import json
from pathlib import Path

from ..core.dataset_loader import build_dataset_loader
from ..di.factory import load_settings
from ..eval.harness import evaluate_system
from ..system import answer_question


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", type=str, default="config/settings_torch.json")
    ap.add_argument("--mode", type=str, default="full",
                    choices=["graph_only", "full"])
    ap.add_argument("--output", type=str, default="results.json")
    ap.add_argument("--count", type=int, default=None,
                    help="override dataset.count")
    args = ap.parse_args(argv)

    settings = load_settings(args.settings)
    ds_cfg = dict(settings.get("dataset", {}) or {})
    if args.count is not None:
        ds_cfg["count"] = args.count
    loader = build_dataset_loader(ds_cfg)
    samples = loader.load()

    answer = functools.partial(answer_question, settings_path=args.settings)
    report = evaluate_system(answer, samples, mode=args.mode)

    for rec in report["records"]:
        print(f"Q: {rec['question'][:60]}... -> Pred: {rec['pred'][:60]} "
              f"(gold: {rec['gold']}) [{rec['verdict']}]")
    summary = {k: v for k, v in report.items() if k != "records"}
    print(json.dumps(summary, indent=2))

    out_path = Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=2, ensure_ascii=False),
                        encoding="utf-8")
    print(f"Saved {len(report['records'])} results to {out_path}")


if __name__ == "__main__":
    main()
