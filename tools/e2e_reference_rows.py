#!/usr/bin/env python3
"""The JAX package's answers on the quality record's corpora, per question:
the reference the port's quality check holds itself to.

    python tools/e2e_reference_rows.py [--out tests/fixtures/e2e_jax_rows.json]

Runs the JAX package's `answer_question(mode="full")` on the CPU over the
corpora of `tools/e2e_run.py` (whose `build_corpus_settings` makes the
settings: the shipped config/settings.yaml pointed at the ingested corpus,
the backend's graph_root at the ingest's graphs, so retrieval derives its
seeds from BM25), with an empty mesh so one device serves, as the port
does. Rows:

  variety  300 samples, seed 17, the first 100 questions
  heldout  300 samples, seed 17, the first 100 questions
  natural  the whole 1,015-sample corpus of data/natural/, index_titles,
           the first 150 questions

For each question it records the answer, verdict, status and retry round
(and EM / F1 against the gold answer); for each row the aggregate beside
the matching docs/E2E_RUN.json row (regress_variety, regress_heldout,
natural_shipped). ~5 min on an 8-core CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

ROWS = {  # corpus -> (samples, questions, the record's row)
    "variety": (300, 100, "regress_variety"),
    "heldout": (300, 100, "regress_heldout"),
    "natural": (1015, 150, "natural_shipped"),
}
SEED = 17
NATURAL = REPO / "data" / "natural" / "natural_hotpotqa.json"


def dataset_block(corpus: str, samples: int, seed: int = SEED) -> dict:
    """`tools/e2e_run.py`'s dataset block for ``corpus``."""
    if corpus == "natural":
        return {"type": "hotpotqa", "path": str(NATURAL), "count": samples}
    return {"type": "synthetic_hotpotqa", "count": samples, "seed": seed,
            "unique_entities": True, "variety": corpus == "variety",
            "heldout": corpus == "heldout"}


def run_row(corpus: str, n_samples: int, n_questions: int) -> dict:
    import yaml

    from a_modular_rag_framework_tpu.core.dataset_loader import (
        HotpotQALoader, SyntheticHotpotQALoader)
    from a_modular_rag_framework_tpu.eval.metrics import exact_match, f1_score
    from a_modular_rag_framework_tpu.system import (answer_question,
                                                     reset_system_cache)
    from e2e_run import build_corpus_settings

    ds = dataset_block(corpus, n_samples)
    loader = HotpotQALoader if corpus == "natural" else SyntheticHotpotQALoader
    samples = loader(ds).load()
    work = Path(tempfile.mkdtemp(prefix=f"e2e_ref_{corpus}_"))
    s_path, settings = build_corpus_settings(
        samples, work, index_titles=corpus == "natural")
    settings["dataset"] = ds
    settings["mesh"] = {"axes": {}}  # one device, as the port serves
    # the per-question graphs under the work directory, not the cwd
    settings["modules"]["graph_construction"]["impl_kwargs"]["root_dir"] = str(
        work / "qgraphs")
    s_path.write_text(yaml.safe_dump(settings))
    reset_system_cache()

    per_q = []
    t0 = time.time()
    for s in samples[:n_questions]:
        res = answer_question(s["question"], mode="full",
                              settings_path=str(s_path),
                              runs_dir=str(work / "runs"))
        answer = (res.get("reasoning") or {}).get("answer") or ""
        ver = res.get("verification") or {}
        per_q.append({
            "answer": answer, "verdict": ver.get("verdict") or "?",
            "status": ver.get("status"), "ok": bool(ver.get("ok")),
            "retry_round": int(res.get("retry_round") or 0),
            "retrieval_source": res.get("retrieval_source"),
            "em": exact_match(answer, s["answer"]),
            "f1": round(f1_score(answer, s["answer"]), 6),
        })
    sec = time.time() - t0
    reset_system_cache()
    shutil.rmtree(work, ignore_errors=True)
    return {"samples": n_samples, "questions": n_questions, "seed": SEED,
            "per_question": per_q, "aggregate": aggregate(per_q, samples),
            "cpu_sec_per_question": round(sec / max(len(per_q), 1), 3)}


def aggregate(per_q, samples) -> dict:
    """EM / relaxed EM / F1, verdicts and retry rounds of the rows, in
    `tools/e2e_run.py`'s keys."""
    n = max(len(per_q), 1)
    verdicts, rounds = {}, {}
    for r in per_q:
        verdicts[r["verdict"]] = verdicts.get(r["verdict"], 0) + 1
        rounds[str(r["retry_round"])] = rounds.get(str(r["retry_round"]), 0) + 1
    relaxed = sum(s["answer"].lower() in r["answer"].lower()
                  for r, s in zip(per_q, samples))
    return {"n": len(per_q), "em": round(sum(r["em"] for r in per_q) / n, 4),
            "em_relaxed": round(relaxed / n, 4),
            "f1": round(sum(r["f1"] for r in per_q) / n, 4),
            "verdicts": verdicts, "retry_rounds": rounds,
            "retry_recovered": sum(1 for r in per_q
                                   if r["retry_round"] > 0 and r["em"])}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "tests" / "fixtures" /
                                         "e2e_jax_rows.json"))
    args = ap.parse_args(argv)
    # before the JAX package loads: the CPU, and no compilation cache
    # written outside the repository
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("AMRF_DISABLE_JAX_CACHE", "1")

    record = json.loads((REPO / "docs" / "E2E_RUN.json").read_text())
    out = {"package": "a_modular_rag_framework_tpu", "platform": "cpu",
           "settings": "tools/e2e_run.py::build_corpus_settings, mesh {}",
           "rows": {}}
    for corpus, (n_samples, n_questions, tag) in ROWS.items():
        row = run_row(corpus, n_samples, n_questions)
        rec = record[tag]
        row["record"] = {"tag": tag, **{k: rec[k] for k in (
            "n", "em", "em_relaxed", "f1", "verdicts", "retry_rounds",
            "retry_recovered")}}
        out["rows"][corpus] = row
        print(json.dumps({corpus: row["aggregate"],
                          "record": row["record"],
                          "cpu_sec_per_question": row["cpu_sec_per_question"]}),
              flush=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
