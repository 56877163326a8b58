#!/usr/bin/env python3
"""Recorded end-to-end QA runs through the PyTorch port.

The port's counterpart of tools/e2e_run.py: the full workflow (graph
construction -> hybrid retrieval with iterative 2-hop -> plan / synthesize
reasoning -> rules + LLM verification and the retry loop) through the
port's `answer_question` under the shipped settings
(config/settings_torch.json), over an ingested corpus, reporting EM /
relaxed EM / F1, verdicts, retry rounds, seconds per question and their
split by workflow node.

  python tools/e2e_run_torch.py [--corpus plain|variety|heldout|natural] \
      [--samples 300] [--questions 100] [--seed 17] [--tag natural_shipped] \
      [--device cpu] [--per_question rows.json] [--no_write]

As in tools/e2e_run.py the backend's graph_root holds the ingest's
supporting-fact graphs, so retrieval derives its seeds from BM25 (the
per-question graphs go to a directory of their own). Without ``--device``
the system runs on the card and raises where there is none. Updates
docs/E2E_RUN_TORCH.json under ``--tag`` (default ``<corpus>_shipped``),
other entries kept; ``--per_question`` writes each question's answer,
verdict, status, retry round, EM and F1.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
NATURAL = ROOT / "data" / "natural" / "natural_hotpotqa.json"


def dataset_block(corpus: str, samples: int, seed: int = 17) -> dict:
    """tools/e2e_run.py's dataset block: the real-schema natural corpus, or
    the synthetic generator with unique entities."""
    if corpus == "natural":
        return {"type": "hotpotqa", "path": str(NATURAL), "count": samples}
    return {"type": "synthetic_hotpotqa", "count": samples, "seed": seed,
            "unique_entities": True, "variety": corpus == "variety",
            "heldout": corpus == "heldout"}


def load_samples(dataset: dict) -> list:
    from a_modular_rag_framework_torch.core.dataset_loader import (
        HotpotQALoader, SyntheticHotpotQALoader)

    loader = (HotpotQALoader if dataset["type"] == "hotpotqa"
              else SyntheticHotpotQALoader)
    return loader(dataset).load()


def build_corpus_settings(samples, work: Path, *, dataset: dict,
                          index_titles: bool = False, device=None):
    """Ingest ``samples`` under ``work`` with the port's ingest and write a
    settings file that points the shipped config at it
    (`di.factory.write_settings`): the backend's index_path and graph_root
    (the ingest's graphs), the per-question graphs under ``work/qgraphs``,
    the dataset block, and a top-level ``device`` when one is given (none:
    the card). Returns (settings path, settings)."""
    from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest
    from a_modular_rag_framework_torch.di.factory import write_settings

    work.mkdir(parents=True, exist_ok=True)
    docs_out = work / "docs.jsonl"
    ingest(samples, graph_root=work / "graph", docs_out=docs_out,
           index_titles=index_titles)
    s_path = work / "settings.json"
    write_settings(s_path, device=device, dataset=dataset, docs=docs_out,
                   graph_root=work / "graph", root_dir=work / "qgraphs",
                   retrieval={"index_titles": True} if index_titles else None)
    return s_path, json.loads(s_path.read_text())


def run_questions(samples, settings_path, runs_dir):
    """Each sample's question through `answer_question(mode="full")`.
    Returns (per-question rows, summary). A row holds the answer, verdict,
    status, retry round, EM / F1 / containment, seconds, the hits
    ({id: score}), the seed mode, the graph's size and the workflow's node
    path and the count of BM25 candidates (above 64, the backend's derived
    graph seeds are a cut that can run through exact BM25 ties); the
    summary tools/e2e_run.py's keys plus the first question's
    seconds (it builds the system), the steady seconds per question, the
    seconds per question of every workflow node and the engine's
    dispatch-to-fetch ms per question."""
    from a_modular_rag_framework_torch.eval.metrics import (exact_match,
                                                            f1_score)
    from a_modular_rag_framework_torch.system import answer_question
    from a_modular_rag_framework_torch.telemetry.sinks import (
        _read_events, build_latency_breakdown)

    rows, spans = [], {}
    device_ms = 0.0
    t_all = time.time()
    for s in samples:
        t0 = time.time()
        res = answer_question(s["question"], mode="full",
                              settings_path=str(settings_path),
                              runs_dir=str(runs_dir))
        sec = time.time() - t0
        events = _read_events(Path(runs_dir) / res["trace_id"])
        for node, node_sec in build_latency_breakdown(events)["by_node"].items():
            spans[node] = spans.get(node, 0.0) + node_sec
        device_ms += sum(float((e.get("payload") or {}).get("device_ms") or 0)
                         for e in events if e.get("event") == "device_timing")
        answer = (res.get("reasoning") or {}).get("answer") or ""
        ver = res.get("verification") or {}
        retrieval = res.get("retrieval") or {}
        hits = retrieval.get("hits") or []
        rows.append({
            "answer": answer, "verdict": ver.get("verdict") or "?",
            "status": ver.get("status"), "ok": bool(ver.get("ok")),
            "retry_round": int(res.get("retry_round") or 0),
            "retrieval_source": res.get("retrieval_source"),
            "em": exact_match(answer, s["answer"]),
            "contains": s["answer"].lower() in answer.lower(),
            "f1": f1_score(answer, s["answer"]), "sec": sec,
            "hits": {h["id"]: h["score"] for h in hits},
            "seed_mode": (retrieval.get("diagnostics") or {}).get("seed_mode"),
            "bm25_candidates": (retrieval.get("diagnostics") or {}).get(
                "bm25_candidates"),
            "graph": ((res.get("graph") or {}).get("node_count"),
                      (res.get("graph") or {}).get("edge_count")),
            "nodes": [e.get("node") for e in events
                      if e.get("event") == "node_start"],
        })
    total = time.time() - t_all
    return rows, summarize(rows, spans, device_ms, total)


def summarize(rows, spans, device_ms, total) -> dict:
    n = max(len(rows), 1)
    verdicts, rounds = {}, {}
    confusion = {"right_pass": 0, "right_fail": 0, "wrong_pass": 0,
                 "wrong_fail": 0}
    for r in rows:
        verdicts[r["verdict"]] = verdicts.get(r["verdict"], 0) + 1
        rr = str(r["retry_round"])
        rounds[rr] = rounds.get(rr, 0) + 1
        confusion[("right" if r["em"] else "wrong")
                  + ("_pass" if r["ok"] else "_fail")] += 1
    wrong = confusion["wrong_pass"] + confusion["wrong_fail"]
    fails = confusion["wrong_fail"] + confusion["right_fail"]
    steady = [r["sec"] for r in rows[1:]] or [r["sec"] for r in rows]
    return {
        "n": len(rows),
        "em": round(sum(r["em"] for r in rows) / n, 4),
        "em_relaxed": round(sum(r["contains"] for r in rows) / n, 4),
        "f1": round(sum(r["f1"] for r in rows) / n, 4),
        "verdicts": verdicts,
        "verifier_confusion": confusion,
        "verdict_recall_on_wrong": (round(confusion["wrong_fail"] / wrong, 4)
                                    if wrong else None),
        "verdict_precision_on_fail": (round(confusion["wrong_fail"] / fails, 4)
                                      if fails else None),
        "retry_rounds": rounds,
        "retry_recovered": sum(1 for r in rows
                               if r["retry_round"] > 0 and r["em"]),
        "total_sec": total,
        "sec_per_question": total / n,
        "first_question_sec": rows[0]["sec"] if rows else 0.0,
        "steady_sec_per_question": sum(steady) / max(len(steady), 1),
        "span_sec_per_question": {k: v / n for k, v in sorted(spans.items())},
        "engine_device_ms_per_question": device_ms / n,
        "seed_modes": sorted({str(r["seed_mode"]) for r in rows}),
    }


def card_line() -> str:
    """nvidia-smi's name and power limit, or "" where it is absent."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", default="plain",
                    choices=["plain", "variety", "heldout", "natural"])
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--questions", type=int, default=100)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--tag", default=None,
                    help="E2E_RUN_TORCH.json key (default <corpus>_shipped)")
    ap.add_argument("--device", default=None,
                    help="torch device of the system (default: the card)")
    ap.add_argument("--per_question", default=None,
                    help="write each question's answer, verdict, status, "
                         "retry round, EM and F1 here (JSON)")
    ap.add_argument("--no_write", action="store_true")
    args = ap.parse_args(argv)
    tag = args.tag or f"{args.corpus}_shipped"

    dataset = dataset_block(args.corpus, args.samples, args.seed)
    samples = load_samples(dataset)
    work = Path(tempfile.mkdtemp(prefix="e2e_run_torch_"))
    try:
        t0 = time.time()
        s_path, _ = build_corpus_settings(
            samples, work, dataset=dataset,
            index_titles=args.corpus == "natural", device=args.device)
        ingest_sec = time.time() - t0
        rows, summary = run_questions(samples[: args.questions], s_path,
                                      work / "runs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        from a_modular_rag_framework_torch.system import reset_system_cache

        reset_system_cache()

    import torch

    dev = args.device or "cuda"
    row = {"corpus": args.corpus, "samples": len(samples),
           "sentences": sum(len(se) for s in samples for _, se in s["context"]),
           **summary, "ingest_sec": ingest_sec, "device": dev,
           "card": (card_line() if torch.device(dev).type == "cuda" else ""),
           "torch": torch.__version__}
    print(json.dumps({tag: row}, indent=2))
    if args.per_question:
        Path(args.per_question).write_text(json.dumps([
            {k: r[k] for k in ("answer", "verdict", "status", "retry_round",
                               "em", "f1")} for r in rows], indent=1) + "\n")
    if not args.no_write:
        out = ROOT / "docs" / "E2E_RUN_TORCH.json"
        data = json.loads(out.read_text()) if out.exists() else {}
        data[tag] = row
        out.write_text(json.dumps(data, indent=2) + "\n")
    return row


if __name__ == "__main__":
    main()
