"""The quality record's corpora through both packages' `answer_question`,
on the CPU.

`tools/e2e_run_torch.py` (the port's counterpart of `tools/e2e_run.py`)
records the rows `regress_variety`, `regress_heldout` and `natural_shipped`
of docs/E2E_RUN.json on the card; this file holds a cut of each against
the JAX package. Each corpus is ingested once by the tool's own
`build_corpus_settings` (the shipped settings, the backend's graph_root at
the ingest's graphs, so retrieval derives its seeds from BM25; the
per-question graphs elsewhere), and the JAX package reads the same docs,
packed index and graphs through its shipped YAML with an empty mesh (one
device, as the port serves). The cuts use the tool's own knobs:

  variety, heldout  300 samples, seed 17 (the record's corpora), the
                    questions of VARIETY_QUESTIONS / HELDOUT_QUESTIONS
  natural           the first 120 samples of data/natural/ with
                    index_titles, the questions of NATURAL_QUESTIONS

The natural questions were chosen by running the JAX package over the cut
first: question 7 is answered in retry round 1 with the verdict
INCONCLUSIVE, question 113 in retry round 1 with the right answer
(recovered by the retry) and PASS-WITH-NOISE, question 0 in round 0.

Equal on every question: the answer string, verdict, status, retry round,
`retrieval_source` and the workflow's node path (as in
`tests/test_torch_system.py::test_answer_question_matches_jax`), with the
shipped self-consistency runs (sc_runs 5), since verdicts and retries
depend on them. So is the count of BM25 candidates. Hit ids, and scores
within ATOL = 1e-5 (the engines' f32 programs differ by summation order
only), are compared where the cut is tie-free: where a question has at
most SEED_CUT = 64 BM25 candidates, the backend's derived graph seeds (its
top 64 BM25 rows) and its pool of 200 take every candidate, so no cut runs
through equal scores. The synthetic corpora are made from templates whose
sentences tie exactly in BM25, and the two packages' sorts break such ties
differently (ROADMAP.md C): variety question 2 has 68 candidates, the two
packages seed the graph with different equal-scored rows, and one fused
score differs by 9e-4 (same answer and verdict). The test prints the
questions whose hits it did not compare.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from a_modular_rag_framework_torch import system as t_system
from a_modular_rag_framework_tpu import system as j_system

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import e2e_run_torch  # noqa: E402

ATOL = 1e-5
SEED_CUT = 64  # the backend's derived graph seeds: the top 64 BM25 rows
VARIETY_QUESTIONS = (0, 1, 2)
HELDOUT_QUESTIONS = (0, 1)
NATURAL_QUESTIONS = (0, 7, 113)
CUTS = {  # corpus -> (samples, questions)
    "variety": (300, VARIETY_QUESTIONS),
    "heldout": (300, HELDOUT_QUESTIONS),
    "natural": (120, NATURAL_QUESTIONS),
}


@pytest.fixture(scope="module", params=sorted(CUTS))
def cut(request, tmp_path_factory):
    """One corpus ingested by the port's tool; a settings file per package
    over it."""
    corpus = request.param
    n_samples, questions = CUTS[corpus]
    work = tmp_path_factory.mktemp(f"quality_{corpus}")
    dataset = e2e_run_torch.dataset_block(corpus, n_samples)
    samples = e2e_run_torch.load_samples(dataset)
    t_path, t_settings = e2e_run_torch.build_corpus_settings(
        samples, work, dataset=dataset, index_titles=corpus == "natural",
        device="cpu")
    j = yaml.safe_load((REPO / "config" / "settings.yaml").read_text())
    j["mesh"] = {"axes": {}}
    j["dataset"] = dataset
    j["modules"]["retrieval"]["impl_kwargs"].update(
        t_settings["modules"]["retrieval"]["impl_kwargs"])
    j["modules"]["graph_construction"]["impl_kwargs"]["root_dir"] = str(
        work / "qgraphs_jax")
    j_path = work / "settings.yaml"
    j_path.write_text(yaml.safe_dump(j))
    t_system.reset_system_cache()
    j_system.reset_system_cache()
    yield {"corpus": corpus, "samples": samples, "questions": questions,
           "t": str(t_path), "j": str(j_path), "work": work}
    t_system.reset_system_cache()
    j_system.reset_system_cache()


def _node_names(runs, trace_id):
    lines = (Path(runs) / trace_id / "events.jsonl").read_text().splitlines()
    return [e.get("node") for e in map(json.loads, lines)
            if e.get("event") == "node_start"]


def _compare_hits(t_ret, j_ret, where):
    """The BM25 candidate counts equal; where no cut can run through a tie
    (at most SEED_CUT candidates), hit ids in order and scores within
    ATOL. Returns whether the hits were compared."""
    n_cand = t_ret["diagnostics"]["bm25_candidates"]
    assert n_cand == j_ret["diagnostics"]["bm25_candidates"], where
    if n_cand > SEED_CUT:
        return False
    assert ([h["id"] for h in t_ret["hits"]]
            == [h["id"] for h in j_ret["hits"]]), where
    np.testing.assert_allclose([h["score"] for h in t_ret["hits"]],
                               [h["score"] for h in j_ret["hits"]],
                               atol=ATOL, err_msg=where)
    return True


def test_quality_cut_matches_jax(cut):
    runs_t, runs_j = cut["work"] / "runs_t", cut["work"] / "runs_j"
    tied, j_rows = [], []
    for q in cut["questions"]:
        question = cut["samples"][q]["question"]
        t = t_system.answer_question(question, mode="full",
                                     settings_path=cut["t"],
                                     runs_dir=str(runs_t))
        j = j_system.answer_question(question, mode="full",
                                     settings_path=cut["j"],
                                     runs_dir=str(runs_j))
        where = f"{cut['corpus']} question {q}"
        assert t["reasoning"]["answer"] == j["reasoning"]["answer"], where
        assert t["verification"]["verdict"] == j["verification"]["verdict"], where
        assert t["verification"]["status"] == j["verification"]["status"], where
        assert t["retry_round"] == j["retry_round"], where
        assert t["retrieval_source"] == j["retrieval_source"], where
        assert (_node_names(runs_t, t["trace_id"])
                == _node_names(runs_j, j["trace_id"])), where
        if not _compare_hits(t["retrieval"], j["retrieval"], where):
            tied.append(q)
        j_rows.append((j["retry_round"], j["verification"]["verdict"]))
    if cut["corpus"] == "natural":  # the cut reaches the retry loop
        assert any(rr == 1 for rr, _ in j_rows), j_rows
        assert any(v != "PASS-WITH-NOISE" for _, v in j_rows), j_rows
    if tied:
        print(f"{cut['corpus']}: questions {tied} have more than {SEED_CUT} "
              f"BM25 candidates (a cut may run through exact ties): hits "
              f"not compared")


def test_reference_rows_fixture():
    """tests/fixtures/e2e_jax_rows.json (tools/e2e_reference_rows.py), which
    chip_smoke.py's quality phase holds the card against: every row has
    its questions, its aggregate is the one of its questions, and the
    natural row reaches the retry loop and a verdict other than
    PASS-WITH-NOISE, as the same questions do in the natural cut above."""
    sys.path.insert(0, str(REPO / "tools"))
    import e2e_reference_rows as ref

    rows = json.loads((REPO / "tests" / "fixtures" /
                       "e2e_jax_rows.json").read_text())["rows"]
    assert sorted(rows) == sorted(ref.ROWS)
    for corpus, (n_samples, n_questions, tag) in ref.ROWS.items():
        row = rows[corpus]
        assert (row["samples"], len(row["per_question"])) == (n_samples,
                                                              n_questions)
        assert row["record"]["tag"] == tag
        agg = row["aggregate"]
        assert agg["n"] == n_questions
        assert agg["em"] == round(sum(r["em"] for r in row["per_question"])
                                  / n_questions, 4)
        assert sum(agg["verdicts"].values()) == n_questions
    natural = [rows["natural"]["per_question"][q] for q in NATURAL_QUESTIONS]
    assert any(r["retry_round"] == 1 for r in natural)
    assert any(r["verdict"] != "PASS-WITH-NOISE" for r in natural)


def test_the_tool_without_a_device_asks_for_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        e2e_run_torch.main(["--corpus", "plain", "--samples", "4",
                            "--questions", "1", "--no_write"])
