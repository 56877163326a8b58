"""The port's recorded-transcript and Ollama providers, on the CPU.

The unit cases of `tests/test_transcript_provider.py` against the port's
`TranscriptReplayProvider` / `TranscriptRecorder`, and its three system
cases through the port's `answer_question`, selecting the provider by the
port's class path in a JSON settings file (``"device": "cpu"``): a
hand-authored transcript feeds plan variance, three drafts of which two
agree, and a 3/1/1 supported / insufficient / contradicted verdict mix
over five fact-check runs. The same transcript through the JAX package
gives the same answers, votes and self-consistency summaries.

`OllamaProvider` makes no live call here: with ``requests`` unimportable
(as it may be on the card's machine) every call falls back to the mock,
as in the JAX package.
"""
import json
import sys
from pathlib import Path

import pytest
import yaml

from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest
from a_modular_rag_framework_torch.core.dataset_loader import (
    SyntheticHotpotQALoader)
from a_modular_rag_framework_torch.core.providers import (
    MockProvider, OllamaProvider, TranscriptRecorder, TranscriptReplayProvider)
from a_modular_rag_framework_torch.system import (answer_question,
                                                  reset_system_cache)
from a_modular_rag_framework_tpu import system as j_system
from a_modular_rag_framework_tpu.core.providers import (
    OllamaProvider as JOllamaProvider)

REPO = Path(__file__).resolve().parents[1]
CLASS = ("a_modular_rag_framework_torch.core.providers."
         "transcript_provider:TranscriptReplayProvider")


def _write(path: Path, entries) -> str:
    path.write_text("\n".join(json.dumps(e) for e in entries) + "\n")
    return str(path)


# ---------------- unit: replay mechanics ----------------


def test_replay_cycles_responses(tmp_path):
    p = _write(tmp_path / "t.jsonl", [
        {"purpose": "plan", "responses": ["A", "B"]},
    ])
    prov = TranscriptReplayProvider(p)
    texts = [prov.complete("anything", purpose="plan")["text"]
             for _ in range(5)]
    assert texts == ["A", "B", "A", "B", "A"]


def test_matching_precedence(tmp_path):
    p = _write(tmp_path / "t.jsonl", [
        {"purpose": "synthesize", "responses": ["catchall"]},
        {"purpose": "synthesize", "contains": "Marie", "responses": ["sub"]},
        {"purpose": "synthesize", "prompt": "exact prompt",
         "responses": ["exact"]},
    ])
    prov = TranscriptReplayProvider(p)
    assert prov.complete("exact prompt", purpose="synthesize")["text"] == "exact"
    assert prov.complete("about Marie Okafor", purpose="synthesize")["text"] == "sub"
    assert prov.complete("other", purpose="synthesize")["text"] == "catchall"


def test_unmatched_falls_back_to_mock_or_raises(tmp_path):
    p = _write(tmp_path / "t.jsonl", [
        {"purpose": "plan", "responses": ["A"]},
    ])
    prov = TranscriptReplayProvider(p)
    out = prov.complete("Question:\nWho is X?", purpose="factcheck")
    assert out["text"] and "replayed" not in out  # mock path
    strict = TranscriptReplayProvider(p, strict=True)
    with pytest.raises(KeyError):
        strict.complete("Question:\nWho is X?", purpose="factcheck")
    with pytest.raises(FileNotFoundError):
        TranscriptReplayProvider(str(tmp_path / "missing.jsonl"), strict=True)


def test_embed_delegates_to_mock(tmp_path):
    prov = TranscriptReplayProvider("")
    out = prov.embed(["a", "b"])
    assert len(out["vectors"]) == 2 and len(out["vectors"][0]) == 64


def test_recorder_roundtrip(tmp_path):
    out_path = tmp_path / "rec.jsonl"
    with TranscriptRecorder(MockProvider(), out_path=str(out_path)) as rec:
        r1 = rec.complete("Question:\nWho wrote X?", purpose="plan")
        r2 = rec.complete("Question:\nWho wrote X?", purpose="plan")
    replay = TranscriptReplayProvider(str(out_path), strict=True)
    assert replay.complete("Question:\nWho wrote X?",
                           purpose="plan")["text"] == r1["text"]
    assert replay.complete("Question:\nWho wrote X?",
                           purpose="plan")["text"] == r2["text"]


@pytest.mark.parametrize("purpose", ["plan", "synthesize", "factcheck"])
def test_ollama_without_requests_falls_back_to_the_mock(monkeypatch, purpose):
    monkeypatch.setitem(sys.modules, "requests", None)  # import fails
    prompt = "Question:\nIn which city was Sage Silverton born?"
    texts = ["Sage Silverton was born in Zephyr Bay.", "lion mane"]
    t = OllamaProvider(embed_dim_fallback=32)
    j = JOllamaProvider(embed_dim_fallback=32)
    assert t.complete(prompt, purpose=purpose) == MockProvider(
        embed_dim=32).complete(prompt, purpose=purpose)
    assert t.complete(prompt, purpose=purpose) == j.complete(prompt,
                                                             purpose=purpose)
    assert t.embed(texts) == j.embed(texts)
    assert len(t.embed(texts)["vectors"][0]) == 32


# ---------------- e2e: variance through the full pipeline ----------------


N_SAMPLES = 4


def _transcript(path: Path, gold: str) -> str:
    return _write(path, [
        # plan variance: straight list, then one with prose chatter the
        # parser must drop
        {"purpose": "plan", "responses": [
            "1) Identify the collaborator the question pivots on\n"
            "2) Find the birthplace of that collaborator",
            "Sure! Here is the plan:\n"
            "Step 1: spot the pivot person\n"
            "Step 2 - look up where they were born",
        ]},
        # drafts that DISAGREE: two for gold, one dissenting
        {"purpose": "synthesize", "responses": [
            f"{gold} [#1]", "Atlantis [#2]", f"{gold}. [#1]",
        ]},
        # 3 supported / 1 insufficient / 1 contradicted over 5 sc runs
        {"purpose": "factcheck", "responses": [
            json.dumps({"verdict": "supported", "score": 0.9,
                        "valid_citations": [1]}),
            json.dumps({"verdict": "insufficient", "score": 0.4}),
            json.dumps({"verdict": "supported", "score": 0.85,
                        "valid_citations": [1]}),
            json.dumps({"verdict": "contradicted", "score": 0.2,
                        "misleading_citations": [2]}),
            json.dumps({"verdict": "supported", "score": 0.9}),
        ]},
    ])


def _with_transcript(base, transcript, root, tag):
    base["providers"]["transcript"] = {
        "type": CLASS if tag == "t" else CLASS.replace(
            "a_modular_rag_framework_torch", "a_modular_rag_framework_tpu"),
        "kwargs": {"transcript_path": transcript},
    }
    route = [{"model": "recorded", "provider": "transcript",
              "ctx": 32000, "price": 0.0}]
    base["llm_policy"]["routes"]["ReasoningAgent"] = {
        "plan": route, "synthesize": route}
    base["llm_policy"]["routes"]["VerifierAgent"] = {"factcheck": route}
    rcfg = base["modules"]["retrieval"]["impl_kwargs"]
    rcfg["index_path"] = str(root / "data" / "docs.jsonl")
    rcfg["graph_root"] = str(root / tag / "graph")
    base["modules"]["graph_construction"]["impl_kwargs"]["root_dir"] = str(
        root / tag / "graph")
    base["modules"]["reasoning"]["impl_kwargs"]["n_drafts"] = 3
    base["modules"]["reasoning"]["impl_kwargs"]["max_refine_rounds"] = 0
    base["modules"]["verification"]["impl_kwargs"]["sc_runs"] = 5
    return base


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_transcript_e2e")
    samples = SyntheticHotpotQALoader({"count": N_SAMPLES, "seed": 11}).load()
    ingest(samples, graph_root=root / "data" / "graph_ingest",
           docs_out=root / "data" / "docs.jsonl", build_graphs=True, pack=True)
    s = samples[0]
    transcript = _transcript(root / "transcript.jsonl", s["answer"])
    t = json.loads((REPO / "config" / "settings_torch.json").read_text())
    t["device"] = "cpu"
    t = _with_transcript(t, transcript, root, "t")
    (root / "settings.json").write_text(json.dumps(t))
    j = yaml.safe_load((REPO / "config" / "settings.yaml").read_text())
    j["mesh"] = {"axes": {}}
    j = _with_transcript(j, transcript, root, "j")
    (root / "settings.yaml").write_text(yaml.safe_dump(j))
    reset_system_cache()
    j_system.reset_system_cache()
    yield {"settings": str(root / "settings.json"),
           "j_settings": str(root / "settings.yaml"), "sample": s,
           "runs": str(root / "runs"), "j_runs": str(root / "j_runs"),
           "gold": s["answer"]}
    reset_system_cache()
    j_system.reset_system_cache()


def _both(env):
    """One call through each package (each has its own replay provider, so
    the transcript cycles the same way in both)."""
    q = env["sample"]["question"]
    t = answer_question(q, mode="full", settings_path=env["settings"],
                        runs_dir=env["runs"])
    j = j_system.answer_question(q, mode="full",
                                 settings_path=env["j_settings"],
                                 runs_dir=env["j_runs"])
    assert t["reasoning"]["answer"] == j["reasoning"]["answer"]
    assert t["reasoning"]["steps"] == j["reasoning"]["steps"]
    assert (t["verification"]["self_consistency"]
            == j["verification"]["self_consistency"])
    assert t["verification"]["verdict"] == j["verification"]["verdict"]
    return t


def test_disagreeing_drafts_resolve_by_majority(env):
    res = _both(env)
    answer = res["reasoning"]["answer"]
    assert env["gold"] in answer and "Atlantis" not in answer
    votes = res["reasoning"]["steps"][3]["votes"]
    assert len(votes) == 2, f"expected a 2-1 split, got {votes}"
    assert sorted(votes.values()) == [1, 2]


def test_verdict_mix_aggregates_below_unanimity(env):
    res = _both(env)
    sc = res["verification"]["self_consistency"]
    assert sc["runs"] == 5
    assert sc["majority_verdict"] == "supported"
    assert 0.0 < sc["agreement_rate"] < 1.0
    assert res["verification"]["verdict"] not in ("FAIL-CONTRADICTED",)


def test_plan_variance_is_coerced_identically(env):
    res = _both(env)
    plan = res["reasoning"]["steps"][0]["plan"]
    assert len(plan.splitlines()) == 2
    assert "Sure!" not in plan and "Here is the plan" not in plan
