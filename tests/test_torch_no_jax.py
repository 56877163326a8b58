"""The port runs without jax, pydantic or yaml.

A fresh interpreter (no conftest, so nothing imports jax first) imports
the port, builds a tiny index, runs both entry points of the engine (the
dense [B, N] and the compact form), iterative 2-hop retrieval and the
QueryServer on the CPU, and checks what was imported.
"""
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import json, sys
from a_modular_rag_framework_torch._host import load_shared_module
from a_modular_rag_framework_torch.engine import EngineConfig, TorchQueryEngine
from a_modular_rag_framework_torch.engine.server import QueryServer
from a_modular_rag_framework_torch.index import SentenceCorpus, build_packed_index
from a_modular_rag_framework_torch.modules.retrieval.multihop import (
    iterative_retrieve, iterative_retrieve_pipelined)
from a_modular_rag_framework_tpu.eval.harness import evaluate_retrieval

loader = load_shared_module("core/dataset_loader.py")
samples = loader.SyntheticHotpotQALoader({"count": 12, "seed": 1}).load()
idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples), embed_dim=32)
eng = TorchQueryEngine(idx, device="cpu",
                       config=EngineConfig(top_k=5, batch_buckets=(16,)))
qs = [s["question"] for s in samples]
hybrid = eng.query_batch(qs)
compact = TorchQueryEngine(idx, device="cpu", config=EngineConfig(
    top_k=5, batch_buckets=(16,), graph_impl="compact")).query_batch(qs)
dense = eng.query_dense_batch(qs)
rec = evaluate_retrieval(eng, samples, k=5, batch_size=16)
it_ids, _, _, diag = iterative_retrieve(eng, qs, top_k=5)
piped = list(iterative_retrieve_pipelined(eng, [qs[:6], qs[6:]], top_k=5))
with QueryServer(eng, max_batch=8) as server:
    served = server.submit(qs[0], mode="iterative", top_k=5).result(60)
print(json.dumps({
    "hybrid_shape": list(hybrid.hits.ids.shape),
    "forms": [hybrid.diagnostics["graph_impl"],
              compact.diagnostics["graph_impl"]],
    "dense_shape": list(dense.hits.ids.shape),
    "hybrid_hits": int((hybrid.hits.ids >= 0).sum()),
    "recall": rec["recall_at_5"],
    "iterative_shape": list(it_ids.shape),
    "hop2_active": diag["hop2_active"],
    "pipelined_equal": bool((piped[0][0] == it_ids[:6]).all()),
    "served": [h.id for h in served] == [
        eng.index.corpus.hit_id(int(i)) for i in it_ids[0] if i >= 0],
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pydantic", "yaml")),
}))
"""


def test_port_imports_and_runs_without_jax_pydantic_yaml():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["hybrid_shape"] == [12, 5] and out["dense_shape"] == [12, 5]
    assert out["forms"] == ["dense", "compact"]
    assert out["hybrid_hits"] > 0
    assert out["recall"] > 0.0
    assert out["iterative_shape"] == [12, 5] and out["hop2_active"] > 0
    assert out["pipelined_equal"] and out["served"]


def test_port_sources_have_no_jax_import():
    pkg = REPO / "a_modular_rag_framework_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text(encoding="utf-8").splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), path
