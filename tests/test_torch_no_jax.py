"""The port runs without jax, pydantic or yaml.

A fresh interpreter (no conftest, so nothing imports jax first) imports
the port, builds a tiny index, runs both entry points on the CPU and
checks what was imported.
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
from a_modular_rag_framework_torch.index import SentenceCorpus, build_packed_index
from a_modular_rag_framework_tpu.eval.harness import evaluate_retrieval

loader = load_shared_module("core/dataset_loader.py")
samples = loader.SyntheticHotpotQALoader({"count": 12, "seed": 1}).load()
idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples), embed_dim=32)
eng = TorchQueryEngine(idx, device="cpu",
                       config=EngineConfig(top_k=5, batch_buckets=(16,)))
qs = [s["question"] for s in samples]
hybrid = eng.query_batch(qs)
dense = eng.query_dense_batch(qs)
rec = evaluate_retrieval(eng, samples, k=5, batch_size=16)
print(json.dumps({
    "hybrid_shape": list(hybrid.hits.ids.shape),
    "dense_shape": list(dense.hits.ids.shape),
    "hybrid_hits": int((hybrid.hits.ids >= 0).sum()),
    "recall": rec["recall_at_5"],
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
    assert out["hybrid_hits"] > 0
    assert out["recall"] > 0.0


def test_port_sources_have_no_jax_import():
    pkg = REPO / "a_modular_rag_framework_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text(encoding="utf-8").splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), path
