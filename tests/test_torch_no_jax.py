"""The port runs without jax, optax, orbax, pydantic, yaml or the JAX
package.

A fresh interpreter (no conftest, so nothing imports jax first) imports
the port, builds a tiny index, runs both entry points of the engine (the
dense [B, N] and the compact form), the port's own evaluation harness,
iterative 2-hop retrieval and the QueryServer on the CPU, the sharded
engine and the sharded dryrun (``parallel``) on two CPU positions, then the learned
models (a `TextEncoder` as the engine's and `build_packed_index`'s encoder,
the SPLADE channel, the cross-encoder reranker, the sidecar), then one
`answer_question(mode="full")` from a JSON settings file, then the training
path (one train step of each model, a chunk of the device-resident
trainer, a train state saved and restored, the encoder's train CLI and the
dense lab's functions), then the rest of the surface (the HTTP front's
routes, the request adapters and v2 schema, the graph store, the
providers, similarity, the reference harness's metrics), and checks what
was imported: no module of jax,
optax, orbax, pydantic or yaml, and no module whose file lies in the JAX
package or the repo-root ``native/`` directory. An AST scan of the port's
sources, ``chip_smoke.py`` and the port's tools finds no import of jax,
optax, orbax or the JAX package and no path built into it.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = "a_modular_rag_framework_tpu"
PORT_SOURCES = sorted((REPO / "a_modular_rag_framework_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_engine.py",
    REPO / "tools" / "profile_dense_topk.py",
    REPO / "tools" / "dense_lab_torch.py",
    REPO / "tools" / "reembed_index_torch.py",
    REPO / "tools" / "prebuild_sidecars_torch.py",
    REPO / "tools" / "sharded_multicard_check_torch.py",
    REPO / "tools" / "e2e_run_torch.py"]
# JAX modules whose port has another name, and the one module with no port
# (utils/jax_setup.py: the compilation cache is jax-only; the engine reads
# its NaN switch, AMRF_DEBUG_NANS, itself)
RENAMED = {"core/providers/tpu_embed_provider.py":
           "core/providers/torch_embed_provider.py",
           "modules/retrieval/tpu_backend.py":
           "modules/retrieval/torch_backend.py"}
NOT_PORTED = ("utils/jax_setup.py",)

SCRIPT = r"""
import json, sys, tempfile
from pathlib import Path
from a_modular_rag_framework_torch.core.dataset_loader import (
    SyntheticHotpotQALoader)
from a_modular_rag_framework_torch.engine import EngineConfig, TorchQueryEngine
from a_modular_rag_framework_torch.engine.server import QueryServer
from a_modular_rag_framework_torch.eval.harness import (evaluate_dense,
                                                         evaluate_retrieval)
from a_modular_rag_framework_torch.index import (
    SentenceCorpus, attach_learned_embeddings, build_packed_index,
    embed_corpus_pipelined, save_learned_embeddings)
from a_modular_rag_framework_torch.models import (
    CrossEncoderConfig, CrossEncoderReranker, EncoderConfig, SpladeConfig,
    SpladeEncoder, TextEncoder)
from a_modular_rag_framework_torch.ops.splade import SpladeDenseHybrid
from a_modular_rag_framework_torch.modules.retrieval.multihop import (
    iterative_retrieve, iterative_retrieve_pipelined)
from a_modular_rag_framework_torch.native.binding import native_available

samples = SyntheticHotpotQALoader({"count": 12, "seed": 1}).load()
idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples), embed_dim=32)
eng = TorchQueryEngine(idx, device="cpu",
                       config=EngineConfig(top_k=5, batch_buckets=(16,)))
qs = [s["question"] for s in samples]
hybrid = eng.query_batch(qs)
compact = TorchQueryEngine(idx, device="cpu", config=EngineConfig(
    top_k=5, batch_buckets=(16,), graph_impl="compact")).query_batch(qs)
dense = eng.query_dense_batch(qs)
rec = evaluate_retrieval(eng, samples, k=5, batch_size=16)
dense_rec = evaluate_dense(eng, samples, k=5)
it_ids, _, _, diag = iterative_retrieve(eng, qs, top_k=5)
piped = list(iterative_retrieve_pipelined(eng, [qs[:6], qs[6:]], top_k=5))
with QueryServer(eng, max_batch=8) as server:
    served = server.submit(qs[0], mode="iterative", top_k=5).result(60)
from a_modular_rag_framework_torch.parallel import (ShardedHybridEngine,
                                                    build_mesh)
from a_modular_rag_framework_torch.parallel.dryrun import dryrun_multichip
sharded = ShardedHybridEngine(
    idx, mesh=build_mesh({"data": 2}, devices=["cpu"] * 2),
    config=EngineConfig(top_k=5, batch_buckets=(16,))).query_batch(qs)
dryrun_lines = []
dryrun_multichip(2, device="cpu", log=dryrun_lines.append)

small = dict(vocab_size=256, max_len=8, d_model=16, n_heads=2, n_layers=1,
             d_ff=32, subword_ngrams=2)
enc = TextEncoder(EncoderConfig(**small), seed=0, device="cpu")
corpus = SentenceCorpus.from_hotpotqa(samples)
texts = corpus.texts()
with tempfile.TemporaryDirectory() as tmp:
    enc.save(tmp + "/enc.npz")
    learned_idx = build_packed_index(corpus, encoder=enc, out_dir=tmp + "/a/idx")
    save_learned_embeddings(tmp + "/a/idx", embed_corpus_pipelined(
        enc, texts, batch=32), tmp + "/enc.npz", enc.cfg)
    q_enc, _ = attach_learned_embeddings(learned_idx, tmp + "/a/idx",
                                         device="cpu")
    learned = TorchQueryEngine(learned_idx, device="cpu", encoder=q_enc,
                               config=EngineConfig(top_k=5, batch_buckets=(16,)))
    learned_hits = learned.query_batch(qs)
    learned_dense = learned.query_dense_batch(qs)
    sp = SpladeEncoder(SpladeConfig(encoder=EncoderConfig(**small),
                                    doc_top_terms=16, query_top_terms=4),
                       seed=1, device="cpu")
    sp.save(tmp + "/sp.npz")
    splade = TorchQueryEngine(idx, device="cpu", config=EngineConfig(
        top_k=5, batch_buckets=(16,), sparse_impl="splade",
        splade_weights=tmp + "/sp.npz")).query_batch(qs)
rr = CrossEncoderReranker(CrossEncoderConfig(max_query_len=3, **small),
                          seed=2, pair_budget=8, device="cpu")
hybrid_sp = SpladeDenseHybrid(sp, pool_k=8, build_batch=32, reranker=rr,
                              rerank_top_m=3)
hybrid_sp.build(texts)
sp_ids, _ = hybrid_sp.query_batch(qs[:4], top_k=5)

from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest
from a_modular_rag_framework_torch.system import answer_question
with tempfile.TemporaryDirectory() as tmp:
    settings = json.loads(Path("config/settings_torch.json").read_text())
    settings["device"] = "cpu"
    ingest(samples, graph_root=Path(tmp) / "ingest", build_graphs=False,
           docs_out=Path(tmp) / "docs.jsonl")
    settings["dataset"] = {"type": "synthetic_hotpotqa", "count": 12, "seed": 1}
    settings["modules"]["retrieval"]["impl_kwargs"].update(
        index_path=tmp + "/docs.jsonl", graph_root=tmp + "/graph")
    settings["modules"]["graph_construction"]["impl_kwargs"]["root_dir"] = (
        tmp + "/graph")
    settings["modules"]["verification"]["impl_kwargs"]["sc_runs"] = 2
    Path(tmp, "settings.json").write_text(json.dumps(settings))
    qa = answer_question(qs[0], mode="full", runs_dir=tmp + "/runs",
                         settings_path=tmp + "/settings.json")
# the rest of the surface: serve CLI, providers, graph store, adapters
# (the JAX package's v2 schema is pydantic), similarity, reference harness
from a_modular_rag_framework_torch.adapters import hotpotqa_to_v2
from a_modular_rag_framework_torch.cli.serve import _App
from a_modular_rag_framework_torch.core.providers import (
    OllamaProvider, TranscriptReplayProvider)
from a_modular_rag_framework_torch.eval.reference_harness import score_hits
from a_modular_rag_framework_torch.modules.retrieval import RetrievalAdapter
from a_modular_rag_framework_torch.modules.retrieval.graph_store import (
    build_index, expand_qmatch_neighbors)
from a_modular_rag_framework_torch.utils.similarity import mmr_diversify
with QueryServer(eng, max_batch=8) as server:
    served_http = _App(server, idx.n_docs).handle("/query", {"query": qs[0]})
v2 = hotpotqa_to_v2({"context": samples[0]["context"]}).model_dump()
g = {"nodes": [{"id": "D::sent0", "type": "sentence", "text": "zebra"},
               {"id": "D::sent1", "type": "sentence", "text": "lion"}],
     "edges": [{"source": "D::sent0", "target": "D::sent1",
                "type": "next_in_doc"}]}
expanded = expand_qmatch_neighbors("zebra", *build_index(g)[:4], device="cpu")
surface = [served_http[0], len(v2["inputs"]["sentences"]) > 0,
           sorted(expanded), len(mmr_diversify([("a", 1.0, None)])),
           TranscriptReplayProvider("").complete("x", purpose="plan")["text"] != "",
           score_hits(["sent::D::0"], {"supporting_facts": [["D", 0]]}, 5)]
import contextlib, io
import torch
from a_modular_rag_framework_torch.cli import train_encoder as train_cli
from a_modular_rag_framework_torch.models import checkpoint, cross_encoder
from a_modular_rag_framework_torch.models import encoder as enc_mod
from a_modular_rag_framework_torch.models import splade as splade_mod
sys.path.insert(0, "tools")
import dense_lab_torch, prebuild_sidecars_torch, reembed_index_torch

ecfg = EncoderConfig(**small)
pairs = dense_lab_torch.build_collide_pairs(8, 50)
batch = {k: torch.from_numpy(v) for k, v in
         TextEncoder.make_pair_batch(*pairs, ecfg).items()}
train_losses = {}
for name, make, params in (
        ("encoder", enc_mod.make_train_step(ecfg), enc.params),
        ("splade", splade_mod.make_splade_train_step(sp.cfg), sp.params)):
    init_state, step = make
    state = init_state(params)
    first = float(step(params, state, batch)[2]["loss"])
    train_losses[name] = [first, float(step(params, state, batch)[2]["loss"])]
lists = cross_encoder.CrossEncoderReranker.make_listwise_batch(
    qs[:4], [texts[i:i + 3] for i in range(4)], [0, 1, 2, 0], rr.cfg)
init_state, step = cross_encoder.make_cross_train_step(rr.cfg)
train_losses["cross"] = [float(step(
    rr.params, init_state(rr.params),
    {k: torch.from_numpy(v) for k, v in lists.items()})[2]["loss"])]
with tempfile.TemporaryDirectory() as tmp:
    checkpoint.save_train_state(tmp, sp.params, state, 2)
    restored = checkpoint.restore_train_state(tmp, sp.params, state)
    lab_params = dense_lab_torch.train(*pairs, ecfg, steps=4, batch=8,
                                       lr=1e-3, chunk=2, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as cli_out:
        train_cli.main(["--synthetic", "8", "--steps", "2", "--batch", "8",
                        "--d_model", "16", "--out", tmp + "/cli.npz",
                        "--device", "cpu"])
    cli_report = json.loads(cli_out.getvalue().strip().splitlines()[-1])
repo = Path.cwd().resolve()
banned = (repo / "a_modular_rag_framework_tpu", repo / "native")
files = [Path(f).resolve() for m in list(sys.modules.values())
         if isinstance(f := getattr(m, "__file__", None), str)]
print(json.dumps({
    "hybrid_shape": list(hybrid.hits.ids.shape),
    "forms": [hybrid.diagnostics["graph_impl"],
              compact.diagnostics["graph_impl"]],
    "dense_shape": list(dense.hits.ids.shape),
    "hybrid_hits": int((hybrid.hits.ids >= 0).sum()),
    "recall": rec["recall_at_5"],
    "dense_keys": sorted(dense_rec),
    "iterative_shape": list(it_ids.shape),
    "hop2_active": diag["hop2_active"],
    "pipelined_equal": bool((piped[0][0] == it_ids[:6]).all()),
    "served": [h.id for h in served] == [
        eng.index.corpus.hit_id(int(i)) for i in it_ids[0] if i >= 0],
    "native": native_available(),
    "sharded": [list(sharded.hits.ids.shape), sharded.diagnostics["n_shards"]],
    "dryrun": dryrun_lines[-1],
    "learned_shapes": [list(learned_hits.hits.ids.shape),
                       list(learned_dense.hits.ids.shape)],
    "learned_embed": [learned_idx.embed_dim, learned_idx.embed_dtype],
    "splade_hits": int((splade.hits.ids >= 0).sum()),
    "splade_hybrid_shape": list(sp_ids.shape),
    "qa": [bool(qa["reasoning"]["answer"]), qa["verification"]["verdict"],
           len(qa["retrieval"]["hits"]),
           qa["retrieval"]["diagnostics"]["seed_mode"]],
    "surface": surface,
    "train_losses": train_losses,
    "restored_step": restored[2],
    "lab_leaves": len(lab_params["layers"]),
    "cli_report": sorted(cli_report),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax",
                                            "pydantic", "yaml",
                                            "a_modular_rag_framework_tpu")),
    "files_in_jax_package": sorted(str(f) for f in files
                                   if any(f.is_relative_to(b) for b in banned)),
}))
"""


def test_port_imports_and_runs_without_jax_pydantic_yaml():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["files_in_jax_package"] == []
    assert out["hybrid_shape"] == [12, 5] and out["dense_shape"] == [12, 5]
    assert out["forms"] == ["dense", "compact"]
    assert out["hybrid_hits"] > 0
    assert out["recall"] > 0.0
    assert out["dense_keys"] == ["hop1_recall", "recall_at_5",
                                 "two_hop_mrr", "two_hop_recall_at_5"]
    assert out["iterative_shape"] == [12, 5] and out["hop2_active"] > 0
    assert out["pipelined_equal"] and out["served"]
    assert out["sharded"] == [[12, 5], 2]
    assert out["dryrun"] == "dryrun_multichip ok: n_devices=2"
    assert out["learned_shapes"] == [[12, 5], [12, 5]]
    assert out["learned_embed"] == [16, "bfloat16"]
    assert out["splade_hits"] > 0 and out["splade_hybrid_shape"] == [4, 5]
    answered, verdict, n_hits, seed_mode = out["qa"]
    assert answered and verdict and n_hits > 0 and seed_mode == "qmatch"
    assert out["surface"] == [200, True, ["D::sent0", "D::sent1"], 1, True,
                              [1.0, 1.0]]
    losses = out["train_losses"]
    assert sorted(losses) == ["cross", "encoder", "splade"]
    assert all(v == v and v > 0 for vs in losses.values() for v in vs)
    assert losses["encoder"][1] < losses["encoder"][0]
    assert out["restored_step"] == 2 and out["lab_leaves"] == 1
    assert out["cli_report"] == ["final_acc", "final_loss", "out", "pairs",
                                 "steps", "train_sec"]


def test_every_jax_module_has_a_counterpart():
    """Each .py module of the JAX package has one in the port, at the same
    path or under its port name (RENAMED); NOT_PORTED is the only
    exception."""
    jax_root, port_root = REPO / JAX_PKG, REPO / "a_modular_rag_framework_torch"
    missing = []
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        if rel in NOT_PORTED:
            assert not (port_root / rel).exists(), rel
            continue
        if not (port_root / RENAMED.get(rel, rel)).is_file():
            missing.append(rel)
    assert missing == []
    for rel in list(RENAMED) + list(NOT_PORTED):
        assert (jax_root / rel).is_file(), rel  # the lists name real modules


def _imported_modules(tree: ast.AST, path: Path):
    """Absolute names of the modules a source imports (relative imports
    resolved against the file's package, when it has one)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module or ""
            else:
                rel = path.relative_to(REPO).with_suffix("").parts
                base = ".".join(rel[:len(rel) - node.level])
                yield f"{base}.{node.module}" if node.module else base


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_have_no_jax_import(path):
    """No import of jax, optax, orbax or the JAX package (AST, so a
    docstring that names the package is fine), and no string that builds a
    path into the JAX package or the repo-root native/ directory."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for name in _imported_modules(tree, path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "orbax", JAX_PKG), (
            path, name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            args = [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)]
            for a in args:  # importlib / Path / open on the JAX package
                assert JAX_PKG not in a, (path, a)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            for side in (node.left, node.right):  # Path(...) / "native"
                if isinstance(side, ast.Constant) and isinstance(side.value,
                                                                 str):
                    assert side.value not in (JAX_PKG, "native"), (
                        path, side.value)
