"""The port's own copies of the JAX package's host modules equal their
originals.

The port imports nothing of the JAX package, so it carries copies of the
host modules it needs (``native/binding.py`` + ``csrc/text_native.cpp``,
``utils/textspan.py``, ``utils/entity_linker.py``, ``eval/metrics.py``,
``eval/harness.py``, ``index/corpus.py``, ``core/dataset_loader.py``).
Each copy is held to its original twice: its code (the AST without
docstrings and imports) is the same, and on small inputs it gives the same
outputs. Everything compared is host data made by the same code, so
equality is exact; only wall-clock fields of the harness are left out.

The modules of the `answer_question` path (telemetry, providers, router,
graph construction, query expansion, reasoning, verification, the
orchestrator, the CLIs) are copies too. Their intended differences are
named beside them: ``EdgeBuilder`` takes the device its semantic-edge
program runs on (a ``device`` parameter, attribute and call keyword, dropped
from the copy before the comparison), ``cli/run_system.py`` defaults to
the port's settings file, and a string that names the JAX package or its
hash encoder (a default class path, the router's fallback model name) names
the port's in the copy.

The learned-model modules mix torch code with host code copied verbatim
(subword hashing, pair packing, the idf prior, the SPLADE posting index,
the reranker's ordering): those functions and classes are held equal by
name.

So are the host helpers of the training path: the train CLIs' `build_pairs`
and `build_lists`, the batch makers, the dense lab's `build_collide_pairs`
and `featurize`
(code equal once the package's name in a lazy import is set aside), and the
two evaluation helpers that build an engine (``evaluate_encoder``,
``eval_rerank``), whose intended differences are the engine's class name
and the ``device`` they thread to it. ``eval_sparse`` / ``eval_bm25`` and
the CLIs' ``main`` (``--device``) are held by outputs and by their argument
lists in ``tests/test_torch_train.py``.

The rest of the surface: ``core/__init__.py``, the transcript and Ollama
providers, the retrieval adapter, the request adapters, ``utils/similarity``
and the reference harness are whole-module copies (the harness but its
default checkout, ``import_reference`` and the three functions that build
the port's backend on a device, held by outputs in
``tests/test_torch_surface.py``; it imports the reference, which is absent
here, so it is held by AST);
``build_neighbor_table``, the graph store's host half and the serve CLI's
``_App`` / handler are held by name.
"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

from a_modular_rag_framework_torch import orchestrator as t_orch
from a_modular_rag_framework_torch import core as t_core
from a_modular_rag_framework_torch import telemetry as t_telemetry
from a_modular_rag_framework_torch.adapters import \
    graph_request_adapter as t_req_adapter
from a_modular_rag_framework_torch.cli import serve as t_serve
from a_modular_rag_framework_torch.cli import ingest_hotpotqa as t_ingest_cli
from a_modular_rag_framework_torch.cli import run_system as t_run_cli
from a_modular_rag_framework_torch.cli import \
    train_cross_encoder as t_train_cross
from a_modular_rag_framework_torch.cli import train_encoder as t_train_enc
from a_modular_rag_framework_torch.core import dataset_loader as t_loader
from a_modular_rag_framework_torch.core import interfaces as t_interfaces
from a_modular_rag_framework_torch.core import llm_router as t_router
from a_modular_rag_framework_torch.core.providers import base as t_pbase
from a_modular_rag_framework_torch.core.providers import \
    mock_provider as t_mock
from a_modular_rag_framework_torch.core.providers import \
    ollama_provider as t_ollama
from a_modular_rag_framework_torch.core.providers import \
    openai_provider as t_openai
from a_modular_rag_framework_torch.core.providers import \
    transcript_provider as t_transcript
from a_modular_rag_framework_torch.engine import EngineConfig, TorchQueryEngine
from a_modular_rag_framework_torch.eval import harness as t_harness
from a_modular_rag_framework_torch.eval import metrics as t_metrics
from a_modular_rag_framework_torch.eval import reference_harness as t_ref
from a_modular_rag_framework_torch.index import bm25 as t_bm25
from a_modular_rag_framework_torch.index import build_packed_index
from a_modular_rag_framework_torch.index import builder as t_builder
from a_modular_rag_framework_torch.index import corpus as t_corpus
from a_modular_rag_framework_torch.models import cross_encoder as t_cross
from a_modular_rag_framework_torch.models import encoder as t_encoder
from a_modular_rag_framework_torch.models import splade as t_splade
from a_modular_rag_framework_torch.models.hash_embed import HashEmbedEncoder
from a_modular_rag_framework_torch.modules import graph_construction as t_gc
from a_modular_rag_framework_torch.modules import reasoning as t_reasoning
from a_modular_rag_framework_torch.modules import verification as t_verif
from a_modular_rag_framework_torch.modules.graph_construction import \
    edge_builder as t_edges
from a_modular_rag_framework_torch.modules.graph_construction import \
    flow as t_gc_flow
from a_modular_rag_framework_torch.modules.graph_construction import \
    impl_arrays as t_gc_arrays
from a_modular_rag_framework_torch.modules.graph_construction import \
    node_builder as t_nodes
from a_modular_rag_framework_torch.modules.graph_construction import \
    segmenter as t_segmenter
from a_modular_rag_framework_torch.modules.reasoning import \
    flow as t_reason_flow
from a_modular_rag_framework_torch.modules.reasoning import \
    impl_planner_synth as t_planner
from a_modular_rag_framework_torch.modules.reasoning import \
    strategies as t_strategies
from a_modular_rag_framework_torch.modules.retrieval import \
    graph_store as t_graph_store
from a_modular_rag_framework_torch.modules.retrieval import \
    query_expander as t_expander
from a_modular_rag_framework_torch.modules.retrieval import \
    retrieval_adapter as t_ret_adapter
from a_modular_rag_framework_torch.modules.verification import \
    flow as t_verif_flow
from a_modular_rag_framework_torch.modules.verification import \
    impl_rules_llm as t_rules
from a_modular_rag_framework_torch.native import binding as t_bind
from a_modular_rag_framework_torch.ops import graph as t_graph_ops
from a_modular_rag_framework_torch.ops import splade as t_splade_ops
from a_modular_rag_framework_torch.orchestrator import nodes as t_wf_nodes
from a_modular_rag_framework_torch.orchestrator import state as t_wf_state
from a_modular_rag_framework_torch.orchestrator import workflow as t_workflow
from a_modular_rag_framework_torch.telemetry import sinks as t_sinks
from a_modular_rag_framework_torch.utils import graph_analyzer as t_analyzer
from a_modular_rag_framework_torch.utils import entity_linker as t_linker
from a_modular_rag_framework_torch.utils import similarity as t_similarity
from a_modular_rag_framework_torch.utils import textspan as t_span
from a_modular_rag_framework_tpu import orchestrator as j_orch
from a_modular_rag_framework_tpu import core as j_core
from a_modular_rag_framework_tpu import telemetry as j_telemetry
from a_modular_rag_framework_tpu.adapters import \
    graph_request_adapter as j_req_adapter
from a_modular_rag_framework_tpu.cli import serve as j_serve
from a_modular_rag_framework_tpu.cli import ingest_hotpotqa as j_ingest_cli
from a_modular_rag_framework_tpu.cli import run_system as j_run_cli
from a_modular_rag_framework_tpu.cli import \
    train_cross_encoder as j_train_cross
from a_modular_rag_framework_tpu.cli import train_encoder as j_train_enc
from a_modular_rag_framework_tpu.core import dataset_loader as j_loader
from a_modular_rag_framework_tpu.core import interfaces as j_interfaces
from a_modular_rag_framework_tpu.core import llm_router as j_router
from a_modular_rag_framework_tpu.core.providers import base as j_pbase
from a_modular_rag_framework_tpu.core.providers import mock_provider as j_mock
from a_modular_rag_framework_tpu.core.providers import \
    ollama_provider as j_ollama
from a_modular_rag_framework_tpu.core.providers import \
    openai_provider as j_openai
from a_modular_rag_framework_tpu.core.providers import \
    transcript_provider as j_transcript
from a_modular_rag_framework_tpu.eval import harness as j_harness
from a_modular_rag_framework_tpu.eval import metrics as j_metrics
from a_modular_rag_framework_tpu.eval import reference_harness as j_ref
from a_modular_rag_framework_tpu.index import builder as j_builder
from a_modular_rag_framework_tpu.index import corpus as j_corpus
from a_modular_rag_framework_tpu.models import cross_encoder as j_cross
from a_modular_rag_framework_tpu.models import encoder as j_encoder
from a_modular_rag_framework_tpu.models import splade as j_splade
from a_modular_rag_framework_tpu.models.hash_embed import \
    HashEmbedEncoder as JaxHashEmbedEncoder
from a_modular_rag_framework_tpu.modules import graph_construction as j_gc
from a_modular_rag_framework_tpu.modules import reasoning as j_reasoning
from a_modular_rag_framework_tpu.modules import verification as j_verif
from a_modular_rag_framework_tpu.modules.graph_construction import \
    edge_builder as j_edges
from a_modular_rag_framework_tpu.modules.graph_construction import \
    flow as j_gc_flow
from a_modular_rag_framework_tpu.modules.graph_construction import \
    impl_arrays as j_gc_arrays
from a_modular_rag_framework_tpu.modules.graph_construction import \
    node_builder as j_nodes
from a_modular_rag_framework_tpu.modules.graph_construction import \
    segmenter as j_segmenter
from a_modular_rag_framework_tpu.modules.reasoning import flow as j_reason_flow
from a_modular_rag_framework_tpu.modules.reasoning import \
    impl_planner_synth as j_planner
from a_modular_rag_framework_tpu.modules.reasoning import \
    strategies as j_strategies
from a_modular_rag_framework_tpu.modules.retrieval import \
    graph_store as j_graph_store
from a_modular_rag_framework_tpu.modules.retrieval import \
    query_expander as j_expander
from a_modular_rag_framework_tpu.modules.retrieval import \
    retrieval_adapter as j_ret_adapter
from a_modular_rag_framework_tpu.modules.verification import \
    flow as j_verif_flow
from a_modular_rag_framework_tpu.modules.verification import \
    impl_rules_llm as j_rules
from a_modular_rag_framework_tpu.native import binding as j_bind
from a_modular_rag_framework_tpu.ops import graph as j_graph_ops
from a_modular_rag_framework_tpu.ops import splade as j_splade_ops
from a_modular_rag_framework_tpu.ops.bm25 import Bm25DeviceIndex
from a_modular_rag_framework_tpu.orchestrator import nodes as j_wf_nodes
from a_modular_rag_framework_tpu.orchestrator import state as j_wf_state
from a_modular_rag_framework_tpu.orchestrator import workflow as j_workflow
from a_modular_rag_framework_tpu.telemetry import sinks as j_sinks
from a_modular_rag_framework_tpu.utils import graph_analyzer as j_analyzer
from a_modular_rag_framework_tpu.utils import entity_linker as j_linker
from a_modular_rag_framework_tpu.utils import similarity as j_similarity
from a_modular_rag_framework_tpu.utils import textspan as j_span

REPO = Path(__file__).resolve().parents[1]


class _Tool:
    """A script under tools/, named by its file (it is read, not run)."""

    def __init__(self, name):
        self.__file__ = str(REPO / "tools" / f"{name}.py")


# copy -> original, with the top-level names left out of the comparison: the
# binding's build step (where and how the library is written); the device
# that `EdgeBuilder` threads to its semantic-edge program (DEVICE: every
# `device` parameter, attribute assignment and call keyword is dropped from
# the copy first); `run_system`'s `main`, whose default --settings is the
# port's file; the reference harness's checkout (the port has no default
# checkout: it takes --reference_root or AMRF_REFERENCE_ROOT, and
# ``import_reference`` raises when neither names one) and the three
# functions that build the port's backend on a ``device`` (the backend's
# class, the device argument, the platform name in the report; held by
# outputs in tests/test_torch_surface.py)
DEVICE = "<device>"
COPIES = [
    (t_span, j_span, ()),
    (t_linker, j_linker, ()),
    (t_metrics, j_metrics, ()),
    (t_harness, j_harness, ()),
    (t_corpus, j_corpus, ()),
    (t_loader, j_loader, ()),
    (t_bind, j_bind, ("_SRC", "_BUILD", "_build_lib")),
    (t_telemetry, j_telemetry, ()),
    (t_sinks, j_sinks, ()),
    (t_interfaces, j_interfaces, ()),
    (t_pbase, j_pbase, ()),
    (t_mock, j_mock, ()),
    (t_openai, j_openai, ("OpenAIProvider",)),  # see COPIED_NAMES
    (t_router, j_router, ()),
    (t_analyzer, j_analyzer, ()),
    (t_gc, j_gc, ()),
    (t_segmenter, j_segmenter, ()),
    (t_nodes, j_nodes, ()),
    (t_edges, j_edges, (DEVICE,)),
    (t_gc_arrays, j_gc_arrays, ()),
    (t_gc_flow, j_gc_flow, ()),
    (t_expander, j_expander, ()),
    (t_reasoning, j_reasoning, ()),
    (t_reason_flow, j_reason_flow, ()),
    (t_planner, j_planner, ()),
    (t_strategies, j_strategies, ()),
    (t_verif, j_verif, ()),
    (t_verif_flow, j_verif_flow, ()),
    (t_rules, j_rules, ()),
    (t_orch, j_orch, ()),
    (t_wf_state, j_wf_state, ()),
    (t_wf_nodes, j_wf_nodes, ()),
    (t_workflow, j_workflow, ()),
    (t_ingest_cli, j_ingest_cli, ()),
    (t_run_cli, j_run_cli, ("main",)),
    (t_core, j_core, ()),
    (t_transcript, j_transcript, ()),
    (t_ollama, j_ollama, ()),
    (t_ret_adapter, j_ret_adapter, ()),
    (t_req_adapter, j_req_adapter, ()),
    (t_similarity, j_similarity, ()),
    (t_ref, j_ref, ("DEFAULT_REFERENCE_ROOT", "import_reference",
                    "run_engine_eval", "run_baseline", "main")),
]

TEXTS = [
    "Sage Silverton was born in Zephyr Bay.",
    "John D. Rockefeller met Vincent van Gogh in New York City.",
    "O'Brien and Jean-Luc Picard visited Çelik Köprü near Mistral Hollow.",
    "lowercase only text, no names at all",
    "",
    "The McDonald brothers' diner; ABC and IBM were Persona's rivals.",
    "Kelvin K sign and naïve café owners in Zürich",
    "Alden Ashford collaborated closely with Brisa Blackwood for a decade.",
]


def _code_nodes(mod, skip):
    """Top-level statements without the module docstring and imports, and
    function/class bodies without their docstrings, as AST dumps."""
    tree = ast.parse(Path(mod.__file__).read_text(encoding="utf-8"))
    if DEVICE in skip:
        _drop_device(tree)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    out = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        name = getattr(node, "name", None)
        if name is None and isinstance(node, (ast.Assign, ast.AnnAssign)):
            tgt = node.targets[0] if isinstance(node, ast.Assign) else node.target
            name = getattr(tgt, "id", None)
        if name in skip:
            continue
        for sub in ast.walk(node):  # nested lazy imports name their package
            if isinstance(sub, ast.ImportFrom):
                sub.module = (sub.module or "").replace(
                    "a_modular_rag_framework_tpu", "").lstrip(".")
                sub.level = 0
            elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                sub.value = sub.value.replace(
                    "a_modular_rag_framework_tpu",
                    "a_modular_rag_framework_torch").replace(
                        "tpu-hash-encoder", "torch-hash-encoder")
        out.append(ast.dump(node))
    return out


def _drop_device(tree):
    """Remove what threads a device through a copy: ``device`` parameters
    (with their defaults), ``self.device = ...`` and ``device=`` keywords."""
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            a = node.args
            pos = a.posonlyargs + a.args
            for i in reversed(range(len(pos))):
                if pos[i].arg == "device":
                    d = i - (len(pos) - len(a.defaults))
                    if d >= 0:
                        del a.defaults[d]
                    a.args.remove(pos[i])
            node.body = [
                st for st in node.body
                if not (isinstance(st, ast.Assign)
                        and isinstance(st.targets[0], ast.Attribute)
                        and st.targets[0].attr == "device")]
        elif isinstance(node, ast.Call):
            node.keywords = [k for k in node.keywords if k.arg != "device"]


def _copy_id(c):
    """The module's name, with its package where several copies share it
    (`graph_construction.flow`)."""
    parts = c[0].__name__.split(".")
    shared = sum(o[0].__name__.split(".")[-1] == parts[-1] for o in COPIES) > 1
    return ".".join(parts[-2:]) if shared else parts[-1]


@pytest.mark.parametrize("copy,orig,skip", COPIES,
                         ids=[_copy_id(c) for c in COPIES])
def test_copy_has_the_originals_code(copy, orig, skip):
    port = REPO / "a_modular_rag_framework_torch"
    assert Path(copy.__file__).resolve().is_relative_to(port)
    assert _code_nodes(copy, skip) == _code_nodes(orig, skip)


# host code copied verbatim into modules that otherwise hold torch code:
# (copy module, original module, "function", "Class" or "Class.method")
COPIED_NAMES = [
    (t_encoder, j_encoder, "_word_feature_ids"),
    (t_cross, j_cross, "encode_pairs"),
    (t_cross, j_cross, "CrossEncoderReranker.rerank"),
    (t_cross, j_cross, "CrossEncoderReranker.rerank_batch"),
    (t_splade, j_splade, "idf_lexical_prior"),
    (t_splade_ops, j_splade_ops, "SpladeDeviceIndex"),
    # all of OpenAIProvider but its constructor, which finds the SDK
    # without importing it (the SDK imports pydantic)
    (t_openai, j_openai, "OpenAIProvider.live"),
    (t_openai, j_openai, "OpenAIProvider._client"),
    (t_openai, j_openai, "OpenAIProvider.complete"),
    (t_openai, j_openai, "OpenAIProvider.embed"),
    # the training path's host helpers
    (t_train_enc, j_train_enc, "build_pairs"),
    (t_train_enc, j_train_enc, "evaluate_encoder"),
    (t_train_cross, j_train_cross, "build_lists"),
    (t_train_cross, j_train_cross, "eval_rerank"),
    (t_encoder, j_encoder, "TextEncoder.make_pair_batch"),
    (t_cross, j_cross, "CrossEncoderReranker.make_listwise_batch"),
    (_Tool("dense_lab_torch"), _Tool("dense_lab"), "build_collide_pairs"),
    (_Tool("dense_lab_torch"), _Tool("dense_lab"), "featurize"),
    # the rest of the surface: the graph store's host half (its expansion
    # takes the device it runs on), the neighbor-table packer, the serve
    # CLI but `build_engine` / `main` (the engine's class and device, the
    # port's settings file)
    (t_graph_ops, j_graph_ops, "build_neighbor_table"),
    (t_graph_store, j_graph_store, "load_graph_json"),
    (t_graph_store, j_graph_store, "build_index"),
    (t_graph_store, j_graph_store, "_meta_of"),
    (t_serve, j_serve, "_hit_to_dict"),
    (t_serve, j_serve, "_App"),
    (t_serve, j_serve, "_make_handler"),
]


def _named_node(mod, dotted):
    """AST dump of one function, class or method, docstrings dropped, the
    package's name in a lazy import set aside, the engine's class under one
    name and whatever threads a ``device`` removed."""
    body = ast.parse(Path(mod.__file__).read_text(encoding="utf-8")).body
    for part in dotted.split("."):
        node = next(n for n in body if getattr(n, "name", None) == part)
        body = node.body
    _drop_device(node)
    for sub in ast.walk(node):
        inner = getattr(sub, "body", None)
        if (isinstance(inner, list) and inner
                and isinstance(inner[0], ast.Expr)
                and isinstance(inner[0].value, ast.Constant)
                and isinstance(inner[0].value.value, str)):
            sub.body = inner[1:] or [ast.Pass()]
        if isinstance(sub, ast.ImportFrom):
            sub.module = (sub.module or "").replace(
                "a_modular_rag_framework_tpu", "").replace(
                "a_modular_rag_framework_torch", "").lstrip(".")
            sub.level = 0
        for field in ("id", "name"):
            if getattr(sub, field, None) == "TPUQueryEngine":
                setattr(sub, field, "TorchQueryEngine")
    return ast.dump(node)


@pytest.mark.parametrize("copy,orig,name", COPIED_NAMES,
                         ids=[c[2] for c in COPIED_NAMES])
def test_copied_host_function_has_the_originals_code(copy, orig, name):
    assert _named_node(copy, name) == _named_node(orig, name)


def test_native_source_is_the_originals():
    assert ((REPO / "a_modular_rag_framework_torch" / "csrc" /
             "text_native.cpp").read_bytes()
            == (REPO / "native" / "text_native.cpp").read_bytes())


def test_native_library_builds_atomically_into_the_port():
    so = t_bind._build_lib()
    if so is None:  # no g++ here: both copies fall back to Python
        assert t_bind.load_native() is None
        return
    assert so.parent == REPO / "a_modular_rag_framework_torch" / "csrc" / "build"
    assert so.exists() and not list(so.parent.glob(".text_native_*"))
    assert t_bind._build_lib() == so  # built once per source hash


@pytest.mark.parametrize("cfg", [
    {"count": 6, "seed": 1},
    {"count": 6, "seed": 2, "collide_entities": True, "n_distractors": 3},
    {"count": 6, "seed": 3, "unique_entities": True},
    {"count": 5, "seed": 4, "variety": True, "collide_entities": True},
    {"count": 6, "seed": 5, "heldout": True, "index": 7},
], ids=["plain", "collide", "unique", "variety", "heldout"])
def test_synthetic_loader_and_corpus_rows(cfg, tmp_path):
    t = t_loader.build_dataset_loader(dict(cfg, type="synthetic_hotpotqa"))
    j = j_loader.build_dataset_loader(dict(cfg, type="synthetic_hotpotqa"))
    samples = t.load()
    assert samples == j.load()
    tc = t_corpus.SentenceCorpus.from_hotpotqa(samples)
    jc = j_corpus.SentenceCorpus.from_hotpotqa(samples)
    assert tc.docs == jc.docs and tc.texts() == jc.texts()
    assert [tc.hit_id(i) for i in range(len(tc))] == [
        jc.hit_id(i) for i in range(len(jc))]
    assert [tc.hit_meta(i) for i in range(len(tc))] == [
        jc.hit_meta(i) for i in range(len(jc))]
    assert tc.row_by_title_sid() == jc.row_by_title_sid()
    t_corpus.write_docs_jsonl(tc.docs, tmp_path / "t.jsonl")
    j_corpus.write_docs_jsonl(jc.docs, tmp_path / "j.jsonl")
    assert ((tmp_path / "t.jsonl").read_bytes()
            == (tmp_path / "j.jsonl").read_bytes())
    assert (t_corpus.SentenceCorpus.from_jsonl(tmp_path / "j.jsonl").docs
            == jc.docs)
    (tmp_path / "s.json").write_text(json.dumps(samples))
    file_cfg = {"type": "hotpotqa", "path": str(tmp_path / "s.json"),
                "index": 1, "count": 3}
    assert (t_loader.build_dataset_loader(file_cfg).load()
            == j_loader.build_dataset_loader(file_cfg).load())


def test_textspan_and_entity_linker():
    for text in TEXTS:
        for kw in ({}, {"min_words": 2}, {"particles": True},
                   {"particles": True, "min_words": 2}):
            assert (t_span.capitalized_runs(text, **kw)
                    == j_span.capitalized_runs(text, **kw)), (text, kw)
        assert t_linker.simple_ner(text) == j_linker.simple_ner(text)
        assert (t_linker.elq_link_entities(text, max_entities=3)
                == j_linker.elq_link_entities(text, max_entities=3))


def test_metrics():
    pairs = [("The Zephyr Bay.", "zephyr bay"), ("an apple [1]", "Apple"),
             ("", ""), ("a b c", "b c d"), ("Paris", "London"),
             ("It was born in Zephyr Bay, sources say", "Zephyr Bay")]
    for p, g in pairs:
        for name in ("normalize_answer",):
            assert getattr(t_metrics, name)(p) == getattr(j_metrics, name)(p)
        for name in ("exact_match", "contains_match", "f1_score"):
            assert (getattr(t_metrics, name)(p, g)
                    == getattr(j_metrics, name)(p, g)), (name, p, g)
    ret = ["a", "b", "c", "d"]
    for gold in (["c"], ["x"], ["a", "d"], []):
        for k in (1, 2, 4):
            assert (t_metrics.recall_at_k(ret, gold, k)
                    == j_metrics.recall_at_k(ret, gold, k))
        assert t_metrics.mrr(ret, gold) == j_metrics.mrr(ret, gold)


@pytest.fixture(scope="module")
def tiny_engine():
    samples = t_loader.SyntheticHotpotQALoader(
        {"count": 10, "seed": 6, "n_distractors": 3}).load()
    idx = build_packed_index(t_corpus.SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=32)
    eng = TorchQueryEngine(idx, device="cpu",
                           config=EngineConfig(top_k=5, batch_buckets=(8,)))
    yield eng, samples
    eng.close()


def _no_clock(d):
    return {k: v for k, v in d.items() if k not in ("total_sec", "qps")}


def test_harness_on_a_port_engine(tiny_engine):
    eng, samples = tiny_engine
    for kw in ({"k": 5, "batch_size": 4}, {"k": 3, "batch_size": 8}):
        t = t_harness.evaluate_retrieval(eng, samples, **kw)
        j = j_harness.evaluate_retrieval(eng, samples, **kw)
        assert _no_clock(t) == _no_clock(j) and t["n"] == len(samples)
    assert (t_harness.evaluate_dense(eng, samples, k=5)
            == j_harness.evaluate_dense(eng, samples, k=5))
    assert ([t_harness.gold_hit_ids(s) for s in samples]
            == [j_harness.gold_hit_ids(s) for s in samples])

    def answer_fn(q, mode):
        return {"reasoning": {"answer": q.split()[-1]},
                "verification": {"verdict": "pass" if len(q) % 2 else "fail"}}

    t = t_harness.evaluate_system(answer_fn, samples)
    j = j_harness.evaluate_system(answer_fn, samples)
    assert _no_clock(t) == _no_clock(j)


def _corpus_texts():
    samples = t_loader.SyntheticHotpotQALoader(
        {"count": 8, "seed": 7, "collide_entities": True,
         "n_distractors": 3}).load()
    return t_corpus.SentenceCorpus.from_hotpotqa(samples).texts() + TEXTS


def _assert_bm25_equal(t, j):
    for f in ("doc_ids", "tfs", "row_ptr", "df", "doc_lens", "scores"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert t.vocab == j.vocab


@pytest.mark.parametrize("library", ["with", "without"])
def test_native_featurize_and_bm25_build(library, monkeypatch):
    """With the library, the port's native calls give the original's
    arrays; without it (both loaders return None), both fall back to
    their Python paths, which give the same arrays again."""
    if library == "without":
        monkeypatch.setattr(t_bind, "load_native", lambda: None)
        monkeypatch.setattr(j_bind, "load_native", lambda: None)
    texts = _corpus_texts()
    both = [t_bind.native_available(), j_bind.native_available()]
    assert both[0] == both[1]
    for name, args in (("featurize_batch_native", (texts, 64, 256)),
                       ("hash_embed_batch_native", (texts, 32, 128)),
                       ("token_counts_native", (texts,)),
                       ("encoder_tokens_native", (texts, 16, 997, 3, 3, 5)),
                       ("entity_graph_native", (texts, 8, 4))):
        t = getattr(t_bind, name)(*args)
        j = getattr(j_bind, name)(*args)
        assert (t is None) == (j is None) == (not both[0]), name
        if t is not None:
            for a, b in zip(t if isinstance(t, tuple) else (t,),
                            j if isinstance(j, tuple) else (j,)):
                np.testing.assert_array_equal(a, b, err_msg=name)
    for phrase in (False, True):
        t = t_bind.bm25_build_native(texts, phrase_tokens=phrase)
        j = j_bind.bm25_build_native(texts, phrase_tokens=phrase)
        assert (t is None) == (j is None) == (not both[0])
        if t is not None:
            assert t.keys() == j.keys() and t["vocab"] == j["vocab"]
            for f in t.keys() - {"vocab"}:
                np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    # the callers: the port's builds equal the JAX package's, either way
    for phrase in (False, True):
        _assert_bm25_equal(
            t_bm25.Bm25Index.build(texts, phrase_tokens=phrase),
            Bm25DeviceIndex.build(texts, phrase_tokens=phrase,
                                  use_native=library == "with"))
    for a, b in zip(HashEmbedEncoder(dim=64).featurize(texts),
                    JaxHashEmbedEncoder(dim=64).featurize(texts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        HashEmbedEncoder(dim=32).encode_texts(texts),
        JaxHashEmbedEncoder(dim=32).encode_texts(texts))
    corpus = t_corpus.SentenceCorpus(docs=[{"text": t} for t in texts])
    t_nbrs = t_builder.build_sentence_graph(corpus, max_degree=8)
    j_nbrs = j_builder.build_sentence_graph(
        j_corpus.SentenceCorpus(docs=corpus.docs), max_degree=8,
        use_native=library == "with")
    for a, b in zip(t_nbrs, j_nbrs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("library", ["with", "without"])
def test_native_vocab_and_bridge(library, monkeypatch):
    if library == "without":
        monkeypatch.setattr(t_bind, "load_native", lambda: None)
        monkeypatch.setattr(j_bind, "load_native", lambda: None)
    texts = _corpus_texts()
    vocab = t_bm25.Bm25Index.build_python(texts).vocab
    tv, jv = t_bind.NativeVocab(vocab), j_bind.NativeVocab(vocab)
    assert tv.available == jv.available
    t, j = tv.lookup_batch(texts, 12), jv.lookup_batch(texts, 12)
    assert (t is None) == (j is None)
    if t is not None:
        np.testing.assert_array_equal(t, j)
    docs = [{"text": x, "title": x.split(" ")[0]} for x in texts]
    words = {"Where", "Who", "In", "The"}
    tb, jb = t_bind.NativeBridge(docs, words), j_bind.NativeBridge(docs, words)
    assert tb.available == jb.available
    ids = np.arange(len(texts) * 4, dtype=np.int32).reshape(-1, 4) % len(texts)
    queries = [f"Where was the collaborator of {x} born?" for x in texts]
    assert (tb.hop2_batch(queries, ids[:len(queries)])
            == jb.hop2_batch(queries, ids[:len(queries)]))


PROMPTS = {
    "plan": ("You are a decomposition planner for multi-hop QA.\nQuestion: "
             "Where was the collaborator of Sage Silverton born?\nDecompose"),
    "synthesize": (
        "Synthesize a final answer using ONLY the provided citations. Cite "
        "evidence inline using [#k].\n\nPlan:\nStep 1: x\n\nCitations:\n"
        '[#1] (doc=A, sent_id=0) "The sky is blue."\n'
        '[#2] (doc=B, sent_id=1) "Alice Smith was born in Paris."\n'
        "\nQuestion: Where was Alice Smith born?\nAnswer:"),
    "factcheck": (
        "You are a strict but fair fact-checker.\nReturn pure JSON\n\n"
        "Question:\nWhere was Alice born?\n\nAnswer:\nAlice was born in "
        "Paris [#1]\n\nCitations:\n"
        '[#1] (doc=B, sent_id=1) "Alice Smith was born in Paris."\n'),
    "query_expand": "Rewrite the query.\nQuery: Where was Alice Smith born?",
    "alias_resolve": "Resolve aliases: Alice Smith, A. Smith",
}


@pytest.mark.parametrize("purpose", sorted(PROMPTS))
def test_mock_provider_and_router_outputs(purpose):
    t, j = t_mock.MockProvider(embed_dim=16), j_mock.MockProvider(embed_dim=16)
    assert (t.complete(PROMPTS[purpose], purpose=purpose)
            == j.complete(PROMPTS[purpose], purpose=purpose))
    assert t.embed(TEXTS) == j.embed(TEXTS)
    policy = {"default": [{"model": "m0", "provider": "mock"}],
              "embedding_provider": "mock"}
    tr = t_router.LLMRouter(providers={"mock": t}, policy=policy)
    jr = j_router.LLMRouter(providers={"mock": j}, policy=policy)
    kw = dict(module="ReasoningAgent", purpose=purpose, prompt=PROMPTS[purpose])
    assert tr.complete(**kw)["text"] == jr.complete(**kw)["text"]
    assert tr.embed(texts=TEXTS[:2]) == jr.embed(texts=TEXTS[:2])
    assert (t_expander.LLMQueryExpander(tr, 3, True).expand(
        query="What is the nationality of Alice Smith?", trace_id="t")
        == j_expander.LLMQueryExpander(jr, 3, True).expand(
            query="What is the nationality of Alice Smith?", trace_id="t"))


def test_telemetry_and_graph_host_outputs(tmp_path):
    events = []
    for mod, tag in ((t_sinks, "t"), (j_sinks, "j")):
        sink = mod.LocalJsonlSink(root_dir=str(tmp_path / tag))
        with mod.span("NodeA", sink, "tr"):
            mod.record_device_timing(sink, "tr", kernel="engine/query_batch",
                                     device_ms=1.5, shape="B1xN9k3",
                                     backend="cpu")
        with mod.span("NodeB", sink, "tr"):
            mod.record_metrics(sink, "tr", retrieval={"hits": 3})
        evts = mod._read_events(tmp_path / tag / "tr")
        for e in evts:  # wall-clock fields differ by construction
            e.pop("ts", None)
            e.pop("duration_sec", None)
        events.append((evts, mod.build_mermaid(evts),
                       mod.build_latency_breakdown(evts)))
    assert events[0] == events[1] and len(events[0][0]) == 6
    context = [["Doc A", ["One. Two! Three?", "Four"]], ["Doc B", ["Five."]]]
    assert (t_segmenter.segment_context(context)
            == j_segmenter.segment_context(context))
    assert (t_segmenter.simple_rule_split("One. Two! Three? Four")
            == j_segmenter.simple_rule_split("One. Two! Three? Four"))
    dumps = []
    for nodes_mod, edges_mod, extra in ((t_nodes, t_edges, {"device": "cpu"}),
                                        (j_nodes, j_edges, {})):
        nodes = nodes_mod.NodeBuilder().build(
            "Where was Sage Silverton born?",
            [["Sage Silverton", ["Sage Silverton was born in Zephyr Bay.",
                                 "Sage Silverton was born in Zephyr Bay."]],
             ["Zephyr Bay", ["Zephyr Bay is a city."]]], {})
        edges = edges_mod.EdgeBuilder(**extra).build(
            [n.model_dump() for n in nodes], "Where was Sage Silverton born?",
            {})
        dumps.append(([n.model_dump() for n in nodes], edges))
    assert dumps[0] == dumps[1]
    assert any(e["type"] == "semantic_sim" for e in dumps[0][1])


def test_openai_provider_finds_the_sdk_without_importing_it(tmp_path,
                                                            monkeypatch):
    import sys

    j = j_openai.OpenAIProvider(api_key="", embed_dim_fallback=16)
    sdk = tmp_path / "openai"  # a stand-in SDK that must not be imported
    sdk.mkdir()
    (sdk / "__init__.py").write_text("raise RuntimeError('imported')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "openai", raising=False)
    t = t_openai.OpenAIProvider(api_key="", embed_dim_fallback=16)
    assert t._has_sdk and not t.live and "openai" not in sys.modules
    for attr in ("api_key", "model_default", "embed_model", "proxy"):
        assert getattr(t, attr) == getattr(j, attr)
    # no key: both answer from their mock
    assert t.embed(TEXTS[:2]) == j.embed(TEXTS[:2])
    assert (t.complete(PROMPTS["plan"], purpose="plan")
            == j.complete(PROMPTS["plan"], purpose="plan"))
