"""The harness finds a cell's files by name, a cell added as new files runs
without an edit, the measurement path refuses to run without a card, and
nothing the benchmark runs imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import shutil
import sys
from pathlib import Path

import pytest

from conftest import BENCH, small_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "a_modular_rag_framework_tpu"}
PROGRAM = "a_modular_rag_framework_torch"


def test_cells_resolve_by_name():
    from harness import spec

    doc = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for w in doc["workloads"]:
        cell = spec.find_cell(w["name"])
        on_disk = json.loads((BENCH / "cells" / f"{w['name']}.json")
                             .read_text())
        assert (on_disk["config"], on_disk["traffic"]) == (w["config"],
                                                          w["traffic"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) and all(
            isinstance(v, float) for v in cell.limits.values())
        for m in cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
        assert callable(spec.load_module("entries",
                                         cell.traffic["entry"]).drive)
        assert callable(spec.load_module("streams",
                                         cell.traffic["stream"]).make)
        assert callable(spec.load_module("judges", cell.judge).make)
        assert callable(spec.load_module(
            "corpora", cell.config["corpus"]["generator"]).generate)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for c in doc["configs"]:
        assert (BENCH.parent / c["file"]).is_file()


STREAM = """from harness.seeds import seed_rng


class FirstHalf:
    def __init__(self, batch, n, seed):
        self.batch, self.n = batch, max(n // 2, 1)
        self.rng = seed_rng(seed, 5)

    def next_batch(self):
        return self.rng.integers(self.n, size=self.batch)


def make(mix, n_questions, seed):
    return FirstHalf(int(mix["batch"]), n_questions, seed)
"""

ENTRY = """import time

import numpy as np

from harness.window import WindowResult

GAP_SPANS = ("split_call",)


def drive(engine, questions, stream, mix, spans, seconds, *, n_batches=0):
    k, out, t0 = int(mix["top_k"]), WindowResult(), time.perf_counter()
    while True:
        qidx = stream.next_batch()
        texts = [questions[i] for i in qidx]
        h = len(texts) // 2
        with spans.span("split_call"):
            parts = [engine.query_dense_batch(texts[:h], top_k=k),
                     engine.query_dense_batch(texts[h:], top_k=k)]
        out.calls += 1
        out.questions += len(qidx)
        out.results.append((qidx,
                            np.concatenate([p.hits.ids for p in parts]),
                            np.concatenate([p.hits.scores for p in parts])))
        out.seconds = time.perf_counter() - t0
        out.at.append(out.seconds)
        if (n_batches and out.calls >= n_batches) or (
                not n_batches and out.seconds >= seconds):
            break
    out.values["qps"] = out.questions / out.seconds
    return out
"""

JUDGE = """import numpy as np


def make(ctx):
    n = len(ctx.ref.flatten(ctx.samples))

    def judge(control=None):
        bad = 0
        for call, row in ctx.sample:
            ids, scores = ctx.results[call][1][row], ctx.results[call][2][row]
            bad += int(((ids < 0) | (ids >= n)).sum())
            bad += int((np.diff(scores) > 0).sum())
        return {"invalid_hits": float(bad)}
    return judge
"""


def test_a_cell_added_as_files_runs_without_an_edit(tmp_path):
    """A copy of the benchmark gains a stream (repeats drawn from half of
    the questions), an entry (each batch in two calls), a judge, a mix, a
    cell and a per-layer metric as new files and entries only, and its new
    cell runs and reports them."""
    root = tmp_path / "checkout"
    b = root / "benchmark"
    shutil.copytree(BENCH, b,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    doc = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (b / "streams/first_half.py").write_text(STREAM)
    (b / "entries/dense_split.py").write_text(ENTRY)
    (b / "judges/valid_rows.py").write_text(JUDGE)
    (b / "traffic/split_b32.json").write_text(json.dumps(
        {"entry": "dense_split", "stream": "first_half", "batch": 32,
         "top_k": 10, "warmup_batches": 1, "check_questions": 16}))
    (b / "cells/hash1m.split_b32.json").write_text(json.dumps(
        {"config": "hotpot1m-hash", "traffic": "split_b32",
         "judge": "valid_rows", "limits": {"invalid_hits": 0.0}}))
    (b / "metrics/calls_in_window.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    doc["workloads"].append({"name": "hash1m.split_b32",
                             "config": "hotpot1m-hash",
                             "traffic": "split_b32", "chips": 1,
                             "why": "a test cell"})
    for m in doc["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("hash1m.split_b32")
    doc["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "test", "moves": "qps",
                             "workloads": ["hash1m.split_b32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    from harness import spec

    import run

    cell = spec.find_cell("hash1m.split_b32", root=b)
    assert [m["name"] for m in cell.per_layer] == ["calls_in_window"]
    cell.config["samples"] = 200
    cell.config["engine"]["batch_buckets"] = [32]
    for trace in (False, True):
        result, compared, _, _ = run.run_cell(cell, 2 ** 40 + 5, 0.5, trace,
                                              "cpu", 0.0, root=b)
        assert result["correct"], compared
        assert result["attempted"] % 32 == 0
        assert set(result["metrics"]) == (
            {"calls_in_window"} if trace else {"qps", "setup_s"})


BUILDER = """import numpy as np
import torch


class HashLinear:
    \"\"\"The program's hash features of a text through a seeded linear
    map, normalized: an encoder TextEncoder's keys cannot describe.\"\"\"

    def __init__(self, w, hash_dim, device):
        from a_modular_rag_framework_torch.models.hash_embed import \\
            HashEmbedEncoder

        self.hash = HashEmbedEncoder(dim=hash_dim)
        self.w, self.device = w, torch.device(device)

    @property
    def dim(self):
        return int(self.w.shape[1])

    def host_featurize(self, texts):
        return (self.hash.encode_texts(list(texts)),)

    @torch.no_grad()
    def device_embed(self, x):
        y = x.float() @ self.w
        return y / y.norm(dim=1, keepdim=True).clamp(min=1e-9)

    def encode_texts(self, texts):
        x = torch.from_numpy(self.host_featurize(texts)[0]).to(self.device)
        return self.device_embed(x).cpu().numpy().astype(np.float32)


def build(block, seed, device):
    h, d = int(block["hash_dim"]), int(block["dim"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    w = torch.randn(h, d, generator=gen, device=device) * h ** -0.5
    return HashLinear(w, h, device), {"w": w}


def flops(batch, block):
    return 2.0 * batch * int(block["hash_dim"]) * int(block["dim"])
"""

REFERENCE = """import torch

from hotpot import *  # noqa: F401,F403  (the corpus helpers and top-k)
from hotpot import hash_matrix, round_operand


def embed_texts(params, texts, enc, device, operand_dtype):
    x = torch.from_numpy(hash_matrix(list(texts), int(enc["hash_dim"])))
    y = (round_operand(x.to(device), operand_dtype)
         @ round_operand(params["w"], operand_dtype))
    return y / y.norm(dim=1, keepdim=True).clamp(min=1e-9)
"""


def _files(root: Path):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and ".cache" not in p.parts
            and "__pycache__" not in p.parts}


def test_a_model_added_as_files_runs_without_an_edit(tmp_path):
    """A copy of the benchmark gains a model as new files only: a builder
    (``encoders/``) whose encoder TextEncoder's keys cannot describe, a
    configuration naming it, a reference with its ``embed_texts``, a cell
    judged by the existing ``hotpot_dense`` and a metric that reads the
    trunk's operations. The cell runs ``correct`` with the trace off and
    on, the metric reads the builder's ``flops``, and no file the copy had
    before changed."""
    root = tmp_path / "checkout"
    b = root / "benchmark"
    shutil.copytree(BENCH, b,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = _files(b)
    doc = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (b / "encoders/hash_linear.py").write_text(BUILDER)
    (b / "reference/hash_linear.py").write_text(REFERENCE)
    config = json.loads((b / "configs/hotpot1m-hash.json").read_text())
    block = {"builder": "hash_linear", "hash_dim": 64, "dim": 32,
             "dtype": "float32"}
    config.update(name="toy-hash-linear", reference="hash_linear",
                  encoder=block)
    config["index"].update(embed="learned", embed_dim=32)
    (b / "configs/toy-hash-linear.json").write_text(json.dumps(config))
    (b / "cells/toy.batch_dense.json").write_text(json.dumps(
        {"config": "toy-hash-linear", "traffic": "batch_dense",
         "judge": "hotpot_dense", "control": "bfloat16",
         "limits": {"dense_rank_gap": 1e-5, "dense_score_err": 1e-5}}))
    (b / "metrics/trunk_flops_read.py").write_text(
        "def read(run):\n    return run.trunk_flops\n")
    doc["configs"].append({"name": "toy-hash-linear", "source": "a test",
                           "file": "benchmark/configs/toy-hash-linear.json",
                           "reduced": [], "why": "a test model"})
    doc["workloads"].append({"name": "toy.batch_dense",
                             "config": "toy-hash-linear",
                             "traffic": "batch_dense", "chips": 1,
                             "why": "a test cell"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if m["name"] in ("qps", "dense_step_mfu"):
            m["workloads"].append("toy.batch_dense")
    doc["per_layer"].append({"name": "trunk_flops_read", "unit": "flop",
                             "better": "higher", "source": "host_clock",
                             "layer": "test", "moves": "qps",
                             "workloads": ["toy.batch_dense"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    from harness import spec

    import run

    cell = spec.find_cell("toy.batch_dense", root=b)
    assert [m["name"] for m in cell.per_layer] == ["dense_step_mfu",
                                                   "trunk_flops_read"]
    cell.config["samples"] = 200
    cell.config["engine"]["batch_buckets"] = [32]
    cell.traffic.update(batch=32, warmup_batches=1, check_questions=64)
    for trace in (False, True):
        result, compared, _, _ = run.run_cell(cell, 2 ** 40 + 9, 0.5, trace,
                                              "cpu", 0.0, root=b)
        assert result["correct"], compared
        assert result["attempted"] % 32 == 0
        if trace:
            got = result["metrics"]
            assert got["trunk_flops_read"]["value"] == 2.0 * 32 * 64 * 32
            assert got["dense_step_mfu"]["value"] > 0
        else:
            assert set(result["metrics"]) == {"qps", "setup_s"}
    after = _files(b)
    assert {p: after[p] for p in before} == before
    assert set(after) - set(before) == {
        Path("encoders/hash_linear.py"), Path("reference/hash_linear.py"),
        Path("configs/toy-hash-linear.json"),
        Path("cells/toy.batch_dense.json"),
        Path("metrics/trunk_flops_read.py")}


def test_no_card_no_result(capsys, monkeypatch):
    """The measurement path refuses to run without a CUDA device: exit
    code 3 and no result line, never a CPU fallback."""
    import torch

    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "hash1m.batch_dense", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 3
    assert capsys.readouterr().out == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".", 1)[0]


def test_no_jax_anywhere_and_a_reference_without_the_program():
    """No module of the benchmark imports JAX or the JAX package; the
    encoder builders may import the program, the references may not."""
    folders = set()
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        folders.add(path.parent.name)
        names = set(_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if path.parent.name == "reference":
            assert PROGRAM not in names, path
    assert {"encoders", "reference", "harness", "metrics"} <= folders
    # whole top-level names: the program's name starts with the JAX
    # package's stem and is not flagged; the JAX package is
    import run

    saved = dict(sys.modules)
    try:
        assert run.forbidden_modules() == []
        sys.modules["a_modular_rag_framework_tpu.ops"] = sys.modules["json"]
        assert run.forbidden_modules() == ["a_modular_rag_framework_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_small_cells_are_correct_on_the_cpu():
    """Every cell at a CPU size through the whole run: the committed
    limits hold."""
    import run

    for name in ("hash1m.batch_hybrid", "learned1m.batch_dense_concurrent",
                 "hash1m.batch_dense"):
        cell = small_cell(name, samples=100 if "learned" in name else 300)
        result, compared, _, _ = run.run_cell(cell, 2 ** 31 + 7, 0.5, False,
                                              "cpu", 0.0)
        assert result["correct"], (name, compared)
        assert list(result)[-1] == "compared"


@pytest.mark.gpu
def test_cells_on_the_card(cuda_device):
    """Every cell at a small size on the card (the full size runs through
    ``benchmark/run.py``)."""
    import run

    for name in ("hash1m.batch_hybrid", "learned1m.batch_dense_concurrent",
                 "hash1m.batch_dense"):
        cell = small_cell(name, samples=2000, batch=512, check=128)
        result, compared, _, _ = run.run_cell(cell, 11, 1.0, True,
                                              cuda_device, 0.0)
        assert result["correct"], (name, compared)
        assert result["device"]["busy_s"] > 0
