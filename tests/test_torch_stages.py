"""The port's stage ranges and their table (`telemetry.stages`).

The ranges of `query_dense_batch` and of the hybrid path, the host-time
table kept only while a profiler records, its per-thread sums, the
benchmark's readers of them, and, on the card, the dense top-k kernel's
launches tied to the range of the thread that made them. No JAX here: the
last test runs on the card.
"""
import json
import sys
import threading
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from a_modular_rag_framework_torch.core.dataset_loader import \
    SyntheticHotpotQALoader
from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                  TorchQueryEngine)
from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                 build_packed_index)
from a_modular_rag_framework_torch.models import EncoderConfig, TextEncoder
from a_modular_rag_framework_torch.ops import topk  # noqa: F401 (its operator)
from a_modular_rag_framework_torch.telemetry.stages import (
    reset_stage_table, stage, stage_table)

REPO = Path(__file__).resolve().parents[1]
DENSE_STAGES = ("engine/featurize", "engine/embed", "engine/dense_topk",
                "engine/fetch")
READERS = ("featurize_host_ms", "fetch_host_ms", "topk_stage_roofline",
           "topk_stage_roofline.concurrent")


@pytest.fixture(scope="module")
def corpus():
    samples = SyntheticHotpotQALoader(
        {"count": 8, "seed": 5, "unique_entities": True,
         "n_distractors": 1}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=32, embed_dtype="float32")
    return [s["question"] for s in samples], idx


@pytest.fixture()
def empty_table():
    reset_stage_table()
    yield
    reset_stage_table()


def _cpu_engine(idx, encoder="hash"):
    """The hash encoder (host embed), or a small learned `TextEncoder`
    (host featurize, then the trunk in ``engine/embed``)."""
    enc = None
    if encoder == "learned":
        enc = TextEncoder(EncoderConfig(
            vocab_size=512, max_len=16, d_model=idx.embed_dim, n_heads=4,
            n_layers=1, d_ff=64, dtype=torch.float32), device="cpu")
    return TorchQueryEngine(idx, device="cpu", encoder=enc,
                            config=EngineConfig(top_k=5))


def _all_threads():
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


@pytest.mark.parametrize("entry", ["query_dense_batch", "query_batch"])
def test_no_profiler_leaves_the_table_empty(corpus, empty_table, entry):
    questions, idx = corpus
    res = getattr(_cpu_engine(idx), entry)(questions, top_k=5)
    assert res.hits.ids.shape == (len(questions), 5)
    assert stage_table() == {}


@pytest.mark.parametrize("encoder", ["hash", "learned"])
def test_dense_call_under_a_profiler_counts_each_stage_once(
        corpus, empty_table, encoder):
    questions, idx = corpus
    eng = _cpu_engine(idx, encoder)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.query_dense_batch(questions)
    table = stage_table()
    assert {name: table[name][0] for name in DENSE_STAGES} == dict.fromkeys(
        DENSE_STAGES, 1)
    assert all(table[name][1] > 0 for name in DENSE_STAGES)
    if encoder == "learned":  # the trunk runs inside engine/embed
        assert table["model/trunk"][0] == 1
        assert table["model/trunk"][1] <= table["engine/embed"][1]
    else:
        assert "model/trunk" not in table
    assert set(DENSE_STAGES) <= {e.name for e in prof.events()}
    # the host time no longer poses as a device time
    assert res.diagnostics == {"mode": "dense_only",
                               "batch_bucket": eng._bucket(len(questions))}


def test_hybrid_call_times_host_prep_and_fetch(corpus, empty_table):
    questions, idx = corpus
    with profile(activities=[ProfilerActivity.CPU]):
        _cpu_engine(idx).query_batch(questions)
    table = stage_table()
    for name in ("engine/host_prep", "engine/featurize", "engine/embed",
                 "engine/fusion", "engine/fetch"):
        assert table[name][0] == 1, name


def test_two_threads_calling_at_once_add_up(corpus, empty_table):
    questions, idx = corpus
    eng = _cpu_engine(idx)
    calls = 4

    def caller():
        for _ in range(calls):
            eng.query_dense_batch(questions)

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_all_threads()):
        threads = [threading.Thread(target=caller) for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    table = stage_table()
    assert {name: table[name][0] for name in DENSE_STAGES} == dict.fromkeys(
        DENSE_STAGES, 2 * calls)


def test_many_threads_lose_no_count(empty_table):
    """More threads than cores, switching as often as the interpreter
    allows: every range is counted, those of threads that have ended
    included."""
    n_threads, n_ranges = 32, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def worker():
                for _ in range(n_ranges):
                    with stage("engine/a"), stage("engine/b"):
                        pass
            threads = [threading.Thread(target=worker)
                       for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    table = stage_table()
    assert table["engine/a"][0] == table["engine/b"][0] == (
        n_threads * n_ranges)
    assert table["engine/a"][1] >= table["engine/b"][1] > 0
    reset_stage_table()
    assert stage_table() == {}


def test_profile_writes_the_stage_table_beside_the_trace(
        corpus, tmp_path, empty_table):
    questions, idx = corpus
    eng = _cpu_engine(idx)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.query_dense_batch(questions)  # a window before: not written
    with eng.profile(str(tmp_path)):
        eng.query_dense_batch(questions)
        eng.query_dense_batch(questions)
    traces = list(tmp_path.glob("engine.*.pt.trace.json"))
    tables = list(tmp_path.glob("engine.*.stages.json"))
    assert len(traces) == len(tables) == 1
    stem = traces[0].name[:-len(".pt.trace.json")]
    assert tables[0].name == f"{stem}.stages.json"
    written = json.loads(tables[0].read_text())
    for name in DENSE_STAGES:
        assert written[name]["count"] == 2 and written[name]["seconds"] > 0


def test_the_kernel_launches_through_an_operator_with_no_cpu_kernel():
    """The kernel's launch is the operator ``amrf::dense_topk_launch``,
    which `dense_topk_cuda` calls (a CUDA kernel only: there is no CPU
    mode)."""
    op = torch.ops.amrf.dense_topk_launch
    assert [a.name for a in op.default._schema.arguments] == [
        "q_planes", "d_planes", "k", "nwg", "smem_lists", "S", "slice_"]
    planes = torch.zeros((3, 4, 16), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        op(planes, planes[:1], 2, 1, True, 1, 128)


def test_the_port_opens_ranges_only_through_stage():
    pkg = REPO / "a_modular_rag_framework_torch"
    found = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                   if "record_function(" in p.read_text(encoding="utf-8"))
    assert set(found) <= {"telemetry/stages.py"}, found


@pytest.fixture()
def load_reader(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "benchmark"))
    from harness import spec

    return lambda name: spec.load_module("metrics", name)


def _run(trace):
    return types.SimpleNamespace(trace=trace, batch=4096, n_rows=1_034_138,
                                 dim=64, top_k=10)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_a_trace(load_reader, name, empty_table):
    with profile(activities=[ProfilerActivity.CPU]):
        with stage("engine/featurize"), stage("engine/fetch"):
            pass
    assert load_reader(name).read(_run(None)) is None


@pytest.mark.parametrize("name", READERS[:2])
def test_host_readers_read_the_stage_table(load_reader, name, empty_table):
    reader = load_reader(name)
    trace = {"range_count": {}, "range_ms": {}}
    assert reader.read(_run(trace)) is None  # an empty table
    rng = "engine/" + name.split("_")[0]
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with stage(rng):
                pass
    count, seconds = stage_table()[rng]
    assert count == 3
    assert reader.read(_run(trace)) == pytest.approx(1e3 * seconds / 3)


@pytest.mark.parametrize("name", READERS[2:])
def test_topk_stage_readers_divide_the_bound_by_the_range(load_reader, name):
    from harness.roofline import dense_topk_bound_s

    reader = load_reader(name)
    bound_ms = 1e3 * dense_topk_bound_s(4096, 1_034_138, 64, 10)
    trace = {"range_count": {"engine/dense_topk": 4, "bench/dense_call": 4},
             "range_ms": {"engine/dense_topk": 8 * bound_ms,
                          "bench/dense_call": 9 * bound_ms}}
    assert reader.read(_run(trace)) == pytest.approx(50.0)
    # a program without the range
    del trace["range_count"]["engine/dense_topk"]
    assert reader.read(_run(trace)) is None


# ---------------- on the card ----------------


@pytest.mark.gpu
def test_dense_topk_launches_join_the_worker_threads_range(corpus):
    """Under a profiler of every thread, each ``topk_partial`` and
    ``topk_merge`` launched by `query_dense_batch` on a worker thread is
    tied (by its launch record's correlation id) to that thread, inside
    its ``engine/dense_topk`` range: the device ms inside the range hold
    all of the kernel's time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    questions, idx = corpus
    eng = TorchQueryEngine(idx, device="cuda", config=EngineConfig(top_k=5))
    eng.query_dense_batch(questions)  # builds the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_all_threads()) as prof:
        th = threading.Thread(target=lambda: [
            eng.query_dense_batch(questions) for _ in range(3)])
        th.start()
        th.join(timeout=120)
        torch.cuda.synchronize()
    assert not th.is_alive()
    events = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    launches, ranges = {}, {}
    for e in events:
        if e.device_type() != cpu:
            continue
        if e.name() == "engine/dense_topk":
            ranges.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.correlation_id() and e.name().startswith("cu"):
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    b1_ns = inside_ns = 0
    for e in events:
        if e.device_type() != cuda or not any(
                k in e.name() for k in ("topk_partial", "topk_merge")):
            continue
        b1_ns += e.duration_ns()
        tid, t = launches.get(e.correlation_id(), (None, 0))
        if any(a <= t <= b for a, b in ranges.get(tid, ())):
            inside_ns += e.duration_ns()
    assert sum(len(r) for r in ranges.values()) == 3
    assert b1_ns > 0 and inside_ns == b1_ns
