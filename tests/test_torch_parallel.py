"""Index sharding and the sharded train step of the port
(`a_modular_rag_framework_torch/parallel/`) against the port on one device
and against the JAX package's sharded paths, on the CPU.

The port's mesh is a list of ``torch.device`` positions; ``["cpu"] * S``
runs S shards in this process. The JAX side runs on the eight virtual CPU
devices of ``tests/conftest.py``; its results are computed once per module
(``shard_map`` compiles are slow).

Tolerances. On the tie-free corpus the sharded engine equals the port's
single-device engine exactly (ids identical, scores within ATOL = 1e-5,
seen 0) and the JAX package's sharded engine within ATOL (ids identical).
Sharded SPLADE scores within rtol 1e-6, as in ``__graft_entry__.py``. The
train step: one step's gradients within ``1e-5 * max|g| + 1e-7`` per leaf
and the loss within 1e-5 (f32 config), parameters within 5e-4 after five
steps, within 1e-6 of JAX's ``shard_train_step`` after one; bf16 config
gradients within 2e-2 of a leaf's largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_modular_rag_framework_torch.core.dataset_loader import (
    SyntheticHotpotQALoader)
from a_modular_rag_framework_torch.engine import EngineConfig, TorchQueryEngine
from a_modular_rag_framework_torch.index import SentenceCorpus
from a_modular_rag_framework_torch.index.builder import build_packed_index
from a_modular_rag_framework_torch.models import encoder as t_enc
from a_modular_rag_framework_torch.models.optim import (clone_tree,
                                                        value_and_grad)
from a_modular_rag_framework_torch.models.params import (flatten_params,
                                                         tree_leaves)
from a_modular_rag_framework_torch.ops import splade as t_splade
from a_modular_rag_framework_torch.ops.bm25 import bm25_topk_sorted
from a_modular_rag_framework_torch.ops.topk import dense_topk_reference
from a_modular_rag_framework_torch.parallel import (
    DeviceMesh, PartitionSpec, ShardedDenseEngine, ShardedHybridEngine,
    all_gather, all_reduce_max, all_reduce_sum, build_mesh, dryrun_check,
    mesh_from_settings, shard_corpus_rows, shard_hybrid_arrays,
    shard_splade_postings, sharded_dense_topk, sharded_splade_topk)
from a_modular_rag_framework_torch.parallel import dryrun as t_dryrun
from a_modular_rag_framework_torch.parallel import train as t_train
from a_modular_rag_framework_torch.parallel.sharded_hybrid import (
    DRYRUN_CONFIGS, _tie_free_corpus, dryrun_config)
from a_modular_rag_framework_tpu.engine.query_engine import (
    EngineConfig as JEngineConfig)
from a_modular_rag_framework_tpu.index.builder import (
    build_packed_index as j_build_packed_index)
from a_modular_rag_framework_tpu.models import encoder as j_enc
from a_modular_rag_framework_tpu.ops.splade import (
    SpladeDeviceIndex as JSpladeDeviceIndex)
from a_modular_rag_framework_tpu.parallel import mesh as j_mesh
from a_modular_rag_framework_tpu.parallel import sharded as j_sharded
from a_modular_rag_framework_tpu.parallel import sharded_hybrid as j_hybrid
from a_modular_rag_framework_tpu.parallel.sharded_engine import (
    ShardedDenseEngine as JShardedDenseEngine)

ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL, LOSS_ATOL = 1e-5, 1e-7, 1e-5
STEPS_ATOL = 5e-4
JAX_STEP_ATOL = 1e-6
BF16_GRAD_RTOL = 2e-2
SMALL = dict(vocab_size=256, max_len=8, d_model=32, n_heads=4, n_layers=2,
             d_ff=64, subword_ngrams=2)


def cpu_mesh(axes, n):
    return build_mesh(axes, devices=["cpu"] * n)


def cfg_pair(cfg: EngineConfig) -> JEngineConfig:
    return JEngineConfig(**dataclasses.asdict(cfg))


def seeds_for(n_docs, n_queries):
    return [[(3 * i) % n_docs, (7 * i + 1) % n_docs]
            for i in range(n_queries)]


# ---------------- the mesh ----------------


def test_build_mesh_shapes_and_errors_match_jax():
    for axes in ({"data": 4, "model": 2}, {"data": -1, "model": 2},
                 {"model": -1, "data": 2}, {"data": -1}):
        t = cpu_mesh(axes, 8)
        j = j_mesh.build_mesh(axes)
        assert t.shape == dict(j.shape) and t.axis_names == j.axis_names
    for bad in ({"data": 3}, {"data": -1, "model": -1}, {"data": -1,
                                                         "model": 3}):
        with pytest.raises(ValueError):
            cpu_mesh(bad, 8)
        with pytest.raises(ValueError):
            j_mesh.build_mesh(bad)


def test_mesh_from_settings_puts_dcn_outermost():
    settings = {"mesh": {"axes": {"data": -1}, "dcn_axes": {"dcn": 2}}}
    t = mesh_from_settings(settings, devices=["cpu"] * 8)
    j = j_mesh.mesh_from_settings(settings)
    assert t.axis_names == j.axis_names == ("dcn", "data")
    assert t.shape == dict(j.shape) == {"dcn": 2, "data": 4}
    with pytest.raises(ValueError):
        mesh_from_settings({"mesh": {"axes": {"data": -1},
                                     "dcn_axes": {"data": 2}}},
                           devices=["cpu"] * 8)


def test_mesh_groups_follow_the_device_order():
    devs = [torch.device("cpu")] * 6
    m = DeviceMesh(("dcn", "data"), np.array(
        [[0, 1, 2], [3, 4, 5]], dtype=object))
    assert m.groups("data") == [[0, 1, 2], [3, 4, 5]]
    assert m.groups("dcn") == [[0, 3], [1, 4], [2, 5]]
    assert cpu_mesh({"data": 6}, 6).groups("data") == [devs]
    # the default mesh on a machine without a card: one CPU position
    assert build_mesh().shape == {"data": 1}


# ---------------- the collectives ----------------


def test_collectives_combine_in_shard_order_and_carry_gradients():
    rng = np.random.default_rng(3)
    parts = [torch.tensor(rng.standard_normal((2, 3)), dtype=torch.float32,
                          requires_grad=True) for _ in range(4)]
    gathered = all_gather(parts, "cpu", dim=1)
    assert torch.equal(gathered, torch.cat(parts, dim=1))
    total = all_reduce_sum(parts, "cpu")
    assert torch.equal(total, ((parts[0] + parts[1]) + parts[2]) + parts[3])
    assert torch.equal(all_reduce_max(parts, "cpu"),
                       torch.stack(parts).amax(0))
    # one non-zero term per element: the sum is that term, exactly
    owned = [torch.where(torch.arange(3) % 4 == s, p, torch.zeros_like(p))
             for s, p in enumerate(parts)]
    exact = all_reduce_sum(owned, "cpu")
    for c in range(3):
        assert torch.equal(exact[:, c], parts[c % 4][:, c])
    w = torch.tensor(rng.standard_normal((2, 12)), dtype=torch.float32)
    grads = torch.autograd.grad((gathered * w).sum() + 2.0 * total.sum(),
                                parts)
    for s, g in enumerate(grads):
        assert torch.equal(g, w[:, 3 * s: 3 * s + 3] + 2.0)


# ---------------- sharded dense ----------------


@pytest.fixture(scope="module")
def dense_case():
    rng = np.random.default_rng(0)
    N, d, B, k = 1021, 32, 4, 10  # N not a multiple of the shard count
    emb = rng.standard_normal((N, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    j_emb = np.concatenate([emb, np.zeros((3, d), np.float32)])  # 1024 rows
    j_s, j_i = j_sharded.sharded_dense_topk(
        jnp.asarray(q), j_sharded.shard_corpus_rows(
            jnp.asarray(j_emb), j_mesh.build_mesh({"data": 8})), k,
        j_mesh.build_mesh({"data": 8}), precision=jax.lax.Precision.HIGHEST)
    return emb, q, k, np.asarray(j_s), np.asarray(j_i)


@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_sharded_dense_topk_matches_single_device_and_jax(dense_case,
                                                          n_shards):
    emb, q, k, j_s, j_i = dense_case
    rows = shard_corpus_rows(torch.from_numpy(emb),
                             cpu_mesh({"data": n_shards}, n_shards))
    assert sum(t.shape[0] for t in rows.shards) == emb.shape[0]
    s, i = sharded_dense_topk(torch.from_numpy(q), rows, k)
    s_ref, i_ref = dense_topk_reference(torch.from_numpy(q),
                                        torch.from_numpy(emb), k)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)
    np.testing.assert_array_equal(i.numpy(), j_i)
    np.testing.assert_allclose(s.numpy(), j_s, atol=ATOL)


def test_sharded_dense_topk_breaks_ties_by_ascending_id():
    emb = torch.tensor([[1.0, 0.0]] * 9 + [[0.5, 0.0]] * 3)
    q = torch.tensor([[1.0, 0.0]])
    s, i = sharded_dense_topk(q, shard_corpus_rows(
        emb, cpu_mesh({"data": 4}, 4)), 11)
    assert i[0].tolist() == list(range(11))
    assert s[0].tolist() == [1.0] * 9 + [0.5] * 2


@pytest.fixture(scope="module")
def tie_free():
    corpus, queries = _tie_free_corpus()
    j_corpus, j_queries = j_hybrid._tie_free_corpus()
    assert j_corpus.docs == corpus.docs and j_queries == queries
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    j_idx = j_build_packed_index(j_corpus, embed_dim=32,
                                 embed_dtype="float32")
    return {"idx": idx, "j_idx": j_idx, "queries": queries,
            "seeds": seeds_for(idx.n_docs, len(queries))}


def test_sharded_dense_engine_matches_single_device_and_jax(tie_free):
    idx, qs = tie_free["idx"], tie_free["queries"]
    sharded = ShardedDenseEngine(idx, mesh=cpu_mesh({"data": 8}, 8),
                                 batch_buckets=(8,))
    assert sharded.n_shards == 8
    single = TorchQueryEngine(idx, device="cpu",
                              config=EngineConfig(batch_buckets=(8,)))
    hb = sharded.query_batch(qs[:3], top_k=7)
    rd = single.query_dense_batch(qs[:3], top_k=7)
    np.testing.assert_array_equal(hb.ids, rd.hits.ids)
    np.testing.assert_array_equal(hb.scores, rd.hits.scores)
    j = JShardedDenseEngine(tie_free["j_idx"], batch_buckets=(8,))
    jb = j.query_batch(qs[:3], top_k=7)
    np.testing.assert_array_equal(hb.ids, np.asarray(jb.ids))
    np.testing.assert_allclose(hb.scores, np.asarray(jb.scores), atol=ATOL)


# ---------------- the sharded hybrid engine ----------------


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("which", range(len(DRYRUN_CONFIGS)),
                         ids=["dense", "compact", "dense_bf16_wave",
                              "compact_two_stage"])
def test_sharded_hybrid_equals_single_device(tie_free, which, n_shards):
    """Both seed modes; identical ids, scores within ATOL (seen 0)."""
    cfg = dryrun_config(*DRYRUN_CONFIGS[which])
    single = TorchQueryEngine(tie_free["idx"], device="cpu", config=cfg)
    sharded = ShardedHybridEngine(tie_free["idx"], config=cfg,
                                  mesh=cpu_mesh({"data": n_shards}, n_shards))
    for kw in ({}, {"seed_rows": tie_free["seeds"]}):
        r1 = single.query_batch(tie_free["queries"], top_k=10, **kw)
        r2 = sharded.query_batch(tie_free["queries"], top_k=10, **kw)
        np.testing.assert_array_equal(r1.hits.ids, r2.hits.ids)
        np.testing.assert_allclose(r1.hits.scores, r2.hits.scores, atol=ATOL)
        np.testing.assert_allclose(r1.channel_norms, r2.channel_norms,
                                   atol=ATOL)
        assert r2.diagnostics["n_shards"] == n_shards
        assert r2.diagnostics["graph_impl"] == r1.diagnostics["graph_impl"]


def test_dryrun_check_on_four_and_eight_shards():
    for n in (4, 8):
        dryrun_check(cpu_mesh({"data": n}, n))


@pytest.fixture(scope="module")
def jax_hybrid(tie_free):
    """The JAX sharded engine's hits on 8 shards, each configuration and
    seed mode (computed once: one shard_map compile each)."""
    mesh = j_mesh.build_mesh({"data": 8})
    out = {}
    for which, case in enumerate(DRYRUN_CONFIGS):
        eng = j_hybrid.ShardedHybridEngine(
            tie_free["j_idx"], mesh=mesh,
            config=cfg_pair(dryrun_config(*case)))
        for mode, kw in (("derived", {}),
                         ("explicit", {"seed_rows": tie_free["seeds"]})):
            r = eng.query_batch(tie_free["queries"], top_k=10, **kw)
            out[which, mode] = (np.asarray(r.hits.ids),
                                np.asarray(r.hits.scores),
                                np.asarray(r.channel_norms))
    return out


@pytest.mark.parametrize("mode", ["derived", "explicit"])
@pytest.mark.parametrize("which", range(len(DRYRUN_CONFIGS)),
                         ids=["dense", "compact", "dense_bf16_wave",
                              "compact_two_stage"])
def test_sharded_hybrid_matches_jax_sharded(tie_free, jax_hybrid, which,
                                            mode):
    sharded = ShardedHybridEngine(
        tie_free["idx"], mesh=cpu_mesh({"data": 8}, 8),
        config=dryrun_config(*DRYRUN_CONFIGS[which]))
    kw = {"seed_rows": tie_free["seeds"]} if mode == "explicit" else {}
    r = sharded.query_batch(tie_free["queries"], top_k=10, **kw)
    j_ids, j_scores, j_norms = jax_hybrid[which, mode]
    np.testing.assert_array_equal(r.hits.ids, j_ids)
    np.testing.assert_allclose(r.hits.scores, j_scores, atol=ATOL)
    np.testing.assert_allclose(r.channel_norms, j_norms, atol=ATOL)


def test_shard_hybrid_arrays_equal_jax(tie_free):
    t = shard_hybrid_arrays(tie_free["idx"], 8)
    j = j_hybrid.shard_hybrid_arrays(tie_free["j_idx"], 8)
    assert t.keys() == j.keys()
    for key, v in j.items():
        got = t[key].float().numpy() if key == "emb" else t[key]
        if key == "emb":
            np.testing.assert_allclose(got, v, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, v, err_msg=key)


def test_dcn_axes_split_the_batch(tie_free):
    mesh = mesh_from_settings(
        {"mesh": {"axes": {"data": -1}, "dcn_axes": {"dcn": 2}}},
        devices=["cpu"] * 8)
    cfg = dryrun_config("compact", "float32", None)
    single = TorchQueryEngine(tie_free["idx"], device="cpu", config=cfg)
    sharded = ShardedHybridEngine(tie_free["idx"], mesh=mesh, axis="data",
                                  config=cfg)
    assert sharded.n_shards == 4
    assert sharded.dp_axes == ("dcn",) and sharded._dp_size == 2
    # one device per shard, shared by both dcn groups
    assert sharded._shards[0][1] is sharded._shards[1][1]
    qs = tie_free["queries"][:7]  # bucket 8, split 4 + 4
    r1, r2 = single.query_batch(qs, top_k=10), sharded.query_batch(qs,
                                                                   top_k=10)
    np.testing.assert_array_equal(r1.hits.ids, r2.hits.ids)
    np.testing.assert_allclose(r1.hits.scores, r2.hits.scores, atol=ATOL)


def test_recall_on_a_template_corpus():
    """Template sentences tie exactly at pool cuts, where the two selection
    orders may keep different equal-scored members: gold recall must
    still agree (the JAX test's bound)."""
    from a_modular_rag_framework_torch.eval.harness import evaluate_retrieval

    samples = SyntheticHotpotQALoader({"count": 24, "seed": 5,
                                       "unique_entities": True}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=32, embed_dtype="float32")
    cfg = EngineConfig(top_k=10, pool_k=64, graph_window=2,
                       bm25_term_topm=4096, batch_buckets=(32,))
    single = TorchQueryEngine(idx, device="cpu", config=cfg)
    sharded = ShardedHybridEngine(idx, mesh=cpu_mesh({"data": 8}, 8),
                                  config=cfg)
    r1 = evaluate_retrieval(single, samples, k=10, batch_size=32)
    r2 = evaluate_retrieval(sharded, samples, k=10, batch_size=32)
    assert r1["recall_at_10"] > 0
    assert r2["recall_at_10"] == pytest.approx(r1["recall_at_10"], abs=0.05)


def test_async_pipelined_and_pool_k(tie_free):
    cfg = dryrun_config("compact", "float32", None)
    single = TorchQueryEngine(tie_free["idx"], device="cpu", config=cfg)
    sharded = ShardedHybridEngine(tie_free["idx"], config=cfg,
                                  mesh=cpu_mesh({"data": 4}, 4))
    qs = tie_free["queries"]
    direct = sharded.query_batch(qs[:4])
    piped = list(sharded.query_batches_pipelined([qs[:4], qs[4:]]))
    sharded.close()
    np.testing.assert_array_equal(piped[0].hits.ids, direct.hits.ids)
    # pool_k reaches the program (below the candidate count the cut runs
    # through equal BM25 scores whose phase-1 prefix sums round by ulps
    # differently per shard, so ids are compared where the cut is vacuous)
    narrow = sharded.query_batch_async(qs, pool_k=16).result()
    assert narrow.diagnostics["pool"]["bm25_pool_k"] == 16
    for kw in ({"pool_k": 64}, {"pool_k": 64, "prepruned": True}):
        a = single.query_batch_async(qs, **kw).result()
        b = sharded.query_batch_async(qs, **kw).result()
        np.testing.assert_array_equal(a.hits.ids, b.hits.ids)
    hits = sharded.hydrate_hits(direct, 0)
    assert hits and hits[0].id.startswith("sent::")
    assert sharded.device_bytes() > 0
    with pytest.raises(ValueError, match="BM25"):
        ShardedHybridEngine(tie_free["idx"], mesh=cpu_mesh({"data": 2}, 2),
                            config=EngineConfig(sparse_impl="splade",
                                                splade_weights="x.npz"))


def test_iterative_and_served_over_the_sharded_engine():
    """Iterative 2-hop (hop 2 firing) and QueryServer in both modes over
    the sharded engine == the single-device engine."""
    t_dryrun.iterative_and_serving(cpu_mesh({"data": 4}, 4),
                                   log=lambda _: None)


def test_settings_mesh_activates_the_sharded_engine(tmp_path, monkeypatch):
    """The settings' mesh + index.shard_axis, through the retrieval flow,
    build the sharded engine over the visible devices (8, monkeypatched)."""
    from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest
    from a_modular_rag_framework_torch.core.dto import RetrievalIn
    from a_modular_rag_framework_torch.modules.retrieval import torch_backend
    from a_modular_rag_framework_torch.modules.retrieval.flow import (
        RetrievalAgentFlow)

    monkeypatch.setattr(torch_backend, "visible_devices", lambda d: 8)
    samples = SyntheticHotpotQALoader({"count": 12, "seed": 3,
                                       "unique_entities": True}).load()
    docs_out = tmp_path / "docs.jsonl"
    ingest(samples, graph_root=tmp_path / "graph", docs_out=docs_out,
           embed_dim=32, embed_dtype="float32", build_graphs=False)
    settings = {
        "device": "cpu",
        "mesh": {"axes": {"data": -1}},
        "index": {"embed_dim": 32, "dtype": "float32", "shard_axis": "data"},
        "modules": {"retrieval": {
            "type": ("a_modular_rag_framework_torch.modules.retrieval."
                     "flow:RetrievalAgentFlow"),
            "impl": ("a_modular_rag_framework_torch.modules.retrieval."
                     "torch_backend:TorchHybridRetrievalBackend"),
            "impl_kwargs": {"index_path": str(docs_out),
                            "graph_root": str(tmp_path / "graph"),
                            "iterative_hops": 1},
        }},
    }
    flow = RetrievalAgentFlow.from_settings(settings)
    engine = flow.backend.engine
    assert isinstance(engine, ShardedHybridEngine), type(engine)
    assert engine.n_shards == 8
    out = flow.retrieve(RetrievalIn(query=samples[0]["question"],
                                    graph_id="", top_k=5, trace_id="t"))
    assert out.hits and out.hits[0].id.startswith("sent::")
    assert out.diagnostics["n_shards"] == 8


# ---------------- sharded SPLADE ----------------


@pytest.fixture(scope="module")
def splade_case():
    rng = np.random.default_rng(11)
    N, K, V, B, T = 41, 6, 64, 5, 4
    doc_ids = rng.integers(0, V, size=(N, K)).astype(np.int32)
    w = (rng.random((N, K)) + 0.01).astype(np.float32)
    t_ids = rng.integers(0, V, size=(B, T)).astype(np.int32)
    t_ids[0, -1] = -1  # a padding slot
    t_w = (rng.random((B, T)) + 0.1).astype(np.float32)
    j_idx = JSpladeDeviceIndex.from_expansions(doc_ids, w, vocab_size=V)
    d_sh, i_sh, rp_sh, rows = j_sharded.shard_splade_postings(j_idx, 8)
    j_s, j_i = j_sharded.sharded_splade_topk(
        jnp.asarray(t_ids), jnp.asarray(t_w), jnp.asarray(d_sh),
        jnp.asarray(i_sh), jnp.asarray(rp_sh), mesh=j_mesh.build_mesh(
            {"data": 8}), rows_per_shard=rows, n_docs=N, k=7, term_topm=N)
    return {"idx": t_splade.SpladeDeviceIndex.from_expansions(
        doc_ids, w, vocab_size=V), "j_idx": j_idx, "t_ids": t_ids,
        "t_w": t_w, "N": N, "jax": (np.asarray(j_s), np.asarray(j_i))}


@pytest.mark.parametrize("n_shards", [3, 8])
def test_sharded_splade_matches_single_device_and_jax(splade_case, n_shards):
    c = splade_case
    N, k = c["N"], 7
    host = shard_splade_postings(c["idx"], n_shards)
    for a, b in zip(host, j_sharded.shard_splade_postings(c["j_idx"],
                                                          n_shards)):
        np.testing.assert_array_equal(a, b)
    t_ids, t_w = torch.from_numpy(c["t_ids"]), torch.from_numpy(c["t_w"])
    ref_s, ref_i = bm25_topk_sorted(
        t_ids[:, None, :], torch.from_numpy(c["idx"].doc_ids),
        torch.from_numpy(c["idx"].impacts), torch.from_numpy(
            c["idx"].row_ptr), n_docs=N, term_topm=N, pool_k=k,
        term_weights=t_w[:, None, :])
    d_sh, i_sh, rp_sh, rows = host
    s, i = sharded_splade_topk(
        t_ids, t_w, d_sh, i_sh, rp_sh,
        mesh=cpu_mesh({"data": n_shards}, n_shards), rows_per_shard=rows,
        n_docs=N, k=k, term_topm=N)
    assert torch.equal(i, ref_i)
    np.testing.assert_allclose(s.numpy(), ref_s.numpy(), rtol=1e-6)
    if n_shards == 8:
        np.testing.assert_array_equal(i.numpy(), c["jax"][1])
        np.testing.assert_allclose(s.numpy(), c["jax"][0], rtol=1e-6)


# ---------------- the sharded train step ----------------


def t_cfg(dtype=torch.float32):
    return t_enc.EncoderConfig(**SMALL, dtype=dtype)


def pair_batch(cfg, n=8):
    qs = [f"question {i} about topic {i} x" for i in range(n)]
    ps = [f"passage {i} on topic {i} y z" for i in range(n)]
    return t_enc.TextEncoder.make_pair_batch(qs, ps, cfg)


def nce(cfg):
    def loss_fn(params, batch):
        loss, acc = t_enc.info_nce_loss(params, batch, cfg)
        return loss, {"accuracy": acc}
    return loss_fn


def test_partition_specs_equal_jax_leaf_for_leaf():
    t_specs = t_enc.param_partition_specs(t_cfg())
    j_specs = j_enc.param_partition_specs(j_enc.EncoderConfig(**SMALL))
    j_leaves = jax.tree_util.tree_flatten_with_path(
        j_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    flat = {}

    def walk(node, prefix):
        if isinstance(node, PartitionSpec):
            flat[prefix] = tuple(node)
        elif isinstance(node, dict):
            for key, v in node.items():
                walk(v, f"{prefix}[{key!r}]")
        else:
            for n, v in enumerate(node):
                walk(v, f"{prefix}[{n}]")

    walk(t_specs, "")
    assert flat == {jax.tree_util.keystr(k): tuple(v)
                    for k, v in j_leaves[0]}
    # the specs cover the parameter tree
    params = t_enc.init_params(t_enc.seeded_generator(0, "cpu"), t_cfg())
    assert set(flat) == set(flatten_params(params))


def test_blocks_have_the_shapes_their_specs_imply():
    cfg = t_cfg()
    params = t_enc.init_params(t_enc.seeded_generator(0, "cpu"), cfg)
    mesh = cpu_mesh({"data": 2, "model": 2}, 4)
    placed = t_train.place_params(params, cfg, mesh)
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.max_len, cfg.vocab_size
    assert [tuple(b.shape) for b in placed["tok_emb"]] == [(V, d // 2)] * 2
    assert [tuple(b.shape) for b in placed["pos_emb"]] == [(L, d // 2)] * 2
    layer = placed["layers"][0]
    assert [tuple(b.shape) for b in layer["wqkv"]] == [(d, 3 * d // 2)] * 2
    assert [tuple(b.shape) for b in layer["wo"]] == [(d // 2, d)] * 2
    assert [tuple(b.shape) for b in layer["w1"]] == [(d, f // 2)] * 2
    assert [tuple(b.shape) for b in layer["w2"]] == [(f // 2, d)] * 2
    assert tuple(layer["ln1"]["g"].shape) == (d,)
    # JAX's contiguous blocks: the first wqkv block is columns 0..3d/2
    assert torch.equal(layer["wqkv"][0], params["layers"][0]["wqkv"][:, :48])
    gathered = t_train.gather_params(placed, cfg)
    for a, b in zip(tree_leaves(gathered), tree_leaves(params)):
        assert torch.equal(a, b)
    batch = t_train.place_batch(pair_batch(cfg), mesh)
    assert [tuple(b.shape) for b in batch["q_mask"]] == [(4, L)] * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_gradients_equal_single_device(dtype):
    cfg = t_cfg(dtype)
    params = t_enc.init_params(t_enc.seeded_generator(0, "cpu"), cfg)
    hb = pair_batch(cfg)
    l1, _, g1 = value_and_grad(nce(cfg), params,
                               {k: torch.from_numpy(v) for k, v in hb.items()})
    mesh = cpu_mesh({"data": 2, "model": 2}, 4)
    l2, aux, g2 = value_and_grad(
        t_train.sharded_info_nce(cfg, mesh),
        t_train.place_params(params, cfg, mesh), t_train.place_batch(hb, mesh))
    assert abs(float(l1) - float(l2)) <= LOSS_ATOL
    assert set(aux) == {"accuracy"}
    g2 = t_train.gather_params(g2, cfg)
    for key, a in flatten_params(g1).items():
        b = flatten_params(g2)[key]
        top = float(np.abs(a).max())
        if dtype == torch.float32:
            assert np.abs(a - b).max() <= GRAD_RTOL * top + GRAD_ATOL, key
        else:
            assert np.abs(a - b).max() <= BF16_GRAD_RTOL * top, key


def test_five_sharded_steps_equal_single_device():
    cfg = t_cfg()
    params = t_enc.init_params(t_enc.seeded_generator(1, "cpu"), cfg)
    hb = pair_batch(cfg)
    init, step = t_enc.make_train_step(cfg)
    p1 = clone_tree(params)
    s1 = init(p1)
    mesh = cpu_mesh({"data": 2, "model": 2}, 4)
    place_params, place_batch, init2, step2 = t_enc.shard_train_step(cfg,
                                                                     mesh)
    p2 = place_params(params)
    s2 = init2(p2)
    b1 = {k: torch.from_numpy(v) for k, v in hb.items()}
    b2 = place_batch(hb)
    for _ in range(5):
        p1, s1, m1 = step(p1, s1, b1)
        p2, s2, m2 = step2(p2, s2, b2)
        assert abs(float(m1["loss"]) - float(m2["loss"])) <= LOSS_ATOL
    for a, b in zip(tree_leaves(p1),
                    tree_leaves(t_train.gather_params(p2, cfg))):
        assert float((a - b).abs().max()) <= STEPS_ATOL
    assert int(s2["count"]) == 5
    mu = t_train.gather_params(s2["mu"], cfg)
    assert [tuple(t.shape) for t in tree_leaves(mu)] == [
        tuple(t.shape) for t in tree_leaves(params)]


def test_sharded_step_matches_jax_shard_train_step():
    """One step on {data: 4, model: 2} from one parameter file, against
    the JAX package's ``shard_train_step`` on 8 virtual devices."""
    cfg = t_cfg()
    j_cfg = j_enc.EncoderConfig(**SMALL, dtype=jnp.float32)
    params = t_enc.init_params(t_enc.seeded_generator(2, "cpu"), cfg)
    flat = flatten_params(params)
    paths, treedef = jax.tree_util.tree_flatten_with_path(
        j_enc.init_params(jax.random.PRNGKey(0), j_cfg))
    j_params = jax.tree_util.tree_unflatten(
        treedef, [jnp.array(flat[jax.tree_util.keystr(k)]) for k, _ in paths])
    hb = pair_batch(cfg)
    j_hb = j_enc.TextEncoder.make_pair_batch(
        [f"question {i} about topic {i} x" for i in range(8)],
        [f"passage {i} on topic {i} y z" for i in range(8)], j_cfg)
    for key in hb:
        np.testing.assert_array_equal(hb[key], j_hb[key])

    jm = j_mesh.build_mesh({"data": 4, "model": 2})
    jp, jb, j_init, j_step = j_enc.shard_train_step(j_cfg, jm)
    j_params = jp(j_params)
    j_params, _, j_m = j_step(j_params, j_init(j_params),
                              jb({k: jnp.asarray(v) for k, v in hb.items()}))
    mesh = cpu_mesh({"data": 4, "model": 2}, 8)
    place_params, place_batch, init, step = t_enc.shard_train_step(cfg, mesh)
    p = place_params(params)
    p, _, m = step(p, init(p), place_batch(hb))
    assert abs(float(m["loss"]) - float(j_m["loss"])) <= LOSS_ATOL
    got = flatten_params(t_train.gather_params(p, cfg))
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(j_params)[0]}
    assert got.keys() == want.keys()
    for key, a in got.items():
        np.testing.assert_allclose(a, want[key], atol=JAX_STEP_ATOL, rtol=0,
                                   err_msg=key)


def test_sharded_step_runs_on_the_mesh_and_learns():
    """Mirror of tests/test_models.py::test_sharded_train_step_runs_on_mesh:
    the step runs, its blocks stay split over model, and the loss falls."""
    cfg = t_cfg()
    mesh = cpu_mesh({"data": 4, "model": 2}, 8)
    place_params, place_batch, init, step = t_enc.shard_train_step(cfg, mesh)
    p = place_params(t_enc.init_params(t_enc.seeded_generator(0, "cpu"), cfg))
    s = init(p)
    b = place_batch(pair_batch(cfg))
    first = None
    for _ in range(10):
        p, s, m = step(p, s, b)
        first = first if first is not None else float(m["loss"])
    assert np.isfinite(first) and float(m["loss"]) < first
    assert len(p["layers"][0]["wqkv"]) == 2
    with pytest.raises(ValueError, match="split over data"):
        place_batch(pair_batch(cfg, n=6))


# ---------------- the graft entry counterpart ----------------


def test_dryrun_multichip_in_process():
    lines = []
    t_dryrun.dryrun_multichip(4, device="cpu", log=lines.append)
    assert lines[-1] == "dryrun_multichip ok: n_devices=4"
    assert len(lines) == 8


def test_entry_runs():
    fn, args = t_dryrun.entry("cpu")
    out = fn(*args)
    assert out.shape == (2, 64)
    np.testing.assert_allclose(out.norm(dim=1).numpy(), 1.0, atol=1e-5)


# ---------------- on the card ----------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [2, 4])
def test_per_shard_kernel_matches_reference(cuda_device, n_shards):
    """The dense kernel per shard of [cuda:0] * S: ids and scores equal the
    plain version over the whole corpus on small-integer inputs (every
    score exact), each shard launching once."""
    from a_modular_rag_framework_torch.ops import topk as ttopk

    g = np.random.default_rng(n_shards)
    q = torch.from_numpy(g.integers(-3, 4, (70, 64)).astype(np.float32))
    db = torch.from_numpy(g.integers(-4, 5, (5003, 64)).astype(np.float32))
    q, db = q.to(cuda_device), db.to(cuda_device, torch.bfloat16)
    rows = shard_corpus_rows(db, build_mesh(
        {"data": n_shards}, devices=[cuda_device] * n_shards))
    before = ttopk.dense_topk_cuda.launches
    s, i = sharded_dense_topk(q, rows, 10)
    torch.cuda.synchronize()
    assert ttopk.dense_topk_cuda.launches == before + n_shards
    s_ref, i_ref = dense_topk_reference(q, db, 10)
    assert torch.equal(i.cpu(), i_ref.cpu())
    assert torch.equal(s.cpu(), s_ref.cpu())


@pytest.mark.gpu
def test_dryrun_multichip_on_the_card(cuda_device):
    t_dryrun.dryrun_multichip(4, device=cuda_device, log=lambda _: None)
