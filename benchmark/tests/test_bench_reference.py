"""The corpus generator's widths, and the plain reference on a tiny corpus
held against the program on the CPU; the roofline and mfu arithmetic from
the shapes; the control and the planted faults come out not correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import small_cell

CELLS = ["hash1m.batch_hybrid", "learned1m.batch_dense_concurrent",
         "hash1m.batch_dense"]


def _corpus(name="hash1m.batch_hybrid"):
    from harness import spec

    c = spec.find_cell(name, listed=False).config["corpus"]
    return c, spec.load_module("corpora", c["generator"])


def _samples(count=120, seed=2 ** 31 + 3):
    c, gen = _corpus()
    return gen.generate(c, count, seed)


def _reference(samples, name="hash1m.batch_hybrid"):
    from harness import spec

    cell = spec.find_cell(name, listed=False)
    ref = spec.load_module("reference", cell.config["reference"])
    return cell, ref, ref.HotpotReference(samples, cell.config)


def test_generator_widths_and_seeds():
    """HotpotQA's distractor widths; the same seed gives the same samples,
    and every seed the same sizes."""
    from harness import spec

    text = spec.load_module("reference", "hotpot")
    c, gen = _corpus()
    a = gen.generate(c, 400, 2 ** 31 + 3)
    assert a == gen.generate(c, 400, 2 ** 31 + 3)
    b = gen.generate(c, 400, 17)
    assert a != b
    for x, y in zip(a, b):
        assert x["type"] == y["type"]
        assert sorted(len(p[1]) for p in x["context"]) == sorted(
            len(p[1]) for p in y["context"])
    rows = text.flatten(a)
    assert len(rows) == len(text.flatten(b)) == gen.rows_of(c, 400)
    assert all(len(x["context"]) == c["paragraphs"] == 10 for x in a)
    words = np.array([len(t.split()) for _, _, t in rows])
    assert 38 <= len(rows) / 400 <= 42 and 20 <= words.mean() <= 24
    q = np.array([len(x["question"].split()) for x in a])
    assert q.min() >= 12 and q.max() <= 24 and 16 <= q.mean() <= 20
    share = np.mean([x["type"] == "comparison" for x in a])
    assert 0.15 <= share <= 0.25
    for x in a:
        ctx = dict((t, s) for t, s in x["context"])
        for t, sid in x["supporting_facts"]:
            assert sid < len(ctx[t])
        (t0, s0), (t1, s1) = x["supporting_facts"]
        if x["type"] == "bridge":
            assert t1 in ctx[t0][s0] and x["answer"] in ctx[t1][s1]
        else:
            assert x["answer"] in (t0, t1)
    for _, _, t in rows:
        text.cap_runs(t)  # plain ASCII, as the reference's text rules want


def _program_index(samples):
    from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                     build_packed_index)

    return build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                              embed_dim=64, embed_dtype="bfloat16")


def test_bm25_and_graph_equal_the_program():
    samples = _samples()
    _, ref, r = _reference(samples)
    idx = _program_index(samples)
    bm = idx.bm25
    assert r.n == idx.n_docs
    assert r.avgdl == pytest.approx(float(bm.doc_lens.astype(np.float64)
                                          .mean()), rel=1e-12)
    for q in [s["question"] for s in samples[:30]]:
        for t in r.terms(r.prune(q)):
            tid = bm.vocab[t]
            a, b = bm.row_ptr[tid], bm.row_ptr[tid + 1]
            assert r.df(t) == int(bm.df[tid])
            want = list(zip(bm.scores[a:b].tolist(), bm.doc_ids[a:b].tolist()))
            got = [(float(c), rr) for c, rr in r.postings(t)]
            assert got == want
    table = np.concatenate([idx.graph_next, idx.graph_entity], axis=1)
    for row in range(0, r.n, 7):
        want = [int(x) for x in table[row] if x >= 0]
        assert r.neighbours(row) == want


def test_bulk_forms_equal_their_loops():
    """The reference's bulk forms (postings sorted at once, hash rows in
    one pass) equal the per-item loops they replace, bit for bit."""
    samples = _samples()
    _, ref, r = _reference(samples)
    for q in [s["question"] for s in samples[:30]]:
        for t in r.terms(r.prune(q)):
            loop = sorted(((r.contribution(t, row, tf), row)
                           for row, tf in r.post[t].items()),
                          key=lambda x: (-x[0], x[1]))
            assert [(float(c), row) for c, row in r.postings(t)] == [
                (float(c), row) for c, row in loop]
    texts = [t for _, _, t in r.rows[:500]] + [""]
    loop = np.stack([ref.unit_f32(ref.hash_vector(t, 64)) for t in texts])
    assert np.array_equal(ref.hash_matrix(texts, 64), loop)
    assert np.array_equal(ref.hash_matrix(texts, 64, stored=True),
                          ref.stored_rows(loop))


def test_hybrid_reference_equals_the_program():
    from a_modular_rag_framework_torch.engine.query_engine import (
        EngineConfig, TorchQueryEngine)
    from harness import check

    samples = _samples()
    cell, ref, r = _reference(samples)
    eng_cfg = dict(cell.config["engine"], batch_buckets=(32,),
                   order_alphas=tuple(cell.config["engine"]["order_alphas"]))
    engine = TorchQueryEngine(_program_index(samples), device="cpu",
                              config=EngineConfig(**eng_cfg))
    questions = [s["question"] for s in samples[:32]]
    res = engine.query_batch(questions, top_k=10)
    width = r.term_width(max(len(r.terms(r.prune(q))) for q in questions))
    for i, q in enumerate(questions):
        truth = r.hybrid(q, width)
        gap, err = check.judge_hybrid(truth, res.hits.ids[i],
                                      res.hits.scores[i], 10)
        assert gap == 0.0 and err < 1e-6
        assert [int(h) for h in res.hits.ids[i] if h >= 0] == truth["hits"]


def test_trunk_and_topk_equal_the_program():
    from a_modular_rag_framework_torch.models.encoder import (apply_encoder,
                                                              encode_tokens)
    from harness import deploy, spec

    cell = spec.find_cell("learned1m.batch_dense_concurrent")
    enc = cell.config["encoder"]
    ref = spec.load_module("reference", "hotpot")
    model, params = deploy.encoder_builder(enc).build(enc, 5, "cpu")
    texts = [s["question"] for s in _samples(40)] + [""]
    cfg = model.cfg
    ids, mask = encode_tokens(texts, cfg)
    want = apply_encoder(params, torch.from_numpy(ids).long(),
                         torch.from_numpy(mask), cfg)
    rids, rmask = ref.EncoderTokens(enc)(texts)
    assert torch.equal(rids, torch.from_numpy(ids).long())
    got = ref.encoder_forward(params, rids, rmask, enc, torch.bfloat16)
    assert float((got - want).abs().max()) < 1e-3

    rows = ref.store_bf16(torch.nn.functional.normalize(
        torch.randn(5000, 128, generator=torch.Generator().manual_seed(1)),
        dim=1))
    s, i = ref.dense_scores(got, rows, 10, block=777)
    brute = got / got.norm(dim=1, keepdim=True).clamp(min=1e-9) @ \
        rows.float().T
    bs, bi = torch.sort(brute, dim=1, descending=True, stable=True)
    assert torch.equal(i, bi[:, :10])
    assert float((s - bs[:, :10]).abs().max()) < 1e-6


def test_roofline_and_mfu_arithmetic():
    from harness import roofline, spec

    # B1's bound at the dense cell's shapes: operations, 3.29 ms
    b = roofline.dense_topk_bound_s(4096, 1_034_000, 128, 10)
    assert b == pytest.approx(3 * 2 * 4096 * 1_034_000 * 128 / 989e12)
    assert b * 1e3 == pytest.approx(3.2898, abs=1e-3)
    # a tiny corpus is bound by bytes
    assert roofline.dense_topk_bound_s(1, 10 ** 6, 64, 10) == pytest.approx(
        (64 * 4 + 10 ** 6 * 64 * 2 + 80) / 3.35e12)
    text_encoder = spec.load_module("encoders", "text_encoder")
    enc = {"max_len": 32, "d_model": 128, "d_ff": 512, "n_layers": 2}
    per_pos = 2 * (4 * 128 * 128 + 2 * 128 * 512) + 4 * 32 * 128
    assert text_encoder.flops(4096, enc) == 4096 * 32 * 2 * per_pos


# the readings of `metrics/dense_step_mfu.py` and `.concurrent.py` at the
# parent commit 192f770, for one fixed RunInfo (37 calls of 4,096 over
# 1,034,138 rows, a 10.25 s window, 5.5 s busy): the learned trunk's
# operations counted by `roofline.encoder_flops`, the hash encoder's none
MFU_BEFORE = {
    "hotpot1m-learned": {"dense_step_mfu": 1.2265473245699574,
                         "dense_step_mfu.concurrent": 2.285838195789466},
    "hotpot1m-hash": {"dense_step_mfu": 0.5936783837390219,
                      "dense_step_mfu.concurrent": 1.1064006242409046},
}


@pytest.mark.parametrize("config", sorted(MFU_BEFORE))
def test_mfu_readers_read_as_before(config):
    """The MFU readers take the trunk's operations from the builder's
    ``flops`` on RunInfo and read what they read before, bit for bit."""
    import run
    from harness import deploy, spec

    cfg = spec.load_json(spec.BENCH / "configs" / f"{config}.json")
    enc = cfg.get("encoder")
    trunk = (deploy.encoder_builder(enc).flops(4096, enc) if enc is not None
             else 0.0)
    info = run.RunInfo(calls=37, window_s=10.25, batch=4096,
                       n_rows=1_034_138, dim=int(cfg["index"]["embed_dim"]),
                       trace={"busy_s": 5.5}, trunk_flops=trunk)
    for name, want in MFU_BEFORE[config].items():
        assert spec.load_module("metrics", name).read(info) == want, name


def _seeded_encoder_params_before(enc, seed, device):
    """A frozen copy of ``harness/deploy.py::seeded_encoder_params`` at the
    parent commit 192f770, which drew the learned cell's weights."""
    V, L, d = int(enc["vocab_size"]), int(enc["max_len"]), int(enc["d_model"])
    f, n_layers = int(enc["d_ff"]), int(enc["n_layers"])
    shapes = [("tok_emb", (V, d), d ** -0.5), ("pos_emb", (L, d), d ** -0.5)]
    for i in range(n_layers):
        shapes += [(f"wqkv{i}", (d, 3 * d), d ** -0.5),
                   (f"wo{i}", (d, d), d ** -0.5),
                   (f"w1{i}", (d, f), d ** -0.5),
                   (f"w2{i}", (f, d), f ** -0.5)]
    total = sum(a * b for _, (a, b), _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    leaves, pos = {}, 0
    for name, (a, b), scale in shapes:
        leaves[name] = flat[pos:pos + a * b].view(a, b) * scale
        pos += a * b

    def ln():
        return {"g": torch.ones(d, device=device),
                "b": torch.zeros(d, device=device)}

    return {
        "tok_emb": leaves["tok_emb"], "pos_emb": leaves["pos_emb"],
        "layers": [{"ln1": ln(), "wqkv": leaves[f"wqkv{i}"],
                    "wo": leaves[f"wo{i}"], "ln2": ln(),
                    "w1": leaves[f"w1{i}"], "w2": leaves[f"w2{i}"]}
                   for i in range(n_layers)],
        "out_ln": ln(),
    }


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("seed", [5, 2 ** 40 + 17])
def test_text_encoder_builder_draws_the_weights_as_before(seed):
    """The learned cell's block without a ``builder`` key is built by
    ``encoders/text_encoder.py``, which draws every tensor of the old
    ``seeded_encoder_params`` bit for bit, at the cell's own widths, and
    hands the program the same tree and EncoderConfig."""
    from a_modular_rag_framework_torch.models.encoder import EncoderConfig
    from harness import deploy, spec

    enc = spec.find_cell("learned1m.batch_dense_concurrent").config["encoder"]
    assert "builder" not in enc
    builder = deploy.encoder_builder(enc)
    assert builder.__file__.endswith("encoders/text_encoder.py")
    model, params = builder.build(enc, seed, "cpu")
    old = dict(_leaves(_seeded_encoder_params_before(enc, seed, "cpu")))
    new = dict(_leaves(params))
    assert list(new) == list(old)
    for name, t in old.items():
        assert new[name].dtype == t.dtype and torch.equal(new[name], t), name
    assert model.params is params
    assert model.cfg == EncoderConfig(
        vocab_size=32768, max_len=32, d_model=128, n_heads=4, n_layers=2,
        d_ff=512, dtype=torch.bfloat16, subword_ngrams=8, ngram_min=3,
        ngram_max=5)


def _break_half(res):
    """Half of every batch left out: its hits empty."""
    for _, ids, scores in res.results:
        ids[len(ids) // 2:] = -1
        scores[len(scores) // 2:] = 0.0


def _alter_answers(res):
    """An answer altered where it is produced: every question's best hit
    replaced by the next row."""
    for _, ids, _ in res.results:
        ids[:, 0] = ids[:, 0] + 1


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, _break_half, _alter_answers])
def test_faults_come_out_not_correct(name, fault):
    import run

    cell = small_cell(name, samples=100 if "learned" in name else 300)
    result, compared, _, ctl = run.run_cell(
        cell, 2 ** 31 + 5, 0.3, False, "cpu", 0.0, fault=fault,
        controls=(cell.control,))
    assert result["correct"] is (fault is None), compared
    # the cell's control in the program's place fails one of the numbers
    assert any(v > compared[n][1] for n, v in ctl[cell.control].items()), ctl
