"""DeepSeek-V2 as the port's dense embedder (``models/deepseek_v2.py``,
``ops/moe.py``), held against the plain reference beside this file
(``tests/deepseek_v2_reference.py``) on seeded random weights at a small
size, piece by piece and whole; the expert layer's share of held experts;
padding and the query instruction; ``query_dense_batch`` on the CPU; and,
on the card (``gpu``), the grouped expert kernel at the published widths.

Tolerances: the port and the reference round the same operands to
bfloat16 and sum in float32 in another order, so they agree to float32
rounding (1e-5 here) wherever a bfloat16 rounding cannot flip; the
routing is compared exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import deepseek_v2_reference as ref
from a_modular_rag_framework_torch.models import deepseek_v2 as dsv2
from a_modular_rag_framework_torch.ops import moe as tmoe

CFG = dsv2.DeepseekV2Config(
    vocab_size=512, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
    n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=2,
    word_ids=500, eos_token_id=501, query_len=48, row_len=48,
    query_instruction="Instruct: find the answer\nQuery: ")
WIDTHS = dict(heads=4, nope=16, rope=8, v=16, rank=32, eps=1e-6, top_k=2,
              scale=dsv2.softmax_scale(CFG),
              yarn=(10000.0, 40.0, 4096, 32.0, 1.0, 0.707, 0.707))
TOL = dict(rtol=1e-5, atol=1e-5)
TEXTS = ["Alan Turing was born in London in 1912.",
         "Who was born first, the novelist Ada Byron or Alan?",
         "a b c d e f g h i j k l m n o p q r s t u v w x y z .",
         "Short one."]


@pytest.fixture(scope="module")
def params():
    return dsv2.init_params(CFG, 7, "cpu")


def _batch(texts, length=48, instruct=False):
    enc = dsv2.DeepseekV2Encoder(CFG, {}, device="cpu")
    ids, lens = (enc.host_featurize(texts) if instruct
                 else dsv2.featurize(texts, length, CFG))
    return torch.from_numpy(ids), torch.from_numpy(lens)


def _hidden(n=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, CFG.hidden_size), generator=g)


def test_rms_norm_matches(params):
    x = _hidden()
    w = torch.rand(CFG.hidden_size) + 0.5
    torch.testing.assert_close(dsv2.rms_norm(x, w, 1e-6),
                               ref.rms_norm(x, w, 1e-6), rtol=0, atol=0)


def test_yarn_tables_and_deinterleave():
    """The tables are the published ones bit for bit; the port's rope
    (de-interleave, then rotate_half) equals the published
    apply_rotary_pos_emb, and differs from rotating without the
    de-interleave."""
    cos, sin = dsv2.yarn_tables(48, CFG)
    rc, rs = ref.yarn(48, 8, *WIDTHS["yarn"])
    assert torch.equal(cos, rc) and torch.equal(sin, rs)
    full = dsv2.yarn_tables(48, dsv2.DeepseekV2Config())
    assert full[0].shape == (48, 64)
    x = torch.randn((3, 48, 4, 8), generator=torch.Generator().manual_seed(1))
    got = dsv2.apply_rope(x, cos, sin)
    want = ref.apply_rope(x.transpose(1, 2), rc, rs).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    plain = x * cos[:, None] + ref.rotate_half(x) * sin[:, None]
    assert not torch.allclose(got, plain)
    assert abs(dsv2.softmax_scale(dsv2.DeepseekV2Config()) - 192 ** -0.5 * (
        0.1 * 0.707 * np.log(40) + 1) ** 2) < 1e-12


def test_mla_matches(params):
    ids, lens = _batch(TEXTS)
    x = params["embed"][ids].float()
    lay = params["layers"][0]
    h = dsv2.rms_norm(x, lay["input_norm"], 1e-6)
    L = ids.shape[1]
    pos = torch.arange(L)
    valid = pos[None] < lens[:, None]
    allowed = (pos[None, :, None] >= pos[None, None, :]) & valid[:, None]
    cos, sin = dsv2.yarn_tables(L, CFG)
    got = dsv2.mla(h, lay["attn"], allowed, cos, sin, CFG)
    want = ref.mla(h, lay["attn"], valid, cos, sin, WIDTHS, torch.bfloat16)
    torch.testing.assert_close(got[valid], want[valid], **TOL)


def test_routing_agrees_exactly(params):
    lay = params["layers"][1]
    x = _hidden(200)
    w, e = tmoe.route(x, lay["router"], 2)
    rw, re_ = ref.router(x, lay["router"], 2)
    assert torch.equal(e, re_) and torch.equal(w, rw)


def test_moe_layer_matches_reference(params):
    lay = params["layers"][1]
    x = _hidden(120, seed=3)
    routes = []
    got = tmoe.moe_layer(x, lay["router"], lay["experts"], lay["shared"], 2,
                         routes=routes)
    want = ref.moe(x, lay, 2, torch.bfloat16)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(routes[0], ref.router(x, lay["router"], 2)[1])


@pytest.mark.parametrize("shares", [[[0, 1, 2, 3], [4, 5, 6, 7]],
                                    [[5], [0, 7, 2], [1, 3, 4, 6]]])
def test_held_experts_add_up_to_the_uncut_layer(params, shares):
    """Each card's layer gives its held experts' part; the parts, with the
    shared experts counted once, add up to the uncut reference layer."""
    lay = params["layers"][2]
    x = _hidden(150, seed=4)
    total = torch.zeros_like(x)
    for n, held in enumerate(shares):
        total += tmoe.moe_layer(x, lay["router"], _held(lay, held),
                                lay["shared"] if n == 0 else None, 2,
                                experts_held=held)
    torch.testing.assert_close(total, ref.moe(x, lay, 2, torch.bfloat16),
                               **TOL)
    alone = tmoe.moe_layer(x, lay["router"], _held(lay, shares[0]), None, 2,
                           experts_held=shares[0])
    assert not torch.allclose(alone, total - swiglu_shared(x, lay))


def _held(lay, held):
    """The routed experts' weights a card holding the experts ``held``
    keeps."""
    idx = torch.tensor(held)
    return {k: v[idx] for k, v in lay["experts"].items()}


def swiglu_shared(x, lay):
    return tmoe.swiglu(x, lay["shared"])


def test_padding_never_reaches_the_routed_experts(params):
    """The routed tokens are the real ones (their count, as routed), and
    a padding position's hidden state does not change a real output."""
    ids, lens = _batch(TEXTS)
    routes = []
    emb = dsv2.forward(params, ids, lens, CFG, routes=routes)
    assert len(routes) == 2
    assert all(r.shape[0] == int(lens.sum()) for r in routes)
    lay = params["layers"][1]
    x = _hidden(30, seed=5)
    real = torch.tensor([0, 1, 2, 5, 8, 13, 21])
    a = tmoe.moe_layer(x, lay["router"], lay["experts"], lay["shared"], 2,
                       real=real)
    y = x.clone()
    pad = torch.ones(30, dtype=torch.bool)
    pad[real] = False
    y[pad] = 1e3
    b = tmoe.moe_layer(y, lay["router"], lay["experts"], lay["shared"], 2,
                       real=real)
    torch.testing.assert_close(a[real], b[real], rtol=0, atol=0)
    assert emb.shape == (len(TEXTS), 64)


def test_instruction_on_queries_never_on_rows(params):
    enc = dsv2.DeepseekV2Encoder(CFG, params, device="cpu")
    ids, lens = enc.host_featurize(["Who?"])
    instr = dsv2.token_ids(CFG.query_instruction, CFG)[:-1]
    assert ids[0, :len(instr)].tolist() == instr
    assert int(lens[0]) == len(instr) + 3  # Who, ?, EOS
    rows = enc.encode_texts(["Who?"])
    r_ids, r_lens = dsv2.featurize(["Who?"], CFG.row_len, CFG)
    assert int(r_lens[0]) == 3
    plain = dsv2.forward(params, torch.from_numpy(r_ids),
                         torch.from_numpy(r_lens), CFG)
    torch.testing.assert_close(torch.from_numpy(rows), plain, rtol=0, atol=0)
    q = enc.device_embed(torch.from_numpy(ids), torch.from_numpy(lens))
    assert not torch.allclose(q, plain)
    with pytest.raises(ValueError, match="does not fit"):
        dsv2.featurize(["w " * 60], CFG.row_len, CFG)


@pytest.mark.parametrize("instruct", [False, True])
def test_trunk_embeddings_match_reference(params, instruct):
    ids, lens = _batch(TEXTS, instruct=instruct)
    got = dsv2.forward(params, ids, lens, CFG)
    want = ref.embed(params, ids, lens, WIDTHS)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.allclose((got * got).sum(-1), torch.ones(len(TEXTS)))
    f32 = ref.embed(params, ids, lens, WIDTHS, operand=None)
    assert (got - f32).abs().max() > 1e-4  # bfloat16 operands show


def test_query_dense_batch_on_the_cpu_is_the_exact_topk(params):
    from a_modular_rag_framework_torch.engine.query_engine import (
        EngineConfig, TorchQueryEngine)
    from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                     build_packed_index)

    samples = [{"_id": str(i), "question": f"q{i}", "answer": "",
                "context": [[f"T{i}", [f"Sentence {i} about topic {j} "
                                       f"and word{(i * j) % 7}."
                                       for j in range(5)]]],
                "supporting_facts": []} for i in range(12)]
    enc = dsv2.DeepseekV2Encoder(CFG, params, device="cpu")
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             encoder=enc, embed_dim=64)
    eng = TorchQueryEngine(idx, device="cpu", encoder=enc,
                           config=EngineConfig(batch_buckets=(8,), top_k=5))
    qs = ["Which sentence is about topic 3?", "word4 and topic 1",
          "Sentence 7", "nothing here"]
    res = eng.query_dense_batch(qs, top_k=5)
    texts = [t for _, _, t in _rows(samples)]
    r_ids, r_lens = dsv2.featurize(texts, CFG.row_len, CFG)
    rows = ref.embed(params, torch.from_numpy(r_ids),
                     torch.from_numpy(r_lens), WIDTHS)
    rows = rows.to(torch.bfloat16).float()
    rows = (rows / rows.norm(dim=1, keepdim=True)).to(torch.bfloat16).float()
    q_ids, q_lens = enc.host_featurize(qs)
    q = ref.embed(params, torch.from_numpy(q_ids), torch.from_numpy(q_lens),
                  WIDTHS)
    best, order = torch.sort(q @ rows.T, dim=1, descending=True, stable=True)
    assert np.array_equal(res.hits.ids, order[:, :5].numpy())
    np.testing.assert_allclose(res.hits.scores, best[:, :5].numpy(),
                               rtol=0, atol=1e-5)
    eng.close()


def _rows(samples):
    return [(t, sid, s) for smp in samples for t, sents in smp["context"]
            for sid, s in enumerate(sents)]


def test_tile_table_cuts_each_expert_into_tiles():
    counts = torch.tensor([0, 1, 128, 129, 300, 0])
    offsets = torch.cumsum(counts, 0) - counts
    e, row0, rows, n = tmoe.tile_table(counts, offsets, int(counts.sum()))
    k = int(n)
    assert k == 0 + 1 + 1 + 2 + 3 + 0
    assert e[:k].tolist() == [1, 2, 3, 3, 4, 4, 4]
    assert row0[:k].tolist() == [0, 1, 129, 257, 258, 386, 514]
    assert rows[:k].tolist() == [1, 128, 128, 1, 128, 128, 44]


def test_moe_gemm_on_the_cpu_is_the_reference_and_counts_no_launch(params):
    ex = params["layers"][1]["experts"]
    x = _hidden(50, seed=6).to(torch.bfloat16)
    counts = torch.tensor([10, 0, 5, 20, 0, 0, 15, 0])
    offsets = torch.cumsum(counts, 0) - counts
    order = torch.randperm(50, generator=torch.Generator().manual_seed(0))
    scale = torch.rand(50)
    before = tmoe.moe_gemm_cuda.launches
    y = tmoe.moe_gemm(x, ex["w_gate"], ex["w_up"], ex["w_down"], counts,
                      offsets, order, scale, 60)
    assert tmoe.moe_gemm_cuda.launches == before
    assert y.shape == (60, 64) and bool((y[50:] == 0).all())
    for e in range(8):
        rows = slice(int(offsets[e]), int(offsets[e] + counts[e]))
        want = ref.swiglu(x[rows].float(), {n: t[e] for n, t in ex.items()},
                          torch.bfloat16) * scale[rows, None]
        torch.testing.assert_close(y[order[rows]], want, **TOL)
    with pytest.raises(ValueError, match="CUDA"):
        tmoe.moe_gemm_cuda(x, ex["w_gate"], ex["w_up"], ex["w_down"], counts,
                           offsets, order, scale, 60)


def test_moe_table_counts_only_while_a_profiler_records(params):
    from a_modular_rag_framework_torch.telemetry.stages import (
        moe_table, reset_moe_table)

    lay = params["layers"][1]
    reset_moe_table()
    x = _hidden(40, seed=8)
    tmoe.moe_layer(x, lay["router"], lay["experts"], lay["shared"], 2)
    assert moe_table() == {}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            tmoe.moe_layer(x, lay["router"], lay["experts"], lay["shared"],
                           2, counter="model/moe/layer1")
    got = moe_table()["model/moe/layer1"]
    _, chosen = ref.router(x, lay["router"], 2)
    loads = torch.bincount(chosen.reshape(-1), minlength=8)
    assert got == {"batches": 3, "slots": 240,
                   "max_expert_slots": int(loads.max()), "experts_held": 8,
                   "expert_width": 32, "hidden": 64}
    reset_moe_table()


# ---------------- on the card ----------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the grouped kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("held", [64, 48])
def test_moe_kernel_matches_reference_at_published_widths(cuda_device, held):
    """64 experts of width 1408 at hidden 2048, uneven loads: empty
    experts, one row, a whole tile, a tile and one row, several tiles;
    with ``held`` < 64 the others count 0 and their rows stay zero."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    E, H, Fw = 64, 2048, 1408
    loads = [0, 1, 127, 128, 129, 300, 513, 0] * 8
    counts = torch.tensor(loads, device=cuda_device)
    counts[held:] = 0
    rows = int(sum(loads))
    offsets = torch.cumsum(torch.tensor(loads, device=cuda_device), 0) - \
        torch.tensor(loads, device=cuda_device)

    def w(*shape):
        return (torch.randn(shape, generator=g, device=cuda_device)
                * shape[-1] ** -0.5).to(torch.bfloat16)

    wg, wu, wd = w(E, Fw, H), w(E, Fw, H), w(E, H, Fw)
    x = torch.randn((rows, H), generator=g, device=cuda_device).to(
        torch.bfloat16)
    order = torch.randperm(rows, generator=g, device=cuda_device)
    scale = torch.rand(rows, generator=g, device=cuda_device)
    before = tmoe.moe_gemm_cuda.launches
    y = tmoe.moe_gemm_cuda(x, wg, wu, wd, counts, offsets, order, scale,
                           rows, covered=held == E)
    torch.cuda.synchronize()
    assert tmoe.moe_gemm_cuda.launches == before + 2
    want = tmoe.moe_reference(x, wg, wu, wd, counts, offsets, order, scale,
                              rows)
    big = float(want.abs().max())
    torch.testing.assert_close(y, want, rtol=2e-3, atol=2e-3 * big)
    if held < E:
        assert bool((y[order[int(offsets[held]):]] == 0).all())
