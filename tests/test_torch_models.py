"""The port's learned models against the JAX package on the CPU.

The same parameters (numpy, from a seed) are pushed through
``models/params.py`` into both packages and the same token arrays through
the JAX functions and their counterparts: the tokenizer, the transformer
trunk, the sentence encoder, the cross-encoder, the SPLADE head and
``sparsify_topk``; then every committed checkpoint, and the checkpoint
files in both directions.

Tolerances. With ``dtype=float32`` both packages compute plain f32 and
differ only in summation order: F32_ATOL. With the default bfloat16
compute dtype every dense layer rounds its operands to bf16; two f32
inputs that differ in the last bits can round to different bf16 values
(one part in 256), so the outputs agree to two to three digits: BF16_ATOL
on unit-scale outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_modular_rag_framework_torch.models import cross_encoder as t_cross
from a_modular_rag_framework_torch.models import encoder as t_enc
from a_modular_rag_framework_torch.models import splade as t_splade
from a_modular_rag_framework_torch.models.params import (flatten_params,
                                                         unflatten_params)
from a_modular_rag_framework_torch.native import binding as t_bind
from a_modular_rag_framework_tpu.models import cross_encoder as j_cross
from a_modular_rag_framework_tpu.models import encoder as j_enc
from a_modular_rag_framework_tpu.models import splade as j_splade
from a_modular_rag_framework_tpu.native import binding as j_bind

F32_ATOL = 2e-5
BF16_ATOL = 2e-2
SMALL = dict(vocab_size=512, max_len=12, d_model=32, n_heads=2, n_layers=2,
             d_ff=64)
# (compute dtype, subword features per word)
CASES = [("float32", 1), ("float32", 8), ("bfloat16", 8)]
CASE_IDS = [f"{d}-G{g}" for d, g in CASES]

TEXTS = [
    "Sage Silverton was born in Zephyr Bay.",
    "",
    "Who collaborated with Alden Ashford before moving to Mistral Hollow?",
    "a b c d e f g h i j k l m n o p q r s t u v w x y z",
    "O'Brien and Jean-Luc Picard visited Çelik Köprü",
    "The McDonald brothers' diner; ABC and IBM were rivals.",
    "lowercase only text, no names at all",
]


def configs(dtype: str, ngrams: int, **extra):
    kw = dict(SMALL, subword_ngrams=ngrams, **extra)
    return (j_enc.EncoderConfig(dtype=getattr(jnp, dtype), **kw),
            t_enc.EncoderConfig(dtype=getattr(torch, dtype), **kw))


def random_flat(template, seed: int):
    """{keystr: numpy array} in the shapes of a port parameter tree: unit
    LayerNorm gains with a spread, everything else normal / sqrt(fan)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in flatten_params(template).items():
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if key.endswith("['g']"):
            a = 1.0 + 0.1 * a
        elif leaf.ndim >= 1:
            a = a * (leaf.shape[0] ** -0.5 if leaf.ndim == 2 else 0.3)
        flat[key] = a
    return flat


def jax_tree(template, flat):
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[jax.tree_util.keystr(k)])
                  for k, _ in paths])


def both_params(j_template, t_template, seed):
    flat = random_flat(t_template, seed)
    return (jax_tree(j_template, flat),
            unflatten_params(flat, t_template, device="cpu"))


def token_batch(cfg, texts=TEXTS):
    ids, mask = t_enc.encode_tokens(list(texts), cfg)
    return ids, mask


def atol_of(dtype):
    return F32_ATOL if dtype == "float32" else BF16_ATOL


def gen(seed=0):
    return t_enc.seeded_generator(seed, "cpu")


# ---------------- tokenizer ----------------


@pytest.mark.parametrize("ngrams", [1, 8])
@pytest.mark.parametrize("library", ["with", "without"])
def test_encode_tokens_equals_jax(library, ngrams, monkeypatch):
    if library == "without":
        monkeypatch.setattr(t_bind, "load_native", lambda: None)
        monkeypatch.setattr(j_bind, "load_native", lambda: None)
    j_cfg, t_cfg = configs("float32", ngrams)
    many = [f"{t} extra{i} Word{i % 7}" for i, t in enumerate(TEXTS * 10)]
    for texts in (TEXTS, many):  # Python loop; native path at >= 64 texts
        j_ids, j_mask = j_enc.encode_tokens(list(texts), j_cfg)
        t_ids, t_mask = t_enc.encode_tokens(list(texts), t_cfg)
        assert t_ids.dtype == np.int32 and t_mask.dtype == np.float32
        assert t_ids.shape == ((len(texts), 12) if ngrams == 1
                               else (len(texts), 12, 8))
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_mask, j_mask)
    # the native and the Python path give the same arrays
    a = t_enc.encode_tokens(many, t_cfg)
    monkeypatch.setattr(t_bind, "load_native", lambda: None)
    b = t_enc.encode_tokens(many, t_cfg)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    for tok in ("zephyr", "a", "ravkelsel"):
        assert (t_enc._word_feature_ids(tok, t_cfg)
                == j_enc._word_feature_ids(tok, j_cfg))


def test_encode_pairs_equals_jax():
    kw = dict(SMALL, subword_ngrams=8, max_query_len=5)
    j_out = j_cross.encode_pairs(TEXTS, TEXTS[::-1],
                                 j_cross.CrossEncoderConfig(**kw))
    t_out = t_cross.encode_pairs(TEXTS, TEXTS[::-1],
                                 t_cross.CrossEncoderConfig(**kw))
    for a, b in zip(t_out, j_out):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------- forward passes ----------------


@pytest.mark.parametrize("dtype,ngrams", CASES, ids=CASE_IDS)
def test_encoder_forward_matches_jax(dtype, ngrams):
    j_cfg, t_cfg = configs(dtype, ngrams)
    j_params, t_params = both_params(
        j_enc.init_params(jax.random.PRNGKey(0), j_cfg),
        t_enc.init_params(gen(), t_cfg), seed=1)
    ids, mask = token_batch(t_cfg)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    atol = atol_of(dtype)

    j_h = np.asarray(j_enc.encode_hidden(j_params, jnp.asarray(ids),
                                         jnp.asarray(mask), j_cfg))
    t_h = t_enc.encode_hidden(t_params, t_ids, t_mask, t_cfg).numpy()
    assert t_h.shape == (len(TEXTS), 12, 32) and t_h.dtype == np.float32
    # hidden states are LayerNorm outputs, a few units wide
    np.testing.assert_allclose(t_h, j_h, atol=4 * atol, rtol=0)

    j_e = np.asarray(j_enc.apply_encoder(j_params, jnp.asarray(ids),
                                         jnp.asarray(mask), j_cfg))
    t_e = t_enc.apply_encoder(t_params, t_ids, t_mask, t_cfg).numpy()
    np.testing.assert_allclose(t_e, j_e, atol=atol, rtol=0)
    # the fully padded row ("" text): a finite, zero embedding, as in JAX
    assert np.isfinite(t_h).all() and np.isfinite(t_e).all()
    assert not t_e[1].any() and not j_e[1].any()
    np.testing.assert_allclose(np.linalg.norm(t_e[[0, 2, 3]], axis=1), 1.0,
                               atol=1e-5)

    # the wrapper: encode_texts = tokenize + apply, in encode_batch chunks
    enc = t_enc.TextEncoder(t_cfg, params=t_params, device="cpu")
    enc.encode_batch = 3
    np.testing.assert_allclose(enc.encode_texts(TEXTS), t_e, atol=1e-6)
    assert enc.dim == 32 and enc.encode_texts([]).shape == (0, 32)


def test_attention_dtype_option_matches_jax():
    """attn_dtype=bfloat16: the attention products round their operands
    too; the softmax stays f32."""
    j_cfg, t_cfg = configs("bfloat16", 1)
    j_cfg = j_enc.EncoderConfig(**{**j_cfg.__dict__,
                                   "attn_dtype": jnp.bfloat16})
    t_cfg = t_enc.EncoderConfig(**{**t_cfg.__dict__,
                                   "attn_dtype": torch.bfloat16})
    j_params, t_params = both_params(
        j_enc.init_params(jax.random.PRNGKey(0), j_cfg),
        t_enc.init_params(gen(), t_cfg), seed=2)
    ids, mask = token_batch(t_cfg)
    j_e = np.asarray(j_enc.apply_encoder(j_params, jnp.asarray(ids),
                                         jnp.asarray(mask), j_cfg))
    t_e = t_enc.apply_encoder(t_params, torch.from_numpy(ids),
                              torch.from_numpy(mask), t_cfg).numpy()
    np.testing.assert_allclose(t_e, j_e, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype,ngrams", CASES, ids=CASE_IDS)
def test_cross_encoder_matches_jax(dtype, ngrams):
    kw = dict(SMALL, subword_ngrams=ngrams, max_query_len=5)
    j_cfg = j_cross.CrossEncoderConfig(dtype=getattr(jnp, dtype), **kw)
    t_cfg = t_cross.CrossEncoderConfig(dtype=getattr(torch, dtype), **kw)
    j_params, t_params = both_params(
        j_cross.init_cross_params(jax.random.PRNGKey(0), j_cfg),
        t_cross.init_cross_params(gen(), t_cfg), seed=3)
    queries, passages = TEXTS, TEXTS[::-1]
    ids, mask, seg = t_cross.encode_pairs(queries, passages, t_cfg)
    j_s = np.asarray(j_cross.apply_cross_encoder(
        j_params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(seg),
        j_cfg))
    t_s = t_cross.apply_cross_encoder(
        t_params, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(seg), t_cfg).numpy()
    assert t_s.shape == (len(TEXTS),) and np.isfinite(t_s).all()
    # logits: |w_score . pooled| is a few units
    np.testing.assert_allclose(t_s, j_s, atol=4 * atol_of(dtype), rtol=0)

    j_r = j_cross.CrossEncoderReranker(j_cfg, params=j_params)
    t_r = t_cross.CrossEncoderReranker(t_cfg, params=t_params, device="cpu")
    np.testing.assert_allclose(t_r.score_pairs(queries, passages), t_s,
                               atol=1e-6)
    assert t_r.score_pairs([], []).shape == (0,)
    if dtype == "float32":  # scores separated by far more than F32_ATOL
        cands = [passages[:4], passages[2:7], []]
        assert (t_r.rerank_batch(queries[:3], cands)
                == j_r.rerank_batch(queries[:3], cands))
        assert (t_r.rerank(queries[0], passages, top_m=4)
                == j_r.rerank(queries[0], passages, top_m=4))
        assert t_r.rerank(queries[0], []) == []


def test_reranker_chunked_scores_equal_unchunked():
    """pair_budget chunking with the padded tail changes no score."""
    cfg = t_cross.CrossEncoderConfig(**dict(SMALL, subword_ngrams=8,
                                            max_query_len=5))
    full = t_cross.CrossEncoderReranker(cfg, seed=4, pair_budget=4096,
                                        device="cpu")
    q = [TEXTS[i % len(TEXTS)] for i in range(23)]
    p = [TEXTS[(3 * i + 1) % len(TEXTS)] + f" item{i}" for i in range(23)]
    want = full.score_pairs(q, p)
    for budget in (5, 8, 23):  # padded tail; two full chunks + tail; exact
        chunked = t_cross.CrossEncoderReranker(
            cfg, params=full.params, pair_budget=budget, device="cpu")
        np.testing.assert_allclose(chunked.score_pairs(q, p), want,
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype,ngrams", CASES, ids=CASE_IDS)
def test_splade_head_matches_jax(dtype, ngrams, monkeypatch):
    j_ecfg, t_ecfg = configs(dtype, ngrams)
    j_cfg = j_splade.SpladeConfig(encoder=j_ecfg, doc_top_terms=24,
                                  query_top_terms=6)
    t_cfg = t_splade.SpladeConfig(encoder=t_ecfg, doc_top_terms=24,
                                  query_top_terms=6)
    j_params, t_params = both_params(
        j_splade.init_splade_params(jax.random.PRNGKey(0), j_cfg),
        t_splade.init_splade_params(gen(), t_cfg), seed=5)
    ids, mask = token_batch(t_ecfg)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    atol = 4 * atol_of(dtype)  # weights up to a few units (b0 * lex_w)

    j_h = j_enc.encode_hidden(j_params, jnp.asarray(ids), jnp.asarray(mask),
                              j_ecfg)
    j_w = np.asarray(j_splade.splade_from_hidden(
        j_params, j_h, jnp.asarray(mask), j_cfg, jnp.asarray(ids)))
    # the head alone, on JAX's hidden states
    t_w_head = t_splade.splade_from_hidden(
        t_params, torch.from_numpy(np.array(j_h)), t_mask, t_cfg,
        t_ids).numpy()
    np.testing.assert_allclose(t_w_head, j_w, atol=atol, rtol=0)
    t_w = t_splade.apply_splade(t_params, t_ids, t_mask, t_cfg).numpy()
    assert t_w.shape == (len(TEXTS), 512) and (t_w >= 0).all()
    np.testing.assert_allclose(t_w, j_w, atol=atol, rtol=0)
    # the fully padded row expands to nothing, in both
    assert not t_w[1].any() and not j_w[1].any()
    assert t_w[0].max() > 0.5

    # folding the positions one at a time (as JAX scans them) or all at
    # once gives the same max-pool
    monkeypatch.setattr(t_splade, "_POOL_GROUP_BYTES", 1)
    one_by_one = t_splade.apply_splade(t_params, t_ids, t_mask, t_cfg).numpy()
    np.testing.assert_allclose(one_by_one, t_w, atol=1e-6, rtol=0)

    if dtype == "float32":
        j_i, j_v = j_splade.sparsify_topk(jnp.asarray(j_w), 6)
        t_i, t_v = t_splade.sparsify_topk(torch.from_numpy(t_w), 6)
        np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
        np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), atol=atol)
        enc = t_splade.SpladeEncoder(t_cfg, params=t_params, device="cpu")
        e_i, e_v = enc.expand_texts(TEXTS)
        np.testing.assert_array_equal(e_i, t_i.numpy())
        np.testing.assert_allclose(enc.dense_expand(TEXTS), t_w, atol=1e-6)
        assert enc.expand_texts([], k=4)[0].shape == (0, 4)


def test_sparsify_topk_tie_order_and_padding():
    """Equal weights keep ascending term ids at the cut, non-positive
    weights pad to (-1, 0): exactly lax.top_k's selection."""
    rng = np.random.default_rng(6)
    w = rng.integers(-1, 4, size=(9, 40)).astype(np.float32)  # many ties
    w[3] = 0.0
    w[4] = -1.0
    w[5, :] = 2.0
    for k in (1, 7, 40):
        j_i, j_v = j_splade.sparsify_topk(jnp.asarray(w), k)
        t_i, t_v = t_splade.sparsify_topk(torch.from_numpy(w), k)
        assert t_i.dtype == torch.int32 and t_v.dtype == torch.float32
        np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
        np.testing.assert_array_equal(t_v.numpy(), np.asarray(j_v))
    assert (t_i[3] == -1).all() and (t_i[4] == -1).all()
    np.testing.assert_array_equal(t_i[5].numpy(), np.arange(40))


def test_idf_lexical_prior_equals_jax():
    for ngrams in (1, 8):
        j_ecfg, t_ecfg = configs("float32", ngrams)
        np.testing.assert_array_equal(
            t_splade.idf_lexical_prior(TEXTS * 3,
                                       t_splade.SpladeConfig(encoder=t_ecfg),
                                       batch=4),
            j_splade.idf_lexical_prior(TEXTS * 3,
                                       j_splade.SpladeConfig(encoder=j_ecfg),
                                       batch=4))


# ---------------- the committed checkpoints ----------------

ENCODER_CONFIGS = {
    "encoder": dict(d_model=64, n_layers=2, subword_ngrams=8),
    "encoder_collide": dict(vocab_size=32768, max_len=32, d_model=128,
                            n_heads=4, n_layers=2, subword_ngrams=8),
}


@pytest.mark.parametrize("name", sorted(ENCODER_CONFIGS))
def test_committed_encoder_checkpoints(name):
    path = f"data/{name}.npz"
    j = j_enc.TextEncoder.load(path, j_enc.EncoderConfig(
        **ENCODER_CONFIGS[name]))
    t = t_enc.TextEncoder.load(path, t_enc.EncoderConfig(
        **ENCODER_CONFIGS[name]), device="cpu")
    a, b = j.encode_texts(TEXTS), t.encode_texts(TEXTS)
    assert b.shape == (len(TEXTS), ENCODER_CONFIGS[name]["d_model"])
    np.testing.assert_allclose(b, a, atol=BF16_ATOL, rtol=0)
    assert not b[1].any()
    # nearest neighbours agree: the cosine matrices are within 2 atol
    np.testing.assert_allclose(b @ b.T, a @ a.T, atol=2 * BF16_ATOL)


@pytest.mark.parametrize("name", ["cross_encoder", "cross_encoder_collide"])
def test_committed_cross_encoder_checkpoints(name):
    path = f"data/{name}.npz"
    j = j_cross.CrossEncoderReranker.load(
        path, j_cross.CrossEncoderConfig(subword_ngrams=8))
    t = t_cross.CrossEncoderReranker.load(
        path, t_cross.CrossEncoderConfig(subword_ngrams=8), device="cpu",
        pair_budget=4)
    q = [TEXTS[2]] * len(TEXTS)
    a, b = j.score_pairs(q, TEXTS), t.score_pairs(q, TEXTS)
    # trained logits reach +-20: relative to that scale
    np.testing.assert_allclose(b, a, atol=BF16_ATOL * max(1.0, np.abs(a).max()),
                               rtol=0)
    assert t.pair_budget == 4


@pytest.mark.parametrize("name", ["splade", "splade_variety"])
def test_committed_splade_checkpoints(name):
    path = f"data/{name}.npz"
    j = j_splade.SpladeEncoder.load(path)
    t = t_splade.SpladeEncoder.load(path, device="cpu")
    assert t.cfg.encoder.dtype == torch.bfloat16
    assert (t.cfg.doc_top_terms, t.cfg.query_top_terms,
            t.cfg.encoder.subword_ngrams, t.cfg.encoder.d_model) == (
        j.cfg.doc_top_terms, j.cfg.query_top_terms,
        j.cfg.encoder.subword_ngrams, j.cfg.encoder.d_model)
    a, b = j.dense_expand(TEXTS), t.dense_expand(TEXTS)
    np.testing.assert_allclose(b, a, atol=BF16_ATOL, rtol=0)
    # the kept terms: ids agree wherever the weight at the cut is clear of
    # the tolerance; overall overlap >= 0.9
    j_i, j_v = j.expand_texts(TEXTS, 32)
    t_i, t_v = t.expand_texts(TEXTS, 32)
    assert (t_i[1] == -1).all() and (j_i[1] == -1).all()  # the "" row
    overlap = np.mean([len(set(x[x >= 0]) & set(y[y >= 0])) / (y >= 0).sum()
                       for x, y in zip(t_i, j_i) if (y >= 0).any()])
    assert overlap >= 0.9, overlap
    for row in range(len(TEXTS)):
        clear = j_v[row] > j_v[row, -1] + 2 * BF16_ATOL
        assert set(j_i[row][clear]) <= set(t_i[row]), row


# ---------------- checkpoint files, both directions ----------------


def _roundtrip_cases():
    kw = dict(SMALL, subword_ngrams=8)
    return [
        ("encoder",
         lambda: j_enc.TextEncoder(j_enc.EncoderConfig(**kw), seed=1),
         lambda p: j_enc.TextEncoder.load(p, j_enc.EncoderConfig(**kw)),
         lambda: t_enc.TextEncoder(t_enc.EncoderConfig(**kw), seed=1,
                                   device="cpu"),
         lambda p: t_enc.TextEncoder.load(p, t_enc.EncoderConfig(**kw),
                                          device="cpu"),
         lambda m: m.encode_texts(TEXTS)),
        ("cross_encoder",
         lambda: j_cross.CrossEncoderReranker(
             j_cross.CrossEncoderConfig(max_query_len=5, **kw), seed=1),
         lambda p: j_cross.CrossEncoderReranker.load(
             p, j_cross.CrossEncoderConfig(max_query_len=5, **kw)),
         lambda: t_cross.CrossEncoderReranker(
             t_cross.CrossEncoderConfig(max_query_len=5, **kw), seed=1,
             device="cpu"),
         lambda p: t_cross.CrossEncoderReranker.load(
             p, t_cross.CrossEncoderConfig(max_query_len=5, **kw),
             device="cpu"),
         lambda m: m.score_pairs(TEXTS, TEXTS[::-1])),
        ("splade",  # the file carries its config: load takes none
         lambda: j_splade.SpladeEncoder(j_splade.SpladeConfig(
             encoder=j_enc.EncoderConfig(**kw), doc_top_terms=20,
             query_top_terms=5), seed=1),
         lambda p: j_splade.SpladeEncoder.load(p),
         lambda: t_splade.SpladeEncoder(t_splade.SpladeConfig(
             encoder=t_enc.EncoderConfig(**kw), doc_top_terms=20,
             query_top_terms=5), seed=1, device="cpu"),
         lambda p: t_splade.SpladeEncoder.load(p, device="cpu"),
         lambda m: m.dense_expand(TEXTS)),
    ]


@pytest.mark.parametrize("case", _roundtrip_cases(), ids=lambda c: c[0])
def test_checkpoint_files_load_in_the_other_package(case, tmp_path):
    _, j_new, j_load, t_new, t_load, run = case
    # port save -> JAX load
    t_model = t_new()
    t_model.save(str(tmp_path / "t.npz"))
    j_model = j_load(str(tmp_path / "t.npz"))
    assert flatten_params(t_model.params).keys() == {
        jax.tree_util.keystr(k) for k, _ in
        jax.tree_util.tree_flatten_with_path(j_model.params)[0]}
    np.testing.assert_allclose(run(j_model), run(t_model), atol=4 * BF16_ATOL)
    # JAX save -> port load
    j_model = j_new()
    j_model.save(str(tmp_path / "j.npz"))
    t_model = t_load(str(tmp_path / "j.npz"))
    np.testing.assert_allclose(run(t_model), run(j_model), atol=4 * BF16_ATOL)
    for key, leaf in flatten_params(t_model.params).items():
        np.testing.assert_array_equal(leaf, np.load(tmp_path / "j.npz")[key])
    if hasattr(t_model.cfg, "doc_top_terms"):
        assert (t_model.cfg.doc_top_terms, t_model.cfg.query_top_terms) == (
            20, 5)
        assert t_model.cfg.encoder == t_new().cfg.encoder
    # the same seed gives the same fresh parameters
    for a, b in zip(flatten_params(t_new().params).values(),
                    flatten_params(t_new().params).values()):
        np.testing.assert_array_equal(a, b)


def test_load_rejects_missing_keys_and_wrong_shapes(tmp_path):
    cfg = t_enc.EncoderConfig(**SMALL)
    enc = t_enc.TextEncoder(cfg, seed=0, device="cpu")
    flat = flatten_params(enc.params)
    missing = dict(flat)
    del missing["['layers'][1]['wo']"]
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(KeyError, match="wo"):
        t_enc.TextEncoder.load(str(tmp_path / "missing.npz"), cfg,
                               device="cpu")
    enc.save(str(tmp_path / "ok.npz"))
    wider = t_enc.EncoderConfig(**dict(SMALL, d_ff=128))
    with pytest.raises(ValueError, match="shape mismatch"):
        t_enc.TextEncoder.load(str(tmp_path / "ok.npz"), wider, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        t_cross.CrossEncoderReranker.load(
            "data/cross_encoder.npz", t_cross.CrossEncoderConfig(**SMALL),
            device="cpu")
    with pytest.raises(KeyError, match="splade_head"):
        t_splade.SpladeEncoder.load(
            str(tmp_path / "ok.npz"),
            t_splade.SpladeConfig(encoder=cfg), device="cpu")


def test_models_default_to_the_card():
    """No device argument means the card: without one, construction
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: t_enc.TextEncoder(t_enc.EncoderConfig(**SMALL)),
                 lambda: t_cross.CrossEncoderReranker(
                     t_cross.CrossEncoderConfig(**SMALL)),
                 lambda: t_splade.SpladeEncoder.load("data/splade.npz"),
                 lambda: t_enc.TextEncoder.load("data/encoder.npz")):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            make()
