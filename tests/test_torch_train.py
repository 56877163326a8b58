"""The port's training path against the JAX package on the CPU.

One parameter file (numpy, from a seed, written through
``models/params.py``) and one batch go through ``jax.value_and_grad`` of
the JAX loss and through the port's loss and autograd, for the three
learned models; one AdamW step is held to ``optax.adamw``; five whole train
steps to JAX's five; the chunk trainer to single steps; train-state and
weight files cross between the packages in both directions; the train
CLIs' host helpers and the dense lab's evaluation equal their originals;
the sidecar tools write what the JAX package attaches.

Tolerances. With ``dtype=float32`` both packages compute plain f32 and
differ in summation order only: the loss agrees to 1e-5 relative and every
gradient leaf within ``1e-5 * max|g| + 1e-7`` (seen: 3e-6). With the
default bfloat16 compute dtype every dense layer rounds its operands to
bf16, forward and backward (JAX's transpose rule of ``dot_general`` and
autograd's backward of ``.float()`` both round a cotangent to the operand's
dtype); two f32 values that differ in their last bits between the packages
can round to different bf16 values, one part in 256 of that value, so a
gradient leaf agrees to BF16_GRAD_RTOL of its largest entry (seen: 4e-3).

Adam divides the first moment by the root of the second, so the first
steps move every element by about ``lr`` in the direction of its
gradient's sign, however small the gradient. After five steps at lr 1e-3
the packages agree to STEPS_ATOL (seen: 8e-5), with one exception: the
cross-encoder's ``b_score`` shifts every candidate's logit alike, the
listwise softmax does not see it, its gradient is rounding noise around an
exact zero (1e-8, of either sign) and Adam walks it up to ``lr`` per step
in either direction. It is held to ``5 * lr``; no output depends on it.
"""
import ast
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from a_modular_rag_framework_torch.cli import train_cross_encoder as t_cli_cross
from a_modular_rag_framework_torch.cli import train_encoder as t_cli_enc
from a_modular_rag_framework_torch.cli import train_splade as t_cli_splade
from a_modular_rag_framework_torch.core.dataset_loader import \
    SyntheticHotpotQALoader
from a_modular_rag_framework_torch.models import checkpoint as t_ckpt
from a_modular_rag_framework_torch.models import cross_encoder as t_cross
from a_modular_rag_framework_torch.models import encoder as t_enc
from a_modular_rag_framework_torch.models import optim as t_optim
from a_modular_rag_framework_torch.models import splade as t_splade
from a_modular_rag_framework_torch.models.params import (flatten_params,
                                                         save_params,
                                                         tree_leaves,
                                                         unflatten_params)
from a_modular_rag_framework_torch.ops.splade import SpladeRetriever
from a_modular_rag_framework_tpu.cli import train_cross_encoder as j_cli_cross
from a_modular_rag_framework_tpu.cli import train_encoder as j_cli_enc
from a_modular_rag_framework_tpu.cli import train_splade as j_cli_splade
from a_modular_rag_framework_tpu.models import checkpoint as j_ckpt
from a_modular_rag_framework_tpu.models import cross_encoder as j_cross
from a_modular_rag_framework_tpu.models import encoder as j_enc
from a_modular_rag_framework_tpu.models import splade as j_splade

REPO = Path(__file__).resolve().parents[1]
F32_LOSS_RTOL = 1e-5
F32_GRAD_RTOL, F32_GRAD_ATOL = 1e-5, 1e-7
BF16_LOSS_RTOL = 1e-4
BF16_GRAD_RTOL = 2e-2
OPT_ATOL = 1e-6
STEPS_ATOL = 5e-4  # five steps at lr 1e-3 (module docstring)
STEPS_LOSS_RTOL = 1e-4
LR = 1e-3
# gradient exactly zero but for rounding noise (module docstring)
NOISE_LEAVES = ("['b_score']",)

SMALL = dict(vocab_size=1024, max_len=16, d_model=32, n_heads=2, n_layers=2,
             d_ff=64, subword_ngrams=4)
MODELS = ["encoder", "cross_encoder", "splade"]

# short texts, a long one and a fully padded row ("")
QUERIES = ["Who collaborated with Alden Ashford?", "born where", "",
           "In which city was the collaborator of Sage Silverton born?",
           "a b c d e f g h i j k l m n o p q r s t u v w x y z",
           "Zephyr Bay", "who wrote the book about Mistral Hollow",
           "O'Brien and Jean-Luc Picard"]
PASSAGES = ["Alden Ashford collaborated closely with Brisa Blackwood.",
            "Sage Silverton was born in Zephyr Bay.", "x",
            "Brisa Blackwood was born in Mistral Hollow in 1950.",
            "the quick brown fox jumps over the lazy dog again and again "
            "and again until the sentence is cut", "",
            "The book about Mistral Hollow was written by Ann Li.",
            "Jean-Luc Picard visited Çelik Köprü"]


def _dt(pkg, name):
    return getattr(jnp if pkg == "j" else torch, name)


class Case:
    """One model at the small size in both packages: configs, templates,
    the JAX and the port loss as ``(params, batch) -> (loss, aux dict)``,
    the two train-step factories and a host batch."""

    def __init__(self, model: str, dtype: str):
        self.model, self.dtype = model, dtype
        gen = t_enc.seeded_generator(0, "cpu")
        key = jax.random.PRNGKey(0)
        if model == "encoder":
            self.j_cfg = j_enc.EncoderConfig(dtype=_dt("j", dtype), **SMALL)
            self.t_cfg = t_enc.EncoderConfig(dtype=_dt("t", dtype), **SMALL)
            self.j_template = j_enc.init_params(key, self.j_cfg)
            self.t_template = t_enc.init_params(gen, self.t_cfg)
            # no empty text here: see test_info_nce_with_an_empty_text
            self.batch = t_enc.TextEncoder.make_pair_batch(
                [q or "who" for q in QUERIES], [p or "it" for p in PASSAGES],
                self.t_cfg)
            self.j_loss = lambda p, b: _aux(j_enc.info_nce_loss(
                p, b, self.j_cfg))
            self.t_loss = lambda p, b: _aux(t_enc.info_nce_loss(
                p, b, self.t_cfg))
            self.j_make = lambda: j_enc.make_train_step(self.j_cfg, LR)
            self.t_make = lambda: t_enc.make_train_step(self.t_cfg, LR)
        elif model == "cross_encoder":
            kw = dict(SMALL, max_query_len=6)
            self.j_cfg = j_cross.CrossEncoderConfig(dtype=_dt("j", dtype),
                                                    **kw)
            self.t_cfg = t_cross.CrossEncoderConfig(dtype=_dt("t", dtype),
                                                    **kw)
            self.j_template = j_cross.init_cross_params(key, self.j_cfg)
            self.t_template = t_cross.init_cross_params(gen, self.t_cfg)
            lists = [[PASSAGES[(i + j) % 8] for j in range(4)]
                     for i in range(8)]
            self.batch = t_cross.CrossEncoderReranker.make_listwise_batch(
                QUERIES, lists, [i % 4 for i in range(8)], self.t_cfg)
            self.j_loss = lambda p, b: _aux(j_cross.listwise_loss(
                p, b, self.j_cfg))
            self.t_loss = lambda p, b: _aux(t_cross.listwise_loss(
                p, b, self.t_cfg))
            self.j_make = lambda: j_cross.make_cross_train_step(self.j_cfg, LR)
            self.t_make = lambda: t_cross.make_cross_train_step(self.t_cfg, LR)
        else:
            # budgets below the vocabulary size: the truncation is exercised
            kw = dict(doc_top_terms=24, query_top_terms=6)
            self.j_cfg = j_splade.SpladeConfig(encoder=j_enc.EncoderConfig(
                dtype=_dt("j", dtype), **SMALL), **kw)
            self.t_cfg = t_splade.SpladeConfig(encoder=t_enc.EncoderConfig(
                dtype=_dt("t", dtype), **SMALL), **kw)
            self.j_template = j_splade.init_splade_params(key, self.j_cfg)
            self.t_template = t_splade.init_splade_params(gen, self.t_cfg)
            self.batch = t_enc.TextEncoder.make_pair_batch(
                QUERIES, PASSAGES, self.t_cfg.encoder)
            self.j_loss = lambda p, b: j_splade.splade_loss(p, b, self.j_cfg)
            self.t_loss = lambda p, b: t_splade.splade_loss(p, b, self.t_cfg)
            self.j_make = lambda: j_splade.make_splade_train_step(self.j_cfg,
                                                                  LR)
            self.t_make = lambda: t_splade.make_splade_train_step(self.t_cfg,
                                                                  LR)
        self._j_vg = self._j_step = None

    def j_value_and_grad(self, params, batch):
        if self._j_vg is None:
            self._j_vg = jax.jit(jax.value_and_grad(self.j_loss,
                                                    has_aux=True))
        return self._j_vg(params, batch)

    def j_step(self):
        """(init_state, jitted train_step), compiled once per case."""
        if self._j_step is None:
            init_state, step = self.j_make()
            self._j_step = (init_state, jax.jit(step))
        return self._j_step

    def params(self, tmp_path, seed=1):
        """One parameter file, read by both packages."""
        path = tmp_path / f"{self.model}_{self.dtype}.npz"
        save_params(str(path), unflatten_params(
            random_flat(self.t_template, seed), self.t_template,
            device="cpu"))
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        # the port's steps update in place while JAX's run asynchronously:
        # the two trees must not share the numpy arrays' memory
        return (jax_tree(self.j_template, flat),
                t_optim.clone_tree(unflatten_params(flat, self.t_template,
                                                    device="cpu")))

    def batches(self):
        return ({k: jnp.asarray(v) for k, v in self.batch.items()},
                {k: torch.from_numpy(v) for k, v in self.batch.items()})


def _aux(loss_acc):
    return loss_acc[0], {"accuracy": loss_acc[1]}


_CASES = {}


def case(model, dtype="float32") -> Case:
    """Cases are built (and their JAX functions jitted) once per module."""
    if (model, dtype) not in _CASES:
        _CASES[model, dtype] = Case(model, dtype)
    return _CASES[model, dtype]


def random_flat(template, seed: int):
    """{keystr: numpy array} in the shapes of a port parameter tree: unit
    LayerNorm gains with a spread, everything else normal / sqrt(fan); the
    SPLADE head's scalars near their initial values."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, leaf in flatten_params(template).items():
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if key.endswith("['g']") or key.endswith("['lex_w']"):
            a = 1.0 + 0.1 * a
        elif key.endswith("['b0']"):
            a = np.float32(2.0) + 0.1 * a
        elif key.endswith("['g_exp']"):
            a = np.float32(0.5) + 0.1 * a
        elif leaf.ndim >= 1:
            a = a * (leaf.shape[0] ** -0.5 if leaf.ndim == 2 else 0.3)
        flat[key] = a.astype(np.float32)
    return flat


def jax_tree(template, flat):
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.array(flat[jax.tree_util.keystr(k)])
                  for k, _ in paths])


def jax_flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(t_tree, j_tree, atol, what, noise_atol=None):
    """Every leaf within ``atol``; a NOISE_LEAVES leaf within ``noise_atol``
    where one is given."""
    t_flat, j_flat = flatten_params(t_tree), jax_flat(j_tree)
    assert t_flat.keys() == j_flat.keys()
    for key, a in t_flat.items():
        tol = (noise_atol if noise_atol is not None and key in NOISE_LEAVES
               else atol)
        np.testing.assert_allclose(a, j_flat[key], atol=tol, rtol=0,
                                   err_msg=f"{what} {key}")


# ---------------- losses and gradients ----------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", MODELS)
def test_loss_and_gradients_match_jax(model, dtype, tmp_path):
    c = case(model, dtype)
    j_params, t_params = c.params(tmp_path)
    j_batch, t_batch = c.batches()
    (j_loss, j_aux), j_grads = c.j_value_and_grad(j_params, j_batch)
    t_loss, t_aux, t_grads = t_optim.value_and_grad(c.t_loss, t_params,
                                                    t_batch)
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=0,
                               rtol=F32_LOSS_RTOL if f32 else BF16_LOSS_RTOL)
    assert t_aux.keys() == j_aux.keys()
    for key in t_aux:  # accuracy, and SPLADE's nce and doc_nnz
        if f32:
            np.testing.assert_allclose(float(t_aux[key]), float(j_aux[key]),
                                       rtol=1e-5, err_msg=key)
        elif key == "nce":
            np.testing.assert_allclose(float(t_aux[key]), float(j_aux[key]),
                                       rtol=BF16_LOSS_RTOL, err_msg=key)
    t_flat, j_flat = flatten_params(t_grads), jax_flat(j_grads)
    assert t_flat.keys() == j_flat.keys()
    for key, g in t_flat.items():
        ref = j_flat[key]
        assert g.shape == ref.shape and np.isfinite(g).all(), key
        scale = float(np.abs(ref).max())
        atol = (F32_GRAD_RTOL * scale + F32_GRAD_ATOL if f32
                else BF16_GRAD_RTOL * scale + F32_GRAD_ATOL)
        np.testing.assert_allclose(g, ref, atol=atol, rtol=0, err_msg=key)
    # every leaf takes part: the embedding (tied decoder in SPLADE), the
    # norms, the head's scalars
    assert all(np.abs(g).max() > 0 for g in t_flat.values())
    # the parameters themselves are untouched and carry no graph
    assert all(not t.requires_grad for t in tree_leaves(t_params))


def test_info_nce_with_an_empty_text(tmp_path):
    """A fully padded row pools to the zero vector, whose L2 norm has an
    infinite derivative at 0 that meets the clamp's zero: the loss is
    finite and the gradients are NaN, in the JAX package and in the port
    alike. (The cross-encoder and the SPLADE head have no such norm: their
    cases above keep the empty text.)"""
    c = case("encoder")
    j_params, t_params = c.params(tmp_path)
    batch = t_enc.TextEncoder.make_pair_batch(QUERIES, PASSAGES, c.t_cfg)
    assert not batch["q_mask"][2].any() and not batch["p_mask"][5].any()
    (j_loss, _), j_grads = c.j_value_and_grad(
        j_params, {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, _, t_grads = t_optim.value_and_grad(
        c.t_loss, t_params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(t_loss), float(j_loss),
                               rtol=F32_LOSS_RTOL)
    j_flat = jax_flat(j_grads)
    for key, g in flatten_params(t_grads).items():
        assert np.isnan(g).any() == np.isnan(j_flat[key]).any(), key
    assert np.isnan(j_flat["['out_ln']['g']"]).all()


def test_splade_truncation_is_exercised_and_keeps_laxs_set(tmp_path):
    """`_topk_dense` keeps `lax.top_k`'s set (lower id first on equal
    weights) and gradients only on the survivors."""
    rng = np.random.default_rng(3)
    w = rng.integers(0, 4, size=(5, 40)).astype(np.float32)  # many ties
    w[2] = 0.0
    for k in (1, 7, 40):
        j = np.asarray(j_splade._topk_dense(jnp.asarray(w), k))
        wt = torch.from_numpy(w).requires_grad_(True)
        t = t_splade._topk_dense(wt, k)
        np.testing.assert_array_equal(t.detach().numpy(), j)
        t.sum().backward()
        j_g = np.asarray(jax.grad(
            lambda x: j_splade._topk_dense(x, k).sum())(jnp.asarray(w)))
        kept = wt.grad.numpy() > 0
        assert kept.sum(axis=1).tolist() == [k] * 5
        # JAX gives a kept zero 0.5 where the port gives 1 (maximum vs
        # clamp at equality); upstream of a zero weight sits a relu or a
        # mask with gradient 0, so only the kept SET matters: equal here
        np.testing.assert_array_equal(kept, j_g > 0)
        np.testing.assert_array_equal(wt.grad.numpy()[w > 0],
                                      j_g[w > 0])


# ---------------- the optimizer ----------------


@pytest.mark.parametrize("model", MODELS)
def test_adamw_step_equals_optax(model, tmp_path):
    """Three steps from the same parameters with the same gradients: the
    parameters, both moments and the count equal optax's."""
    c = case(model)
    j_params, t_params = c.params(tmp_path)
    tx = optax.adamw(LR)
    j_state = tx.init(j_params)
    t_state = t_optim.adamw_init(t_params)
    assert t_state["count"].dtype == torch.int32
    for step in range(3):
        flat = random_flat(c.t_template, 10 + step)
        flat = {k: v * np.float32(10.0 ** -step) for k, v in flat.items()}
        j_grads = jax_tree(c.j_template, flat)
        t_grads = unflatten_params(flat, c.t_template, device="cpu")
        updates, j_state = tx.update(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_optim.adamw_update(t_params, t_grads, t_state, LR)
        assert_trees_close(t_params, j_params, OPT_ATOL, "params")
        assert_trees_close(t_state["mu"], j_state[0].mu, OPT_ATOL, "mu")
        assert_trees_close(t_state["nu"], j_state[0].nu, OPT_ATOL, "nu")
        assert int(t_state["count"]) == int(j_state[0].count) == step + 1
    # weight decay reaches every leaf, LayerNorm gains and biases included:
    # with zero gradients a step only shrinks the parameters
    zeros = unflatten_params({k: np.zeros_like(v) for k, v in flat.items()},
                             c.t_template, device="cpu")
    before = flatten_params(t_optim.clone_tree(t_params))
    t_optim.adamw_update(t_params, zeros, t_optim.adamw_init(t_params), LR)
    for key, after in flatten_params(t_params).items():
        np.testing.assert_allclose(after, before[key] * (1 - LR * 1e-4),
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("model", MODELS)
def test_five_train_steps_match_jax(model, tmp_path):
    c = case(model)
    j_params, t_params = c.params(tmp_path)
    j_batch, t_batch = c.batches()
    j_init, j_step = c.j_step()
    t_init, t_step = c.t_make()
    j_state, t_state = j_init(j_params), t_init(t_params)
    leaves_before = tree_leaves(t_params)
    for _ in range(5):
        j_params, j_state, j_m = j_step(j_params, j_state, j_batch)
        t_params, t_state, t_m = t_step(t_params, t_state, t_batch)
        assert t_m.keys() == j_m.keys()
        np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]),
                                   rtol=STEPS_LOSS_RTOL)
    assert_trees_close(t_params, j_params, STEPS_ATOL, "params after 5 steps",
                       noise_atol=5 * LR * 1.01)
    assert int(t_state["count"]) == int(j_state[0].count) == 5
    # the step updates in place and hands the same tensors back
    assert all(a is b for a, b in zip(leaves_before, tree_leaves(t_params)))


# ---------------- training learns ----------------


def test_train_step_reduces_loss():
    """Mirror of tests/test_models.py::test_train_step_reduces_loss."""
    cfg = t_enc.EncoderConfig(vocab_size=512, max_len=16, d_model=32,
                              n_heads=2, n_layers=2, d_ff=64)
    samples = SyntheticHotpotQALoader({"count": 16, "seed": 2}).load()
    batch = {k: torch.from_numpy(v) for k, v in
             t_enc.TextEncoder.make_pair_batch(
                 [s["question"] for s in samples],
                 [s["context"][0][1][0] for s in samples], cfg).items()}
    params = t_enc.init_params(t_enc.seeded_generator(1, "cpu"), cfg)
    init_state, step = t_enc.make_train_step(cfg, learning_rate=3e-3)
    opt_state = init_state(params)
    with torch.no_grad():
        loss0 = float(t_enc.info_nce_loss(params, batch, cfg)[0])
    for _ in range(20):
        params, opt_state, metrics = step(params, opt_state, batch)
    assert float(metrics["loss"]) < loss0 * 0.8, (loss0, metrics)


def test_training_learns_relevance():
    """Mirror of tests/test_cross_encoder.py::test_training_learns_relevance."""
    cfg = t_cross.CrossEncoderConfig(vocab_size=512, max_len=24,
                                     max_query_len=8, d_model=32, n_heads=2,
                                     n_layers=1, d_ff=64, subword_ngrams=2)
    rng = np.random.default_rng(0)
    names = [f"name{i}" for i in range(40)]
    towns = [f"town{i}" for i in range(40)]
    queries, lists, labels = [], [], []
    for i in range(40):
        pos = f"{names[i]} lives in {towns[i]}."
        negs = [f"{names[j]} lives in {towns[j]}."
                for j in rng.choice([x for x in range(40) if x != i], 3,
                                    replace=False)]
        slot = int(rng.integers(4))
        queries.append(f"where does {names[i]} live")
        lists.append(negs[:slot] + [pos] + negs[slot:])
        labels.append(slot)
    r = t_cross.CrossEncoderReranker(cfg, seed=0, device="cpu")
    init_state, step = t_cross.make_cross_train_step(cfg, 3e-3)
    params, opt = r.params, init_state(r.params)
    batch = {k: torch.from_numpy(v) for k, v in
             t_cross.CrossEncoderReranker.make_listwise_batch(
                 queries, lists, labels, cfg).items()}
    for _ in range(60):
        params, opt, m = step(params, opt, batch)
    assert float(m["accuracy"]) >= 0.9, m
    order = r.rerank("where does name3 live",
                     [f"{names[j]} lives in {towns[j]}." for j in
                      (7, 3, 12, 30)])
    assert order[0] == 1


def test_train_smoke_accuracy_off_chance():
    """Mirror of tests/test_splade.py::test_train_smoke_accuracy_off_chance."""
    cfg = t_splade.SpladeConfig(
        encoder=t_enc.EncoderConfig(vocab_size=512, max_len=16, d_model=32,
                                    n_heads=2, n_layers=1, d_ff=64),
        doc_top_terms=32, query_top_terms=8)
    enc = t_splade.SpladeEncoder(cfg, seed=1, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             t_enc.TextEncoder.make_pair_batch(
                 [f"who is person{i} anyway" for i in range(16)],
                 [f"person{i} works in city{i} at plant{i}"
                  for i in range(16)], cfg.encoder).items()}
    init_state, step = t_splade.make_splade_train_step(cfg,
                                                       learning_rate=3e-3)
    params, opt = enc.params, init_state(enc.params)
    first = None
    for _ in range(30):
        params, opt, metrics = step(params, opt, batch)
        first = float(metrics["loss"]) if first is None else first
    assert float(metrics["accuracy"]) >= 0.5  # chance = 1/16
    assert float(metrics["loss"]) < first
    assert float(metrics["doc_nnz"]) > 0
    # the no_grad wrapper gives what the plain function gives
    ids, mask = enc.host_featurize(["who is person3 anyway"])
    with torch.no_grad():
        plain = t_splade.apply_splade(params, torch.from_numpy(ids),
                                      torch.from_numpy(mask), cfg).numpy()
    np.testing.assert_array_equal(
        enc.dense_expand(["who is person3 anyway"]), plain)


# ---------------- the chunk trainer ----------------


def _pair_set(cfg, n=24):
    samples = SyntheticHotpotQALoader({"count": n, "seed": 4}).load()
    q, p = t_cli_enc.build_pairs(samples)
    return {k: torch.from_numpy(v) for k, v in
            t_enc.TextEncoder.make_pair_batch(q, p, cfg).items()}


def test_run_chunk_equals_single_steps_and_repeats(tmp_path):
    c = case("encoder")
    data = _pair_set(c.t_cfg)
    n = data["q_ids"].shape[0]
    init_state, run_chunk = t_enc.infonce_scan_trainer(
        c.t_cfg, batch=8, chunk=4, learning_rate=LR)

    def chunked(seed):
        _, params = c.params(tmp_path)
        out = run_chunk(params, init_state(params), data,
                        t_enc.seeded_generator(seed, "cpu"))
        return out

    params, state, metrics = chunked(7)
    # the same steps one at a time, on the indices the generator draws
    _, single = c.params(tmp_path)
    def loss_fn(p, b):
        return _aux(t_enc.info_nce_loss(p, b, c.t_cfg, 0.05))
    _, step = t_optim.make_step(loss_fn, LR)
    s_state, gen = t_optim.adamw_init(single), t_enc.seeded_generator(7, "cpu")
    for _ in range(4):
        idx = t_enc.sample_batch_indices(n, 8, gen)
        assert idx.shape == (8,) and int(idx.min()) >= 0 and int(idx.max()) < n
        single, s_state, s_metrics = step(
            single, s_state, {k: v[idx] for k, v in data.items()})
    for a, b in zip(tree_leaves(params), tree_leaves(single)):
        assert torch.equal(a, b)
    assert float(metrics["loss"]) == float(s_metrics["loss"])
    assert int(state["count"]) == 4
    # a second run from the same seed is bit for bit the same; another
    # seed draws other batches
    again, _, again_m = chunked(7)
    for a, b in zip(tree_leaves(params), tree_leaves(again)):
        assert torch.equal(a, b)
    assert float(again_m["loss"]) == float(metrics["loss"])
    other, _, _ = chunked(8)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(other)))


# ---------------- train state ----------------


def test_resume_is_bit_for_bit(tmp_path):
    """save -> restore -> continue equals the uninterrupted run."""
    c = case("splade")
    _, t_batch = c.batches()
    init_state, step = c.t_make()
    _, params = c.params(tmp_path)
    state = init_state(params)
    for _ in range(2):
        params, state, _ = step(params, state, t_batch)
    t_ckpt.save_train_state(tmp_path / "run", params, state, 2)
    for _ in range(2):
        params, state, _ = step(params, state, t_batch)

    _, template = c.params(tmp_path, seed=9)
    r_params, r_state, at = t_ckpt.restore_train_state(
        tmp_path / "run", template, t_optim.adamw_init(template))
    assert at == 2 and int(r_state["count"]) == 2
    assert r_state["count"].dtype == torch.int32
    for _ in range(2):
        r_params, r_state, _ = step(r_params, r_state, t_batch)
    for a, b in zip(tree_leaves(r_params) + tree_leaves(r_state),
                    tree_leaves(params) + tree_leaves(state)):
        assert torch.equal(a, b)
    # a later save moves latest.json; the earlier file stays
    t_ckpt.save_train_state(tmp_path / "run", params, state, 4)
    assert json.loads((tmp_path / "run" / "latest.json").read_text()) == {
        "step": 4}
    assert (tmp_path / "run" / "state_2.npz").exists()


def test_restore_without_checkpoint_and_with_a_missing_leaf(tmp_path):
    c = case("encoder")
    _, params = c.params(tmp_path)
    state = t_optim.adamw_init(params)
    assert t_ckpt.restore_train_state(tmp_path / "none", params,
                                      state) is None
    t_ckpt.save_train_state(tmp_path / "run", params, state, 1)
    path = tmp_path / "run" / "state_1.npz"
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    for gone in ("params/['layers'][1]['wo']", "opt/[0].nu['pos_emb']",
                 "opt/[0].count"):
        np.savez(path, **{k: v for k, v in flat.items() if k != gone})
        with pytest.raises(KeyError):
            t_ckpt.restore_train_state(tmp_path / "run", params, state)
        with pytest.raises(KeyError):  # as the JAX package does
            j_ckpt.restore_train_state(
                tmp_path / "run", c.j_template,
                optax.adamw(LR).init(c.j_template))


@pytest.mark.parametrize("model", MODELS)
def test_train_state_crosses_between_the_packages(model, tmp_path,
                                                  monkeypatch):
    """A state the port wrote restores in the JAX package against an optax
    template, and the reverse from the JAX package's ``.npz`` (written when
    orbax cannot be imported); one more step on either side then agrees
    within the five-step tolerance."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    c = case(model)
    j_batch, t_batch = c.batches()
    j_init, j_step = c.j_step()
    t_init, t_step = c.t_make()

    # port -> JAX
    _, t_params = c.params(tmp_path)
    t_state = t_init(t_params)
    for _ in range(2):
        t_params, t_state, _ = t_step(t_params, t_state, t_batch)
    t_ckpt.save_train_state(tmp_path / "t", t_params, t_state, 2)
    j_params, j_state, at = j_ckpt.restore_train_state(
        tmp_path / "t", c.j_template, j_init(c.j_template))
    assert at == 2 and int(j_state[0].count) == 2
    assert_trees_close(t_params, j_params, 0, "restored params")
    assert_trees_close(t_state["mu"], j_state[0].mu, 0, "restored mu")
    assert_trees_close(t_state["nu"], j_state[0].nu, 0, "restored nu")
    j_params, j_state, j_m = j_step(
        jax.tree_util.tree_map(jnp.asarray, j_params),
        jax.tree_util.tree_map(jnp.asarray, j_state), j_batch)
    t_params, t_state, t_m = t_step(t_params, t_state, t_batch)
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]),
                               rtol=STEPS_LOSS_RTOL)
    assert_trees_close(t_params, j_params, STEPS_ATOL, "one more step",
                       noise_atol=LR * 1.01)

    # JAX -> port
    j_ckpt.save_train_state(tmp_path / "j", j_params, j_state, 3)
    assert (tmp_path / "j" / "state_3.npz").exists()
    with np.load(tmp_path / "j" / "state_3.npz") as data:
        t_ckpt.save_train_state(tmp_path / "t3", t_params, t_state, 3)
        with np.load(tmp_path / "t3" / "state_3.npz") as mine:
            assert set(mine.files) == set(data.files)  # optax's key strings
    r_params, r_state, at = t_ckpt.restore_train_state(
        tmp_path / "j", c.t_template, t_optim.adamw_init(c.t_template))
    assert at == 3 and int(r_state["count"]) == 3
    assert_trees_close(r_params, j_params, 0, "params from JAX's file")
    assert_trees_close(r_state["nu"], j_state[0].nu, 0, "nu from JAX's file")
    j_params, j_state, j_m = j_step(j_params, j_state, j_batch)
    r_params, r_state, r_m = t_step(r_params, r_state, t_batch)
    np.testing.assert_allclose(float(r_m["loss"]), float(j_m["loss"]),
                               rtol=STEPS_LOSS_RTOL)
    assert_trees_close(r_params, j_params, STEPS_ATOL, "one more step",
                       noise_atol=LR * 1.01)


# ---------------- the CLIs ----------------


def _report_keys(module):
    """String keys of ``main``'s ``report`` dict in a CLI's source: the
    dict literal and every ``report["..."] = ...``."""
    tree = ast.parse(Path(module.__file__).read_text(encoding="utf-8"))
    main = next(n for n in tree.body if getattr(n, "name", "") == "main")
    keys = set()
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id == "report"
                and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
        if (isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript) and getattr(
                    node.targets[0].value, "id", "") == "report"):
            keys.add(node.targets[0].slice.value)
    return keys


def _arguments(module):
    """(flag, sorted keyword source) of every ``add_argument`` in a CLI's
    ``main``."""
    tree = ast.parse(Path(module.__file__).read_text(encoding="utf-8"))
    main = next(n for n in tree.body if getattr(n, "name", "") == "main")
    out = []
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            out.append((node.args[0].value, sorted(
                (k.arg, ast.unparse(k.value)) for k in node.keywords
                if k.arg != "help")))
    return sorted(out)


@pytest.mark.parametrize("t_cli,j_cli", [
    (t_cli_enc, j_cli_enc), (t_cli_cross, j_cli_cross),
    (t_cli_splade, j_cli_splade)], ids=MODELS)
def test_cli_arguments_are_the_originals_plus_device(t_cli, j_cli):
    mine, theirs = _arguments(t_cli), _arguments(j_cli)
    device = [a for a in mine if a[0] == "--device"]
    assert len(device) == 1 and ("default", "'cuda'") in device[0][1]
    assert [a for a in mine if a[0] != "--device"] == theirs
    assert _report_keys(t_cli) == _report_keys(j_cli)


def _run_main(main, argv, capsys):
    main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])


def test_train_encoder_cli_round_trip(tmp_path, capsys):
    out = tmp_path / "enc.npz"
    lines, report = _run_main(t_cli_enc.main, [
        "--synthetic", "24", "--steps", "10", "--batch", "16", "--d_model",
        "32", "--subword_ngrams", "4", "--eval_samples", "8", "--out",
        str(out), "--device", "cpu"], capsys)
    assert lines[0] == "training pairs: 48"
    assert lines[1].startswith("step 1/10 loss=") and " acc=" in lines[1]
    assert set(report) == _report_keys(j_cli_enc)
    assert set(report["held_out"]) == {"n", "hash", "trained"}
    assert set(report["held_out"]["trained"]) == {"recall_at_10", "mrr"}
    assert report["steps"] == 10 and report["pairs"] == 48
    kw = dict(d_model=32, n_layers=2, subword_ngrams=4)
    j = j_enc.TextEncoder.load(str(out), j_enc.EncoderConfig(**kw))
    t = t_enc.TextEncoder.load(str(out), t_enc.EncoderConfig(**kw),
                               device="cpu")
    np.testing.assert_allclose(t.encode_texts(QUERIES),
                               j.encode_texts(QUERIES), atol=2e-2)
    # the wrapper runs without a graph and equals the plain function
    ids, mask = t.host_featurize(QUERIES)
    e = t.device_embed(torch.from_numpy(ids), torch.from_numpy(mask))
    assert not e.requires_grad
    with torch.no_grad():
        plain = t_enc.apply_encoder(t.params, torch.from_numpy(ids),
                                    torch.from_numpy(mask), t.cfg)
    assert torch.equal(e, plain)


def test_train_cross_encoder_cli_round_trip(tmp_path, capsys):
    out = tmp_path / "cross.npz"
    lines, report = _run_main(t_cli_cross.main, [
        "--synthetic", "12", "--steps", "3", "--batch", "4", "--m_cands", "4",
        "--eval_samples", "8", "--collide", "--out", str(out), "--device",
        "cpu"], capsys)
    assert lines[0].startswith("training lists: ") and "(M=4)" in lines[0]
    assert lines[1].startswith("step 1: loss=")
    assert any(x.startswith("trained in ") for x in lines)
    assert f"saved {out}" in lines
    # train_cross_encoder.py:93, 160: eval_rerank's keys and the seed
    assert set(report) == {"heldout_seed", "recall_before", "recall_after",
                           "mrr_before", "mrr_after"}
    assert report["heldout_seed"] == 101
    j = j_cross.CrossEncoderReranker.load(
        str(out), j_cross.CrossEncoderConfig(subword_ngrams=8))
    t = t_cross.CrossEncoderReranker.load(
        str(out), t_cross.CrossEncoderConfig(subword_ngrams=8), device="cpu")
    np.testing.assert_allclose(t.score_pairs(QUERIES, PASSAGES),
                               j.score_pairs(QUERIES, PASSAGES), atol=5e-2)
    ids, mask, seg = (torch.from_numpy(a) for a in t_cross.encode_pairs(
        QUERIES, PASSAGES, t.cfg))
    with torch.no_grad():
        plain = t_cross.apply_cross_encoder(t.params, ids, mask, seg, t.cfg)
    np.testing.assert_array_equal(t.score_pairs(QUERIES, PASSAGES),
                                  plain.numpy())


def test_train_splade_cli_round_trip(tmp_path, capsys):
    out = tmp_path / "splade.npz"
    lines, report = _run_main(t_cli_splade.main, [
        "--synthetic", "24", "--steps", "4", "--batch", "16", "--d_model",
        "32", "--vocab_size", "1024", "--eval_samples", "8", "--eval_every",
        "4", "--variety", "--out", str(out), "--device", "cpu"], capsys)
    assert lines[0] == "training pairs: 48"
    assert any(x.startswith("  val@4: recall ") for x in lines)
    assert set(report) == _report_keys(j_cli_splade)
    assert [row["step"] for row in report["val_curve"]] == [0, 4]
    assert report["selected_step"] in (0, 4)
    best = max(report["val_curve"],
               key=lambda r: (r["recall_at_10"], r["mrr"]))
    sel = next(r for r in report["val_curve"]
               if r["step"] == report["selected_step"])
    assert (sel["recall_at_10"], sel["mrr"]) == (best["recall_at_10"],
                                                 best["mrr"])
    j = j_splade.SpladeEncoder.load(str(out))
    t = t_splade.SpladeEncoder.load(str(out), device="cpu")
    assert (j.cfg.doc_top_terms, j.cfg.encoder.d_model,
            j.cfg.encoder.vocab_size) == (128, 32, 1024)
    np.testing.assert_allclose(t.dense_expand(QUERIES),
                               j.dense_expand(QUERIES), atol=5e-2)
    # idf initialisation of lex_w survived: not the uniform prior
    assert float(np.ptp(flatten_params(t.params)[
        "['splade_head']['lex_w']"])) > 0.1


def test_best_checkpoint_snapshot_is_a_real_copy():
    c = case("encoder")
    params = t_enc.init_params(t_enc.seeded_generator(0, "cpu"), c.t_cfg)
    snap = t_optim.clone_tree(params)
    _, t_batch = c.batches()
    init_state, step = c.t_make()
    before = flatten_params(snap)
    step(params, init_state(params), t_batch)
    for key, a in flatten_params(snap).items():
        np.testing.assert_array_equal(a, before[key])
    assert any(not np.array_equal(a, before[k])
               for k, a in flatten_params(params).items())


# ---------------- host helpers ----------------


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pair_and_list_makers_equal_the_originals():
    samples = SyntheticHotpotQALoader(
        {"count": 12, "seed": 3, "collide_entities": True,
         "n_distractors": 4}).load()
    assert t_cli_enc.build_pairs(samples) == j_cli_enc.build_pairs(samples)
    t = t_cli_cross.build_lists(samples, 6, np.random.default_rng(5))
    j = j_cli_cross.build_lists(samples, 6, np.random.default_rng(5))
    assert t == j and len(t[0]) == 24 and all(len(c) == 6 for c in t[1])
    assert (_load_tool("dense_lab_torch").build_collide_pairs(10, 40, 1)
            == _load_tool("dense_lab").build_collide_pairs(10, 40, 1))

    c = case("encoder")
    q, p = t_cli_enc.build_pairs(samples)
    for a, b in zip(
            t_enc.TextEncoder.make_pair_batch(q, p, c.t_cfg).items(),
            j_enc.TextEncoder.make_pair_batch(q, p, c.j_cfg).items()):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        np.testing.assert_array_equal(a[1], b[1])
    x = case("cross_encoder")
    for a, b in zip(
            t_cross.CrossEncoderReranker.make_listwise_batch(
                t[0], t[1], t[2], x.t_cfg).items(),
            j_cross.CrossEncoderReranker.make_listwise_batch(
                j[0], j[1], j[2], x.j_cfg).items()):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        np.testing.assert_array_equal(a[1], b[1])


def test_sparse_evals_equal_the_originals():
    """`eval_sparse` of both packages over one retriever, and `eval_bm25`
    (the port's query terms come from `engine.host_prep`) against JAX's."""
    samples = SyntheticHotpotQALoader(
        {"count": 20, "seed": 6, "unique_entities": True,
         "variety": True}).load()
    cfg = case("splade").t_cfg
    enc = t_splade.SpladeEncoder(cfg, seed=2, device="cpu")
    t = t_cli_splade.eval_sparse(samples, SpladeRetriever(enc))
    j = j_cli_splade.eval_sparse(samples, SpladeRetriever(enc))
    assert t == j and 0.0 < t["recall_at_10"] <= 1.0
    t = t_cli_splade.eval_bm25(samples, device="cpu")
    j = j_cli_splade.eval_bm25(samples)
    assert t.keys() == j.keys()
    # the same postings and query terms; BM25 sums in another order, and
    # template sentences tie, so the rank of a gold row can move by a slot
    assert t["recall_at_10"] == pytest.approx(j["recall_at_10"], abs=0.05)
    assert t["mrr"] == pytest.approx(j["mrr"], abs=0.05)


def test_trainers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main, argv in ((t_cli_enc.main, ["--synthetic", "4", "--steps", "1"]),
                       (t_cli_cross.main, ["--synthetic", "4", "--steps",
                                           "1"]),
                       (t_cli_splade.main, ["--synthetic", "4", "--steps",
                                            "1"])):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            main(argv)
    lab = _load_tool("dense_lab_torch")
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        lab.train(["a b"], ["c d"], case("encoder").t_cfg, steps=1, batch=1,
                  lr=LR, chunk=1)


# ---------------- the tools ----------------


@pytest.fixture(scope="module")
def collide_index(tmp_path_factory):
    """A 2,816-row collide index on disk, its samples and its directory."""
    from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                     build_packed_index)

    samples = SyntheticHotpotQALoader(
        {"count": 128, "seed": 0, "n_distractors": 8,
         "collide_entities": True}).load()
    cache = tmp_path_factory.mktemp("lab") / "data" / "bench_cache_100k"
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=64, out_dir=str(cache))
    return samples, idx, cache


COLLIDE = dict(vocab_size=32768, max_len=32, d_model=128, n_heads=4,
               n_layers=2, subword_ngrams=8)


def test_dense_eval_equals_the_originals(collide_index):
    """The dense lab's evaluation over one index with the committed
    checkpoint in both packages: queries and corpus are rounded to bf16 in
    both, so the products are the same and the recalls equal."""
    samples, idx, _ = collide_index
    path = str(REPO / "data" / "encoder_collide.npz")
    t_lab, j_lab = _load_tool("dense_lab_torch"), _load_tool("dense_lab")
    t = t_enc.TextEncoder.load(path, t_enc.EncoderConfig(**COLLIDE),
                               device="cpu")
    j = j_enc.TextEncoder.load(path, j_enc.EncoderConfig(**COLLIDE))
    texts = idx.corpus.texts()
    t_emb, j_emb = t_lab.embed_corpus(t, texts), j_lab.embed_corpus(j, texts)
    np.testing.assert_allclose(t_emb, j_emb, atol=2e-2)
    t_rep = t_lab.dense_eval(idx, t, t_emb, samples[:64])
    j_rep = j_lab.dense_eval(idx, j, j_emb, samples[:64])
    assert t_rep.keys() == j_rep.keys()
    for key in t_rep:  # a bf16 flip can swap two near-tied neighbours
        assert t_rep[key] == pytest.approx(j_rep[key], abs=0.02), key
    assert t_rep["dense_1shot_hop1_recall"] > 0.9


def test_sidecar_tools_write_what_the_jax_package_attaches(collide_index):
    from a_modular_rag_framework_torch.index import PackedIndex
    from a_modular_rag_framework_tpu.index.reembed import \
        attach_learned_embeddings as j_attach

    _, idx, cache = collide_index
    tool = _load_tool("prebuild_sidecars_torch")
    ckpt = REPO / "data" / "encoder_collide.npz"
    assert tool.ensure_sidecar(cache, cache.parent / "missing.npz",
                               device="cpu") == (
        "hash64", f"encoder checkpoint missing: {cache.parent / 'missing.npz'}")
    assert tool.ensure_sidecar(cache, ckpt, device="cpu") == (
        "subword_collide_d128", None)
    doc = json.loads((cache / "learned_embed.json").read_text())
    assert doc["rows"] == idx.n_docs and doc["dim"] == 128
    assert doc["encoder_checkpoint"] == "data/encoder_collide.npz"
    assert doc["built_by"] == "prebuild_sidecars_torch"
    built = (cache / "embeddings_learned.npy").stat().st_mtime_ns
    # a second call attaches what is there; the JAX package attaches it too
    assert tool.ensure_sidecar(cache, ckpt, device="cpu")[1] is None
    assert (cache / "embeddings_learned.npy").stat().st_mtime_ns == built
    loaded = PackedIndex.load(cache)
    # the sidecar names its checkpoint relative to the data directory's parent
    (cache.parent / "encoder_collide.npz").write_bytes(ckpt.read_bytes())
    enc, j_doc = j_attach(loaded, cache)
    assert j_doc["rows"] == idx.n_docs and enc.cfg.d_model == 128
    # main() over a data directory: builds nothing new, reports the label
    tool.main(["--data", str(cache.parent), "--device", "cpu"])
