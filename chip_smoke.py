#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--samples 47000]

Drives the port's main path (a_modular_rag_framework_torch) once through
the entry points a user calls, on the repo's own 1M-row scale corpus
(SyntheticHotpotQALoader, 47,000 samples, collide entities -> 1,034,000
sentence rows; hash embeddings d = 64 in bf16):

  1. card check: CUDA present, card name + power limit, no jax / pydantic /
     yaml and no module of the JAX package (by name, or by a file in its
     tree or in the repo-root native/) loaded; checked again at the end;
  2. build the hand-written kernels (nvcc: B1, the hash kernel, the
     grouped expert kernel) and report the build times,
     the ptxas reports and B1's HGMMA / UTMALDG counts of cuobjdump -sass;
  3. kernel vs its plain PyTorch version on the card: adversarial cases,
     then B 256 x N 1,034,000 x d 64, k 10 and 100, both timed;
  4. corpus + index build on the host (cached as
     data/torch_smoke_<n>/docs.jsonl.packed, where phase 14's retrieval
     backend finds it as the packed cache of data/torch_smoke_<n>/docs.jsonl);
  5. hybrid path (TorchQueryEngine.query_batch through
     eval.harness.evaluate_retrieval, plus query_batches_pipelined) at the
     scale operating point; 64 questions compared with the port on the CPU;
  6. dense-only path (query_dense_batch), which launches the hash kernel
     (csrc/hash_embed.cu: the questions' bytes -> unit rows) and the top-k
     kernel; the top-k kernel is also held against the plain version at
     this shape and timed beside it, beside one PyTorch call
     (torch.topk(q @ emb.float().T, k) in 1024-row chunks, the yardstick
     ``library_ms``) and beside its bound (three bf16 tensor-core passes
     of 2*B*N*d at 989 TFLOP/s); the hash kernel is held bit for bit
     against its plain version on one batch of questions and its device
     time a launch set beside its bound (its bytes at 3.35 TB/s);
  7. iterative bridge-entity 2-hop (iterative_retrieve, then
     iterative_retrieve_pipelined) on the same engine, 3 batches of 4096:
     supporting-fact recall@10 / MRR, q/s, hop-2 activity; 64 questions
     compared with the port on the CPU;
  8. QueryServer on that engine: client threads submit single and
     iterative requests (submit and submit_many); every result must equal
     the direct call; completed q/s and p50 / p99 latency;
  9. the dense [B, N] form at the headline configuration of bench.py
     (600 samples, unique entities, ~13.2k rows, B 2048, graph_impl auto,
     dense_impl matmul, bf16 waves): auto must take the dense form;
     evaluate_retrieval, then iterative; 64 questions card vs CPU;
 10. learned dense: the committed collide-trained TextEncoder
     (data/encoder_collide.npz: vocab 32768, L 32, d 128, 4 heads, 2
     layers, d_ff 512, 8 subword features) re-embeds the 1,034,000 rows on
     the card (embed_corpus_pipelined; rows/s, host tokenize vs device),
     the sidecar is written beside the index and attached, and an engine
     with the learned encoder runs query_dense_batch (the kernel at d 128,
     held against the plain version, timed beside it, the library call
     and its bound) and query_batch; recall@10 / MRR beside the hash
     encoder's; 64 questions card vs CPU;
 11. SPLADE channel: TorchQueryEngine(sparse_impl="splade",
     splade_weights=data/splade_variety.npz) at the checkpoint's width
     (d 64, L 64, vocab 8192, 8 subword features, 128 doc / 32 query
     terms) on the 101,200-row corpus (4,600 samples): corpus expansion
     on the card (docs/s), query_batch at B 4096, recall@10 beside
     BM25's, 64 questions card vs CPU;
 12. cross-encoder rerank (data/cross_encoder_collide.npz, 8 subword
     features) of the learned engine's hybrid top-20 of 512 questions:
     10,240 pairs in two full pair_budget chunks and a padded tail;
     recall@10 / MRR before and after; 1,024 pair scores card vs CPU;
 13. question answering at the recorded configuration (the regress_plain
     row of docs/E2E_RUN.json: 300 samples, seed 17, unique entities, 6,600
     sentences, the shipped settings, 100 questions, mode "full") through
     a_modular_rag_framework_torch.system.answer_question: EM / relaxed EM
     / F1, verdicts, retry rounds, seconds per question and its split by
     span; then the same questions through a second system on the CPU;
     and semantic_sim_matrix (the per-question graph's semantic edges) on
     the card against float64 numpy at n 22 and n 4096;
 14. question answering against the 1,034,000-row index: the same entry
     point, the packed index of phase 4 as the backend's cache, the scale
     operating point where the backend exposes it, 32 questions of the
     collide corpus with their own contexts; one system, one index upload;
 15. training on the card at the committed checkpoints' own widths: the
     dense-lab recipe of data/encoder_collide.npz through
     tools/dense_lab_torch.py (32,768 collide pairs resident on the card,
     batch 1024, chunk 50, lr 1e-3, 1,500 steps): steps/s, host featurize
     seconds, loss and accuracy of the first and the last chunk, peak
     memory; half way the train state is saved, restored and continued
     for one chunk and compared with the uninterrupted run; the trained
     encoder's dense quality (dense_eval over the 101,200-row index of
     phase 11) beside the committed checkpoint's; then
     cli.train_cross_encoder.main (--collide, 300 steps of 32 x 8 pairs)
     with eval_rerank on the held-out seed beside
     data/cross_encoder_collide.npz, and cli.train_splade.main (--variety,
     150 steps, validation every 25) with its held-out and in-domain
     recall beside BM25's; and one loss + gradient of each model from the
     same parameters and batch on the card and on the CPU. The dense_topk
     kernel is not on the training path (0 launches there; dense_eval's
     top-20 goes through it);
 16. sharding on the one card (run after phase 11, while its SPLADE index is
     cached): SHARDS virtual shards, the mesh positions [cuda:0] * SHARDS,
     over phase 4's cached index. ShardedDenseEngine over 3 batches of 4096
     against query_dense_batch (ids identical, scores within 1e-6; the
     kernel launched once per shard per batch, each shard's time beside one
     launch over all rows, the merge's, and the kernel held against its
     plain version at the shard's shape); ShardedHybridEngine at the scale
     operating point through evaluate_retrieval (recall@10 and MRR within
     0.005 of the single engine's, q/s, device ms per engine/<stage> range,
     index bytes), then query_batches_pipelined, one iterative batch and 64
     QueryServer requests, each equal to the direct call;
     parallel.dryrun.dryrun_multichip(SHARDS) on the card (the sharded train
     step, sharded dense, dryrun_check's 4 configurations x 2 seed modes,
     the composed dcn mesh, sharded SPLADE, iterative and served);
     sharded_splade_topk over phase 11's 101,200-row index with term_topm
     covering every list, ids equal to the single-device scorer; and the
     sharded train step on {data: 2, model: 2} at the Main encoder width
     from data/encoder_collide.npz, f32 and bf16 configs: one loss +
     gradient against one device's, then 5 steps of each (steps/s, peak
     memory; f32 parameters within 5e-4). S shards on one card measure the
     sharded program's overhead, not a multi-card speed-up;
 17. the quality record's other rows (run after phase 14): regress_variety
     and regress_heldout of docs/E2E_RUN.json (300 samples, seed 17, 100
     questions each) and the first 80 questions of natural_shipped (the
     1,015-sample real-schema corpus of data/natural/, index_titles)
     through answer_question on the card, with tools/e2e_run_torch.py's
     corpora and settings; every question's answer, verdict and retry
     round held against the JAX package's on the CPU
     (tests/fixtures/e2e_jax_rows.json, tools/e2e_reference_rows.py): at
     least 98 / 98 / 78 equal (exact BM25 ties of template sentences
     may break differently); EM, verdicts, retry rounds, seconds per
     question and their split by span;
 18. the rest of the surface (run after phase 8, on its engine): the serve
     CLI's HTTP front (cli/serve.py: `_App` behind `make_server` on
     127.0.0.1) over the Main engine's QueryServer, 64 concurrent /query
     and 8 /query_batch requests (half iterative) equal to the direct
     calls and 4 /answer requests on phase 13's corpus equal to
     answer_question; the graph store's expand_qmatch_neighbors on the
     card equal to the CPU's; TorchQueryEngine.profile's chrome trace
     naming the engine's ranges and kernels; the AMRF_DEBUG_NANS switch
     tripping on a small engine of its own (at upload and in the hybrid
     program's dense pool);
 19. DeepSeek-V2-Lite as the dense embedder (run after phase 3): the
     published widths cut to 5 layers (layer 0 dense, MoE layers 1-4, as
     benchmark/configs/hotpot258k-dsv2lite.json), weights drawn from seed
     0, E5-Mistral's HotpotQA instruction on queries; an index of
     DSV2_SAMPLES samples (~259,000 rows, the cell's N) embedded on the
     card, then query_dense_batch over 2 batches of 4096 questions with
     the launch counters set to 0 just before: B1 once a batch, the
     grouped expert kernel (csrc/moe_gemm.cu) twice a MoE layer; B1 at
     that path's B 4096 x N x d 2048 held against the plain version and
     timed beside it, the library call and its bound; the grouped kernel
     at DSV2_SLOTS routed slots of 64 experts (H 2048, F 1408, layer 1's
     weights) held against its plain version (moe_reference: a torch
     product per expert) and timed beside it, beside the library's
     grouped products (torch._grouped_mm, where this torch has it) and
     beside its bound.

The learned models compute in bfloat16 with f32 accumulation: an f32 value
that differs in its last bits between the card and the CPU can round to
another bf16 value, so phases 10-12 compare within LEARNED_ATOL /
SPLADE_ATOL / RERANK_ATOL and hold ids through `card_vs_cpu_learned`.

Phase 15 writes its checkpoints and train states under
data/torch_smoke_train/ and removes them at the end.

Phases 13-14, 17 and 18 write their settings files (JSON), corpora and
per-question graphs under data/torch_smoke_qa/ and their traces under a
temporary runs directory there, removed at the end.

Any failed phase exits non-zero. The last lines are the card line, one
{"kernels": [...]} JSON line and the {"ok": true, ...} JSON line.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 4096
HYBRID_BATCHES = 3
CPU_QUESTIONS = 64
# scores: f32 dot products / BM25 sums taken in different orders on the
# card and on the CPU (or in cuBLAS vs the kernel); |score| <= ~10 here
SCORE_ATOL = 1e-4
HASH_REPS = 200  # hash kernel launches timed in phase 6
# published H100 SXM peaks (dense bf16 tensor cores, HBM3), for bound_ms
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the kernel's f32-faithful scores take three bf16 passes (query planes
# hi, mid, lo times a bf16 corpus; six for an f32 corpus)
BF16_PASSES = 3
HYBRID_ATOL = 1e-5
# the scale operating point of bench.py:207-235 (make_scale_engine); the
# hop-2 knobs act on the iterative mode only
SCALE_CONFIG = dict(top_k=10, pool_k=200, graph_window=2,
                    batch_buckets=(BATCH,), query_df_ratio_max=0.05,
                    bm25_term_topm=16, graph_compact_cap=128,
                    dense_impl="pool", alpha_text=0.15, alpha_graph=0.70,
                    alpha_dense=0.15, order_alphas=(0.4, 0.2, 0.4),
                    hop2_graph_window=0, hop2_pool_k=100)
# the headline engine of bench.py:30, 165-214 (make_engine): 600 samples
# with unique entities (~13.2k rows) at B 2048, in the dense [B, N] regime
HEADLINE_SAMPLES = 600
HEADLINE_BATCH = 2048
HEADLINE_CONFIG = dict(top_k=10, pool_k=200, graph_window=2,
                       bm25_posting_cap=1024,
                       batch_buckets=(HEADLINE_BATCH,),
                       query_df_ratio_max=0.05, bm25_term_topm=16,
                       graph_wave_dtype="bfloat16", dense_impl="matmul",
                       alpha_text=0.15, alpha_graph=0.70, alpha_dense=0.15,
                       order_alphas=(0.4, 0.2, 0.4), hop2_graph_window=0)
SERVER_CLIENTS = 8
# phases 10-12: bf16-compute models on the card vs on the CPU. Cosines and
# fused scores are <= 1, SPLADE weights a few units: one bf16 rounding flip
# moves an output by ~1e-3; the cross-encoder's logits reach +-20
LEARNED_ATOL = 1e-2
RERANK_ATOL = 5e-2
# SPLADE fused scores are min-max normalized over the pool: raw scores of
# ~30 with a spread of ~10 inside a pool, so a flipped rounding in a query
# weight (or a swapped low-weight term at the head's top-32 cut, ~0.2 x an
# impact of ~1) moves a normalized score by up to a few 1e-2. The JAX
# package and the port on the CPU differ by 1.05e-2 on this checkpoint
SPLADE_ATOL = 5e-2
# least mean overlap of the card's and the CPU's top-10 id sets (a flipped
# rounding can swap near-tied neighbours at the cut, or a query term at the
# SPLADE head's cut)
LEARNED_MIN_OVERLAP = 0.9
# tools/reembed_index.py's configuration of data/encoder_collide.npz
LEARNED_ENCODER = dict(vocab_size=32768, max_len=32, d_model=128, n_heads=4,
                       n_layers=2, d_ff=512, subword_ngrams=8)
SPLADE_SAMPLES = 4600  # 101,200 rows
RERANK_QUESTIONS = 512
RERANK_TOP = 20
# the iterative mode's reserve (two of the ten merged slots go to hop-2-only
# hits) can evict a gold sentence that single-pass already ranked: the JAX
# reference on the CPU, 101,200 collide rows at this operating point, goes
# from 0.9999 single-pass to 0.9906 iterative (4,096 questions), and the
# port gives the same numbers (hop-2 facts 0.9998 -> 0.9812). At
# 1,034,000 rows the loss must stay inside that; a broken hop-2 path or
# merge loses far more. The headline corpus, where iterative gains, is held
# to iterative >= single-pass.
ITERATIVE_RECALL_SLACK = 0.01


# phase 13: tools/e2e_run.py's regress_plain configuration and its record
QA_RECORDED = dict(count=300, seed=17, unique_entities=True)
QA_QUESTIONS = 100
QA_MIN_EM = 0.99  # docs/E2E_RUN.json regress_plain: 1.00
QA_MIN_SAME_AS_CPU = 98  # answers and verdicts, of QA_QUESTIONS
# phase 14: the first samples of the main corpus (the collide corpus is
# prefix-stable), at the scale operating point where the backend exposes it
QA_SCALE_QUESTIONS = 32
QA_SCALE_MIN_GOLD = 30  # 32 / 32 in every run so far
QA_SCALE_INDEX = dict(max_postings_per_term=16, query_df_ratio_max=0.05,
                      graph_compact_cap=128)
# semantic edges: f32 cosines on the card vs float64 numpy
SEMANTIC_ATOL = 1e-6
# phase 17: the quality record's other rows (tools/e2e_run_torch.py's
# corpora), each question held against the JAX package's answer, verdict
# and retry round on the CPU (tests/fixtures/e2e_jax_rows.json, written by
# tools/e2e_reference_rows.py), phase 13's allowance (98 %) for exact BM25
# ties. The natural row is cut to its first 80 questions (13 retries, 11
# INCONCLUSIVE verdicts in the JAX package's answers) to hold the phase near
# 150 s on the slower hosts (183.6 s with 150 questions on one H100
# machine, NVIDIA H100 80GB HBM3 at 700 W); the whole
# row runs through tools/e2e_run_torch.py
QUALITY_FIXTURE = REPO / "tests" / "fixtures" / "e2e_jax_rows.json"
QUALITY_QUESTIONS = {"variety": 100, "heldout": 100, "natural": 80}
QUALITY_MIN_SAME = {"variety": 98, "heldout": 98, "natural": 78}
# phase 18: the HTTP front over the Main engine
HTTP_QUERIES = 64  # concurrent POST /query
HTTP_BATCHES = 8  # concurrent POST /query_batch, half of them iterative
HTTP_BATCH = 256  # questions per /query_batch
HTTP_ANSWERS = 4  # POST /answer on phase 13's corpus


# phase 15: tools/dense_lab.py's recipe of data/encoder_collide.npz
TRAIN_ENCODER = dict(train_samples=16384, train_index=8192, steps=1500,
                     batch=1024, chunk=50, lr=1e-3)
TRAIN_CROSS_STEPS = 300
TRAIN_SPLADE_STEPS = 150
# the train state restored half way and continued for one chunk against the
# uninterrupted run: the largest |difference| of a parameter allowed
TRAIN_RESUME_ATOL = 0.0
# the card-trained encoder against data/encoder_collide.npz on dense_eval
# (101,200 rows, 128 questions): hop-1 recall and 2-hop recall@10 may lie
# this far below the committed checkpoint's
TRAIN_QUALITY_SLACK = 0.05
# one loss + gradient on the card vs on the CPU, bf16 compute: the forward
# values differ in summation order, so a bf16 rounding of an activation can
# flip (one part in 256 of that value), and in the SPLADE loss such a flip
# can swap a term at the top-k cut, which moves the loss and the gradients
# by that term's whole share (seen: loss 2.7e-4, a gradient leaf 2.8e-2 of
# its largest entry; encoder and cross-encoder 3e-6 and 6e-3).
# max |dg| <= rtol * max |g| + atol. The atol is for a leaf whose gradient
# is an exact zero but for rounding noise (the cross-encoder's b_score
# shifts every candidate's logit alike, so the listwise softmax ignores it)
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_RTOL = 1e-1
TRAIN_GRAD_ATOL = 1e-6

# phase 19: DeepSeek-V2-Lite at the published widths, 5 layers; 11,777
# samples of 22 rows make 259,094 rows, the dsv2lite258k cell's N
DSV2_LAYERS = 5
DSV2_SAMPLES = 11777
DSV2_INSTRUCTION = ("Instruct: Given a multi-hop question, retrieve "
                    "documents that can help answer the question\nQuery: ")
# the grouped kernel's routed slots a layer in the cell: ~162,000 real
# tokens of 4,096 instructed questions x top-6
DSV2_SLOTS = 972_000
# the grouped kernel vs its plain version: both round the same operands to
# bfloat16 and sum in float32 in another order; the hidden activation is
# rounded to bfloat16 between the products, where a last-bit difference
# flips ~1e-3 of its values by one bf16 step (2^-8), ~1.5e-4 of the
# result's norm. Element: the GPU test's rtol / atol (x max |ref|); norm:
# MOE_REL_NORM
MOE_RTOL = 2e-3
MOE_REL_NORM = 1e-3

# phase 16: virtual shards of the one card
SHARDS = 4
SPLADE_SHARD_QUERIES = 32
# sharded SPLADE vs one device: f32 prefix-sum rounding band, in ulps of a
# row's window mass (an H100 at 101,200 rows: max |ds| 0.0078)
SPLADE_PREFIX_ULPS = 4
# the sharded hybrid's quality beside one device's at SCALE_CONFIG. Each
# shard's phase-1 window takes bm25_term_topm (16) postings of its LOCAL
# list, a superset of the single window, so the pools (and the per-pool
# min-max norms of the fusion) differ once posting lists outgrow 16, as
# they do at 1,034,000 rows; the JAX sharded engine does the same
# (tools/sharded_window_gap.py: both packages, 101,200 rows, MRR 0.3783
# sharded against 0.3818, and 0.3783 for both with a window covering every
# list). Recall holds; an H100 gave MRR 0.3675 against 0.3853 here
SHARD_RECALL_SLACK = 0.005
SHARD_MRR_SLACK = 0.03
SHARD_TRAIN_BATCH = 256
SHARD_TRAIN_STEPS = 5
# the sharded step against one device's: per gradient leaf max |dg| <=
# rtol * max |g| + atol, and |dloss| <= loss_rtol * loss. f32 differs by
# summation order (the tests' bounds); bf16 by rounding flips of
# activations (gradients: the tests' 2e-2; loss: phase 15's 2e-3)
SHARD_TOL = {"f32": (1e-5, 1e-7, 1e-6),
             "bf16": (2e-2, 0.0, TRAIN_LOSS_RTOL)}


def index_cache(n_samples: int) -> Path:
    """The packed index of the n-sample scale corpus, at the path where the
    retrieval backend looks for the cache of ``docs.jsonl`` beside it."""
    return REPO / "data" / f"torch_smoke_{n_samples}" / "docs.jsonl.packed"


def collide_index(loader, n_samples: int):
    """(samples, packed index) of the n-sample collide corpus (seed 0, 8
    distractors; hash embeddings d 64 bf16): the cache at
    `index_cache(n_samples)` when it is there, else built and cached."""
    from a_modular_rag_framework_torch.index import (PackedIndex,
                                                     SentenceCorpus,
                                                     build_packed_index)

    cache = index_cache(n_samples)
    samples = loader.SyntheticHotpotQALoader(
        {"count": n_samples, "seed": 0, "n_distractors": 8,
         "collide_entities": True}).load()
    if (cache / "manifest.json").exists():
        return samples, PackedIndex.load(cache)
    return samples, build_packed_index(
        SentenceCorpus.from_hotpotqa(samples), embed_dim=64,
        embed_dtype="bfloat16", out_dir=str(cache))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def compare_topk(ids_a, s_a, ids_b, s_b, atol):
    """(max |score diff|, rows whose ids differ) after checking that the
    scores agree within ``atol`` and that every id difference sits inside
    a group of scores equal within ``atol`` (a tie the two summation
    orders may break differently) whose id set is the same, or that
    reaches the cut-off at k. Raises AssertionError otherwise."""
    import numpy as np

    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    if ids_a.shape != ids_b.shape or s_a.shape != s_b.shape:
        raise AssertionError(f"shapes {ids_a.shape} vs {ids_b.shape}")
    if not (np.isfinite(s_a).all() and np.isfinite(s_b).all()):
        raise AssertionError("non-finite scores")
    err = float(np.abs(s_a - s_b).max()) if s_a.size else 0.0
    if err > atol:
        raise AssertionError(f"scores differ by {err} > {atol}")
    rows = np.nonzero((ids_a != ids_b).any(axis=1))[0]
    for r in rows:
        s = s_b[r]
        start = 0
        for j in range(1, len(s) + 1):
            if j == len(s) or abs(s[j] - s[j - 1]) > atol:
                if (set(ids_a[r, start:j].tolist())
                        != set(ids_b[r, start:j].tolist()) and j != len(s)):
                    raise AssertionError(
                        f"row {r}: ids differ outside a score tie at "
                        f"positions {start}..{j - 1}")
                start = j
    return err, [int(r) for r in rows]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def gold_metrics(engine, samples, ids):
    """(supporting-fact recall@10, MRR, [recall@10 of the hop-1 fact, of
    the hop-2 fact]) of hit ids [B >= len(samples), K], through the repo's
    own eval helpers."""
    import numpy as np

    from a_modular_rag_framework_torch.eval.harness import gold_hit_ids
    from a_modular_rag_framework_torch.eval.metrics import mrr, recall_at_k

    rec, rr, hops = [], [], [[], []]
    for row, sample in enumerate(samples):
        got = [engine.index.corpus.hit_id(int(i)) for i in ids[row] if i >= 0]
        gold = gold_hit_ids(sample)
        rec.append(recall_at_k(got, gold, 10))
        rr.append(mrr(got, gold))
        for hop, g in enumerate(gold[:2]):
            hops[hop].append(recall_at_k(got, [g], 10))
    return (float(np.mean(rec)), float(np.mean(rr)),
            [round(float(np.mean(h)), 4) for h in hops])


def card_vs_cpu(tag, ids_gpu, s_gpu, ids_cpu, s_cpu, atol):
    """compare_topk, failing the phase on a mismatch; logs tie rows."""
    try:
        err, rows = compare_topk(ids_gpu, s_gpu, ids_cpu, s_cpu, atol)
    except AssertionError as e:
        fail(f"{tag} card vs CPU: {e}")
    n = len(ids_gpu)
    for r in rows:
        log(f"[{tag}]   row {r} differs only inside a score tie: card "
            f"{ids_gpu[r].tolist()} vs cpu {ids_cpu[r].tolist()}")
    log(f"[{tag}] card vs CPU on {n} questions: {n - len(rows)} rows with "
        f"identical ids, {len(rows)} differing only inside exact score "
        f"ties; max |ds| {err:.3g} (atol {atol})")


def card_vs_cpu_learned(tag, ids_gpu, s_gpu, ids_cpu, s_cpu, atol,
                        min_overlap=LEARNED_MIN_OVERLAP):
    """Card vs CPU for a bf16-compute model: the k best scores of each row
    agree within ``atol`` position by position, and the id sets overlap by
    at least ``min_overlap`` on average; rows that pass `compare_topk`
    (ids equal wherever scores are separated by more than ``atol``) are
    counted."""
    import numpy as np

    ids_gpu, ids_cpu = np.asarray(ids_gpu), np.asarray(ids_cpu)
    s_gpu, s_cpu = np.asarray(s_gpu), np.asarray(s_cpu)
    if ids_gpu.shape != ids_cpu.shape or not np.isfinite(s_gpu).all():
        fail(f"{tag} card vs CPU: shapes {ids_gpu.shape} vs {ids_cpu.shape} "
             f"or non-finite scores")
    err = float(np.abs(s_gpu - s_cpu).max())
    overlap = float(np.mean([
        len(set(a[a >= 0]) & set(b[b >= 0])) / max(1, int((b >= 0).sum()))
        for a, b in zip(ids_gpu, ids_cpu)]))
    strict = 0
    for r in range(len(ids_gpu)):
        try:
            compare_topk(ids_gpu[r:r + 1], s_gpu[r:r + 1], ids_cpu[r:r + 1],
                         s_cpu[r:r + 1], atol)
            strict += 1
        except AssertionError:
            pass
    same = int((ids_gpu == ids_cpu).all(axis=1).sum())
    log(f"[{tag}] card vs CPU on {len(ids_gpu)} questions: max |ds| "
        f"{err:.3g} (atol {atol}), mean top-k id overlap {overlap:.4f} "
        f"(floor {min_overlap}), {same} rows with identical ids, {strict} "
        f"rows whose ids differ only inside score groups within atol")
    if err > atol:
        fail(f"{tag} card vs CPU: scores differ by {err} > {atol}")
    if overlap < min_overlap:
        fail(f"{tag} card vs CPU: id overlap {overlap} < {min_overlap}")


def hash_kernel_at_shape(H, texts, dev, smi):
    """The hash kernel at the dense path's shape (one batch of questions,
    d 64, 256 features): held bit for bit against the plain version (on the
    host), then its device time a launch from a profiler trace of
    HASH_REPS launches (a launch is shorter than the host's time to queue
    the next, so events around a loop would time the host), beside its
    bound: the text and offsets read once and the f32 rows written once."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from a_modular_rag_framework_torch._host import to_device
    from a_modular_rag_framework_torch.models.hash_embed import pack_texts

    data, offsets = pack_texts(texts)
    d_t, o_t = to_device(data, dev), to_device(offsets, dev)
    rows = H.hash_embed_cuda(d_t, o_t, 64, 256).cpu().numpy()
    t0 = time.perf_counter()
    ref = H.hash_embed_reference(torch.from_numpy(data.copy()),
                                 torch.from_numpy(offsets), 64, 256).numpy()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not np.array_equal(rows.view(np.int32), ref.view(np.int32)):
        fail("the hash kernel's rows differ from its plain version's at the "
             "dense path's shape")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(HASH_REPS):
            H.hash_embed_cuda(d_t, o_t, 64, 256)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "hash_embed_kernel" in e.key]
    if not ev or ev[0].count != HASH_REPS:
        fail(f"the profiler's trace holds {ev[0].count if ev else 0} "
             f"hash_embed_kernel launches, not {HASH_REPS}")
    ms = ev[0].device_time_total / ev[0].count / 1e3
    nbytes = data.size + offsets.size * 4 + len(texts) * 64 * 4
    bound = nbytes / PEAK_BYTES * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes", "max_abs_err": 0.0,
           "shape": f"B{len(texts)} d64 f256, {data.size} text bytes"}
    log(f"[dense] hash kernel at {out['shape']}: {ms * 1e3:.2f} us a launch "
        f"(device time, mean of {HASH_REPS}), plain version (host, Python) "
        f"{plain_ms:.1f} ms, rows bit for bit equal; bound {bound * 1e3:.3f} "
        f"us (bytes), share {bound / ms:.3f} ({smi})")
    return out


def kernel_at_shape(T, q, emb, k, smi, tag):
    """The kernel at one of the main path's shapes: held against the plain
    version (in 256-row chunks: the plain [4096, N] f32 matrix and its sort
    would need ~70 GB), then timed in turns beside it and beside one
    PyTorch call per 1024 questions (the yardstick ``library_ms``)."""
    import torch

    s, i = T.dense_topk_cuda(q, emb, k)

    def plain_chunked():
        outs = [T.dense_topk_reference(q[c: c + 256], emb, k)
                for c in range(0, q.shape[0], 256)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    s_ref, i_ref = plain_chunked()
    try:
        err, rows = compare_topk(i.cpu(), s.cpu(), i_ref.cpu(), s_ref.cpu(),
                                 SCORE_ATOL)
    except AssertionError as e:
        fail(f"dense kernel at the {tag} shape: {e}")

    def library():
        return [torch.topk(q[c: c + 1024] @ emb.float().T, k)
                for c in range(0, q.shape[0], 1024)]

    p1 = cuda_ms(plain_chunked, 2)
    l1 = cuda_ms(library, 3)
    k1 = cuda_ms(lambda: T.dense_topk_cuda(q, emb, k), 5)
    k2 = cuda_ms(lambda: T.dense_topk_cuda(q, emb, k), 5)
    l2 = cuda_ms(library, 3)
    p2 = cuda_ms(plain_chunked, 2)
    B, d = q.shape
    n = emb.shape[0]
    nbytes = emb.numel() * emb.element_size()
    bound, bound_by = bound_ms(B, n, d, k, nbytes)
    single_pass, _ = bound_ms(B, n, d, k, nbytes, passes=1)
    out = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
           "library_ms": min(l1, l2), "bound_ms": bound,
           "bound_by": bound_by, "max_abs_err": err, "ids": i,
           "shape": f"B{B} N{n} d{d} k{k} bf16"}
    log(f"[{tag}] kernel at {out['shape']}: {out['ms']:.3f} ms"
        f" ({k1:.3f} / {k2:.3f}), plain (16 x 256-row chunks) "
        f"{out['plain_ms']:.3f} ms, library (torch.topk(q @ emb.float().T) "
        f"in 1024-row chunks) {out['library_ms']:.3f} ms; bound {bound:.3f} "
        f"ms ({bound_by}; {BF16_PASSES} bf16 passes; one pass "
        f"{single_pass:.3f} ms), share {bound / out['ms']:.3f}; "
        f"{len(rows)} rows differ only inside exact score ties; max |ds| "
        f"{err:.3g} ({smi})")
    return out


def close_engine(engine) -> None:
    """Stop the engine's worker threads (query prep and iterative prep)."""
    engine.close()
    pool = getattr(engine, "_mh_prep_pool", None)
    if pool is not None:
        pool.shutdown(wait=True)
        engine._mh_prep_pool = None


def iterative_phase(engine, cpu_engine, samples, batches, single_recall,
                    smi):
    """Phase 7: iterative 2-hop on the card engine, then card vs CPU."""
    import numpy as np

    from a_modular_rag_framework_torch.modules.retrieval import multihop

    single = np.concatenate([engine.query_batch(b).hits.ids for b in batches])
    # warm-up: the native bridge's corpus registration and the title and
    # doc-run caches are built once per index
    t0 = time.time()
    multihop.iterative_retrieve(engine, batches[0], top_k=10)
    log(f"[iterative] warm-up (bridge registration + caches) "
        f"{time.time() - t0:.2f}s")
    t0 = time.time()
    outs = [multihop.iterative_retrieve(engine, b, top_k=10)
            for b in batches]
    seq_sec = time.time() - t0
    t0 = time.time()
    piped = list(multihop.iterative_retrieve_pipelined(engine, batches,
                                                       top_k=10))
    pipe_sec = time.time() - t0
    n_q = sum(len(b) for b in batches)
    ids = np.concatenate([o[0] for o in outs])
    for o, p, b in zip(outs, piped, batches):
        if o[0].shape != (len(b), 10) or not np.isfinite(o[1]).all():
            fail(f"iterative output shape {o[0].shape} or non-finite scores")
        if not (np.array_equal(o[0], p[0]) and np.array_equal(o[1], p[1])):
            fail("iterative_retrieve_pipelined differs from iterative_retrieve")
    recall, mrr, hops = gold_metrics(engine, samples[:n_q], ids)
    _, _, single_hops = gold_metrics(engine, samples[:n_q], single)
    active = sum(o[3]["hop2_active"] for o in outs)
    native = multihop._NATIVE_BRIDGES.get(engine.index) is not None
    log(f"[iterative] iterative_retrieve over {n_q} questions (B {BATCH}): "
        f"recall@10 {recall:.4f}, MRR {mrr:.4f}, hop2_active {active}/{n_q}, "
        f"native bridge loaded: {native}; {n_q / seq_sec:.1f} q/s "
        f"synchronous ({smi})")
    log(f"[iterative] iterative_retrieve_pipelined: {n_q / pipe_sec:.1f} q/s "
        f"({pipe_sec:.3f}s for {n_q}) ({smi})")
    log(f"[iterative] recall@10 by fact (hop-1, hop-2): single-pass "
        f"{single_hops}, iterative {hops}; single-pass overall "
        f"{single_recall:.4f}")
    if recall < single_recall - ITERATIVE_RECALL_SLACK:
        fail(f"iterative recall@10 {recall} < single-pass {single_recall} "
             f"- {ITERATIVE_RECALL_SLACK}")

    qs = batches[0][:CPU_QUESTIONS]
    g = multihop.iterative_retrieve(engine, qs, top_k=10)
    c = multihop.iterative_retrieve(cpu_engine, qs, top_k=10)
    same_q = sum(a == b for a, b in zip(g[3]["hop2_queries"],
                                        c[3]["hop2_queries"]))
    log(f"[iterative] hop-2 queries identical card vs CPU: {same_q}/"
        f"{len(qs)}")
    card_vs_cpu("iterative", g[0], g[1], c[0], c[1], HYBRID_ATOL)
    return {"recall": recall, "mrr": mrr, "recall_by_fact": hops,
            "single_recall_by_fact": single_hops, "qps": n_q / seq_sec,
            "pipelined_qps": n_q / pipe_sec, "native": native}


def server_phase(engine, questions, smi):
    """Phase 8: QueryServer under client threads; results == direct."""
    import numpy as np

    from a_modular_rag_framework_torch.engine.server import QueryServer
    from a_modular_rag_framework_torch.modules.retrieval import multihop

    # per client: one submit_many of 512 single-mode questions, 16 singles,
    # one submit_many of 128 questions in iterative mode
    plan = []
    for c in range(SERVER_CLIENTS):
        base = c * 656
        plan.append((questions[base: base + 512],
                     questions[base + 512: base + 528],
                     questions[base + 528: base + 656]))
    lat: list = []  # submit -> resolution, per request (list.append is atomic)
    results: dict = {}
    lock = threading.Lock()
    errors: list = []

    def timed(fut):
        ts = time.time()
        fut.add_done_callback(lambda _f: lat.append(time.time() - ts))
        return fut

    def client(c, server):
        try:
            many, singles, iters = plan[c]
            f_many = timed(server.submit_many(many))
            f_single = [(q, timed(server.submit(q))) for q in singles]
            f_iter = timed(server.submit_many(iters, mode="iterative",
                                              top_k=10))
            got = {("single", q): hits
                   for q, hits in zip(many, f_many.result(600))}
            for q, f in f_single:
                got[("single", q)] = f.result(600)
            for q, hits in zip(iters, f_iter.result(600)):
                got[("iterative", q)] = hits
            with lock:
                results.update(got)
        except Exception as e:  # reported by the main thread
            errors.append(repr(e))

    with QueryServer(engine, max_batch=BATCH, max_wait_ms=5) as server:
        threads = [threading.Thread(target=client, args=(c, server))
                   for c in range(SERVER_CLIENTS)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.time() - t0
        stats = dict(server.stats)
    if errors or any(t.is_alive() for t in threads):
        fail(f"server clients failed: {errors[:3]}")

    # the direct calls on the same questions
    single_qs = [q for m, s, _ in plan for q in m + s]
    iter_qs = [q for _, _, it in plan for q in it]
    corpus = engine.index.corpus
    mismatch, max_ds = 0, 0.0

    def check(hits, ids, scores):
        nonlocal mismatch, max_ds
        keep = ids >= 0
        mismatch += [h.id for h in hits] != [corpus.hit_id(int(x))
                                              for x in ids[keep]]
        if len(hits) == int(keep.sum()):
            max_ds = max(max_ds, float(np.abs(
                np.asarray([h.score for h in hits]) - scores[keep]).max(
                initial=0.0)))

    for i in range(0, len(single_qs), BATCH):
        chunk = single_qs[i: i + BATCH]
        r = engine.query_batch(chunk)
        for q, ids, sc in zip(chunk, r.hits.ids, r.hits.scores):
            check(results[("single", q)], ids, sc)
    it = multihop.iterative_retrieve(engine, iter_qs, top_k=10)
    for q, ids, sc in zip(iter_qs, it[0], it[1]):
        check(results[("iterative", q)], ids, sc)
    n_q = len(single_qs) + len(iter_qs)
    if max_ds > 1e-6:
        fail(f"QueryServer: scores differ from the direct call by {max_ds}")
    if mismatch:
        fail(f"QueryServer: {mismatch} of {n_q} results differ from the "
             f"direct call")
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p50 = float(lat_ms[int(0.50 * (lat_ms.size - 1))])
    p99 = float(lat_ms[int(0.99 * (lat_ms.size - 1))])
    log(f"[server] {SERVER_CLIENTS} client threads, {n_q} questions "
        f"({len(single_qs)} single, {len(iter_qs)} iterative) in "
        f"{len(lat)} requests, {stats['batches']} engine batches: "
        f"{n_q / wall:.1f} completed q/s, request latency p50 {p50:.1f} ms, "
        f"p99 {p99:.1f} ms; all {n_q} results equal the direct call (ids "
        f"identical, max |ds| {max_ds:.3g}) ({smi})")
    return {"qps": n_q / wall, "p50_ms": p50, "p99_ms": p99}


def headline_phase(loader, dev, smi):
    """Phase 9: the dense [B, N] form at bench.py's headline config."""
    import numpy as np

    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                     build_packed_index)
    from a_modular_rag_framework_torch.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_torch.modules.retrieval import multihop

    t0 = time.time()
    samples = loader.SyntheticHotpotQALoader(
        {"count": HEADLINE_SAMPLES, "seed": 0, "n_distractors": 8,
         "unique_entities": True}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=64, embed_dtype="bfloat16")
    log(f"[headline] {idx.n_docs} rows built in {time.time() - t0:.1f}s "
        f"(host); graph degree "
        f"{idx.graph_next.shape[1] + idx.graph_entity.shape[1]}")
    engine = TorchQueryEngine(idx, device=dev,
                              config=EngineConfig(**HEADLINE_CONFIG))
    questions = [s["question"] for s in samples]
    qs = (questions * (HEADLINE_BATCH // len(questions) + 1))[:HEADLINE_BATCH]
    r = engine.query_batch(qs)  # warm-up
    multihop.iterative_retrieve(engine, qs, top_k=10)
    form = r.diagnostics["graph_impl"]
    if form != "dense":
        fail(f"graph_impl='auto' took the {form} form at B "
             f"{HEADLINE_BATCH} x N {idx.n_docs}")
    quality = evaluate_retrieval(engine, samples, k=10,
                                 batch_size=HEADLINE_BATCH)
    t0 = time.time()
    list(engine.query_batches_pipelined([qs] * 4))
    pipe_sec = time.time() - t0
    t0 = time.time()
    it = multihop.iterative_retrieve(engine, qs, top_k=10)
    it_sec = time.time() - t0
    t0 = time.time()
    list(multihop.iterative_retrieve_pipelined(engine, [qs] * 4, top_k=10))
    it_pipe_sec = time.time() - t0
    it_recall, it_mrr, _ = gold_metrics(engine, samples, it[0])
    log(f"[headline] auto took the dense [B, N] form (B {HEADLINE_BATCH} x N "
        f"{idx.n_docs}): evaluate_retrieval recall@10 "
        f"{quality['recall_at_10']:.4f}, MRR {quality['mrr']:.4f} over "
        f"{quality['n']} questions; pipelined "
        f"{4 * HEADLINE_BATCH / pipe_sec:.1f} q/s ({smi})")
    log(f"[headline] iterative: recall@10 {it_recall:.4f}, MRR "
        f"{it_mrr:.4f}, hop2_active {it[3]['hop2_active']}/{len(qs)}; "
        f"{len(qs) / it_sec:.1f} q/s synchronous, "
        f"{4 * HEADLINE_BATCH / it_pipe_sec:.1f} q/s pipelined ({smi})")
    if not (np.isfinite(it[1]).all() and quality["n"] == len(samples)):
        fail("headline: non-finite iterative scores or short evaluation")
    if it_recall < quality["recall_at_10"]:
        fail(f"headline iterative recall@10 {it_recall} < single-pass "
             f"{quality['recall_at_10']}")

    cpu = TorchQueryEngine(idx, device="cpu", config=EngineConfig(
        **dict(HEADLINE_CONFIG, batch_buckets=(CPU_QUESTIONS,))))
    q64 = questions[:CPU_QUESTIONS]
    r_gpu, r_cpu = engine.query_batch(q64), cpu.query_batch(q64)
    if r_cpu.diagnostics["graph_impl"] != "dense":
        fail("headline: the CPU engine did not take the dense form")
    card_vs_cpu("headline", r_gpu.hits.ids, r_gpu.hits.scores,
                r_cpu.hits.ids, r_cpu.hits.scores, HYBRID_ATOL)
    g = multihop.iterative_retrieve(engine, q64, top_k=10)
    c = multihop.iterative_retrieve(cpu, q64, top_k=10)
    card_vs_cpu("headline iterative", g[0], g[1], c[0], c[1], HYBRID_ATOL)
    close_engine(engine)
    return {"recall": quality["recall_at_10"], "it_recall": it_recall,
            "rows": idx.n_docs}


class TimedEncoder:
    """An encoder's fused seam with the host featurize seconds summed and
    a CUDA event pair around every device call."""

    def __init__(self, enc):
        import torch

        self._torch = torch
        self.enc, self.device, self.dim = enc, enc.device, enc.dim
        self.host_sec = 0.0
        self.events = []

    def host_featurize(self, texts):
        t0 = time.time()
        out = self.enc.host_featurize(texts)
        self.host_sec += time.time() - t0
        return out

    def device_embed(self, ids, mask):
        a = self._torch.cuda.Event(enable_timing=True)
        b = self._torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.enc.device_embed(ids, mask)
        b.record()
        self.events.append((a, b))
        return out

    def device_sec(self) -> float:
        self._torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def learned_dense_phase(T, idx, cache, eval_samples, batches, hash_quality,
                        hash_dense, dev, smi):
    """Phase 10: the learned TextEncoder's sidecar, the dense-only path
    (the kernel at d 128) and the hybrid path with the learned encoder.
    Swaps ``idx``'s embeddings for the sidecar, in place."""
    import numpy as np
    import torch

    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_torch.index import (
        attach_learned_embeddings, embed_corpus_pipelined,
        save_learned_embeddings)
    from a_modular_rag_framework_torch.models import (EncoderConfig,
                                                      TextEncoder)

    ckpt = "data/encoder_collide.npz"  # repo-relative, as the sidecar names it
    cfg = EncoderConfig(**LEARNED_ENCODER)
    enc = TextEncoder.load(str(REPO / ckpt), cfg, device=dev)
    texts = idx.corpus.texts()
    embed_corpus_pipelined(enc, texts[:BATCH], batch=BATCH)  # warm-up
    timed = TimedEncoder(enc)
    torch.cuda.synchronize()
    t0 = time.time()
    emb = embed_corpus_pipelined(timed, texts, batch=BATCH)
    wall = time.time() - t0
    dev_sec = timed.device_sec()
    if emb.shape != (idx.n_docs, cfg.d_model) or not np.isfinite(emb).all():
        fail(f"learned embeddings: shape {emb.shape} or non-finite values")
    log(f"[learned] embed_corpus_pipelined: {idx.n_docs} rows in {wall:.2f}s "
        f"= {idx.n_docs / wall:.1f} rows/s (batch {BATCH}); host tokenize "
        f"{timed.host_sec:.2f}s, device {dev_sec:.2f}s (CUDA events), the "
        f"rest fetch and concatenation ({smi})")
    t0 = time.time()
    save_learned_embeddings(cache, emb, ckpt, cfg)
    attached = attach_learned_embeddings(idx, cache, device=dev)
    if attached is None:
        fail("the sidecar just written did not attach")
    q_enc, doc = attached
    log(f"[learned] sidecar written to {cache.relative_to(REPO)} and "
        f"attached in {time.time() - t0:.2f}s: {doc['rows']} rows x "
        f"{doc['dim']} {doc['embed_dtype']}")
    del emb

    engine = TorchQueryEngine(idx, device=dev, encoder=q_enc,
                              config=EngineConfig(**SCALE_CONFIG))
    engine.query_batch(batches[0])  # warm-up
    engine.query_dense_batch(batches[0])
    # this path's run: counts from 0, read right after
    T.dense_topk_cuda.launches = 0
    t0 = time.time()
    dense_res = [engine.query_dense_batch(b, top_k=10) for b in batches]
    dense_sec = time.time() - t0
    quality = evaluate_retrieval(engine, eval_samples, k=10, batch_size=BATCH)
    launches = T.dense_topk_cuda.launches
    n_q = len(eval_samples)
    for b, r in zip(batches, dense_res):
        if r.hits.ids.shape != (len(b), 10) or not np.isfinite(
                r.hits.scores).all():
            fail(f"learned dense output {r.hits.ids.shape} or non-finite")
    if launches < 1:
        fail("the learned dense-only path never launched the kernel")
    dense = gold_metrics(engine, eval_samples,
                         np.concatenate([r.hits.ids for r in dense_res]))
    log(f"[learned] query_dense_batch (d 128): {n_q / dense_sec:.1f} q/s "
        f"over {n_q} questions (B {BATCH}, host tokenize + encoder + kernel "
        f"+ fetch), kernel launches {launches}; recall@10 {dense[0]:.4f}, "
        f"MRR {dense[1]:.4f} (hash encoder d 64: {hash_dense[0]:.4f}, "
        f"{hash_dense[1]:.4f}) ({smi})")
    log(f"[learned] query_batch with the learned encoder: recall@10 "
        f"{quality['recall_at_10']:.4f}, MRR {quality['mrr']:.4f}, "
        f"{quality['qps']} q/s (harness) (hash encoder: "
        f"{hash_quality['recall_at_10']:.4f}, {hash_quality['mrr']:.4f}, "
        f"{hash_quality['qps']} q/s)")
    if quality["n"] != n_q or not quality["recall_at_10"] > 0.5:
        fail(f"learned hybrid recall {quality['recall_at_10']}")
    if not dense[0] > hash_dense[0]:
        fail(f"learned dense-only recall@10 {dense[0]} is not above the "
             f"hash encoder's {hash_dense[0]}")

    q = engine.embed_dense_queries(batches[0])
    kern = kernel_at_shape(T, q, engine._emb, 10, smi, "learned")
    np.testing.assert_array_equal(dense_res[0].hits.ids,
                                  kern["ids"].cpu().numpy())
    del q

    qs = batches[0][:CPU_QUESTIONS]
    g_hybrid = engine.query_batch(qs)
    cpu_enc = TextEncoder.load(str(REPO / ckpt), cfg, device="cpu")
    cpu_engine = TorchQueryEngine(
        idx, device="cpu", encoder=cpu_enc, config=EngineConfig(**dict(
            SCALE_CONFIG, graph_impl=g_hybrid.diagnostics["graph_impl"],
            batch_buckets=(CPU_QUESTIONS,))))
    e_gpu = q_enc.encode_texts(qs)
    e_cpu = cpu_enc.encode_texts(qs)
    e_err = float(np.abs(e_gpu - e_cpu).max())
    log(f"[learned] query embeddings card vs CPU: max |de| {e_err:.3g} "
        f"(atol {LEARNED_ATOL})")
    if e_err > LEARNED_ATOL:
        fail(f"learned embeddings differ by {e_err} card vs CPU")
    g, c = engine.query_dense_batch(qs, top_k=10), cpu_engine.query_dense_batch(
        qs, top_k=10)
    card_vs_cpu_learned("learned dense", g.hits.ids, g.hits.scores,
                        c.hits.ids, c.hits.scores, LEARNED_ATOL)
    g, c = g_hybrid, cpu_engine.query_batch(qs)
    card_vs_cpu_learned("learned hybrid", g.hits.ids, g.hits.scores,
                        c.hits.ids, c.hits.scores, LEARNED_ATOL)
    del cpu_engine
    kern.update(launches=launches, qps=n_q / dense_sec,
                recall=dense[0], mrr=dense[1],
                hybrid_recall=quality["recall_at_10"],
                hybrid_mrr=quality["mrr"], embed_rows_per_sec=idx.n_docs / wall,
                embed_host_sec=timed.host_sec, embed_device_sec=dev_sec)
    return engine, kern


def splade_phase(loader, main_idx, main_samples, dev, smi):
    """Phase 11: the engine's learned-sparse channel."""
    import numpy as np
    import torch

    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_torch.models import SpladeEncoder
    from a_modular_rag_framework_torch.ops.splade import (SpladeDeviceIndex,
                                                          SpladeRetriever)

    ckpt = str(REPO / "data" / "splade_variety.npz")
    n_samples = min(len(main_samples), SPLADE_SAMPLES)
    if n_samples < len(main_samples):
        # the expansion of 1,034,000 rows keeps 128 terms a row: the host
        # CSR assembly (a lexsort of ~132M postings, then their doc-major
        # inversion) would take longer than every other phase together
        log(f"[splade] corpus: {SPLADE_SAMPLES} samples, not "
            f"the {main_idx.n_docs}-row one: the host CSR assembly of its "
            f"~{main_idx.n_docs * 128 // 1_000_000}M postings (numpy lexsort) "
            f"does not fit this run's time")
    # from the cache: the main index in memory now holds the learned
    # embeddings of phase 10, this phase wants the hash encoder's
    cache = index_cache(n_samples)
    samples, idx = collide_index(loader, n_samples)
    sp_enc = SpladeEncoder.load(ckpt, device=dev)
    ecfg = sp_enc.cfg.encoder
    log(f"[splade] {Path(ckpt).name}: d {ecfg.d_model}, L {ecfg.max_len}, "
        f"vocab {ecfg.vocab_size}, {ecfg.n_layers} layers, "
        f"{ecfg.subword_ngrams} subword features, {sp_enc.cfg.doc_top_terms} "
        f"doc / {sp_enc.cfg.query_top_terms} query terms; corpus "
        f"{idx.n_docs} rows")
    texts = idx.corpus.texts()
    r = SpladeRetriever(sp_enc, build_batch=BATCH)
    sp_enc.expand_texts(texts[:BATCH], k=sp_enc.cfg.doc_top_terms)  # warm-up
    torch.cuda.synchronize()
    sp_index = r.build(texts)
    st = r.build_stats
    sp_index.save(str(cache / "splade_index.npz"))
    back = SpladeDeviceIndex.load(str(cache / "splade_index.npz"))
    if not (np.array_equal(back.doc_ids, sp_index.doc_ids)
            and np.array_equal(back.row_ptr, sp_index.row_ptr)):
        fail("splade_index.npz did not round-trip")
    log(f"[splade] corpus expansion on the card: {idx.n_docs} docs in "
        f"{st['expand_sec']:.2f}s = {idx.n_docs / st['expand_sec']:.1f} "
        f"docs/s (batch {BATCH}, host tokenize + trunk + head + top-"
        f"{sp_enc.cfg.doc_top_terms} + fetch); host CSR assembly of "
        f"{sp_index.doc_ids.shape[0]} postings {st['assemble_sec']:.2f}s; "
        f"cached as {(cache / 'splade_index.npz').relative_to(REPO)} ({smi})")
    del r

    # bm25_term_topm 128: a subword bucket's posting list is long, and the
    # 16-posting window of the BM25 operating point would cut it short
    base = dict(SCALE_CONFIG, bm25_term_topm=128)
    sp_cfg = dict(base, sparse_impl="splade", splade_weights=ckpt)
    text_only = dict(alpha_text=1.0, alpha_graph=0.0, alpha_dense=0.0,
                     order_alphas=None)
    n_eval = min(len(samples), HYBRID_BATCHES * BATCH)
    eval_samples = samples[:n_eval]
    out = {}
    for name, cfg, kw in (
            ("splade, text channel only", dict(sp_cfg, **text_only),
             {"splade_index": sp_index}),
            ("bm25, text channel only", dict(base, **text_only), {}),
            ("splade in the full hybrid", sp_cfg,
             {"splade_index": sp_index})):
        engine = TorchQueryEngine(idx, device=dev, config=EngineConfig(**cfg),
                                  **kw)
        engine.query_batch([s["question"] for s in eval_samples[:BATCH]])
        torch.cuda.synchronize()
        qual = evaluate_retrieval(engine, eval_samples, k=10,
                                  batch_size=BATCH)
        out[name] = qual
        log(f"[splade] {name}: recall@10 {qual['recall_at_10']:.4f}, MRR "
            f"{qual['mrr']:.4f}, {qual['qps']} q/s over {qual['n']} questions "
            f"(B {BATCH}, harness) ({smi})")
        if qual["n"] != n_eval:
            fail(f"{name}: evaluated {qual['n']} of {n_eval}")
        if name != "splade in the full hybrid":
            del engine
    if not out["splade, text channel only"]["recall_at_10"] > 0.05:
        fail("the SPLADE channel retrieves nothing")

    qs = [s["question"] for s in samples[:CPU_QUESTIONS]]
    g = engine.query_batch(qs)
    cpu = TorchQueryEngine(idx, device="cpu", config=EngineConfig(**dict(
        sp_cfg, graph_impl=g.diagnostics["graph_impl"],
        batch_buckets=(CPU_QUESTIONS,))), splade_index=sp_index)
    w_gpu = sp_enc.dense_expand(qs)
    w_cpu = cpu._splade_enc.dense_expand(qs)
    w_err = float(np.abs(w_gpu - w_cpu).max())
    log(f"[splade] query expansion weights card vs CPU: max |dw| {w_err:.3g} "
        f"(atol {LEARNED_ATOL})")
    if w_err > LEARNED_ATOL:
        fail(f"SPLADE weights differ by {w_err} card vs CPU")
    c = cpu.query_batch(qs)
    card_vs_cpu_learned("splade", g.hits.ids, g.hits.scores, c.hits.ids,
                        c.hits.scores, SPLADE_ATOL)
    close_engine(engine)
    return {"rows": idx.n_docs, "docs_per_sec": idx.n_docs / st["expand_sec"],
            "assemble_sec": st["assemble_sec"],
            **{k: {"recall": v["recall_at_10"], "mrr": v["mrr"],
                   "qps": v["qps"]} for k, v in out.items()}}


def stage_ms(fn) -> dict:
    """Device ms per engine/<stage> profiler range of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: round(e.device_time_total / 1e3, 3)
            for e in prof.key_averages() if e.key.startswith("engine/")}


def sharded_phase(loader, T, samples, dev, smi):
    """Phase 16: the sharded paths on SHARDS virtual shards of the card."""
    import numpy as np
    import torch

    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.engine.server import QueryServer
    from a_modular_rag_framework_torch.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_torch.index import PackedIndex
    from a_modular_rag_framework_torch.models import EncoderConfig
    from a_modular_rag_framework_torch.models import encoder as enc
    from a_modular_rag_framework_torch.models.optim import (clone_tree,
                                                            value_and_grad)
    from a_modular_rag_framework_torch.models.params import (load_params,
                                                             tree_leaves)
    from a_modular_rag_framework_torch.modules.retrieval import multihop
    from a_modular_rag_framework_torch.ops.bm25 import bm25_topk_sorted
    from a_modular_rag_framework_torch.ops.splade import SpladeDeviceIndex
    from a_modular_rag_framework_torch.models import SpladeEncoder
    from a_modular_rag_framework_torch.parallel import (
        ShardedDenseEngine, ShardedHybridEngine, build_mesh,
        shard_splade_postings, sharded_splade_topk)
    from a_modular_rag_framework_torch.parallel import train as tp
    from a_modular_rag_framework_torch.parallel.dryrun import dryrun_multichip
    from a_modular_rag_framework_torch.parallel.sharded import merge_topk

    devices = [dev] * SHARDS
    mesh = build_mesh({"data": SHARDS}, devices=devices)
    idx = PackedIndex.load(index_cache(len(samples)))
    qs = [s["question"] for s in samples[: HYBRID_BATCHES * BATCH]]
    batches = [qs[i: i + BATCH] for i in range(0, len(qs), BATCH)]
    out = {"shards": SHARDS}

    # ---- sharded dense: ShardedDenseEngine against query_dense_batch ----
    single = TorchQueryEngine(idx, device=dev,
                              config=EngineConfig(**SCALE_CONFIG))
    dense_eng = ShardedDenseEngine(idx, mesh=mesh, batch_buckets=(BATCH,))
    want = [single.query_dense_batch(b, top_k=10) for b in batches]
    dense_eng.query_batch(batches[0])  # warm-up
    torch.cuda.synchronize()
    T.dense_topk_cuda.launches = 0
    t0 = time.time()
    got = [dense_eng.query_batch(b, top_k=10) for b in batches]
    dense_sec = time.time() - t0
    launches = T.dense_topk_cuda.launches
    err = 0.0
    for w, g in zip(want, got):
        if not np.array_equal(w.hits.ids, g.ids):
            fail("sharded dense ids differ from query_dense_batch")
        err = max(err, float(np.abs(w.hits.scores - g.scores).max()))
    if err > 1e-6:
        fail(f"sharded dense scores differ by {err} > 1e-6")
    if launches != SHARDS * len(batches):
        fail(f"sharded dense: {launches} kernel launches, want "
             f"{SHARDS * len(batches)} (one per shard per batch)")
    q = dense_eng.embed_queries(batches[0])
    rows = dense_eng.rows
    per_shard = [cuda_ms(lambda e=e: T.dense_topk_cuda(q, e, 10), 5)
                 for e in rows.shards]
    one = cuda_ms(lambda: T.dense_topk_cuda(q, single._emb, 10), 5)
    parts = [T.dense_topk_cuda(q, e, 10) for e in rows.shards]
    merge = cuda_ms(lambda: merge_topk(
        [p[0] for p in parts], [p[1] + b for p, b in zip(parts, rows.bases)],
        10, dev), 5)
    kern = kernel_at_shape(T, q, rows.shards[0], 10, smi, "sharded")
    log(f"[sharded] dense: {SHARDS} shards of {rows.shards[0].shape[0]} rows, "
        f"{len(qs)} questions: ids identical to query_dense_batch, max |ds| "
        f"{err:.3g}; {len(qs) / dense_sec:.1f} q/s; kernel per shard "
        f"{[round(m, 3) for m in per_shard]} ms, sum {sum(per_shard):.3f} ms "
        f"against one launch over {idx.n_docs} rows {one:.3f} ms; merge "
        f"{merge:.3f} ms; {launches} kernel launches ({smi})")
    out["dense"] = {"qps": len(qs) / dense_sec, "shard_ms": per_shard,
                    "shard_sum_ms": sum(per_shard), "single_ms": one,
                    "merge_ms": merge, "launches": launches}
    del dense_eng, parts, q

    # ---- sharded hybrid at the scale operating point ----
    single_bytes = single.device_bytes()
    single.query_batch(batches[0])
    torch.cuda.synchronize()
    single_q = evaluate_retrieval(single, samples[: len(qs)], k=10,
                                  batch_size=BATCH)
    single_stages = stage_ms(lambda: single.query_batch(batches[0]))
    single_first = single.query_batch(batches[0])
    single.close()
    del single
    torch.cuda.empty_cache()
    # one shard: the sharded program with the single engine's phase-1
    # windows, which must give its hits exactly
    one = ShardedHybridEngine(idx, mesh=build_mesh({"data": 1}, devices=[dev]),
                              config=EngineConfig(**SCALE_CONFIG))
    r1 = one.query_batch(batches[0])
    one_err = float(np.abs(r1.hits.scores - single_first.hits.scores).max())
    if not np.array_equal(r1.hits.ids, single_first.hits.ids) or (
            one_err > HYBRID_ATOL):
        fail(f"one-shard ShardedHybridEngine differs from the single engine "
             f"(max |ds| {one_err})")
    log(f"[sharded] one shard over all {idx.n_docs} rows: {BATCH} questions "
        f"with ids identical to the single engine's, max |ds| {one_err:.3g}")
    close_engine(one)
    del one, r1
    torch.cuda.empty_cache()
    t0 = time.time()
    eng = ShardedHybridEngine(idx, mesh=mesh,
                              config=EngineConfig(**SCALE_CONFIG))
    torch.cuda.synchronize()
    build_sec = time.time() - t0
    direct = eng.query_batch(batches[0])
    if direct.diagnostics["graph_impl"] != "compact":
        fail(f"sharded B {BATCH} took the {direct.diagnostics['graph_impl']}"
             f" form under auto")
    torch.cuda.reset_peak_memory_stats(dev)
    qual = evaluate_retrieval(eng, samples[: len(qs)], k=10,
                              batch_size=BATCH)
    peak = torch.cuda.max_memory_allocated(dev)
    stages = stage_ms(lambda: eng.query_batch(batches[0]))
    d_rec = abs(qual["recall_at_10"] - single_q["recall_at_10"])
    d_mrr = abs(qual["mrr"] - single_q["mrr"])
    log(f"[sharded] hybrid (SCALE_CONFIG, compact graph): recall@10 "
        f"{qual['recall_at_10']:.4f} (single {single_q['recall_at_10']:.4f}),"
        f" MRR {qual['mrr']:.4f} (single {single_q['mrr']:.4f}), "
        f"{qual['qps']} q/s (single {single_q['qps']}) over {qual['n']} "
        f"questions; index {eng.device_bytes()} bytes on the shards (single "
        f"{single_bytes}), built in {build_sec:.1f}s; peak device memory "
        f"{peak} bytes ({smi})")
    log(f"[sharded] device ms per stage, one batch of {BATCH}: sharded "
        f"{stages}; single {single_stages}")
    if d_rec > SHARD_RECALL_SLACK or d_mrr > SHARD_MRR_SLACK:
        fail(f"sharded hybrid quality off the single engine's by recall "
             f"{d_rec} (> {SHARD_RECALL_SLACK}), MRR {d_mrr} "
             f"(> {SHARD_MRR_SLACK})")
    piped = list(eng.query_batches_pipelined(batches))
    direct_all = [eng.query_batch(b) for b in batches]
    for a, b in zip(piped, direct_all):
        if not (np.array_equal(a.hits.ids, b.hits.ids)
                and np.array_equal(a.hits.scores, b.hits.scores)):
            fail("sharded query_batches_pipelined differs from query_batch")
    it = multihop.iterative_retrieve(eng, batches[0], top_k=10)
    it_p = list(multihop.iterative_retrieve_pipelined(eng, batches[:1],
                                                      top_k=10))[0]
    if not (np.array_equal(it[0], it_p[0]) and it[3]["hop2_active"] > 0):
        fail("sharded iterative: pipelined differs from the direct call or "
             "hop 2 never fired")
    served_qs = qs[:64]
    with QueryServer(eng, max_batch=64) as srv:
        futs = [srv.submit(x) for x in served_qs]
        served = [f.result(600) for f in futs]
    ref = direct_all[0]
    for row, hits in enumerate(served):
        ids = ref.hits.ids[row]
        if [h.id for h in hits] != [idx.corpus.hit_id(int(i))
                                    for i in ids if i >= 0]:
            fail("sharded QueryServer result differs from the direct call")
    log(f"[sharded] query_batches_pipelined x {len(batches)}, one iterative "
        f"batch (hop2_active {it[3]['hop2_active']}) and {len(served)} "
        f"QueryServer requests: equal to the direct calls")
    out["hybrid"] = {"recall": qual["recall_at_10"], "mrr": qual["mrr"],
                     "qps": qual["qps"], "single_recall":
                     single_q["recall_at_10"], "single_mrr": single_q["mrr"],
                     "single_qps": single_q["qps"], "stages_ms": stages,
                     "single_stages_ms": single_stages,
                     "device_bytes": eng.device_bytes(),
                     "single_device_bytes": single_bytes}
    close_engine(eng)
    del eng, idx
    torch.cuda.empty_cache()

    # ---- exactness on the card: dryrun (a)-(g), dryrun_check included ----
    t0 = time.time()
    dryrun_multichip(SHARDS, device=dev, log=lambda m: log(f"[sharded] {m}"))
    out["dryrun_sec"] = time.time() - t0

    # ---- sharded SPLADE over phase 11's index ----
    sp_idx = SpladeDeviceIndex.load(
        str(index_cache(SPLADE_SAMPLES) / "splade_index.npz"))
    sp_enc = SpladeEncoder.load(str(REPO / "data" / "splade_variety.npz"),
                                device=dev)
    t_ids, t_w = sp_enc.expand_texts(qs[:SPLADE_SHARD_QUERIES])
    t_ids, t_w = torch.from_numpy(t_ids).to(dev), torch.from_numpy(t_w).to(dev)
    longest = int(np.diff(sp_idx.row_ptr).max())
    ref_s, ref_i = bm25_topk_sorted(
        t_ids[:, None, :], torch.from_numpy(sp_idx.doc_ids).to(dev),
        torch.from_numpy(sp_idx.impacts).to(dev),
        torch.from_numpy(sp_idx.row_ptr).to(dev), n_docs=sp_idx.n_docs,
        term_topm=longest, pool_k=10, term_weights=t_w[:, None, :])
    sh = shard_splade_postings(sp_idx, SHARDS)
    sp_s, sp_i = sharded_splade_topk(
        t_ids, t_w, *sh[:3], mesh=mesh, rows_per_shard=sh[3],
        n_docs=sp_idx.n_docs, k=10, term_topm=longest)
    # both scorers sum a doc's window contributions as a difference of f32
    # prefix sums over the whole window (T x longest entries a row), one
    # device's over every doc, a shard's over its own: each total is off by
    # up to a few ulps of the row's window mass, and near-equal scores may
    # swap inside that band
    csum = np.concatenate([[0.0], np.cumsum(sp_idx.impacts, dtype=np.float64)])
    term_mass = torch.from_numpy(csum[sp_idx.row_ptr[1:]]
                                 - csum[sp_idx.row_ptr[:-1]]).to(dev)
    mass = float(torch.where(t_ids >= 0, t_w.double() * term_mass[
        t_ids.clamp(min=0).long()], 0.0).sum(1).max())
    atol = SPLADE_PREFIX_ULPS * 2.0 ** -23 * mass
    try:
        sp_err, rows = compare_topk(sp_i.cpu(), sp_s.cpu(), ref_i.cpu(),
                                    ref_s.cpu(), atol)
    except AssertionError as e:
        fail(f"sharded SPLADE differs from the single-device scorer: {e}")
    log(f"[sharded] SPLADE: {SPLADE_SHARD_QUERIES} queries over "
        f"{sp_idx.n_docs} rows, term_topm {longest} (the longest list): "
        f"{SPLADE_SHARD_QUERIES - len(rows)} rows with ids identical to the "
        f"single-device scorer, {len(rows)} differing only inside score "
        f"groups within {atol:.3g} ({SPLADE_PREFIX_ULPS} ulps of the largest "
        f"window mass {mass:.4g}); max |ds| {sp_err:.3g}")
    del sp_enc, ref_s, ref_i, sp_s, sp_i
    torch.cuda.empty_cache()

    # ---- sharded train step at the Main encoder width ----
    train = {}
    pairs = ([s["question"] for s in samples[:SHARD_TRAIN_BATCH]],
             [s["context"][0][1][0] for s in samples[:SHARD_TRAIN_BATCH]])
    tmesh = build_mesh({"data": 2, "model": 2}, devices=devices)
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = EncoderConfig(**LEARNED_ENCODER, dtype=dtype)
        template = enc.init_params(enc.seeded_generator(0, dev), cfg)
        params = load_params(str(REPO / "data" / "encoder_collide.npz"),
                             template, device=dev)
        hb = enc.TextEncoder.make_pair_batch(*pairs, cfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
        placed_batch = tp.place_batch(hb, tmesh)

        def nce(p, b):
            loss, acc = enc.info_nce_loss(p, b, cfg)
            return loss, {"accuracy": acc}

        l1, _, g1 = value_and_grad(nce, params, batch)
        l2, _, g2 = value_and_grad(tp.sharded_info_nce(cfg, tmesh),
                                   tp.place_params(params, cfg, tmesh),
                                   placed_batch)
        g2 = tp.gather_params(g2, cfg, dev)
        rtol, atol, loss_rtol = SHARD_TOL[tag]
        # max over leaves of max |dg| / (rtol * max |g| + atol): <= 1 passes
        worst = max(float((a - b).abs().max())
                    / (rtol * float(a.abs().max()) + atol)
                    for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
        if abs(float(l1) - float(l2)) > loss_rtol * abs(float(l1)) or (
                worst > 1.0):
            fail(f"sharded train step ({tag}): loss {float(l1)} vs "
                 f"{float(l2)}, worst gradient leaf at {worst} of its bound")
        init, step = enc.make_train_step(cfg)
        place_params, _, init2, step2 = enc.shard_train_step(cfg, tmesh)
        p1 = clone_tree(params)
        s1 = init(p1)
        p2 = place_params(params)
        s2 = init2(p2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        for _ in range(SHARD_TRAIN_STEPS):
            p2, s2, m2 = step2(p2, s2, placed_batch)
        torch.cuda.synchronize()
        sharded_sps = SHARD_TRAIN_STEPS / (time.time() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        t0 = time.time()
        for _ in range(SHARD_TRAIN_STEPS):
            p1, s1, m1 = step(p1, s1, batch)
        torch.cuda.synchronize()
        single_sps = SHARD_TRAIN_STEPS / (time.time() - t0)
        p_err = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(p1), tree_leaves(tp.gather_params(p2, cfg, dev))))
        if tag == "f32" and p_err > 5e-4:
            fail(f"sharded train step: parameters after "
                 f"{SHARD_TRAIN_STEPS} steps differ by {p_err} > 5e-4")
        log(f"[sharded] train step ({tag}, {cfg.d_model} wide, batch "
            f"{SHARD_TRAIN_BATCH}, mesh {tmesh.shape}): loss {float(l2):.5f} "
            f"(single {float(l1):.5f}), worst gradient leaf at {worst:.3g} "
            f"of its bound ({rtol} max|g| + {atol}); {SHARD_TRAIN_STEPS} "
            f"steps: "
            f"{sharded_sps:.1f} steps/s sharded, {single_sps:.1f} single, "
            f"parameters within {p_err:.3g}; peak device memory {peak} "
            f"bytes (sharded) ({smi})")
        train[tag] = {"grad_of_bound": worst, "param_err": p_err,
                      "sharded_steps_per_s": sharded_sps,
                      "single_steps_per_s": single_sps, "peak_bytes": peak}
    out["train"] = train
    return out, kern


def rerank_phase(engine, samples, dev, smi):
    """Phase 12: the cross-encoder over the hybrid top-20."""
    import numpy as np

    from a_modular_rag_framework_torch.models import (CrossEncoderConfig,
                                                      CrossEncoderReranker)
    from a_modular_rag_framework_torch.models.cross_encoder import encode_pairs

    ckpt = str(REPO / "data" / "cross_encoder_collide.npz")
    cfg = CrossEncoderConfig(subword_ngrams=8)
    rr = CrossEncoderReranker.load(ckpt, cfg, device=dev)
    samples = samples[:RERANK_QUESTIONS]
    qs = [s["question"] for s in samples]
    ids = engine.query_batch(qs, top_k=RERANK_TOP).hits.ids
    docs = engine.index.corpus.docs
    cands = [[docs[int(i)].get("text", "") if i >= 0 else "" for i in row]
             for row in ids]
    flat_q = [q for q, c in zip(qs, cands) for _ in c]
    flat_p = [p for c in cands for p in c]
    n_pairs = len(flat_p)
    rr.score_pairs(flat_q[:rr.pair_budget], flat_p[:rr.pair_budget])  # warm-up
    t0 = time.time()
    encode_pairs(flat_q, flat_p, cfg)
    host_sec = time.time() - t0
    t0 = time.time()
    scores = rr.score_pairs(flat_q, flat_p)
    sec = time.time() - t0
    if scores.shape != (n_pairs,) or not np.isfinite(scores).all():
        fail(f"reranker scores: shape {scores.shape} or non-finite")
    orders = rr.rerank_batch(qs, cands)
    reranked = np.stack([row[np.asarray(o)] for row, o in zip(ids, orders)])
    before = gold_metrics(engine, samples, ids[:, :10])
    after = gold_metrics(engine, samples, reranked[:, :10])
    chunks = -(-n_pairs // rr.pair_budget)
    log(f"[rerank] {n_pairs} pairs ({len(qs)} questions x top-{RERANK_TOP}) "
        f"in {chunks} chunks of {rr.pair_budget} (tail padded by "
        f"{chunks * rr.pair_budget - n_pairs}): {sec:.3f}s = "
        f"{n_pairs / sec:.1f} pairs/s, of which host pair tokenization "
        f"{host_sec:.3f}s ({smi})")
    # with order_alphas the engine re-orders its k hits by the parity
    # weights, so the first 10 of a top-20 call are not the top-10 call's
    plain = gold_metrics(engine, samples,
                         engine.query_batch(qs, top_k=10).hits.ids)
    log(f"[rerank] recall@10 / MRR: the engine's top-10 call {plain[0]:.4f} "
        f"/ {plain[1]:.4f}; the first 10 of its top-{RERANK_TOP} call "
        f"{before[0]:.4f} / {before[1]:.4f}; after re-ranking the "
        f"top-{RERANK_TOP} {after[0]:.4f} / {after[1]:.4f}")
    if not after[1] > before[1]:
        fail(f"re-ranking did not raise MRR: {before[1]} -> {after[1]}")
    n_cpu = min(1024, n_pairs)
    cpu = CrossEncoderReranker.load(ckpt, cfg, device="cpu")
    s_cpu = cpu.score_pairs(flat_q[:n_cpu], flat_p[:n_cpu])
    err = float(np.abs(scores[:n_cpu] - s_cpu).max())
    log(f"[rerank] {n_cpu} pair scores card (chunked stream) vs CPU (one "
        f"chunk): max |ds| {err:.3g} (atol {RERANK_ATOL}; logits in "
        f"[{scores.min():.1f}, {scores.max():.1f}])")
    if err > RERANK_ATOL:
        fail(f"reranker scores differ by {err} card vs CPU")
    return {"pairs": n_pairs, "pairs_per_sec": n_pairs / sec,
            "host_sec": host_sec, "recall_top10_call": plain[0],
            "mrr_top10_call": plain[1], "recall_before": before[0],
            "mrr_before": before[1], "recall_after": after[0],
            "mrr_after": after[1]}


def semantic_phase(dev, smi):
    """`ops.semantic.semantic_sim_matrix` on the card against a float64
    numpy computation, at a per-question size and at n 4096: the kept pairs
    must be identical and the values within SEMANTIC_ATOL. A pair whose
    float64 cosine lies within SEMANTIC_ATOL of the threshold, or of its
    row's k-th value, may fall on either side and is left out."""
    import numpy as np
    import torch

    from a_modular_rag_framework_torch.ops.semantic import semantic_sim_matrix

    out = {}
    for n, group in ((22, 3), (4096, 12)):
        rng = np.random.default_rng(n)
        base = rng.standard_normal(((n + group - 1) // group, 64))
        emb = np.repeat(base, group, axis=0)[:n]
        emb = (emb + 0.05 * rng.standard_normal(emb.shape)).astype(np.float32)
        emb[-1] = 0.0  # a zero-norm row has no edges
        e64 = emb.astype(np.float64)
        norms = np.linalg.norm(e64, axis=1, keepdims=True)
        en = e64 / np.maximum(norms, 1e-9)
        sims = en @ en.T
        live = norms[:, 0] > 1e-9
        base_keep = ((sims >= 0.9) & ~np.eye(n, dtype=bool)
                     & live[:, None] & live[None, :])
        near_cut = np.abs(sims - 0.9) < SEMANTIC_ATOL
        t = torch.from_numpy(emb).to(dev)
        for top_k in (0, 8):
            ref = np.where(base_keep, sims, 0.0)
            unsure = near_cut.copy()
            if top_k:
                desc = -np.sort(-ref, axis=1)
                kth = np.maximum(desc[:, top_k - 1:top_k], 1e-30)
                # a row whose (k+1)-th value ties its k-th within the
                # tolerance may cut on either side of that pair
                tight = (desc[:, top_k - 1] - desc[:, top_k]) < SEMANTIC_ATOL
                unsure |= (tight[:, None] & (ref > 0)
                           & (np.abs(ref - kth) < SEMANTIC_ATOL))
                ref = np.where(ref >= kth, ref, 0.0)
            got = semantic_sim_matrix(t, threshold=0.9,
                                      top_k_per_node=top_k).cpu().numpy()
            sure = ~unsure
            if not ((got > 0) == (ref > 0))[sure].all():
                fail(f"semantic n {n} top_k {top_k}: "
                     f"{int(((got > 0) != (ref > 0))[sure].sum())} kept pairs "
                     f"differ from float64")
            kept = (ref > 0) & sure
            err = float(np.abs(got - ref)[kept].max()) if kept.any() else 0.0
            if not kept.any() or err > SEMANTIC_ATOL:
                fail(f"semantic n {n} top_k {top_k}: {int(kept.sum())} pairs, "
                     f"max |d sim| {err:.3g} > {SEMANTIC_ATOL}")
            ms = cuda_ms(lambda: semantic_sim_matrix(
                t, threshold=0.9, top_k_per_node=top_k), 5)
            log(f"[semantic] n {n} d 64 threshold 0.9 top_k_per_node {top_k}: "
                f"{int(kept.sum())} kept pairs identical to float64 "
                f"({int(unsure.sum())} at a cut left out), max |d sim| "
                f"{err:.3g}, {ms:.3f} ms ({smi})")
            out[f"n{n}_k{top_k}"] = {"pairs": int(kept.sum()), "max_err": err,
                                     "ms": ms}
    return out


def run_qa(tag, settings_path, runs_dir, samples):
    """Each sample's question through `answer_question(mode="full")`
    (tools/e2e_run_torch.py's `run_questions`); fails unless every question
    returns hits with finite scores, an answer and a verdict. Returns
    (per-question rows, summary with quality, seconds and the span split)."""
    from e2e_run_torch import run_questions

    rows, summary = run_questions(samples, settings_path, runs_dir)
    # sec_per_question keeps the meaning it has had in this script's JSON:
    # all questions but the first, which builds the system (the tool's own
    # total over n is total_sec / n here)
    summary["sec_per_question"] = summary.pop("steady_sec_per_question")
    for i, r in enumerate(rows):
        if not r["hits"] or not r["answer"] or r["verdict"] == "?":
            fail(f"{tag}: question {i} returned {len(r['hits'])} hits, "
                 f"answer {r['answer']!r}, verdict {r['verdict']!r}")
        if not all(math.isfinite(sc) for sc in r["hits"].values()):
            fail(f"{tag}: question {i} has a non-finite hit score")
    return rows, summary


def log_qa(tag, summary, smi):
    top = {k: round(summary["span_sec_per_question"].get(k, 0.0), 4)
           for k in ("InitExternal", "BuildGraph", "Retrieval", "Reasoning",
                     "Verify")}
    log(f"[{tag}] {summary['n']} questions: EM {summary['em']:.4f}, relaxed EM "
        f"{summary['em_relaxed']:.4f}, F1 {summary['f1']:.4f}; verdicts "
        f"{summary['verdicts']}; retry rounds {summary['retry_rounds']}; "
        f"seeds {summary['seed_modes']}")
    log(f"[{tag}] {summary['sec_per_question']:.4f} s per question "
        f"(host clock, all but the first; the first, which builds the system, "
        f"{summary['first_question_sec']:.2f} s); by span {top}; engine "
        f"dispatch-to-fetch {summary['engine_device_ms_per_question']:.1f} ms "
        f"per question ({smi})")
    log(f"[{tag}] all spans, s per question: " + json.dumps(
        {k: round(v, 4) for k, v in
         summary["span_sec_per_question"].items()}))


def qa_recorded_phase(loader, work, runs, dev, smi, n_questions=QA_QUESTIONS):
    """Phase 13: the regress_plain configuration of tools/e2e_run.py on
    ``dev``, then on the CPU. As there, the backend's graph_root holds the
    ingest's supporting-fact graphs and the per-question graphs go to the
    graph-construction module's own directory, so retrieval derives its seeds from BM25."""
    from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest
    from a_modular_rag_framework_torch.di.factory import write_settings
    from a_modular_rag_framework_torch.ops import topk as T

    dataset = dict(QA_RECORDED, type="synthetic_hotpotqa")
    samples = loader.SyntheticHotpotQALoader(dataset).load()
    t0 = time.time()
    stats = ingest(samples, graph_root=work / "recorded" / "graph",
                   docs_out=work / "recorded" / "docs.jsonl")
    log(f"[qa] ingested {stats['samples']} samples, {stats['sentences']} "
        f"sentences in {time.time() - t0:.1f}s (host)")
    common = dict(docs=work / "recorded" / "docs.jsonl",
                  graph_root=work / "recorded" / "graph", dataset=dataset)
    card = write_settings(work / "recorded_card.json",
                          root_dir=runs / "graphs_card",
                          device=None if dev.type == "cuda" else str(dev),
                          **common)
    cpu = write_settings(work / "recorded_cpu.json",
                         root_dir=runs / "graphs_cpu", device="cpu",
                         **common)
    qs = samples[:n_questions]
    T.dense_topk_cuda.launches = 0
    rows, summary = run_qa("qa", card, str(runs / "card"), qs)
    summary["dense_topk_launches"] = T.dense_topk_cuda.launches
    log_qa("qa", summary, smi)
    log(f"[qa] dense_topk launches on this path: "
        f"{summary['dense_topk_launches']} (answer_question goes through "
        f"query_batch / iterative_retrieve, never query_dense_batch)")
    if summary["em"] < QA_MIN_EM:
        fail(f"qa: EM {summary['em']:.4f} < {QA_MIN_EM} at the recorded "
             f"configuration (docs/E2E_RUN.json regress_plain: 1.00)")

    cpu_rows, cpu_summary = run_qa("qa-cpu", cpu, str(runs / "cpu"), qs)
    log_qa("qa-cpu", cpu_summary, "CPU")
    same = sum(a["answer"] == b["answer"] and a["verdict"] == b["verdict"]
               for a, b in zip(rows, cpu_rows))
    same_hits = sum(list(a["hits"]) == list(b["hits"])
                    for a, b in zip(rows, cpu_rows))
    d_score = max((abs(sc - b["hits"][h]) for a, b in zip(rows, cpu_rows)
                   for h, sc in a["hits"].items() if h in b["hits"]),
                  default=0.0)
    log(f"[qa] {dev.type} vs CPU: {same}/{len(rows)} questions with the same "
        f"answer and verdict, {same_hits}/{len(rows)} with the same hit ids "
        f"in the same order, max |d score| over shared hits {d_score:.3g}")
    need = QA_MIN_SAME_AS_CPU * len(rows) // QA_QUESTIONS
    if same < need:
        fail(f"qa: only {same}/{len(rows)} answers and verdicts equal the "
             f"CPU's (need {need})")
    summary.update(same_as_cpu=same, same_hits_as_cpu=same_hits,
                   max_score_diff_vs_cpu=d_score,
                   cpu_sec_per_question=cpu_summary["sec_per_question"])
    return summary


def qa_scale_phase(loader, samples, n_samples, n_docs, work, runs, dev, smi,
                   n_questions=QA_SCALE_QUESTIONS):
    """Phase 14: `answer_question` against the main corpus's packed index
    (``index_cache(n_samples)``, which the backend loads as the cache of
    the docs.jsonl path beside it without opening that file). The dataset
    block names the main corpus's loader with ``count`` = the questions
    asked: the collide corpus is prefix-stable, so these are the main
    corpus's first samples with their own contexts. The per-question
    graphs go where the backend reads them, so retrieval is seeded by
    their q_match rows."""
    from a_modular_rag_framework_torch import system
    from a_modular_rag_framework_torch.di.factory import write_settings
    from a_modular_rag_framework_torch.engine import TorchQueryEngine

    dataset = {"type": "synthetic_hotpotqa", "count": n_questions, "seed": 0,
               "n_distractors": 8, "collide_entities": True}
    qs = loader.SyntheticHotpotQALoader(dataset).load()
    if qs != samples[:n_questions]:
        fail("qa-1m: the loader's first samples are not the main corpus's")
    packed = index_cache(n_samples)
    if not (packed / "manifest.json").exists():
        fail(f"qa-1m: no packed index at {packed}")
    settings = write_settings(
        work / "scale.json", docs=packed.with_suffix(""),
        graph_root=runs / "graphs_scale", root_dir=runs / "graphs_scale",
        dataset=dataset, device=None if dev.type == "cuda" else str(dev),
        index=QA_SCALE_INDEX, retrieval={"bm25_pool_k": 200})
    uploads = []
    upload = TorchQueryEngine._upload

    def counted(self):
        uploads.append(self._n)
        return upload(self)

    TorchQueryEngine._upload = counted
    try:
        rows, summary = run_qa("qa-1m", settings, str(runs / "scale"), qs)
    finally:
        TorchQueryEngine._upload = upload
    ctx = system.get_node_ctx(settings, runs_dir=str(runs / "scale"))
    engine = ctx.retriever.backend.engine
    log_qa("qa-1m", summary, smi)
    gold = sum(r["contains"] for r in rows)
    summary.update(rows=engine._n, device_bytes=engine.device_bytes(),
                   uploads=uploads, gold_contained=gold)
    log(f"[qa-1m] index rows {engine._n}, {engine.device_bytes()} bytes of "
        f"index tensors on {engine.device}; index uploads while answering "
        f"{len(rows)} questions: {uploads}; gold answer contained in "
        f"{gold}/{len(rows)} answers")
    if engine._n != n_docs:
        fail(f"qa-1m: the backend serves {engine._n} rows, not the main "
             f"corpus's {n_docs}")
    if uploads != [engine._n]:
        fail(f"qa-1m: expected one upload of {engine._n} rows, saw {uploads}")
    if ctx.graph_c.retriever.backend.engine is not engine:
        fail("qa-1m: graph construction's retriever holds a second engine")
    if gold < QA_SCALE_MIN_GOLD * len(rows) // QA_SCALE_QUESTIONS:
        fail(f"qa-1m: the gold answer is in only {gold}/{len(rows)} answers")
    return summary


def qa_phases(loader, samples, n_samples, n_docs, dev, smi):
    """Phases 13 and 14 and the semantic-edge check, under one work
    directory; the traces and per-question graphs are removed at the end."""
    import shutil
    import tempfile

    from a_modular_rag_framework_torch import system

    work = REPO / "data" / "torch_smoke_qa"
    work.mkdir(parents=True, exist_ok=True)
    runs = Path(tempfile.mkdtemp(prefix="runs_", dir=work))
    try:
        t0 = time.time()
        semantic = semantic_phase(dev, smi)
        recorded = qa_recorded_phase(loader, work, runs, dev, smi)
        log(f"[qa] phase {time.time() - t0:.1f}s")
        system.reset_system_cache()
        t0 = time.time()
        scale = qa_scale_phase(loader, samples, n_samples, n_docs, work, runs,
                               dev, smi)
        log(f"[qa-1m] phase {time.time() - t0:.1f}s")
        system.reset_system_cache()
        t0 = time.time()
        quality = quality_phase(work / "quality", runs / "quality", dev, smi)
        log(f"[quality] phase {time.time() - t0:.1f}s")
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    return {"semantic": semantic, "qa_recorded": recorded, "qa_1m": scale,
            "quality": quality}


def quality_phase(work, runs, dev, smi):
    """Phase 17: the rows regress_variety, regress_heldout and the first
    QUALITY_QUESTIONS["natural"] natural_shipped questions of
    docs/E2E_RUN.json through the port's
    `answer_question` on ``dev`` (tools/e2e_run_torch.py's corpora and
    settings: BM25-derived seeds as recorded), each question's answer,
    verdict and retry round held against the JAX package's on the CPU
    (QUALITY_FIXTURE). A differing question is logged with its BM25
    candidate count (above 64 the derived seeds are a cut that can run
    through exact ties)."""
    import e2e_run_torch as e2e
    from a_modular_rag_framework_torch import system
    from a_modular_rag_framework_torch.ops import topk as T

    fixture = json.loads(QUALITY_FIXTURE.read_text())["rows"]
    out = {}
    for corpus, min_same in QUALITY_MIN_SAME.items():
        ref = fixture[corpus]
        t0 = time.time()
        dataset = e2e.dataset_block(corpus, ref["samples"], ref["seed"])
        samples = e2e.load_samples(dataset)
        settings, _ = e2e.build_corpus_settings(
            samples, work / corpus, dataset=dataset,
            index_titles=corpus == "natural",
            device=None if dev.type == "cuda" else str(dev))
        ingest_sec = time.time() - t0
        tag = f"quality-{corpus}"
        want_rows = ref["per_question"][: QUALITY_QUESTIONS[corpus]]
        T.dense_topk_cuda.launches = 0
        rows, summary = run_qa(tag, settings, runs / corpus,
                               samples[: len(want_rows)])
        summary["dense_topk_launches"] = T.dense_topk_cuda.launches
        system.reset_system_cache()
        log_qa(tag, summary, smi)
        same = 0
        for i, (r, f) in enumerate(zip(rows, want_rows)):
            got = (r["answer"], r["verdict"], r["retry_round"])
            want = (f["answer"], f["verdict"], f["retry_round"])
            if got == want:
                same += 1
                continue
            cause = ("more than 64 BM25 candidates: the derived seeds are a "
                     "cut that can run through exact ties"
                     if (r["bm25_candidates"] or 0) > 64 else
                     "no cut through BM25 candidates")
            log(f"[{tag}] question {i} differs from the JAX package: "
                f"{got} vs {want}; {r['bm25_candidates']} BM25 candidates "
                f"({cause})")
        agg = ref["aggregate"]
        log(f"[{tag}] {same}/{len(rows)} questions with the JAX package's "
            f"answer, verdict and retry round (need {min_same}); JAX on the "
            f"CPU over its {agg['n']}: EM {agg['em']}, verdicts "
            f"{agg['verdicts']}, retry rounds {agg['retry_rounds']}; record "
            f"{ref['record']['tag']} (n "
            f"{ref['record']['n']}): EM {ref['record']['em']}; corpus "
            f"{len(samples)} samples, ingest {ingest_sec:.1f}s; dense_topk "
            f"launches {summary['dense_topk_launches']}")
        if same < min_same:
            fail(f"{tag}: only {same}/{len(rows)} questions equal the JAX "
                 f"package's (need {min_same})")
        out[corpus] = dict(summary, same_as_jax=same, ingest_sec=ingest_sec)
    return out


def _http(url, body=None):
    """(status, JSON) of a GET (no body) or POST to the local front."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def surface_phase(loader, engine, questions, dev, smi):
    """Phase 18: the rest of the surface on the card. The serve CLI's `_App`
    behind its threaded HTTP server on 127.0.0.1 over the Main engine's
    QueryServer: HTTP_QUERIES concurrent /query and HTTP_BATCHES
    /query_batch requests (half iterative) equal the direct engine calls,
    and HTTP_ANSWERS /answer requests on phase 13's corpus, sent among
    them, equal `answer_question`; `expand_qmatch_neighbors` on one of
    those per-question graphs on the card equals it on the CPU; the
    engine's `profile` leaves a trace that names its ranges and kernels;
    the NaN switch trips on a small engine of its own."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from a_modular_rag_framework_torch import system
    from a_modular_rag_framework_torch.cli import serve
    from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest
    from a_modular_rag_framework_torch.di.factory import write_settings
    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.engine.server import QueryServer
    from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                     build_packed_index)
    from a_modular_rag_framework_torch.modules.retrieval import (graph_store,
                                                                 multihop)
    from a_modular_rag_framework_torch.ops import topk as T

    work = REPO / "data" / "torch_smoke_qa"
    work.mkdir(parents=True, exist_ok=True)
    runs = Path(tempfile.mkdtemp(prefix="runs_http_", dir=work))
    cwd = os.getcwd()
    out = {}
    try:
        t_setup = time.time()
        dataset = dict(QA_RECORDED, type="synthetic_hotpotqa")
        qa_samples = loader.SyntheticHotpotQALoader(dataset).load()
        ingest(qa_samples, graph_root=work / "http" / "graph",
               docs_out=work / "http" / "docs.jsonl")
        settings = write_settings(
            work / "http.json", docs=work / "http" / "docs.jsonl",
            graph_root=work / "http" / "graph", root_dir=runs / "graphs",
            dataset=dataset, device=None if dev.type == "cuda" else str(dev))
        singles = questions[:HTTP_QUERIES]
        batches = [questions[HTTP_QUERIES + i * HTTP_BATCH:
                             HTTP_QUERIES + (i + 1) * HTTP_BATCH]
                   for i in range(HTTP_BATCHES)]
        modes = ["single", "iterative"] * (HTTP_BATCHES // 2)
        asked = [s["question"] for s in qa_samples[:HTTP_ANSWERS]]
        jobs = ([(("q", i), "/query", {"query": q, "top_k": 10})
                 for i, q in enumerate(singles)]
                + [(("b", i), "/query_batch", {"queries": b, "mode": m,
                                                "top_k": 10})
                   for i, (b, m) in enumerate(zip(batches, modes))]
                + [(("a", i), "/answer", {"question": q})
                   for i, q in enumerate(asked)])
        results, errors = {}, []

        def call(key, path, body):
            try:
                results[key] = _http(base + path, body)
            except Exception as e:  # reported below
                errors.append(f"{path}: {e!r}")

        os.chdir(runs)  # /answer writes its traces under ./runs
        log(f"[http] phase 13's corpus ingested and settings written in "
            f"{time.time() - t_setup:.2f}s")
        T.dense_topk_cuda.launches = 0
        with QueryServer(engine, max_batch=BATCH, max_wait_ms=5) as qserver:
            app = serve._App(qserver, engine.index.n_docs,
                             settings_path=settings, qa=True)
            httpd = serve.make_server("127.0.0.1", 0, app)
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            server = threading.Thread(target=httpd.serve_forever, daemon=True)
            server.start()
            try:
                threads = [threading.Thread(target=call, args=job)
                           for job in jobs]
                t0 = time.time()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(600)
                wall = time.time() - t0
                health = _http(base + "/healthz")
            finally:
                httpd.shutdown()
                httpd.server_close()
        launches = T.dense_topk_cuda.launches
        if errors or len(results) != len(jobs):
            fail(f"http: {len(jobs) - len(results)} requests failed: "
                 f"{errors[:3]}")
        bad = [(k, c) for k, (c, _) in results.items() if c != 200]
        if bad or health[0] != 200:
            fail(f"http: non-200 replies {bad[:5]}, healthz {health[0]}")

        # the direct calls
        corpus = engine.index.corpus
        mismatch, max_ds, n_q = 0, 0.0, 0

        def check(hits, ids, scores):
            nonlocal mismatch, max_ds, n_q
            n_q += 1
            keep = ids >= 0
            mismatch += [h["id"] for h in hits] != [
                corpus.hit_id(int(x)) for x in ids[keep]]
            if len(hits) == int(keep.sum()):
                max_ds = max(max_ds, float(np.abs(np.asarray(
                    [h["score"] for h in hits]) - scores[keep]).max(
                        initial=0.0)))

        r = engine.query_batch(singles, top_k=10)
        for i in range(len(singles)):
            check(results[("q", i)][1]["hits"], r.hits.ids[i],
                  r.hits.scores[i])
        for i, (b, m) in enumerate(zip(batches, modes)):
            if m == "single":
                r = engine.query_batch(b, top_k=10)
                ids, scores = r.hits.ids, r.hits.scores
            else:
                ids, scores = multihop.iterative_retrieve(engine, b,
                                                          top_k=10)[:2]
            for row, hits in enumerate(results[("b", i)][1]["results"]):
                check(hits, ids[row], scores[row])
        if mismatch or max_ds > 1e-6:
            fail(f"http: {mismatch} of {n_q} results differ from the direct "
                 f"call (max |ds| {max_ds:.3g})")
        same_answers = 0
        graphs = []
        for i, q in enumerate(asked):
            got = results[("a", i)][1]
            want = system.answer_question(q, mode="full",
                                          settings_path=settings)
            same_answers += (
                got["reasoning"]["answer"] == want["reasoning"]["answer"]
                and got["verification"]["verdict"]
                == want["verification"]["verdict"]
                and got["retry_round"] == want["retry_round"]
                and [(h["id"], h["score"]) for h in got["retrieval"]["hits"]]
                == [(h["id"], h["score"])
                    for h in want["retrieval"]["hits"]])
            graphs.append(got["graph"])
        if same_answers != len(asked):
            fail(f"http: {same_answers}/{len(asked)} /answer replies equal "
                 f"answer_question")
        check_sec = time.time() - t0 - wall
        log(f"[http] {len(jobs)} concurrent requests ({HTTP_QUERIES} /query, "
            f"{HTTP_BATCHES} /query_batch of {HTTP_BATCH}, half iterative, "
            f"{len(asked)} /answer) in {wall:.2f}s; all {n_q} query results "
            f"equal the direct call (ids identical, max |ds| {max_ds:.3g}); "
            f"{same_answers}/{len(asked)} /answer replies equal "
            f"answer_question; healthz {health[1]['stats']}; dense_topk "
            f"launches {launches}; the direct calls and checks "
            f"{check_sec:.2f}s ({smi})")
        out.update(http_sec=wall, http_results=n_q, max_score_diff=max_ds,
                   answers_equal=same_answers, dense_topk_launches=launches)

        # the graph store on the card vs the CPU, on the largest graph
        t0 = time.time()
        g_out = max(graphs, key=lambda g: g["node_count"])
        g = graph_store.load_graph_json(str(runs / "graphs"), g_out["graph_id"])
        parts = graph_store.build_index(g)
        q = asked[graphs.index(g_out)]
        on_card = graph_store.expand_qmatch_neighbors(
            q, *parts[:4], explicit_qmatch=parts[4], window=2, device=dev)
        on_cpu = graph_store.expand_qmatch_neighbors(
            q, *parts[:4], explicit_qmatch=parts[4], window=2, device="cpu")
        if not on_card or on_card != on_cpu:
            fail(f"graph store: {len(on_card)} expanded sentences on "
                 f"{dev.type}, {len(on_cpu)} on the CPU, or they differ")
        log(f"[graph-store] expand_qmatch_neighbors over a {len(parts[3])}-"
            f"sentence graph ({len(parts[4])} q_match seeds, window 2): "
            f"{len(on_card)} sentences, equal on {dev.type} and the CPU "
            f"({time.time() - t0:.2f}s)")
        out["graph_store_sentences"] = len(on_card)
    finally:
        os.chdir(cwd)
        system.reset_system_cache()
        shutil.rmtree(runs, ignore_errors=True)

    # profile: a trace naming the engine's ranges and its kernels
    t0 = time.time()
    prof_dir = Path(tempfile.mkdtemp(prefix="prof_", dir=work))
    try:
        with engine.profile(str(prof_dir)):
            engine.query_batch(questions[:BATCH])
        traces = list(prof_dir.glob("*.pt.trace.json"))
        events = json.loads(traces[0].read_text())["traceEvents"] if len(
            traces) == 1 else []
        names = {e.get("name") for e in events}
        ranges = sorted(n for n in names if str(n).startswith("engine/"))
        kernels = sum(e.get("cat") == "kernel" for e in events)
        size = traces[0].stat().st_size if traces else 0
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    want = {"engine/bm25_pool", "engine/bm25_rescore", "engine/dense",
            "engine/graph", "engine/fusion"}
    if not want <= set(ranges) or (dev.type == "cuda" and kernels == 0):
        fail(f"profile: ranges {ranges}, {kernels} kernel events")
    log(f"[profile] one batch of {BATCH} under engine.profile: a chrome trace "
        f"of {size} bytes, ranges {ranges}, {kernels} kernel events "
        f"({time.time() - t0:.2f}s)")
    out.update(profile_ranges=ranges, profile_kernels=kernels)

    # the NaN switch on a small engine of its own
    t0 = time.time()
    small = build_packed_index(
        SentenceCorpus.from_hotpotqa(qa_samples[:50]), embed_dim=64)
    cfg = EngineConfig(top_k=10, batch_buckets=(8,))
    qs = [s["question"] for s in qa_samples[:8]]
    old = os.environ.get("AMRF_DEBUG_NANS")
    os.environ["AMRF_DEBUG_NANS"] = "1"
    trips = {}
    try:
        eng = TorchQueryEngine(small, device=dev, config=cfg)
        clean = eng.query_batch(qs)
        eng.query_dense_batch(qs)
        rows = torch.from_numpy(np.unique(clean.hits.ids[clean.hits.ids >= 0]))
        eng._emb[rows.long().to(dev)] = float("nan")
        for name, fn in (("query_batch", eng.query_batch),
                         ("query_dense_batch", eng.query_dense_batch)):
            try:
                fn(qs)
                trips[name] = "no trip"
            except FloatingPointError as e:
                trips[name] = str(e)
        small.embeddings = small.embeddings.copy()
        small.embeddings[rows.numpy()] = np.nan
        try:
            TorchQueryEngine(small, device=dev, config=cfg)
            trips["upload"] = "no trip"
        except FloatingPointError as e:
            trips["upload"] = str(e)
    finally:
        if old is None:
            os.environ.pop("AMRF_DEBUG_NANS", None)
        else:
            os.environ["AMRF_DEBUG_NANS"] = old
    log(f"[nan] AMRF_DEBUG_NANS=1 on {dev.type}, {small.n_docs} rows: {trips} "
        f"({time.time() - t0:.2f}s)")
    if (trips["query_batch"] == "no trip" or "dense pool" not in
            trips["query_batch"] or trips["upload"] == "no trip"):
        fail(f"the NaN switch did not trip: {trips}")
    out["nan_trips"] = trips
    return out


def run_cli(tag, main, argv):
    """Run a train CLI's ``main(argv)``, echo what it printed under
    ``tag`` and return (its lines, its JSON report: the last line)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"[{tag}]   {line}")
    return lines, json.loads(lines[-1])


def printed_losses(lines):
    """The ``loss=`` values of a CLI's progress lines, in order."""
    import re

    return [float(m.group(1)) for line in lines
            if (m := re.search(r"loss=([0-9.]+)", line))]


def train_probe_cases(loader, dev):
    """One real batch per trainer at the committed checkpoints' widths:
    {name: (loss_fn(params, batch) -> (loss, aux), params on the CPU from
    seed 0, host batch)}. Encoder: 1,024 collide pairs at LEARNED_ENCODER;
    cross-encoder: 32 lists of 8 at the Rerank width; SPLADE: 64 variety
    pairs at the SPLADE width."""
    import numpy as np

    sys.path.insert(0, str(REPO / "tools"))
    import dense_lab_torch as lab

    from a_modular_rag_framework_torch.cli.train_cross_encoder import \
        build_lists
    from a_modular_rag_framework_torch.cli.train_encoder import build_pairs
    from a_modular_rag_framework_torch.models import (
        CrossEncoderConfig, CrossEncoderReranker, EncoderConfig, SpladeConfig,
        TextEncoder)
    from a_modular_rag_framework_torch.models.cross_encoder import (
        init_cross_params, listwise_loss)
    from a_modular_rag_framework_torch.models.encoder import (
        info_nce_loss, init_params, seeded_generator)
    from a_modular_rag_framework_torch.models.splade import (
        init_splade_params, splade_loss)

    def gen():
        return seeded_generator(0, "cpu")

    cases = {}
    ecfg = EncoderConfig(**LEARNED_ENCODER)
    q, p = lab.build_collide_pairs(TRAIN_ENCODER["batch"] // 2,
                                   TRAIN_ENCODER["train_index"])

    def enc_loss(params, batch):
        loss, acc = info_nce_loss(params, batch, ecfg)
        return loss, {"accuracy": acc}

    cases["encoder"] = (enc_loss, init_params(gen(), ecfg),
                        TextEncoder.make_pair_batch(q, p, ecfg))

    ccfg = CrossEncoderConfig(subword_ngrams=8)
    samples = loader.SyntheticHotpotQALoader(
        {"count": 32, "seed": 0, "collide_entities": True,
         "n_distractors": 8}).load()
    queries, lists, labels = build_lists(samples, 8, np.random.default_rng(0))

    def cross_loss(params, batch):
        loss, acc = listwise_loss(params, batch, ccfg)
        return loss, {"accuracy": acc}

    cases["cross_encoder"] = (
        cross_loss, init_cross_params(gen(), ccfg),
        CrossEncoderReranker.make_listwise_batch(
            queries[:32], lists[:32], labels[:32], ccfg))

    scfg = SpladeConfig(encoder=EncoderConfig(d_model=64, subword_ngrams=8))
    samples = loader.SyntheticHotpotQALoader(
        {"count": 64, "seed": 0, "unique_entities": True,
         "variety": True}).load()
    q, p = build_pairs(samples)
    cases["splade"] = (
        lambda params, batch: splade_loss(params, batch, scfg),
        init_splade_params(gen(), scfg),
        TextEncoder.make_pair_batch(q[:64], p[:64], scfg.encoder))
    return cases


def train_card_vs_cpu(loader, dev, smi):
    """One loss + gradient of each trainer from the same parameters and
    batch on the card and on the CPU (`train_probe_cases`); the check that
    holds the card's dense-layer backward (`models.encoder._MatmulF32`)."""
    import numpy as np
    import torch

    from a_modular_rag_framework_torch._host import upload_batch
    from a_modular_rag_framework_torch.models.optim import value_and_grad
    from a_modular_rag_framework_torch.models.params import (flatten_params,
                                                             tree_map)

    out = {}
    for name, (loss_fn, params, batch) in train_probe_cases(loader,
                                                            dev).items():
        cpu = value_and_grad(loss_fn, params, upload_batch(batch, "cpu"))
        on_card = tree_map(lambda t: t.to(dev), params)
        card_batch = upload_batch(batch, dev)
        card = value_and_grad(loss_fn, on_card, card_batch)
        again = value_and_grad(loss_fn, on_card, card_batch)
        torch.cuda.synchronize()
        loss_rel = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
        g_cpu, g_card = flatten_params(cpu[2]), flatten_params(card[2])
        worst_key, worst, worst_rel = "", 0.0, 0.0
        for key, g in g_cpu.items():
            err, scale = float(abs(g_card[key] - g).max()), float(abs(g).max())
            share = err / (TRAIN_GRAD_RTOL * scale + TRAIN_GRAD_ATOL)
            if share > worst:
                worst_key, worst, worst_rel = key, share, err / max(scale,
                                                                    1e-30)
        moved = [k for k, g in flatten_params(again[2]).items()
                 if not np.array_equal(g, g_card[k])]
        log(f"[train] {name}: one loss + gradient card vs CPU: loss "
            f"{float(card[0]):.6f} vs {float(cpu[0]):.6f} (rel {loss_rel:.3g},"
            f" rtol {TRAIN_LOSS_RTOL}); the gradient leaf nearest its limit, "
            f"{worst_key}: max |dg| / max |g| {worst_rel:.3g}, {worst:.3g} of "
            f"the allowed {TRAIN_GRAD_RTOL} * max |g| + {TRAIN_GRAD_ATOL}; "
            f"the card's gradients twice from the same state: "
            f"{'bit for bit equal' if not moved else f'differ in {moved}'}")
        if loss_rel > TRAIN_LOSS_RTOL or worst > 1.0:
            fail(f"train {name}: the card's loss / gradients differ from the "
                 f"CPU's (loss rel {loss_rel}; {worst_key} at {worst} of its "
                 f"limit)")
        out[name] = {"loss_rel": loss_rel, "grad_rel": worst_rel,
                     "grad_leaf": worst_key, "leaves_not_repeatable": moved}
    return out


def train_encoder_phase(loader, work, dev, smi):
    """The dense-lab recipe on the card, the resume check, and the trained
    encoder's dense quality beside the committed checkpoint's."""
    import torch

    sys.path.insert(0, str(REPO / "tools"))
    import dense_lab_torch as lab

    from a_modular_rag_framework_torch.models import (EncoderConfig,
                                                      TextEncoder)
    from a_modular_rag_framework_torch.models.checkpoint import (
        restore_train_state, save_train_state)
    from a_modular_rag_framework_torch.models.encoder import (
        init_params, seeded_generator)
    from a_modular_rag_framework_torch.models.optim import (adamw_init,
                                                            clone_tree)
    from a_modular_rag_framework_torch.models.params import tree_leaves

    R = TRAIN_ENCODER
    cfg = EncoderConfig(**LEARNED_ENCODER)
    t0 = time.time()
    queries, passages = lab.build_collide_pairs(R["train_samples"],
                                                R["train_index"], 0)
    gen_sec = time.time() - t0
    t0 = time.time()
    data = lab.device_pair_set(queries, passages, cfg, dev)
    torch.cuda.synchronize()
    feat_sec = time.time() - t0
    log(f"[train-enc] {len(queries)} collide pairs (samples generated in "
        f"{gen_sec:.1f}s); host featurize + upload {feat_sec:.2f}s; pair set "
        f"on the card {sum(t.numel() * t.element_size() for t in data.values())}"
        f" bytes")

    params = init_params(seeded_generator(0, dev), cfg)
    gen = seeded_generator(1, dev)
    steps, chunk = R["steps"], R["chunk"]
    half = steps // 2 // chunk * chunk
    state_dir = work / "encoder_state"
    history, gen_state, at_next = [], None, None
    save_sec = 0.0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.time()
    for done, params, opt_state, m in lab.train_chunks(
            data, cfg, steps=steps, batch=R["batch"], lr=R["lr"], chunk=chunk,
            params=params, gen=gen):
        history.append((done, float(m["loss"]), float(m["accuracy"])))
        if done == half:  # the state a resumed run starts from
            t1 = time.time()
            save_train_state(state_dir, params, opt_state, done)
            gen_state = gen.get_state().clone()
            save_sec = time.time() - t1
        elif done == half + chunk:  # where the uninterrupted run is then
            at_next = clone_tree(params)
    torch.cuda.synchronize()
    wall = time.time() - t0 - save_sec
    peak = torch.cuda.max_memory_allocated(dev)
    first, last = history[0], history[-1]
    log(f"[train-enc] infonce_scan_trainer: {steps} steps (batch "
        f"{R['batch']}, chunk {chunk}, lr {R['lr']}) in {wall:.2f}s = "
        f"{steps / wall:.1f} steps/s (one host fetch per chunk; the state "
        f"save half way, {save_sec:.2f}s, left out); first chunk loss "
        f"{first[1]:.4f} acc {first[2]:.3f}, last chunk loss {last[1]:.4f} "
        f"acc {last[2]:.3f}; peak device memory {peak} bytes ({smi})")
    if not (last[1] < first[1] and math.isfinite(last[1])):
        fail(f"encoder training: loss {first[1]} -> {last[1]} did not fall")

    # resume: restore the half-way state, continue one chunk, compare
    template = init_params(seeded_generator(0, dev), cfg)
    restored = restore_train_state(state_dir, template, adamw_init(template))
    if restored is None or restored[2] != half:
        fail(f"the train state saved at step {half} did not restore")
    gen2 = torch.Generator(device=dev)
    gen2.set_state(gen_state)
    for _, r_params, _, _ in lab.train_chunks(
            data, cfg, steps=chunk, batch=R["batch"], lr=R["lr"], chunk=chunk,
            params=restored[0], opt_state=restored[1], gen=gen2):
        pass
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(r_params), tree_leaves(at_next)))
    log(f"[train-enc] save at step {half} -> restore -> {chunk} more steps "
        f"vs the uninterrupted run at step {half + chunk}: max |dp| {diff:.3g}"
        f" ({'bit for bit' if diff == 0.0 else 'not bit for bit'}; atol "
        f"{TRAIN_RESUME_ATOL})")
    if not diff <= TRAIN_RESUME_ATOL:
        fail(f"the resumed run differs from the uninterrupted one by {diff}")
    del data, restored, r_params, at_next

    # dense quality beside the committed checkpoint
    trained = TextEncoder(cfg, params=params, device=dev)
    trained.save(str(work / "encoder_collide_card.npz"))
    samples, idx = collide_index(loader, SPLADE_SAMPLES)
    texts = idx.corpus.texts()
    eval_samples = samples[:128]  # the collide generator is prefix-stable
    reports = {}
    for name, enc in (
            ("trained on the card", TextEncoder.load(
                str(work / "encoder_collide_card.npz"), cfg, device=dev)),
            ("data/encoder_collide.npz", TextEncoder.load(
                str(REPO / "data" / "encoder_collide.npz"), cfg, device=dev))):
        rep = lab.dense_eval(idx, enc, lab.embed_corpus(enc, texts),
                             eval_samples)
        reports[name] = rep
        log(f"[train-enc] dense_eval over {idx.n_docs} rows, 128 questions, "
            f"{name}: 1-shot recall@10 {rep['dense_1shot_recall_at_10']}, "
            f"hop-1 recall {rep['dense_1shot_hop1_recall']}, 2-hop recall@10 "
            f"{rep['dense_2hop_recall_at_10']}, 2-hop MRR "
            f"{rep['dense_2hop_mrr']}")
    mine, ref = reports["trained on the card"], reports[
        "data/encoder_collide.npz"]
    for key in ("dense_1shot_hop1_recall", "dense_2hop_recall_at_10"):
        if mine[key] < ref[key] - TRAIN_QUALITY_SLACK:
            fail(f"the card-trained encoder's {key} {mine[key]} is more than "
                 f"{TRAIN_QUALITY_SLACK} under the committed one's {ref[key]}")
    return {"steps": steps, "steps_per_sec": steps / wall,
            "featurize_sec": feat_sec, "first_chunk": first[1:],
            "last_chunk": last[1:], "peak_bytes": peak, "resume_max_dp": diff,
            "dense_eval": reports}


def train_cross_phase(loader, work, dev, smi):
    """`cli.train_cross_encoder.main` on the card, beside the committed
    reranker on the same held-out set."""
    import torch

    from a_modular_rag_framework_torch.cli import train_cross_encoder as cli
    from a_modular_rag_framework_torch.models import (CrossEncoderConfig,
                                                      CrossEncoderReranker)

    torch.cuda.reset_peak_memory_stats(dev)
    lines, report = run_cli("train-cross", cli.main, [
        "--collide", "--steps", str(TRAIN_CROSS_STEPS), "--out",
        str(work / "cross_encoder_card.npz"), "--device", str(dev)])
    peak = torch.cuda.max_memory_allocated(dev)
    sec = float(next(line for line in lines if line.startswith(
        "trained in")).split()[2].rstrip("s"))
    losses = printed_losses(lines)
    heldout = loader.SyntheticHotpotQALoader(
        {"count": 128, "seed": 101, "variety": False,
         "collide_entities": True, "n_distractors": 8}).load()
    committed = cli.eval_rerank(heldout, CrossEncoderReranker.load(
        str(REPO / "data" / "cross_encoder_collide.npz"),
        CrossEncoderConfig(subword_ngrams=8), device=dev))
    log(f"[train-cross] {TRAIN_CROSS_STEPS} steps of 32 x 8 pairs in "
        f"{sec:.1f}s = {TRAIN_CROSS_STEPS / sec:.1f} steps/s (host list "
        f"tokenization included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"peak device memory {peak} bytes; held-out seed 101, 128 samples: "
        f"MRR {report['mrr_before']} -> {report['mrr_after']}, recall@10 "
        f"{report['recall_before']} -> {report['recall_after']} "
        f"(data/cross_encoder_collide.npz: MRR {committed['mrr_before']} -> "
        f"{committed['mrr_after']}, recall@10 {committed['recall_before']} "
        f"-> {committed['recall_after']}) ({smi})")
    if not losses[-1] < losses[0]:
        fail(f"cross-encoder training: loss {losses[0]} -> {losses[-1]}")
    if not report["mrr_after"] > report["mrr_before"]:
        fail(f"the card-trained reranker did not raise MRR: "
             f"{report['mrr_before']} -> {report['mrr_after']}")
    return {"steps_per_sec": TRAIN_CROSS_STEPS / sec, "loss": [
        losses[0], losses[-1]], "peak_bytes": peak, "trained": report,
        "committed": committed}


def train_splade_phase(work, dev, smi):
    """`cli.train_splade.main` on the card: the validation curve, the
    selected step, held-out and in-domain quality beside BM25's."""
    import torch

    from a_modular_rag_framework_torch.cli import train_splade as cli

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    lines, report = run_cli("train-splade", cli.main, [
        "--variety", "--steps", str(TRAIN_SPLADE_STEPS), "--eval_samples",
        "128", "--eval_every", "25", "--out", str(work / "splade_card.npz"),
        "--device", str(dev)])
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses = printed_losses(lines)
    log(f"[train-splade] {TRAIN_SPLADE_STEPS} steps of 64 pairs + "
        f"{len(report['val_curve'])} validation evaluations in "
        f"{report['train_sec']}s = "
        f"{TRAIN_SPLADE_STEPS / report['train_sec']:.1f} steps/s with them "
        f"(main {wall:.1f}s in all); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, final accuracy {report['final_acc']:.3f}, doc_nnz "
        f"{report['doc_nnz']:.1f}; selected step {report['selected_step']}; "
        f"peak device memory {peak} bytes ({smi})")
    for key in ("held_out", "in_domain"):
        sp, bm = report[f"{key}_splade"], report[f"{key}_bm25"]
        log(f"[train-splade] {key}: SPLADE recall@10 "
            f"{sp['recall_at_10']:.4f} MRR {sp['mrr']:.4f}; BM25 "
            f"{bm['recall_at_10']:.4f} / {bm['mrr']:.4f}")
    if not losses[-1] < losses[0]:
        fail(f"SPLADE training: loss {losses[0]} -> {losses[-1]}")
    if not report["final_acc"] > 4.0 / 64:
        fail(f"SPLADE training: accuracy {report['final_acc']} at chance")
    if not report["held_out_splade"]["recall_at_10"] > 0.05:
        fail("the card-trained SPLADE model retrieves nothing")
    return {"steps_per_sec_with_validation":
            TRAIN_SPLADE_STEPS / report["train_sec"], "loss": [
                losses[0], losses[-1]], "peak_bytes": peak, "report": report}


def train_phase(loader, T, dev, smi):
    """Phase 15: the three trainers on the card and the card-vs-CPU check.
    The dense_topk kernel is not on the training path: its count stays 0
    until dense_eval's top-20."""
    import shutil

    work = REPO / "data" / "torch_smoke_train"
    work.mkdir(parents=True, exist_ok=True)
    try:
        T.dense_topk_cuda.launches = 0
        t0 = time.time()
        checks = train_card_vs_cpu(loader, dev, smi)
        log(f"[train] card vs CPU {time.time() - t0:.1f}s")
        t0 = time.time()
        cross = train_cross_phase(loader, work, dev, smi)
        log(f"[train-cross] phase {time.time() - t0:.1f}s")
        t0 = time.time()
        splade = train_splade_phase(work, dev, smi)
        log(f"[train-splade] phase {time.time() - t0:.1f}s")
        if T.dense_topk_cuda.launches:
            fail("a trainer launched the dense_topk kernel")
        t0 = time.time()
        encoder = train_encoder_phase(loader, work, dev, smi)
        log(f"[train-enc] phase {time.time() - t0:.1f}s; dense_eval's "
            f"dense_topk launches {T.dense_topk_cuda.launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"card_vs_cpu": checks, "encoder": encoder,
            "cross_encoder": cross, "splade": splade}


def check_imports() -> None:
    """Fails if jax, optax, orbax, pydantic, yaml or any module of the JAX
    package (by name, or by a file in its tree or in the repo-root native/)
    is loaded."""
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "optax", "orbax", "pydantic", "yaml",
        "a_modular_rag_framework_tpu"))
    if leaked:
        fail(f"the port imported {leaked[:5]}")
    for m in list(sys.modules.values()):
        f = getattr(m, "__file__", None)
        if not isinstance(f, str):
            continue
        f = Path(f).resolve()
        if f.is_relative_to(REPO) and f.relative_to(REPO).parts[0] in (
                "a_modular_rag_framework_tpu", "native"):
            fail(f"module {m.__name__} was loaded from {f}")


def sass_counts(lib_path: str) -> dict:
    """Counts of the tensor-core (HGMMA) and TMA load (UTMALDG) instructions
    in the built library, from ``cuobjdump -sass``; empty if no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300)
    return {op: proc.stdout.count(op) for op in ("HGMMA", "UTMALDG")}


def moe_kernel_at_shape(M, experts, slots, dev, smi):
    """The grouped expert kernel at the cell's routed slots a layer:
    ``slots`` unit-normal bf16 rows spread evenly at random over the
    experts (``experts``: one layer's weights), held against the plain
    version (a torch product per expert), then timed in turns beside it and
    beside the library's grouped products, and set beside its bound: the
    products' operations at the bf16 peak against the weights read once
    and each slot's bf16 row in and f32 row out at the memory rate."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(19)
    wg, wu, wd = experts["w_gate"], experts["w_up"], experts["w_down"]
    E, Fw, Hd = wg.shape
    chosen = torch.randint(0, E, (slots,), generator=g, device=dev)
    order = torch.argsort(chosen, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, chosen, torch.ones_like(chosen))
    offsets = torch.cumsum(counts, 0) - counts
    x = torch.randn((slots, Hd), generator=g, device=dev).to(torch.bfloat16)
    scale = torch.rand(slots, generator=g, device=dev)
    args = (x, wg, wu, wd, counts, offsets, order, scale, slots)

    y = M.moe_gemm_cuda(*args, covered=True)
    want = M.moe_reference(*args)
    big = float(want.abs().max())
    err, diff2, ref2, bad = 0.0, 0.0, 0.0, 0
    for c in range(0, slots, 65536):
        d = (y[c:c + 65536] - want[c:c + 65536]).abs()
        r = want[c:c + 65536].abs()
        err = max(err, float(d.max()))
        bad += int((d > MOE_RTOL * r + MOE_RTOL * big).sum())
        diff2 += float((d.double() ** 2).sum())
        ref2 += float((r.double() ** 2).sum())
    rel = math.sqrt(diff2 / ref2)
    if bad or not rel <= MOE_REL_NORM:
        fail(f"the grouped kernel at {slots} slots: {bad} values past rtol "
             f"{MOE_RTOL} (max |dy| {err:.3g}, max |y| {big:.3g}), "
             f"relative norm of the difference {rel:.3g} (limit "
             f"{MOE_REL_NORM})")
    del y, want
    torch.cuda.empty_cache()

    offs = torch.cumsum(counts, 0).to(torch.int32)
    wgt, wut, wdt = (w.transpose(1, 2) for w in (wg, wu, wd))

    def library():
        gate = torch._grouped_mm(x, wgt, offs=offs)
        h = torch.nn.functional.silu(gate) * torch._grouped_mm(x, wut,
                                                               offs=offs)
        return torch._grouped_mm(h, wdt, offs=offs)

    try:
        library()
    except (AttributeError, RuntimeError, TypeError) as exc:
        log(f"[dsv2] torch._grouped_mm unavailable here: {exc!r:.200}")
        library = None
    p1 = cuda_ms(lambda: M.moe_reference(*args), 2)
    l1 = cuda_ms(library, 3) if library else None
    k1 = cuda_ms(lambda: M.moe_gemm_cuda(*args, covered=True), 5)
    k2 = cuda_ms(lambda: M.moe_gemm_cuda(*args, covered=True), 5)
    l2 = cuda_ms(library, 3) if library else None
    p2 = cuda_ms(lambda: M.moe_reference(*args), 2)
    ops = 2.0 * 3 * Hd * Fw * slots
    nbytes = 2.0 * 3 * Hd * Fw * E + slots * 6 * Hd
    ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(ops_ms, bytes_ms)
    out = {"name": "moe_gemm", "route": "cuda",
           "source": "a_modular_rag_framework_torch/csrc/moe_gemm.cu",
           "replaces": "none: the JAX package has no expert layer",
           "ms": min(k1, k2), "plain_ms": min(p1, p2),
           "library_ms": min(l1, l2) if library else None,
           "bound_ms": bound,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "max_abs_err": err, "rel_norm_err": rel,
           "shape": f"{slots} slots, {E} experts (largest {int(counts.max())}"
                    f"), H {Hd}, F {Fw}, bf16"}
    out["bound_share"] = bound / out["ms"]
    lib = (f"{out['library_ms']:.3f} ms" if library
           else "not available")
    log(f"[dsv2] grouped kernel at {out['shape']}: {out['ms']:.3f} ms "
        f"({k1:.3f} / {k2:.3f}; {ops / out['ms'] / 1e9:.1f} TFLOP/s), "
        f"plain (a torch product per expert) {out['plain_ms']:.3f} ms, "
        f"library (torch._grouped_mm x 3, SiLU * up) {lib}; bound "
        f"{bound:.3f} ms ({out['bound_by']}), share {out['bound_share']:.3f};"
        f" max |dy| {err:.3g}, relative norm {rel:.3g} ({smi})")
    return out


def dsv2_phase(loader, T, M, dev, smi):
    """Phase 19: DeepSeek-V2-Lite as the dense embedder on the main path,
    B1 at its d 2048 and the grouped expert kernel at the cell's slots.
    Returns {"dense_topk": B1's entry, "moe_gemm": the grouped kernel's}."""
    import numpy as np
    import torch

    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                     build_packed_index)
    from a_modular_rag_framework_torch.models import deepseek_v2 as D

    cfg = D.DeepseekV2Config(num_hidden_layers=DSV2_LAYERS,
                             query_instruction=DSV2_INSTRUCTION)
    enc = D.DeepseekV2Encoder(cfg, D.init_params(cfg, 0, dev), device=dev)
    samples = loader.SyntheticHotpotQALoader(
        {"count": DSV2_SAMPLES, "seed": 0, "n_distractors": 8,
         "collide_entities": True}).load()
    torch.cuda.synchronize()
    t0 = time.time()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             encoder=enc, embed_dim=cfg.hidden_size,
                             embed_dtype="bfloat16")
    log(f"[dsv2] index of {idx.n_docs} rows built with the rows embedded "
        f"on the card in {time.time() - t0:.1f}s ({cfg.num_hidden_layers} "
        f"layers, d {cfg.hidden_size}, row_len {cfg.row_len})")
    engine = TorchQueryEngine(idx, device=dev, encoder=enc,
                              config=EngineConfig(**SCALE_CONFIG))
    questions = [s["question"] for s in samples]
    batches = [questions[i: i + BATCH] for i in (0, BATCH)]
    engine.query_dense_batch(batches[0])  # warm-up
    torch.cuda.synchronize()
    # the main path's run: counts from 0, read right after
    T.dense_topk_cuda.launches = 0
    M.moe_gemm_cuda.launches = 0
    t0 = time.time()
    res = [engine.query_dense_batch(b, top_k=10) for b in batches]
    sec = time.time() - t0
    launches, moe_launches = (T.dense_topk_cuda.launches,
                              M.moe_gemm_cuda.launches)
    moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    for b, r in zip(batches, res):
        if r.hits.ids.shape != (len(b), 10) or not np.isfinite(
                r.hits.scores).all():
            fail(f"dsv2 dense output {r.hits.ids.shape} or non-finite")
    if launches != len(batches):
        fail(f"{launches} dense_topk launches in the DeepSeek dense run, "
             f"not one for each of its {len(batches)} batches")
    if moe_launches != 2 * moe_layers * len(batches):
        fail(f"{moe_launches} moe_gemm launches in the DeepSeek dense run, "
             f"not two for each of its {moe_layers} MoE layers a batch")
    log(f"[dsv2] query_dense_batch: {len(batches) * BATCH / sec:.1f} q/s "
        f"over {len(batches)} batches of {BATCH} (host tokenize + trunk + "
        f"B1 + fetch); launches: dense_topk {launches}, moe_gemm "
        f"{moe_launches} ({smi})")

    q = engine.embed_dense_queries(batches[0])
    kern = kernel_at_shape(T, q, engine._emb, 10, smi, "dsv2")
    np.testing.assert_array_equal(res[0].hits.ids, kern["ids"].cpu().numpy())
    kern.update(launches=launches, bound_share=kern["bound_ms"] / kern["ms"])
    layer = enc.params["layers"][cfg.first_k_dense_replace]
    del q
    close_engine(engine)
    del engine, idx
    torch.cuda.empty_cache()
    moe = moe_kernel_at_shape(M, layer["experts"], DSV2_SLOTS, dev, smi)
    moe["launches"] = moe_launches
    del enc, layer
    torch.cuda.empty_cache()
    return {"dense_topk": kern, "moe_gemm": moe}


def bound_ms(B: int, N: int, d: int, k: int, corpus_bytes: int,
             passes: int = BF16_PASSES):
    """(least ms, "operations" or "bytes"): the larger of the score
    operations (``passes`` bf16 tensor-core passes of 2*B*N*d) over the bf16
    peak and the bytes (Q f32 and the corpus read once, the f32 + int32
    [B, k] outputs written once) over the memory rate."""
    ops_ms = passes * 2.0 * B * N * d / PEAK_BF16_FLOPS * 1e3
    bytes_ms = (B * d * 4 + corpus_bytes + B * k * 8) / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=47000,
                    help="synthetic samples (47,000 -> 1,034,000 rows)")
    args = ap.parse_args()
    cache = index_cache(args.samples)
    if not (REPO / "a_modular_rag_framework_torch").is_dir():
        fail("the a_modular_rag_framework_torch package is not beside "
             "chip_smoke.py; run it from a checkout of the repo")
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))  # e2e_run_torch (phases 13, 17)
    import numpy as np
    import torch

    # ---------------- 1. card ----------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs a "
             "CUDA device and has no CPU mode")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    from a_modular_rag_framework_torch.core import dataset_loader as loader
    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.index import (PackedIndex,
                                                     SentenceCorpus,
                                                     build_packed_index)
    from a_modular_rag_framework_torch.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_torch.native.binding import native_available
    from a_modular_rag_framework_torch.ops import hash_embed as H
    from a_modular_rag_framework_torch.ops import moe as M
    from a_modular_rag_framework_torch.ops import topk as T

    native_ok = native_available()
    check_imports()
    log(f"[card] no jax/pydantic/yaml or JAX-package module loaded; native "
        f"host library (the port's csrc/text_native.cpp) loaded: {native_ok}")

    # ---------------- 2. build ----------------
    t0 = time.time()
    info = T.build_dense_topk()
    log(f"[build] dense_topk: nvcc {info['seconds']:.2f}s "
        f"(phase {time.time() - t0:.2f}s) -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if line.strip():
            log(f"[build]   {line.strip()}")
    log(f"[build] SASS of {Path(info['path']).name}: {sass_counts(info['path'])}")
    t0 = time.time()
    hinfo = H.build_hash_embed()
    log(f"[build] hash_embed: nvcc {hinfo['seconds']:.2f}s "
        f"(phase {time.time() - t0:.2f}s) -> {hinfo['path']}")
    for line in hinfo["ptxas"].splitlines():
        if line.strip():
            log(f"[build]   {line.strip()}")

    t0 = time.time()
    minfo = M.build_moe_gemm()
    log(f"[build] moe_gemm: nvcc {minfo['seconds']:.2f}s "
        f"(phase {time.time() - t0:.2f}s) -> {minfo['path']}")
    for line in minfo["ptxas"].splitlines():
        if line.strip():
            log(f"[build]   {line.strip()}")

    # ---------------- 3. kernel vs plain on the card ----------------
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def check_case(name, q, d, k, exact):
        s, i = T.dense_topk_cuda(q, d, k)
        torch.cuda.synchronize()
        s_ref, i_ref = T.dense_topk_reference(q, d, k)
        if exact:  # integer-valued inputs: every score exact in any order
            if not (torch.equal(i, i_ref) and torch.equal(s, s_ref)):
                fail(f"kernel case {name}: ids/scores differ from the plain "
                     f"version ({int((i != i_ref).sum())} ids)")
            err, rows = 0.0, []
        else:
            try:
                err, rows = compare_topk(i.cpu(), s.cpu(), i_ref.cpu(),
                                         s_ref.cpu(), SCORE_ATOL)
            except AssertionError as e:
                fail(f"kernel case {name}: {e}")
            if not torch.equal(i, i_ref):
                fail(f"kernel case {name}: tie-free inputs, ids differ in "
                     f"rows {rows[:5]}")
        log(f"[kernel] {name}: ok (max |ds| {err:.3g})")
        return err

    def ints(shape, lo, hi, dtype=torch.float32):
        return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)

    max_err = 0.0
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q = torch.rand((9, 64), generator=g, device=dev) + 0.1
        d = (-(torch.rand((777, 64), generator=g, device=dev) + 0.1)).to(dtype)
        max_err = max(max_err, check_case(f"all-negative {tag}", q, d, 13,
                                          exact=False))
        base = ints((250, 16), -4, 5)
        d = base.repeat_interleave(4, dim=0).to(dtype)  # 4 copies of each row
        check_case(f"exact ties {tag}", ints((33, 16), -3, 4), d, 40,
                   exact=True)
        check_case(f"N % tile != 0 {tag}", ints((70, 33), -3, 4),
                   ints((1037, 33), -4, 5, dtype), 17, exact=True)
        check_case(f"k = 1 {tag}", ints((65, 64), -3, 4),
                   ints((5000, 64), -4, 5, dtype), 1, exact=True)
        check_case(f"k = 256 {tag}", ints((5, 130), -3, 4),
                   ints((3001, 130), -4, 5, dtype), 256, exact=True)
        check_case(f"k = 100 d 130, 2 query tiles {tag}",
                   ints((130, 130), -3, 4), ints((4099, 130), -4, 5, dtype),
                   100, exact=True)
        max_err = max(max_err, check_case(
            f"random d 64 k 10 {tag}", torch.randn((200, 64), generator=g,
                                                   device=dev),
            torch.randn((20000, 64), generator=g, device=dev).to(dtype), 10,
            exact=False))

    N_BIG = 1_034_000
    qb = torch.randn((256, 64), generator=g, device=dev)
    db = torch.randn((N_BIG, 64), generator=g, device=dev).to(torch.bfloat16)
    big = {}
    for k in (10, 100):
        max_err = max(max_err, check_case(f"B256 N{N_BIG} d64 k{k} bf16",
                                          qb, db, k, exact=False))
        # plain, kernel, kernel, plain
        p1 = cuda_ms(lambda: T.dense_topk_reference(qb, db, k), 5)
        k1 = cuda_ms(lambda: T.dense_topk_cuda(qb, db, k), 10)
        k2 = cuda_ms(lambda: T.dense_topk_cuda(qb, db, k), 10)
        p2 = cuda_ms(lambda: T.dense_topk_reference(qb, db, k), 5)
        big[k] = (min(k1, k2), min(p1, p2))
        b_ms, _ = bound_ms(256, N_BIG, 64, k, db.numel() * 2)
        log(f"[kernel] B256 N{N_BIG} d64 k{k} bf16: kernel {big[k][0]:.3f} ms"
            f" ({k1:.3f} / {k2:.3f}), plain {big[k][1]:.3f} ms, bound "
            f"{b_ms:.3f} ms ({smi})")
    del qb, db
    torch.cuda.empty_cache()

    # ---------------- 19. DeepSeek-V2-Lite dense embedder ----------------
    t0 = time.time()
    dsv2 = dsv2_phase(loader, T, M, dev, smi)
    max_err = max(max_err, dsv2["dense_topk"]["max_abs_err"])
    log(f"[dsv2] phase {time.time() - t0:.1f}s")

    # ---------------- 4. corpus + index (host) ----------------
    t0 = time.time()
    samples = loader.SyntheticHotpotQALoader(
        {"count": args.samples, "seed": 0, "n_distractors": 8,
         "collide_entities": True}).load()
    log(f"[index] {len(samples)} samples generated in {time.time() - t0:.1f}s")
    t0 = time.time()
    if (cache / "manifest.json").exists():
        idx = PackedIndex.load(cache)
        log(f"[index] loaded cached index {cache} in {time.time() - t0:.1f}s")
    else:
        corpus = SentenceCorpus.from_hotpotqa(samples)
        idx = build_packed_index(corpus, embed_dim=64, embed_dtype="bfloat16",
                                 out_dir=str(cache))
        log(f"[index] built {idx.n_docs} rows in {time.time() - t0:.1f}s "
            f"(host, incl. save): {idx.manifest['build_stats']}")
    n_docs = idx.n_docs
    log(f"[index] rows {n_docs}, postings {idx.bm25.doc_ids.shape[0]}, "
        f"vocab {len(idx.bm25.vocab)}, graph degree "
        f"{idx.graph_next.shape[1] + idx.graph_entity.shape[1]}")

    # ---------------- 5. hybrid path on the card ----------------
    cfg = dict(SCALE_CONFIG)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    engine = TorchQueryEngine(idx, device=dev, config=EngineConfig(**cfg))
    torch.cuda.synchronize()
    log(f"[hybrid] index uploaded in {time.time() - t0:.1f}s: "
        f"{engine.device_bytes()} bytes of index tensors, "
        f"{torch.cuda.memory_allocated(dev) - mem0} bytes allocated on the card")
    questions = [s["question"] for s in samples]
    eval_samples = samples[: HYBRID_BATCHES * BATCH]
    batches = [questions[i: i + BATCH]
               for i in range(0, len(eval_samples), BATCH)]
    t0 = time.time()
    # warm-up: allocator, sort workspaces, and the pipelining worker
    # thread's own CUDA handles
    engine.query_batch(batches[0])
    list(engine.query_batches_pipelined(batches[:1]))
    engine.query_dense_batch(batches[0])
    log(f"[hybrid] warm-up {time.time() - t0:.2f}s")

    # the main path's run: counts from 0, read right after
    T.dense_topk_cuda.launches = 0
    H.hash_embed_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    quality = evaluate_retrieval(engine, eval_samples, k=10, batch_size=BATCH)
    torch.cuda.synchronize()
    t0 = time.time()
    piped = list(engine.query_batches_pipelined(batches))
    pipe_sec = time.time() - t0
    engine.close()
    t0 = time.time()
    dense_res = [engine.query_dense_batch(b, top_k=10) for b in batches]
    dense_sec = time.time() - t0
    launches = T.dense_topk_cuda.launches
    hash_launches = H.hash_embed_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)

    for b, r in zip(batches + batches, piped + dense_res):
        if r.hits.ids.shape != (len(b), 10) or not np.isfinite(
                r.hits.scores).all():
            fail(f"bad output shape {r.hits.ids.shape} or non-finite scores")
    n_q = len(eval_samples)
    log(f"[hybrid] evaluate_retrieval over {quality['n']} questions "
        f"(B {BATCH}): recall@10 {quality['recall_at_10']:.4f}, "
        f"MRR {quality['mrr']:.4f}, {quality['qps']} q/s (harness, "
        f"synchronous, host prep included)")
    log(f"[hybrid] query_batches_pipelined: {n_q / pipe_sec:.1f} q/s "
        f"({pipe_sec:.3f}s for {n_q}); peak device memory {peak} bytes "
        f"({smi})")
    if quality["n"] != n_q or not quality["recall_at_10"] > 0.5:
        fail(f"hybrid recall {quality['recall_at_10']} over {quality['n']}")

    # the same questions through the port on the CPU, in the form the card
    # took: under graph_impl="auto" a 64-row batch of 1,034,000 rows fits
    # the dense form's 256 MB rule, a 4096-row batch does not
    form = engine.query_batch(batches[0][:8]).diagnostics["graph_impl"]
    if form != "compact":
        fail(f"B {BATCH} x N {n_docs} took the {form} form under auto")
    cpu_cfg = dict(cfg, batch_buckets=(CPU_QUESTIONS,), graph_impl=form)
    cpu_engine = TorchQueryEngine(idx, device="cpu",
                                  config=EngineConfig(**cpu_cfg))
    qs = questions[:CPU_QUESTIONS]
    r_gpu = engine.query_batch(qs)
    r_cpu = cpu_engine.query_batch(qs)
    card_vs_cpu("hybrid", r_gpu.hits.ids, r_gpu.hits.scores,
                r_cpu.hits.ids, r_cpu.hits.scores, HYBRID_ATOL)

    # ---------------- 6. dense-only path ----------------
    log(f"[dense] query_dense_batch: {n_q / dense_sec:.1f} q/s over {n_q} "
        f"questions (B {BATCH}, host packing + hash kernel + top-k kernel + "
        f"fetch) ({smi})")
    if launches < 1:
        fail("the dense-only path never launched the dense_topk kernel")
    log(f"[dense] dense_topk kernel launches in the main-path run: {launches}")
    # one hash launch a batch of each path: evaluate_retrieval, pipelined,
    # dense-only
    if hash_launches != 3 * len(batches):
        fail(f"{hash_launches} hash_embed launches in the main-path run, "
             f"not one for each of its {3 * len(batches)} batches")
    log(f"[dense] hash_embed kernel launches in the main-path run: "
        f"{hash_launches}")
    hash_main = hash_kernel_at_shape(H, batches[0], dev, smi)

    q = engine.embed_dense_queries(batches[0])
    main = kernel_at_shape(T, q, engine._emb, 10, smi, "dense")
    max_err = max(max_err, main["max_abs_err"])
    np.testing.assert_array_equal(dense_res[0].hits.ids,
                                  main["ids"].cpu().numpy())
    hash_dense = gold_metrics(engine, eval_samples, np.concatenate(
        [r.hits.ids for r in dense_res]))
    log(f"[dense] hash encoder d 64, dense-only: recall@10 "
        f"{hash_dense[0]:.4f}, MRR {hash_dense[1]:.4f}")
    del q

    # ---------------- 7. iterative 2-hop ----------------
    t0 = time.time()
    it = iterative_phase(engine, cpu_engine, eval_samples, batches,
                         quality["recall_at_10"], smi)
    log(f"[iterative] phase {time.time() - t0:.1f}s")
    del cpu_engine

    # ---------------- 8. QueryServer ----------------
    t0 = time.time()
    served = server_phase(engine, questions, smi)
    log(f"[server] phase {time.time() - t0:.1f}s")

    # ---------------- 18. HTTP front, graph store, profile, NaN switch ----
    t0 = time.time()
    surface = surface_phase(loader, engine, questions, dev, smi)
    log(f"[surface] phase {time.time() - t0:.1f}s")
    close_engine(engine)
    del engine
    torch.cuda.empty_cache()

    # ---------------- 9. dense [B, N] form, headline config ----------------
    t0 = time.time()
    head = headline_phase(loader, dev, smi)
    log(f"[headline] phase {time.time() - t0:.1f}s")

    # ---------------- 10. learned dense ----------------
    t0 = time.time()
    learned_engine, learned = learned_dense_phase(
        T, idx, cache, eval_samples, batches, quality, hash_dense, dev, smi)
    max_err = max(max_err, learned["max_abs_err"])
    log(f"[learned] phase {time.time() - t0:.1f}s")

    # ---------------- 12. cross-encoder rerank ----------------
    # (before phase 11: it re-ranks the learned engine's hits)
    t0 = time.time()
    reranked = rerank_phase(learned_engine, samples, dev, smi)
    log(f"[rerank] phase {time.time() - t0:.1f}s")
    close_engine(learned_engine)
    del learned_engine
    torch.cuda.empty_cache()

    # ---------------- 11. SPLADE channel ----------------
    t0 = time.time()
    splade = splade_phase(loader, idx, samples, dev, smi)
    log(f"[splade] phase {time.time() - t0:.1f}s")
    # ---------------- 16. sharding on the one card ----------------
    t0 = time.time()
    sharded, shard_kern = sharded_phase(loader, T, samples, dev, smi)
    max_err = max(max_err, shard_kern["max_abs_err"])
    log(f"[sharded] phase {time.time() - t0:.1f}s")
    # ---------------- 13-14. answer_question ----------------
    del idx
    qa = qa_phases(loader, samples, args.samples, n_docs, dev, smi)
    del samples
    # ---------------- 15. training ----------------
    t0 = time.time()
    trained = train_phase(loader, T, dev, smi)
    log(f"[train] phase {time.time() - t0:.1f}s")
    learned_summary = {k: v for k, v in learned.items() if k != "ids"}
    log(json.dumps({"iterative_1m": it, "server_1m": served,
                    "headline": head, "learned_dense": learned_summary,
                    "splade": splade, "rerank": reranked, **qa,
                    "training": trained, "sharded": sharded,
                    "surface": surface}))

    check_imports()
    log(smi)
    common = {"name": "dense_topk", "route": "cuda",
              "source": "a_modular_rag_framework_torch/csrc/dense_topk.cu",
              "replaces": "a_modular_rag_framework_tpu/ops/topk.py:197",
              "max_abs_err": max_err}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    # one entry per main-path shape: the hash encoder's d 64 (phase 6), the
    # learned encoder's d 128 (phase 10) and one shard of phase 16's sharded
    # dense path, each with its own run's count; then the hash kernel at
    # phase 6's shape
    print(json.dumps({"kernels": [
        {**common, "launches": launches, **{k: main[k] for k in keys},
         "bound_share": main["bound_ms"] / main["ms"],
         "b256_k10_ms": big[10][0], "b256_k10_plain_ms": big[10][1],
         "b256_k100_ms": big[100][0], "b256_k100_plain_ms": big[100][1]},
        {**common, "launches": learned["launches"],
         **{k: learned[k] for k in keys},
         "bound_share": learned["bound_ms"] / learned["ms"]},
        {**common, "launches": sharded["dense"]["launches"],
         **{k: shard_kern[k] for k in keys},
         "bound_share": shard_kern["bound_ms"] / shard_kern["ms"],
         "path": f"sharded dense, {SHARDS} shards of one card"},
        {"name": "hash_embed", "route": "cuda",
         "source": "a_modular_rag_framework_torch/csrc/hash_embed.cu",
         "replaces": "none: the JAX package hashes queries on the host",
         "launches": hash_launches, **hash_main,
         "bound_share": hash_main["bound_ms"] / hash_main["ms"]},
        {**common, **{k: v for k, v in dsv2["dense_topk"].items()
                      if k != "ids"},
         "path": "DeepSeek-V2-Lite dense embedder, d 2048 (phase 19)"},
        dsv2["moe_gemm"],
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
