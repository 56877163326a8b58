#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--samples 47000]

Drives the port's main path (a_modular_rag_framework_torch) once through
the entry points a user calls, on the repo's own 1M-row scale corpus
(SyntheticHotpotQALoader, 47,000 samples, collide entities -> 1,034,000
sentence rows; hash embeddings d = 64 in bf16):

  1. card check: CUDA present, card name + power limit, no jax / pydantic /
     yaml imported by the port;
  2. build the hand-written kernel (nvcc) and report the build time;
  3. kernel vs its plain PyTorch version on the card: adversarial cases,
     then B 256 x N 1,034,000 x d 64, k 10 and 100, both timed;
  4. corpus + index build on the host (cached under data/torch_smoke_<n>);
  5. hybrid path (TorchQueryEngine.query_batch through
     eval.harness.evaluate_retrieval, plus query_batches_pipelined) at the
     scale operating point; 64 questions compared with the port on the CPU;
  6. dense-only path (query_dense_batch), which launches the kernel; the
     kernel is also held against the plain version at this shape.

Any failed phase exits non-zero. The last lines are the card line, one
{"kernels": [...]} JSON line and the {"ok": true, ...} JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 4096
HYBRID_BATCHES = 3
CPU_QUESTIONS = 64
# scores: f32 dot products / BM25 sums taken in different orders on the
# card and on the CPU (or in cuBLAS vs the kernel); |score| <= ~10 here
SCORE_ATOL = 1e-4
HYBRID_ATOL = 1e-5
# the scale operating point of bench.py:207-235 (make_scale_engine)
SCALE_CONFIG = dict(top_k=10, pool_k=200, graph_window=2,
                    batch_buckets=(BATCH,), query_df_ratio_max=0.05,
                    bm25_term_topm=16, graph_compact_cap=128,
                    dense_impl="pool", alpha_text=0.15, alpha_graph=0.70,
                    alpha_dense=0.15, order_alphas=(0.4, 0.2, 0.4))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=47000,
                    help="synthetic samples (47,000 -> 1,034,000 rows)")
    args = ap.parse_args()
    cache = REPO / "data" / f"torch_smoke_{args.samples}"
    if not (REPO / "a_modular_rag_framework_torch").is_dir():
        fail("the a_modular_rag_framework_torch package is not beside "
             "chip_smoke.py; run it from a checkout of the repo")
    sys.path.insert(0, str(REPO))
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

    from a_modular_rag_framework_torch._host import load_shared_module
    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.index import (PackedIndex,
                                                     SentenceCorpus,
                                                     build_packed_index)
    from a_modular_rag_framework_torch.ops import topk as T
    from a_modular_rag_framework_tpu.eval.harness import evaluate_retrieval
    from a_modular_rag_framework_tpu.native.binding import native_available

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "pydantic", "yaml"))
    if leaked:
        fail(f"the port imported {leaked[:5]}")
    log(f"[card] no jax/pydantic/yaml imported; native host library "
        f"loaded: {native_available()}")

    # ---------------- 2. build ----------------
    t0 = time.time()
    info = T.build_dense_topk()
    log(f"[build] dense_topk: nvcc {info['seconds']:.2f}s "
        f"(phase {time.time() - t0:.2f}s) -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
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
        log(f"[kernel] B256 N{N_BIG} d64 k{k} bf16: kernel {big[k][0]:.3f} ms"
            f", plain {big[k][1]:.3f} ms ({smi})")
    del qb, db
    torch.cuda.empty_cache()

    # ---------------- 4. corpus + index (host) ----------------
    t0 = time.time()
    loader = load_shared_module("core/dataset_loader.py")
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

    # the same questions through the port on the CPU
    cpu_cfg = dict(cfg, batch_buckets=(CPU_QUESTIONS,))
    cpu_engine = TorchQueryEngine(idx, device="cpu",
                                  config=EngineConfig(**cpu_cfg))
    qs = questions[:CPU_QUESTIONS]
    r_gpu = engine.query_batch(qs)
    r_cpu = cpu_engine.query_batch(qs)
    try:
        err, rows = compare_topk(r_gpu.hits.ids, r_gpu.hits.scores,
                                 r_cpu.hits.ids, r_cpu.hits.scores,
                                 HYBRID_ATOL)
    except AssertionError as e:
        fail(f"hybrid card vs CPU: {e}")
    for r in rows:
        log(f"[hybrid]   row {r} differs only inside a score tie: card "
            f"{r_gpu.hits.ids[r].tolist()} vs cpu {r_cpu.hits.ids[r].tolist()}")
    log(f"[hybrid] card vs CPU on {CPU_QUESTIONS} questions: "
        f"{CPU_QUESTIONS - len(rows)} rows with identical ids, {len(rows)} "
        f"differing only inside exact score ties; max |ds| {err:.3g} "
        f"(atol {HYBRID_ATOL})")
    del cpu_engine

    # ---------------- 6. dense-only path ----------------
    log(f"[dense] query_dense_batch: {n_q / dense_sec:.1f} q/s over {n_q} "
        f"questions (B {BATCH}, host encode + kernel + fetch) ({smi})")
    if launches < 1:
        fail("the dense-only path never launched the dense_topk kernel")
    log(f"[dense] dense_topk kernel launches in the main-path run: {launches}")

    # the kernel at the main path's shape vs the plain version (in 256-row
    # chunks: the plain [4096, N] f32 matrix + its sort would need ~70 GB)
    q = torch.from_numpy(engine.encoder.encode_texts(batches[0])).to(dev)
    emb = engine._emb
    k = 10
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
        fail(f"dense kernel at the main-path shape: {e}")
    max_err = max(max_err, err)
    np.testing.assert_array_equal(dense_res[0].hits.ids, i.cpu().numpy())
    p1 = cuda_ms(plain_chunked, 2)
    k1 = cuda_ms(lambda: T.dense_topk_cuda(q, emb, k), 5)
    k2 = cuda_ms(lambda: T.dense_topk_cuda(q, emb, k), 5)
    p2 = cuda_ms(plain_chunked, 2)
    main_ms, main_plain = min(k1, k2), min(p1, p2)
    log(f"[dense] kernel at B{BATCH} N{n_docs} d64 k{k} bf16: {main_ms:.3f} ms,"
        f" plain (16 x 256-row chunks) {main_plain:.3f} ms; {len(rows)} rows "
        f"differ only inside exact score ties; max |ds| {err:.3g} ({smi})")

    log(smi)
    print(json.dumps({"kernels": [{
        "name": "dense_topk",
        "route": "cuda",
        "source": "a_modular_rag_framework_torch/csrc/dense_topk.cu",
        "replaces": "a_modular_rag_framework_tpu/ops/topk.py:197",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_ms,
        "plain_ms": main_plain,
        "shape": f"B{BATCH} N{n_docs} d64 k{k} bf16",
        "b256_k10_ms": big[10][0], "b256_k10_plain_ms": big[10][1],
        "b256_k100_ms": big[100][0], "b256_k100_plain_ms": big[100][1],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
