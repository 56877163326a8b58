"""Where the device time goes in the port's hybrid, dense-only, iterative
and headline dense [B, N] paths, and in the learned-model paths (learned
dense, SPLADE, cross-encoder rerank).

    python3 tools/profile_torch_engine.py [--samples 47000] [--batches 2]
                                          [--out runs/torch_profile]
                                          [--mode engine|qa|train]

Loads (or builds) the chip smoke's index (chip_smoke.index_cache(samples)),
builds TorchQueryEngine on cuda:0 at chip_smoke.SCALE_CONFIG, and reports:

  - a torch.profiler window over synchronous query_batch calls: device
    time per engine stage (the engine/<stage> ranges), the top kernels by
    device time, the device busy share of the window, and the host split
    of the calls by stage (the program's stage table,
    `telemetry.stages`: host prep, the program's stages, the fetch);
  - the same for query_dense_batch and for iterative_retrieve, with the
    iterative mode's host split (hop-1 call, bridge extraction + hop-2
    dispatch, hop-2 wait, merge);
  - the same window for the dense [B, N] form at chip_smoke's headline
    configuration (13.2k rows, B 2048).

  - the learned models at chip_smoke's configurations: the TextEncoder's
    corpus embed and the learned dense-only and hybrid paths at 1,034,000
    rows (the sidecar beside the cached index when it is there, else
    embedded here); the SPLADE corpus expansion, and the engine's SPLADE
    channel on the 4,600-sample corpus; the cross-encoder over 10,240
    pairs. Each with its host tokenize seconds beside the window, and the
    model/<stage> ranges (trunk, splade_head, sparsify_topk,
    cross_encoder) beside the engine/<stage> ones.

``--mode qa`` profiles `answer_question` instead: chip_smoke's phases 13
and 14 and its semantic-edge check run first (the same functions, the same
checks), then a torch.profiler window over 8 questions at each size
(6,600 rows, the recorded configuration; the 1,034,000-row index): wall
time, device busy share, the engine/<stage> ranges and the top kernels.
It writes <out>/profile_torch_qa.json.

``--mode train`` runs chip_smoke's phase 15 (the same functions, the same
checks; it builds the kernel for `dense_eval`'s top-20 and the 101,200-row
index when they are not there), then profiles the three trainers at its
widths (`chip_smoke.train_probe_cases`: encoder 1,024 pairs at the Main
width, cross-encoder 32 x 8 pairs, SPLADE 64 pairs), without the corpus:
whether ``torch.mm(..., out_dtype=float32)`` has an autograd formula in
this torch; the card's dense layer (`models.encoder._MatmulF32`) beside
the plain widened-f32 form, forward + backward, at the trunk's MLP shape;
and per trainer the forward / backward / optimizer split (CUDA events),
steps/s of the step alone, a profiler window over a few steps (busy share,
launches per step, top kernels), the peak memory, and whether two
gradients from one state are bit for bit equal. It writes
<out>/profile_torch_train.json.

Writes <out>/profile_torch.json and a chrome trace beside it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def window(fn):
    """Run ``fn`` under torch.profiler: (the profile, {wall ms, device busy
    ms and share, device ms per engine/ and model/ range, host ms per
    range and its count from the stage table, kernel launches, the top
    kernels})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from a_modular_rag_framework_torch.telemetry.stages import (
        reset_stage_table, stage_table)

    reset_stage_table()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    # device-side kernel and copy events only: the CPU ops' own device
    # columns and the engine/<stage> GPU ranges would count twice
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in avg
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
         and not e.key.startswith(("engine/", "model/"))),
        key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in kernels)
    stages = {e.key: e.device_time_total / 1e3 for e in avg
              if e.key.startswith(("engine/", "model/"))}
    return prof, {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                  "device_busy_share": busy / (wall * 1e3),
                  "stage_device_ms": stages,
                  "stage_host_ms": {name: {"count": n, "ms": sec * 1e3}
                                    for name, (n, sec) in
                                    sorted(stage_table().items())},
                  "kernel_launches": sum(c for _, _, c in kernels),
                  "top_kernels": [{"name": k[:120], "ms": ms, "count": c}
                                  for k, ms, c in kernels[:25]]}


def smi_line() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def profile_qa(args, loader, samples, n_docs, dev) -> int:
    """chip_smoke's QA phases, then a profiler window over 8 questions at
    each of the two sizes."""
    import shutil
    import tempfile

    import chip_smoke as cs
    from a_modular_rag_framework_torch import system
    from a_modular_rag_framework_torch.cli.ingest_hotpotqa import ingest

    smi = smi_line()
    report = cs.qa_phases(loader, samples, args.samples, n_docs, dev, smi)

    work = REPO / "data" / "torch_smoke_qa"
    runs = Path(tempfile.mkdtemp(prefix="profile_", dir=work))
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        small = dict(cs.QA_RECORDED, type="synthetic_hotpotqa")
        small_samples = loader.SyntheticHotpotQALoader(small).load()
        ingest(small_samples, graph_root=work / "recorded" / "graph",
               docs_out=work / "recorded" / "docs.jsonl")
        big = {"type": "synthetic_hotpotqa", "count": 16, "seed": 0,
               "n_distractors": 8, "collide_entities": True}
        cases = (
            ("qa_6600", small_samples, cs.write_qa_settings(
                work / "profile_recorded.json",
                docs=work / "recorded" / "docs.jsonl",
                graph_root=work / "recorded" / "graph",
                root_dir=runs / "graphs_small", dataset=small)),
            ("qa_1m", samples, cs.write_qa_settings(
                work / "profile_scale.json",
                docs=cs.index_cache(args.samples).with_suffix(""),
                graph_root=runs / "graphs_big", root_dir=runs / "graphs_big",
                dataset=big, index=cs.QA_SCALE_INDEX,
                retrieval={"bm25_pool_k": 200})),
        )
        for name, rows, settings in cases:
            def ask(lo, hi):
                return [system.answer_question(
                    r["question"], mode="full", settings_path=settings,
                    runs_dir=str(runs / name)) for r in rows[lo:hi]]
            ask(0, 4)  # builds the system, warms the allocator
            prof, report[f"profile_{name}"] = window(lambda: ask(4, 12))
            prof.export_chrome_trace(str(out_dir / f"trace_torch_{name}.json"))
            system.reset_system_cache()
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    report["device"] = smi
    (out_dir / "profile_torch_qa.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({
        name: {"wall_ms_per_question": w["wall_ms"] / 8,
               "device_busy_share": w["device_busy_share"],
               "device_busy_ms_per_question": w["device_busy_ms"] / 8,
               "stage_device_ms": w["stage_device_ms"],
               "top10": w["top_kernels"][:10]}
        for name, w in report.items() if name.startswith("profile_")},
        indent=1))
    return 0


def profile_train(args, loader, dev, steps: int = 10) -> int:
    """The three trainers at chip_smoke's phase-15 widths (module
    docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from a_modular_rag_framework_torch._host import upload_batch
    from a_modular_rag_framework_torch.models import encoder as enc_mod
    from a_modular_rag_framework_torch.models.optim import (
        adamw_init, adamw_update, make_step, value_and_grad)
    from a_modular_rag_framework_torch.models.params import (
        flatten_params, tree_leaves, tree_map, tree_unflatten)

    from a_modular_rag_framework_torch.ops import topk as T

    # chip_smoke's phase 15 first: the same functions, the same checks
    report = {"device": smi_line(), "torch": torch.__version__,
              "phase_15": cs.train_phase(loader, T, dev, smi_line())}

    # does the out_dtype form differentiate by itself in this torch?
    a = torch.randn(64, 64, device=dev).to(torch.bfloat16).requires_grad_()
    b = torch.randn(64, 64, device=dev).to(torch.bfloat16).requires_grad_()
    try:
        torch.mm(a, b, out_dtype=torch.float32).sum().backward()
        report["mm_out_dtype_autograd"] = (
            f"backward ran; grad dtypes {a.grad.dtype}, {b.grad.dtype}")
    except Exception as e:  # reported, whatever this torch raises
        report["mm_out_dtype_autograd"] = f"{type(e).__name__}: {e}"[:300]

    # the card's dense layer beside the plain form, forward + backward, at
    # the trunk's MLP shape of one encoder step (65,536 tokens, 128 -> 512)
    x = torch.randn(65536, 128, device=dev, requires_grad=True)
    w = torch.randn(128, 512, device=dev, requires_grad=True)

    def layer(fn):
        def run():
            x.grad = w.grad = None
            fn().sum().backward()
        return run

    card = layer(lambda: enc_mod._dot(x, w, torch.bfloat16))
    plain = layer(lambda: torch.matmul(x.to(torch.bfloat16).float(),
                                       w.to(torch.bfloat16).float()))
    t = [cs.cuda_ms(f, 20) for f in (plain, card, card, plain)]
    card()
    g_card = (x.grad.clone(), w.grad.clone())
    plain()
    report["dense_layer_65536x128x512"] = {
        "card_form_ms": min(t[1], t[2]), "plain_form_ms": min(t[0], t[3]),
        "max_abs_dgrad_x": float((g_card[0] - x.grad).abs().max()),
        "max_abs_dgrad_w": float((g_card[1] - w.grad).abs().max()),
        "max_abs_grad_w": float(w.grad.abs().max())}
    del x, w, g_card

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    lr = 1e-3
    for name, (loss_fn, params, batch) in cs.train_probe_cases(
            loader, dev).items():
        params = tree_map(lambda t: t.to(dev), params)
        batch = upload_batch(batch, dev)
        _, step = make_step(loss_fn, lr)
        state = adamw_init(params)
        for _ in range(3):
            step(params, state, batch)
        torch.cuda.synchronize()

        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(steps)]
        for e in ev:
            live = [t.detach().requires_grad_(True)
                    for t in tree_leaves(params)]
            e[0].record()
            loss, _ = loss_fn(tree_unflatten(params, live), batch)
            e[1].record()
            grads = torch.autograd.grad(loss, live)
            e[2].record()
            adamw_update(params, tree_unflatten(params, grads), state, lr)
            e[3].record()
        torch.cuda.synchronize()
        split = {k: float(np.mean([e[i].elapsed_time(e[i + 1]) for e in ev]))
                 for i, k in enumerate(("forward_ms", "backward_ms",
                                        "optimizer_ms"))}

        t0 = time.perf_counter()
        for _ in range(steps):
            step(params, state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps

        torch.cuda.reset_peak_memory_stats(dev)
        prof, w = window(lambda: [step(params, state, batch)
                                  for _ in range(steps)])
        prof.export_chrome_trace(str(out_dir / f"trace_torch_train_{name}.json"))
        peak = torch.cuda.max_memory_allocated(dev)

        g1 = flatten_params(value_and_grad(loss_fn, params, batch)[2])
        g2 = flatten_params(value_and_grad(loss_fn, params, batch)[2])
        report[name] = {
            **split, "step_ms": step_ms, "steps_per_sec": 1e3 / step_ms,
            "window_steps": steps, "window": w,
            "launches_per_step": w["kernel_launches"] / steps,
            "peak_bytes": peak,
            "gradient_leaves_that_differ_between_two_runs": [
                k for k in g1 if not np.array_equal(g1[k], g2[k])]}
    (out_dir / "profile_torch_train.json").write_text(
        json.dumps(report, indent=1))
    print(json.dumps({
        k: (v if not isinstance(v, dict) or "window" not in v else {
            **{kk: vv for kk, vv in v.items() if kk != "window"},
            "busy_share": v["window"]["device_busy_share"],
            "device_busy_ms_per_step": v["window"]["device_busy_ms"] / steps,
            "stage_device_ms": v["window"]["stage_device_ms"],
            "top8": v["window"]["top_kernels"][:8]})
        for k, v in report.items()}, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=47000)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--out", default=str(REPO / "runs" / "torch_profile"))
    ap.add_argument("--mode", choices=["engine", "qa", "train"],
                    default="engine")
    args = ap.parse_args()

    import torch

    from chip_smoke import (BATCH, HEADLINE_BATCH, HEADLINE_CONFIG,
                            HEADLINE_SAMPLES, LEARNED_ENCODER,
                            RERANK_QUESTIONS, RERANK_TOP, SCALE_CONFIG,
                            SPLADE_SAMPLES, index_cache)
    from a_modular_rag_framework_torch.core import dataset_loader as loader
    from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                      TorchQueryEngine)
    from a_modular_rag_framework_torch.index import (PackedIndex,
                                                     SentenceCorpus,
                                                     build_packed_index)
    from a_modular_rag_framework_torch.index import (
        attach_learned_embeddings, embed_corpus_pipelined,
        save_learned_embeddings)
    from a_modular_rag_framework_torch.models import (
        CrossEncoderConfig, CrossEncoderReranker, EncoderConfig,
        SpladeEncoder, TextEncoder)
    from a_modular_rag_framework_torch.models.cross_encoder import \
        encode_pairs
    from a_modular_rag_framework_torch.modules.retrieval import multihop
    from a_modular_rag_framework_torch.ops.splade import (SpladeDeviceIndex,
                                                          SpladeRetriever)

    if not torch.cuda.is_available():
        print("profile_torch_engine: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.mode == "train":
        return profile_train(args, loader, dev)
    cache = index_cache(args.samples)
    samples = loader.SyntheticHotpotQALoader(
        {"count": args.samples, "seed": 0, "n_distractors": 8,
         "collide_entities": True}).load()
    if (cache / "manifest.json").exists():
        idx = PackedIndex.load(cache)
    else:
        idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                                 embed_dim=64, embed_dtype="bfloat16",
                                 out_dir=str(cache))
    if args.mode == "qa":
        return profile_qa(args, loader, samples, idx.n_docs, dev)
    engine = TorchQueryEngine(idx, device=dev,
                              config=EngineConfig(**SCALE_CONFIG))
    qs = [s["question"] for s in samples]
    batches = [qs[i * BATCH:(i + 1) * BATCH] for i in range(args.batches)]
    engine.query_batch(batches[0])
    engine.query_dense_batch(batches[0])
    torch.cuda.synchronize()

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof_h, hybrid = window(lambda: [engine.query_batch(b) for b in batches])
    prof_h.export_chrome_trace(str(out_dir / "trace_torch_hybrid.json"))
    _, dense = window(lambda: [engine.query_dense_batch(b) for b in batches])

    # iterative 2-hop: the stages of iterative_retrieve, by hand
    multihop.iterative_retrieve(engine, batches[0], top_k=10)  # warm caches
    it_split = []
    for b in batches:
        t0 = time.perf_counter()
        r1 = engine.query_batch(b, top_k=20)
        t1 = time.perf_counter()
        ctx, p2 = multihop._prep_and_dispatch_hop2(
            engine, b, r1, top_k=10, hop1_inspect=20,
            max_bridge_entities=None, graph_window=None, trace_id="")
        t2 = time.perf_counter()
        r2 = p2.result()
        t3 = time.perf_counter()
        multihop._merge_hop2(b, ctx, r2, top_k=10, hop_decay=0.5,
                             hop2_reserve=None)
        t4 = time.perf_counter()
        it_split.append({"hop1_call_ms": (t1 - t0) * 1e3,
                         "bridge_and_hop2_dispatch_ms": (t2 - t1) * 1e3,
                         "hop2_wait_fetch_ms": (t3 - t2) * 1e3,
                         "merge_ms": (t4 - t3) * 1e3})
    _, iterative = window(lambda: [multihop.iterative_retrieve(
        engine, b, top_k=10) for b in batches])
    close = getattr(engine, "_mh_prep_pool", None)
    if close is not None:
        close.shutdown(wait=True)

    # the dense [B, N] form at the headline configuration
    h_samples = loader.SyntheticHotpotQALoader(
        {"count": HEADLINE_SAMPLES, "seed": 0, "n_distractors": 8,
         "unique_entities": True}).load()
    h_idx = build_packed_index(SentenceCorpus.from_hotpotqa(h_samples),
                               embed_dim=64, embed_dtype="bfloat16")
    h_engine = TorchQueryEngine(h_idx, device=dev,
                                config=EngineConfig(**HEADLINE_CONFIG))
    h_qs = [s["question"] for s in h_samples]
    h_qs = (h_qs * (HEADLINE_BATCH // len(h_qs) + 1))[:HEADLINE_BATCH]
    h_engine.query_batch(h_qs)
    prof_d, headline = window(lambda: [h_engine.query_batch(h_qs)
                                       for _ in batches])
    prof_d.export_chrome_trace(str(out_dir / "trace_torch_headline.json"))
    del h_engine, engine
    torch.cuda.empty_cache()

    def host_sec(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # ---- learned dense: corpus embed, dense-only and hybrid ----
    enc_cfg = EncoderConfig(**LEARNED_ENCODER)
    enc_ckpt = "data/encoder_collide.npz"
    enc = TextEncoder.load(str(REPO / enc_ckpt), enc_cfg, device=dev)
    texts = idx.corpus.texts()
    embed_corpus_pipelined(enc, texts[:BATCH], batch=BATCH)
    learned = {"tokenize_sec_per_batch": host_sec(
        lambda: enc.host_featurize(texts[:BATCH]))}
    _, learned["corpus_embed"] = window(lambda: embed_corpus_pipelined(
        enc, texts[:args.batches * BATCH], batch=BATCH))
    if attach_learned_embeddings(idx, cache, device=dev) is None:
        save_learned_embeddings(cache, embed_corpus_pipelined(
            enc, texts, batch=BATCH), enc_ckpt, enc_cfg)
        attach_learned_embeddings(idx, cache, device=dev)
    l_engine = TorchQueryEngine(idx, device=dev, encoder=enc,
                                config=EngineConfig(**SCALE_CONFIG))
    l_engine.query_batch(batches[0])
    l_engine.query_dense_batch(batches[0])
    prof_l, learned["dense_only"] = window(
        lambda: [l_engine.query_dense_batch(b) for b in batches])
    prof_l.export_chrome_trace(str(out_dir / "trace_torch_learned_dense.json"))
    _, learned["hybrid"] = window(
        lambda: [l_engine.query_batch(b) for b in batches])

    # ---- cross-encoder rerank of the learned engine's top hits ----
    rr_cfg = CrossEncoderConfig(subword_ngrams=8)
    rr = CrossEncoderReranker.load(
        str(REPO / "data" / "cross_encoder_collide.npz"), rr_cfg, device=dev)
    rr_qs = qs[:RERANK_QUESTIONS]
    top = l_engine.query_batch(rr_qs, top_k=RERANK_TOP).hits.ids
    docs = idx.corpus.docs
    flat_q = [q for q in rr_qs for _ in range(RERANK_TOP)]
    flat_p = [docs[int(i)].get("text", "") if i >= 0 else ""
              for row in top for i in row]
    rr.score_pairs(flat_q[:BATCH], flat_p[:BATCH])
    rerank = {"pairs": len(flat_p), "tokenize_sec": host_sec(
        lambda: encode_pairs(flat_q, flat_p, rr_cfg))}
    _, rerank["score_pairs"] = window(lambda: rr.score_pairs(flat_q, flat_p))
    l_engine.close()
    del l_engine, rr
    torch.cuda.empty_cache()

    # ---- SPLADE: corpus expansion and the engine's channel ----
    sp_ckpt = str(REPO / "data" / "splade_variety.npz")
    sp_cache = index_cache(SPLADE_SAMPLES)
    sp_samples = loader.SyntheticHotpotQALoader(
        {"count": SPLADE_SAMPLES, "seed": 0, "n_distractors": 8,
         "collide_entities": True}).load()
    if (sp_cache / "manifest.json").exists():
        sp_idx = PackedIndex.load(sp_cache)
    else:
        sp_idx = build_packed_index(SentenceCorpus.from_hotpotqa(sp_samples),
                                    embed_dim=64, embed_dtype="bfloat16",
                                    out_dir=str(sp_cache))
    sp_enc = SpladeEncoder.load(sp_ckpt, device=dev)
    sp_texts = sp_idx.corpus.texts()
    K = sp_enc.cfg.doc_top_terms
    sp_enc.expand_texts(sp_texts[:BATCH], k=K)
    splade = {"tokenize_sec_per_batch": host_sec(
        lambda: sp_enc.host_featurize(sp_texts[:BATCH]))}
    prof_s, splade["corpus_expand"] = window(lambda: [
        sp_enc.expand_texts(sp_texts[i * BATCH:(i + 1) * BATCH], k=K)
        for i in range(args.batches)])
    prof_s.export_chrome_trace(str(out_dir / "trace_torch_splade_expand.json"))
    if (sp_cache / "splade_index.npz").exists():
        sp_index = SpladeDeviceIndex.load(str(sp_cache / "splade_index.npz"))
    else:
        sp_index = SpladeRetriever(sp_enc, build_batch=BATCH).build(sp_texts)
        sp_index.save(str(sp_cache / "splade_index.npz"))
    s_engine = TorchQueryEngine(sp_idx, device=dev, config=EngineConfig(
        **dict(SCALE_CONFIG, bm25_term_topm=128, sparse_impl="splade",
               splade_weights=sp_ckpt)), splade_index=sp_index)
    sp_batches = [[s["question"] for s in
                   sp_samples[i * BATCH:(i + 1) * BATCH]]
                  for i in range(min(args.batches, len(sp_samples) // BATCH))]
    s_engine.query_batch(sp_batches[0])
    _, splade["hybrid"] = window(
        lambda: [s_engine.query_batch(b) for b in sp_batches])
    splade["batches"] = len(sp_batches)
    s_engine.close()
    report = {"device": torch.cuda.get_device_name(0), "rows": idx.n_docs, "batch": BATCH,
              "batches": args.batches, "hybrid": hybrid,
              "dense_only": dense, "iterative_split": it_split,
              "iterative": iterative, "headline_rows": h_idx.n_docs,
              "headline": headline, "learned": learned, "rerank": rerank,
              "splade_rows": sp_idx.n_docs, "splade": splade}
    (out_dir / "profile_torch.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"hybrid_stage_host_ms": hybrid["stage_host_ms"],
                      "hybrid_stage_device_ms": hybrid["stage_device_ms"],
                      "hybrid_busy_share": hybrid["device_busy_share"],
                      "hybrid_wall_ms": hybrid["wall_ms"],
                      "hybrid_top5": hybrid["top_kernels"][:5],
                      "dense_stage_host_ms": dense["stage_host_ms"],
                      "dense_busy_share": dense["device_busy_share"],
                      "dense_wall_ms": dense["wall_ms"],
                      "dense_top3": dense["top_kernels"][:3],
                      "iterative_split": it_split,
                      "iterative_stage_device_ms":
                          iterative["stage_device_ms"],
                      "iterative_busy_share": iterative["device_busy_share"],
                      "iterative_wall_ms": iterative["wall_ms"],
                      "headline_stage_device_ms": headline["stage_device_ms"],
                      "headline_busy_share": headline["device_busy_share"],
                      "headline_wall_ms": headline["wall_ms"],
                      "headline_top5": headline["top_kernels"][:5],
                      **{f"{name}_{part}": {
                          "wall_ms": w["wall_ms"],
                          "busy_share": w["device_busy_share"],
                          "stage_device_ms": w["stage_device_ms"],
                          "top5": w["top_kernels"][:5]}
                         for name, group in (("learned", learned),
                                             ("rerank", rerank),
                                             ("splade", splade))
                         for part, w in group.items()
                         if isinstance(w, dict)},
                      "learned_tokenize_sec_per_batch":
                          learned["tokenize_sec_per_batch"],
                      "rerank_tokenize_sec": rerank["tokenize_sec"],
                      "splade_tokenize_sec_per_batch":
                          splade["tokenize_sec_per_batch"]},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
