"""The port's counterpart of the repo root's ``__graft_entry__.py``.

``entry()``            -> (fn, example_args): the TextEncoder's forward on
                          one device.
``dryrun_multichip(n)`` -> runs the multi-device story on an n-position
                          mesh and raises RuntimeError on any mismatch:
  (a) the sharded train step on {data: n/2, model: 2};
  (b) sharded dense top-k == the single-device top-k;
  (c) the sharded hybrid engine == the single-device engine
      (`parallel.sharded_hybrid.dryrun_check`);
  (d) the same over a composed {dcn: 2, data: n/2} mesh;
  (e) sharded SPLADE posting scoring == the single-device scorer;
  (f) iterative 2-hop and (g) `QueryServer` over the sharded engine ==
      the single-device engine.

The JAX package runs its dryrun in a subprocess with n virtual CPU
devices. The port's mesh takes any list of positions, so it runs in
process: one position per card where there are n cards, else n positions
on one device (``device``, the card unless the caller says ``"cpu"``).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._host import require_device, to_device
from ..models.encoder import (EncoderConfig, TextEncoder, apply_encoder,
                              encode_tokens, init_params, seeded_generator)
from .mesh import build_mesh, mesh_devices, visible_devices


def _cfg() -> EncoderConfig:
    return EncoderConfig(vocab_size=1024, max_len=32, d_model=64, n_heads=4,
                         n_layers=2, d_ff=256)


def entry(device="cuda"):
    """(fn, example_args): ``fn(*example_args)`` is the TextEncoder's
    forward, [2, 64] embeddings on ``device``."""
    dev = require_device(device)
    cfg = _cfg()
    params = init_params(seeded_generator(0, dev), cfg)
    ids, mask = encode_tokens(["who wrote the book",
                               "a sentence about mountains"], cfg)
    fn = functools.partial(apply_encoder, cfg=cfg)
    return fn, (params, to_device(ids, dev), to_device(mask, dev))


def dryrun_devices(n_devices: int, device="cuda") -> List[torch.device]:
    """One position per card where ``device`` is a card and n cards are
    visible, else ``device`` n times."""
    dev = require_device(device)
    if dev.type == "cuda" and visible_devices(dev) >= n_devices > 1:
        return mesh_devices(dev, n_devices)
    return [dev] * n_devices


def dryrun_multichip(n_devices: int, *, device="cuda",
                     devices: Optional[Sequence] = None, log=print) -> None:
    """(a)-(g) of the module docstring over ``devices`` (default
    `dryrun_devices`); ``n_devices`` even and >= 2."""
    from ..ops.bm25 import bm25_topk_sorted
    from ..ops.splade import SpladeDeviceIndex
    from ..ops.topk import dense_topk
    from .sharded import (shard_corpus_rows, shard_splade_postings,
                          sharded_dense_topk, sharded_splade_topk)
    from .sharded_hybrid import dryrun_check
    from .train import shard_train_step

    if n_devices < 2 or n_devices % 2:
        raise ValueError(f"n_devices={n_devices}: the dryrun needs an even "
                         "count >= 2")
    devices = list(devices or dryrun_devices(n_devices, device))
    if len(devices) != n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    lead = torch.device(devices[0])

    # ---- (a) training step: data and tensor parallel ----
    cfg = _cfg()
    mesh = build_mesh({"data": n_devices // 2, "model": 2}, devices=devices)
    place_params, place_batch, init_state, step = shard_train_step(cfg, mesh)
    params = place_params(init_params(seeded_generator(0, lead), cfg))
    opt_state = init_state(params)
    batch_size = mesh.shape["data"] * 2
    queries = [f"question number {i} about topic {i}"
               for i in range(batch_size)]
    passages = [f"passage number {i} describing topic {i}"
                for i in range(batch_size)]
    batch = place_batch(TextEncoder.make_pair_batch(queries, passages, cfg))
    params, opt_state, metrics = step(params, opt_state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss: {loss}")
    log(f"dryrun train step ok: mesh={mesh.shape} loss={loss:.4f}")

    # ---- (b) sharded dense top-k: row shards, gather + merge ----
    data_mesh = build_mesh({"data": n_devices}, devices=devices)
    rng = np.random.default_rng(0)
    n_rows, dim, n_q, k = 64 * n_devices, 32, 16, 10
    emb = to_device(rng.standard_normal((n_rows, dim)).astype(np.float32),
                    lead)
    q = to_device(rng.standard_normal((n_q, dim)).astype(np.float32), lead)
    s_sh, i_sh = sharded_dense_topk(q, shard_corpus_rows(emb, data_mesh), k)
    s_ref, i_ref = dense_topk(q, emb, k)
    if not torch.equal(i_sh, i_ref):
        raise RuntimeError("sharded dense top-k ids diverge from the "
                           "single-device top-k")
    if not torch.allclose(s_sh, s_ref, atol=1e-5):
        raise RuntimeError("sharded dense top-k scores diverge from the "
                           "single-device top-k")
    log(f"dryrun sharded retrieval ok: {n_devices} shards, N={n_rows} "
        f"B={n_q} k={k} == single-device top-k")

    # ---- (c) the sharded hybrid engine ----
    dryrun_check(data_mesh)
    log(f"dryrun sharded hybrid ok: {n_devices} shards == single-device "
        f"engine")

    # ---- (d) composed (dcn, data) mesh: batch split over dcn ----
    composed = build_mesh({"dcn": 2, "data": n_devices // 2},
                          devices=devices)
    dryrun_check(composed)
    log(f"dryrun composed-mesh hybrid ok: mesh={composed.shape} == "
        f"single-device engine")

    # ---- (e) sharded learned-sparse (SPLADE) posting scoring ----
    n_docs, per_doc, vocab, qb, qt, sk = 10 * n_devices + 3, 5, 48, 6, 4, 5
    d_ids = rng.integers(0, vocab, size=(n_docs, per_doc)).astype(np.int32)
    d_w = (rng.random((n_docs, per_doc)) + 0.01).astype(np.float32)
    sp_idx = SpladeDeviceIndex.from_expansions(d_ids, d_w, vocab_size=vocab)
    t_ids = to_device(rng.integers(0, vocab, size=(qb, qt)).astype(np.int32),
                      lead)
    t_w = to_device((rng.random((qb, qt)) + 0.1).astype(np.float32), lead)
    ref_s, ref_i = bm25_topk_sorted(
        t_ids[:, None, :], to_device(sp_idx.doc_ids, lead),
        to_device(sp_idx.impacts, lead), to_device(sp_idx.row_ptr, lead),
        n_docs=n_docs, term_topm=n_docs, pool_k=sk,
        term_weights=t_w[:, None, :])
    sh_d, sh_imp, sh_rp, rows = shard_splade_postings(sp_idx, n_devices)
    sp_s, sp_i = sharded_splade_topk(
        t_ids, t_w, sh_d, sh_imp, sh_rp, mesh=data_mesh,
        rows_per_shard=rows, n_docs=n_docs, k=sk, term_topm=n_docs)
    if not torch.equal(sp_i.cpu(), ref_i.cpu()):
        raise RuntimeError("sharded splade ids diverge from the "
                           "single-device scorer")
    if not torch.allclose(sp_s.cpu(), ref_s.cpu(), rtol=1e-6):
        raise RuntimeError("sharded splade scores diverge from the "
                           "single-device scorer")
    log(f"dryrun sharded splade ok: {n_devices} shards, N={n_docs} k={sk} "
        f"== single-device scorer")

    # ---- (f) + (g) the iterative mode and serving, sharded ----
    iterative_and_serving(data_mesh, log=log)
    log(f"dryrun_multichip ok: n_devices={n_devices}")


def _bridge_corpus(n_docs: int = 24, seed: int = 7):
    """Tie-free corpus whose first sentences name other documents' titles,
    so the iterative mode's bridge extraction fires (the JAX package's
    ``__graft_entry__._bridge_corpus``, the same corpus and queries)."""
    import random

    from ..index.corpus import SentenceCorpus

    rng = random.Random(seed)
    words = [f"w{chr(97 + i % 26)}{i}" for i in range(120)]
    # letter-only name pairs: capitalized_runs breaks runs on digits
    tag = [chr(97 + i % 26) + chr(97 + (i // 26) % 26) for i in range(n_docs)]
    names = [f"Aq{t}zed Bq{t}lor" for t in tag]
    docs = []
    for di in range(n_docs):
        title = names[di]
        other = names[(di * 7 + 3) % n_docs]
        filler = " ".join(rng.choice(words)
                          for _ in range(rng.randrange(2, 8)))
        docs.append({"doc_id": f"{title}#0", "title": title, "sent_id": 0,
                     "text": f"{title} collaborated with {other} {filler}"})
        for si in range(1, rng.randrange(2, 4)):
            docs.append({
                "doc_id": f"{title}#{si}", "title": title, "sent_id": si,
                "text": " ".join(rng.choice(words)
                                 for _ in range(rng.randrange(4, 12)))})
    queries = [f"where did {names[i]} work {rng.choice(words)}"
               for i in (1, 5, 9, 13, 2, 6, 10, 14)]
    return SentenceCorpus(docs=docs), queries


def iterative_and_serving(data_mesh, *, log=print) -> None:
    """(f) iterative bridge-entity 2-hop and (g) `QueryServer` (single and
    iterative modes) over the sharded engine, equal to the single-device
    engine on the mesh's first device, with hop 2 really firing."""
    from ..engine.query_engine import EngineConfig, TorchQueryEngine
    from ..engine.server import QueryServer
    from ..index.builder import build_packed_index
    from ..modules.retrieval.multihop import iterative_retrieve
    from .sharded_hybrid import ShardedHybridEngine

    corpus, queries = _bridge_corpus()
    idx = build_packed_index(corpus, embed_dim=32, embed_dtype="float32")
    cfg = EngineConfig(top_k=5, pool_k=32, graph_window=2,
                       bm25_term_topm=4096, batch_buckets=(8,),
                       graph_pool_exact=True)
    single = TorchQueryEngine(idx, device=data_mesh.devices.flat[0],
                              config=cfg)
    sharded = ShardedHybridEngine(idx, mesh=data_mesh, config=cfg)
    n = data_mesh.size

    ids_a, sc_a, _, diag_a = iterative_retrieve(single, queries, top_k=5)
    ids_b, sc_b, _, diag_b = iterative_retrieve(sharded, queries, top_k=5)
    if diag_a["hop2_active"] == 0:
        raise RuntimeError("iterative dryrun degenerate: no hop-2 fired")
    if diag_a["hop2_active"] != diag_b["hop2_active"]:
        raise RuntimeError("sharded iterative hop-2 activity diverges")
    if not np.array_equal(ids_a, ids_b):
        raise RuntimeError("sharded iterative ids diverge from single-device")
    if not np.allclose(sc_a, sc_b, atol=1e-5):
        raise RuntimeError("sharded iterative scores diverge from "
                           "single-device")
    log(f"dryrun sharded iterative 2-hop ok: {n} shards, hop2_active="
        f"{diag_a['hop2_active']}/{len(queries)} == single-device")

    ref = single.query_batch(queries, top_k=5)
    with QueryServer(sharded, max_batch=8) as srv:
        for mode in ("single", "iterative"):
            served = [srv.submit(q, mode=mode) for q in queries]
            served = [f.result(timeout=120) for f in served]
            want_ids, want_sc = ((ref.hits.ids, ref.hits.scores)
                                 if mode == "single" else (ids_a, sc_a))
            for b, got in enumerate(served):
                pairs = [(idx.corpus.hit_id(int(i)), float(s))
                         for i, s in zip(want_ids[b], want_sc[b]) if i >= 0]
                if [h.id for h in got] != [i for i, _ in pairs]:
                    raise RuntimeError(
                        f"served {mode} ids diverge from single-device")
                if not np.allclose([h.score for h in got],
                                   [s for _, s in pairs], atol=1e-5):
                    raise RuntimeError(
                        f"served {mode} scores diverge from single-device")
    for eng in (single, sharded):
        eng.close()
        pool = getattr(eng, "_mh_prep_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
    log(f"dryrun served sharded engine ok: single + iterative modes over "
        f"{n} shards == single-device")
