"""Dense-channel-at-scale lab of the PyTorch port (counterpart of
``tools/dense_lab.py``).

Trains the subword TextEncoder on the COLLIDING-name distribution the scale
corpora sample (every first/surname token shared by hundreds of
distractors), then evaluates the dense channel standalone over a packed
index:

  - dense-1shot recall@10 (both supporting facts — structurally capped at
    ~0.5 on 2-hop questions: hop-2 gold shares no text with the question);
  - dense-1shot hop-1 recall (the dense-reachable half, the channel's
    actual job in the fusion);
  - dense-2hop recall@10 (hop-1 dense -> bridge-entity extraction ->
    hop-2 dense -> decayed max-merge), the dense analogue of the engine's
    iterative quality mode.

Training is device-resident: the full featurized pair set lives on the
device and `infonce_scan_trainer` runs CHUNK steps per call (random
in-batch InfoNCE batches gathered there), with one host fetch per chunk,
for the printed line.

  python tools/dense_lab_torch.py --steps 1500 --batch 1024 --d_model 128 \
      --cache data/bench_cache_100k --out data/encoder_collide.npz

``--device cpu`` runs everything on the host (small sizes only). The
defaults are the recipe behind ``data/encoder_collide.npz``: 16,384 collide
samples from generator index 8192 (32,768 pairs), batch 1024, chunk 50,
1,500 steps, lr 1e-3, vocab 32768, L 32, d 128, 4 heads, 2 layers, 8
subword features.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np


def build_collide_pairs(n_samples: int, index: int, seed: int = 0):
    """(query, passage) pairs from the colliding generator: a hop-1 pair
    (question -> bridge sentence) and a hop-2 pair (reformulated bridge
    query -> birth sentence) per sample — the two retrieval steps the
    dense channel actually executes in the 2-hop mode."""
    from a_modular_rag_framework_torch.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_torch.modules.retrieval.multihop import (
        hop2_queries_for,
    )

    samples = SyntheticHotpotQALoader(
        {"count": n_samples, "seed": seed, "index": index,
         "n_distractors": 8, "collide_entities": True}).load()
    queries, passages = [], []
    for s in samples:
        ctx = {t: sents for t, sents in s["context"]}
        (t1, s1), (t2, s2) = s["supporting_facts"]
        hop1 = ctx[t1][s1]
        hop2 = ctx[t2][s2]
        queries.append(s["question"])
        passages.append(hop1)
        # the bridge title IS the hop-2 doc title (t2)
        q2 = hop2_queries_for(s["question"], [t2])[0]
        queries.append(q2)
        passages.append(hop2)
    return queries, passages


def featurize(texts, cfg, label=""):
    from a_modular_rag_framework_torch.models.encoder import encode_tokens

    t0 = time.time()
    out = []
    B = 8192
    for i in range(0, len(texts), B):
        out.append(encode_tokens(texts[i:i + B], cfg))
    ids = np.concatenate([o[0] for o in out])
    mask = np.concatenate([o[1] for o in out])
    print(f"featurize[{label}]: {len(texts)} texts in {time.time()-t0:.1f}s",
          file=sys.stderr, flush=True)
    return ids, mask


def device_pair_set(queries, passages, cfg, device):
    """The whole featurized pair set as tensors on ``device``:
    {q_ids, q_mask, p_ids, p_mask}."""
    from a_modular_rag_framework_torch._host import upload_batch

    q_ids, q_mask = featurize(queries, cfg, "q")
    p_ids, p_mask = featurize(passages, cfg, "p")
    return upload_batch({"q_ids": q_ids, "q_mask": q_mask,
                         "p_ids": p_ids, "p_mask": p_mask}, device)


def train_chunks(data, cfg, *, steps, batch, lr, chunk, params, gen,
                 opt_state=None):
    """Yield ``(steps done, params, opt_state, metrics)`` after every
    chunk of `infonce_scan_trainer` over the device-resident ``data``.
    ``opt_state=None`` starts from fresh moments; a restored state
    continues a run (with ``gen`` in the state it had then)."""
    from a_modular_rag_framework_torch.models.encoder import (
        infonce_scan_trainer,
    )

    init_state, run_chunk = infonce_scan_trainer(
        cfg, batch=batch, chunk=chunk, learning_rate=lr)
    if opt_state is None:
        opt_state = init_state(params)
    done = 0
    while done < steps:
        params, opt_state, metrics = run_chunk(params, opt_state, data, gen)
        done += chunk
        yield done, params, opt_state, metrics


def train(queries, passages, cfg, *, steps, batch, lr, seed=0, chunk=50,
          device="cuda"):
    """Device-resident training: CHUNK InfoNCE steps per call."""
    from a_modular_rag_framework_torch._host import require_device
    from a_modular_rag_framework_torch.models.encoder import (
        init_params,
        seeded_generator,
    )

    device = require_device(device)
    data = device_pair_set(queries, passages, cfg, device)
    params = init_params(seeded_generator(seed, device), cfg)
    gen = seeded_generator(seed + 1, device)

    t0 = time.time()
    for done, params, _, metrics in train_chunks(
            data, cfg, steps=steps, batch=batch, lr=lr, chunk=chunk,
            params=params, gen=gen):
        print(f"step {done}/{steps} loss={float(metrics['loss']):.4f} "
              f"acc={float(metrics['accuracy']):.3f} "
              f"({done/(time.time()-t0):.1f} steps/s)",
              file=sys.stderr, flush=True)
    return params


def embed_corpus(encoder, texts, batch=4096):
    """Pipelined corpus embed (`index.reembed.embed_corpus_pipelined`)."""
    from a_modular_rag_framework_torch.index.reembed import (
        embed_corpus_pipelined,
    )

    t0 = time.time()
    emb = embed_corpus_pipelined(encoder, texts, batch=batch)
    print(f"embed_corpus: {len(texts)} rows in {time.time()-t0:.1f}s",
          file=sys.stderr, flush=True)
    return emb


def dense_eval(idx, encoder, emb, samples, *, top_k=10, hop1_inspect=20,
               hop_decay=0.5):
    """Standalone dense channel over a packed index: 1-shot and 2-hop.
    Queries and corpus are rounded to bfloat16, as in the original; the
    top-k is `ops.topk.dense_topk` on the encoder's device."""
    import torch

    from a_modular_rag_framework_torch._host import to_device
    from a_modular_rag_framework_torch.eval.harness import gold_hit_ids
    from a_modular_rag_framework_torch.eval.metrics import mrr, recall_at_k
    from a_modular_rag_framework_torch.modules.retrieval.multihop import (
        bridge_entities,
        hop2_queries_for,
    )
    from a_modular_rag_framework_torch.ops.topk import dense_topk

    D = to_device(np.asarray(emb, dtype=np.float32),
                  encoder.device).to(torch.bfloat16)

    def topk(qs):
        ids, mask = encoder.host_featurize(qs)
        q = encoder.device_embed(to_device(ids, encoder.device),
                                 to_device(mask, encoder.device))
        s, i = dense_topk(q.to(torch.bfloat16).float(), D, hop1_inspect)
        return s.cpu().numpy(), i.cpu().numpy()

    questions = [s["question"] for s in samples]
    s1, i1 = topk(questions)

    known_titles = {d.get("title") for d in idx.corpus.docs}
    known_titles.discard(None)
    docs = idx.corpus.docs
    hop2_qs = []
    for b, q in enumerate(questions):
        texts = [docs[int(i)].get("text", "") for i in i1[b] if i >= 0]
        bridges = bridge_entities(q, texts, max_entities=1,
                                  known_titles=known_titles)
        hop2_qs.append(hop2_queries_for(q, bridges)[0] if bridges else "")
    s2, i2 = topk(hop2_qs)

    rec1, rec1_hop1, rec2h, mrr2h = [], [], [], []
    for b, s in enumerate(samples):
        gold = gold_hit_ids(s)
        (t1, sid1), _ = s["supporting_facts"]
        got1 = [idx.corpus.hit_id(int(i)) for i in i1[b][:top_k] if i >= 0]
        rec1.append(recall_at_k(got1, gold, top_k))
        hop1_gold = [f"sent::{t1}::{sid1}"]
        rec1_hop1.append(recall_at_k(got1, hop1_gold, top_k))
        # merge with a hop-2 reserve (multihop._merge_hop2 semantics): a
        # pure decayed-score merge lets hop-1's distractor tail displace
        # exactly the evidence hop 2 exists to find
        reserve = max(2, top_k // 4)
        h1 = [(int(i), float(sc)) for i, sc in
              zip(i1[b].tolist(), s1[b].tolist()) if i >= 0]
        h1_ids = {i for i, _ in h1[:top_k]}
        h2 = ([(int(i), float(sc) * hop_decay) for i, sc in
               zip(i2[b].tolist(), s2[b].tolist())
               if i >= 0 and int(i) not in h1_ids]
              if hop2_qs[b] else [])
        ranked = (h1[:top_k - min(reserve, len(h2))]
                  + h2[:min(reserve, len(h2))])
        ranked = sorted(ranked, key=lambda kv: -kv[1])[:top_k]
        got2 = [idx.corpus.hit_id(i) for i, _ in ranked]
        rec2h.append(recall_at_k(got2, gold, top_k))
        mrr2h.append(mrr(got2, gold))
    return {
        "dense_1shot_recall_at_10": round(float(np.mean(rec1)), 4),
        "dense_1shot_hop1_recall": round(float(np.mean(rec1_hop1)), 4),
        "dense_2hop_recall_at_10": round(float(np.mean(rec2h)), 4),
        "dense_2hop_mrr": round(float(np.mean(mrr2h)), 4),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_samples", type=int, default=16384)
    ap.add_argument("--train_index", type=int, default=8192,
                    help="first generator index for training samples (eval "
                         "queries are indices 0..128)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--d_model", type=int, default=128)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--n_heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--max_len", type=int, default=32)
    ap.add_argument("--subword_ngrams", type=int, default=8)
    ap.add_argument("--cache", type=str, default="data/bench_cache_100k")
    ap.add_argument("--out", type=str, default="data/encoder_collide.npz")
    ap.add_argument("--eval_only", action="store_true",
                    help="skip training; evaluate --out over --cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda', 'cuda:i' or 'cpu'")
    args = ap.parse_args(argv)

    from a_modular_rag_framework_torch.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_torch.index.packed import PackedIndex
    from a_modular_rag_framework_torch.models.encoder import (
        EncoderConfig,
        TextEncoder,
    )

    cfg = EncoderConfig(vocab_size=args.vocab, max_len=args.max_len,
                        d_model=args.d_model, n_heads=args.n_heads,
                        n_layers=args.n_layers,
                        subword_ngrams=args.subword_ngrams)

    out = Path(args.out)
    if args.eval_only:
        enc = TextEncoder.load(str(out), cfg, device=args.device)
    else:
        queries, passages = build_collide_pairs(
            args.train_samples, args.train_index, args.seed)
        print(f"pairs: {len(queries)}", file=sys.stderr, flush=True)
        params = train(queries, passages, cfg, steps=args.steps,
                       batch=args.batch, lr=args.lr, seed=args.seed,
                       chunk=args.chunk, device=args.device)
        enc = TextEncoder(cfg, params=params, device=args.device)
        out.parent.mkdir(parents=True, exist_ok=True)
        enc.save(str(out))
        print(f"saved {out}", file=sys.stderr, flush=True)

    idx = PackedIndex.load(args.cache)
    emb = embed_corpus(enc, idx.corpus.texts())
    eval_samples = SyntheticHotpotQALoader(
        {"count": 128, "seed": 0, "n_distractors": 8,
         "collide_entities": True}).load()
    report = dense_eval(idx, enc, emb, eval_samples)
    report["corpus_passages"] = idx.n_docs
    report["encoder"] = {"d_model": cfg.d_model, "vocab": cfg.vocab_size,
                         "max_len": cfg.max_len,
                         "subword_ngrams": cfg.subword_ngrams,
                         "checkpoint": str(out)}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
