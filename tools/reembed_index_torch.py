"""Re-embed a packed index with a learned encoder, on the PyTorch port
(counterpart of ``tools/reembed_index.py``; sidecar output).

  python tools/reembed_index_torch.py --cache data/bench_cache_1m \
      --encoder data/encoder_collide.npz

Writes embeddings_learned.npy + learned_embed.json next to the index
(`a_modular_rag_framework_torch.index.reembed`); engines of either package
attach them via ``attach_learned_embeddings``. The encoder checkpoint is
stored repo-relative so a fresh checkout resolves it. ``--device cpu``
embeds on the host.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# the configuration of data/encoder_collide.npz (tools/dense_lab_torch.py)
COLLIDE_ENCODER = dict(vocab_size=32768, max_len=32, d_model=128, n_heads=4,
                       n_layers=2, subword_ngrams=8)


def reembed(cache, encoder_path, cfg, *, batch=4096, device="cuda",
            extra=None):
    """Embed the index at ``cache`` with the checkpoint and write the
    sidecar; -> the sidecar's document."""
    from a_modular_rag_framework_torch.index.packed import PackedIndex
    from a_modular_rag_framework_torch.index.reembed import (
        embed_corpus_pipelined,
        save_learned_embeddings,
    )
    from a_modular_rag_framework_torch.models.encoder import TextEncoder

    enc = TextEncoder.load(str(encoder_path), cfg, device=device)
    idx = PackedIndex.load(cache)
    t0 = time.time()
    emb = embed_corpus_pipelined(enc, idx.corpus.texts(), batch=batch)
    dt = time.time() - t0
    resolved = Path(encoder_path).resolve()
    ckpt_rel = (str(resolved.relative_to(REPO))
                if resolved.is_relative_to(REPO) else str(encoder_path))
    return save_learned_embeddings(
        cache, emb, ckpt_rel, cfg,
        extra={"embed_sec": round(dt, 1),
               "rows_per_sec": round(emb.shape[0] / dt, 1), **(extra or {})})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", required=True)
    ap.add_argument("--encoder", default="data/encoder_collide.npz")
    ap.add_argument("--d_model", type=int, default=128)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--n_heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--max_len", type=int, default=32)
    ap.add_argument("--subword_ngrams", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda', 'cuda:i' or 'cpu'")
    args = ap.parse_args(argv)

    from a_modular_rag_framework_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig(vocab_size=args.vocab, max_len=args.max_len,
                        d_model=args.d_model, n_heads=args.n_heads,
                        n_layers=args.n_layers,
                        subword_ngrams=args.subword_ngrams)
    doc = reembed(args.cache, args.encoder, cfg, batch=args.batch,
                  device=args.device)
    print(json.dumps({"cache": args.cache, "rows": doc["rows"],
                      "dim": doc["dim"], "embed_sec": doc["embed_sec"],
                      "rows_per_sec": doc["rows_per_sec"]}))


if __name__ == "__main__":
    main()
