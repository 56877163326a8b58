"""Pre-build the learned-embedding sidecars for the scale indexes, on the
PyTorch port (counterpart of ``tools/prebuild_sidecars.py``).

For the 100k-row collide index (built here when it is missing: 4,600
samples, 8 distractors, seed 0) and the 1M / 5M ones when they exist
under ``data/``: attach the sidecar of ``data/encoder_collide.npz`` if it
is there, else re-embed the corpus and write it
(`tools/reembed_index_torch.py::reembed`), so that engines attach it at
once.

Run:  python tools/prebuild_sidecars_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

N_SAMPLES_100K = 4600  # -> ~100k unique sentences


def ensure_sidecar(cache: Path, encoder_path: Path, *, device="cuda"):
    """-> (label, error): attach ``cache``'s sidecar, building it first
    when it is missing. ``label`` names the dense space the index now
    holds; ``error`` is None when that is the learned one."""
    from reembed_index_torch import COLLIDE_ENCODER, reembed

    from a_modular_rag_framework_torch.index.packed import PackedIndex
    from a_modular_rag_framework_torch.index.reembed import (
        attach_learned_embeddings,
    )
    from a_modular_rag_framework_torch.models.encoder import EncoderConfig

    idx = PackedIndex.load(cache)
    att = attach_learned_embeddings(idx, cache, device=device)
    if att is None:
        if not encoder_path.exists():
            return "hash64", f"encoder checkpoint missing: {encoder_path}"
        reembed(cache, encoder_path, EncoderConfig(**COLLIDE_ENCODER),
                device=device, extra={"built_by": "prebuild_sidecars_torch"})
        att = attach_learned_embeddings(idx, cache, device=device)
        if att is None:
            return "hash64", "sidecar built but did not attach (row mismatch?)"
    c = att[1].get("encoder_config", {})
    return f"subword_collide_d{c.get('d_model', '?')}", None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=str, default=str(REPO / "data"))
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda', 'cuda:i' or 'cpu'")
    args = ap.parse_args(argv)

    from a_modular_rag_framework_torch._host import require_device
    from a_modular_rag_framework_torch.core.dataset_loader import (
        SyntheticHotpotQALoader,
    )
    from a_modular_rag_framework_torch.index.builder import build_packed_index
    from a_modular_rag_framework_torch.index.corpus import SentenceCorpus

    device = require_device(args.device)
    data = Path(args.data)
    encoder_path = data / "encoder_collide.npz"
    cache_100k = data / "bench_cache_100k"
    if not (cache_100k / "manifest.json").exists():
        samples = SyntheticHotpotQALoader(
            {"count": N_SAMPLES_100K, "seed": 0, "n_distractors": 8,
             "collide_entities": True}).load()
        build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                           embed_dim=64, embed_dtype="bfloat16",
                           out_dir=str(cache_100k))
    for name in ("100k", "1m", "5m"):
        cache = data / f"bench_cache_{name}"
        if not (cache / "manifest.json").exists():
            continue
        t0 = time.time()
        label, err = ensure_sidecar(cache, encoder_path, device=device)
        print(f"{name} sidecar: {label} err={err} ({time.time()-t0:.1f}s)",
              flush=True)


if __name__ == "__main__":
    main()
