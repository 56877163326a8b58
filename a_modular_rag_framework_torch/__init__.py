"""a_modular_rag_framework_torch — the PyTorch + CUDA port of the hybrid
query engine and the learned models of ``a_modular_rag_framework_tpu``.

The JAX package stays the reference; this package mirrors its layout and
names so each counterpart is easy to find:

  core/     Hit / HitBatch as plain dataclasses (the JAX ones are pydantic)
  index/    host index build + the PackedIndex artifact (same on-disk
            layout); reembed.py: pipelined corpus embed and the
            learned-embedding sidecar (same two files)
  models/   hash-feature query encoder (host featurize, torch device
            embed); the learned models, inference only, reading the JAX
            package's .npz checkpoints through params.py: encoder.py
            (TextEncoder), cross_encoder.py (CrossEncoderReranker),
            splade.py (SpladeEncoder: expansion head + sparsify_topk)
  ops/      BM25 (pool + re-score, and the scatter [B, N] form), graph
            expansion (compact and dense [B, N] forms), fusion (pool-union
            and the dense oracle), the fused dense top-k (hand-written
            CUDA for sm_90a), and splade.py (SpladeDeviceIndex,
            SpladeRetriever, SpladeDenseHybrid)
  engine/   TorchQueryEngine: the single-pass hybrid program (compact and
            dense [B, N] forms; BM25 or SPLADE text channel; hash or
            learned query encoder) + dense-only path; QueryServer
  modules/retrieval/multihop.py  iterative bridge-entity 2-hop retrieval
  csrc/     CUDA sources, built with nvcc at first use

  native/, utils/, eval/, index/corpus.py, core/dataset_loader.py
            the port's own copies of the JAX package's host modules
            (text_native.cpp is in csrc/)

It imports torch and never jax, pydantic, yaml or anything of the JAX
package. `TorchQueryEngine` and the models run on the card unless the
caller passes ``device="cpu"``. The models' dense layers round their
operands to bfloat16 and accumulate in float32, as the JAX models do.
Training is not ported.
"""

__version__ = "0.1.0"
