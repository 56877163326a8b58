"""a_modular_rag_framework_torch — the PyTorch + CUDA port of
``a_modular_rag_framework_tpu``: the hybrid query engine, the learned
models and the question-answering pipeline (`system.answer_question`).

The JAX package stays the reference; this package mirrors its layout and
names so each counterpart is easy to find:

  system.py init_system / answer_question: settings -> providers -> router
            -> modules -> workflow; one engine per cached system
  config/settings_torch.json (repo root)  the shipped settings, as JSON
  di/       the settings-driven factory (JSON without PyYAML; an optional
            top-level "device" key)
  core/     dto.py: the data contracts without pydantic; interfaces,
            llm_router, providers/ (mock, openai, ollama, torch_embed, and
            transcript: TranscriptReplayProvider / TranscriptRecorder)
  schemas/  graph_request_v2.py: the v2 graph-assembly request over
            core.dto.Model (pydantic in the JAX package)
  adapters/ graph_request_adapter.py: v1 -> v2 and HotpotQA -> v2
  telemetry/  JSONL event sink, spans, device_timing events
  orchestrator/  the workflow state machine and its nodes
  modules/  graph_construction/ (per-question graphs; semantic edges on the
            device), retrieval/ (flow, torch_backend:
            TorchHybridRetrievalBackend, query_expander, multihop,
            retrieval_adapter, graph_store: per-question graph.json
            expansion on the device), reasoning/, verification/
  cli/      ingest_hotpotqa, run_system, serve (the HTTP front over
            QueryServer), train_encoder, train_cross_encoder, train_splade
  eval/     metrics, harness, reference_harness (the executed reference
            beside the port's backend)
  index/    host index build + the PackedIndex artifact (same on-disk
            layout); reembed.py: pipelined corpus embed and the
            learned-embedding sidecar (same two files)
  models/   hash-feature query encoder (host featurize, torch device
            embed); the learned models, reading and writing the JAX
            package's .npz checkpoints through params.py: encoder.py
            (TextEncoder), cross_encoder.py (CrossEncoderReranker),
            splade.py (SpladeEncoder: expansion head + sparsify_topk),
            each with its loss and train step; optim.py (the shared AdamW,
            optax.adamw's arithmetic and state), checkpoint.py (train
            states in the JAX package's .npz layout)
  ops/      BM25 (pool + re-score, and the scatter [B, N] form), graph
            expansion (compact and dense [B, N] forms), fusion (pool-union
            and the dense oracle), the fused dense top-k (hand-written
            CUDA for sm_90a), splade.py (SpladeDeviceIndex,
            SpladeRetriever, SpladeDenseHybrid) and semantic.py (pairwise
            cosine edges of a per-question graph)
  engine/   TorchQueryEngine: the single-pass hybrid program (compact and
            dense [B, N] forms; BM25 or SPLADE text channel; hash or
            learned query encoder) + dense-only path; profile (a
            torch.profiler trace), the AMRF_DEBUG_NANS check; QueryServer
  parallel/ sharding on a single-controller mesh of torch.device
            positions (repeats allowed: S shards on one card or the CPU):
            build_mesh / mesh_from_settings, the collectives,
            ShardedDenseEngine, ShardedHybridEngine, sharded SPLADE, the
            encoder's tensor-parallel train step (train.py) and the
            counterpart of __graft_entry__.py (dryrun.py)
  csrc/     CUDA sources, built with nvcc at first use

  native/, utils/ (similarity, textspan, entity_linker, graph_analyzer),
  eval/, index/corpus.py, core/dataset_loader.py, and
  the host modules of the question-answering path (telemetry, providers,
  router, graph construction, reasoning, verification, orchestrator, cli)
            the port's own copies of the JAX package's host modules
            (text_native.cpp is in csrc/)

It imports torch and never jax, pydantic or anything of the JAX package;
PyYAML only when it is handed a ``.yaml`` settings file. `TorchQueryEngine`,
the models and `answer_question` run on the card unless the caller passes
``device="cpu"`` (in the settings: ``"device": "cpu"``). The models' dense layers round their
operands to bfloat16 and accumulate in float32, as the JAX models do,
in the forward and in the backward pass.
"""

__version__ = "0.1.0"
