"""Host seams shared with the JAX package, and device validation.

Two stdlib-only host modules of the JAX package sit behind package
``__init__`` files that import jax (``index/``) or pydantic (``core/``).
They are loaded here by file path, so one source stays the truth and the
port never imports those packages:

  - ``index/corpus.py``: ``SentenceCorpus``, ``flatten_hotpotqa_context``;
  - ``core/dataset_loader.py``: ``SyntheticHotpotQALoader``.
"""
from __future__ import annotations

import importlib.util
import sys
import threading
from pathlib import Path
from types import ModuleType

import numpy as np
import torch

_JAX_PKG = Path(__file__).resolve().parents[1] / "a_modular_rag_framework_tpu"
_LOCK = threading.Lock()


def load_shared_module(rel_path: str) -> ModuleType:
    """Load ``a_modular_rag_framework_tpu/<rel_path>`` by path, without
    running its package ``__init__``. Cached in ``sys.modules``."""
    name = "a_modular_rag_framework_torch._shared_" + Path(rel_path).stem
    with _LOCK:
        mod = sys.modules.get(name)
        if mod is not None:
            return mod
        spec = importlib.util.spec_from_file_location(name, _JAX_PKG / rel_path)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load {_JAX_PKG / rel_path}")
        mod = importlib.util.module_from_spec(spec)
        # registered BEFORE exec: @dataclass resolves the defining module
        # through sys.modules while the class body runs
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
        return mod


def to_device(a: np.ndarray, device, *, non_blocking: bool = False
              ) -> torch.Tensor:
    """Upload a host array; read-only (memory-mapped) arrays are copied
    first, so no tensor ever aliases a read-only mapping.

    ``non_blocking=True`` stages a CUDA upload through pinned memory and
    queues it on the current stream: a plain copy from pageable memory
    waits for everything already queued, which would serialize a batch's
    host prep behind the previous batch's device program."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    if non_blocking and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def require_device(device) -> torch.device:
    """Validate an explicit device argument; never picks one."""
    if device is None:
        raise TypeError("an explicit device ('cpu' or 'cuda[:i]') is required")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cpu or cuda)")
    return dev
