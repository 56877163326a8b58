"""Fused dense similarity + exact top-k (port of
``a_modular_rag_framework_tpu/ops/topk.py``).

  scores, ids = top_k(Q @ D^T)     Q: [B, d] f32, D: [N, d] f32 or bf16

- `dense_topk_reference`: the plain version (f32 matmul + stable sort).
- `dense_topk_cuda`: the hand-written kernel (``csrc/dense_topk.cu``),
  which replaces ``dense_topk_pallas``; it never writes the [B, N] matrix.
- `dense_topk`: dispatch on the tensors' device -- CPU tensors take the
  plain version, CUDA tensors the kernel. There is no fallback.

Order everywhere is (score descending, id ascending): `lax.top_k`'s tie
order. `torch.topk` does not promise it, so every top-k of the port goes
through `stable_topk`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._build import load_library

MAX_K = 256  # csrc/dense_topk.cu kMaxK
_MAX_SPLITS = 1024  # csrc/dense_topk.cu kMaxSplits
_QUERY_TILE = 64  # csrc/dense_topk.cu kQB
_CORPUS_TILE = 64  # csrc/dense_topk.cu kTN


def stable_topk(x: torch.Tensor, k: int, dim: int = -1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along ``dim`` with ``lax.top_k``'s order: larger first, and
    among equal values the lower index first. Indices are int64."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def dense_topk_reference(q: torch.Tensor, d: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores f32 [B, k], ids int32 [B, k]): exact f32 ``q @ d.T``, then a
    stable descending sort. On the card the caller pins full-f32 matmuls
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    if k > d.shape[0]:
        raise ValueError(f"k={k} > corpus size {d.shape[0]}")
    scores = q.float() @ d.float().T
    s, i = stable_topk(scores, k, dim=1)
    return s.contiguous(), i.to(torch.int32)


def _library():
    lib, info = load_library("dense_topk")
    if not getattr(lib, "_bound", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.dense_topk_launch.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p, p]
        lib.dense_topk_launch.restype = i
        lib.dense_topk_error_string.argtypes = [i]
        lib.dense_topk_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib, info


def build_dense_topk() -> dict:
    """Build (or find built) the kernel's library; returns its build info."""
    return _library()[1]


def _num_splits(B: int, N: int, device: torch.device) -> int:
    """Corpus splits of pass 1: enough blocks for ~8 per SM, never more
    splits than corpus tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-B // _QUERY_TILE)
    want = -(-8 * sms // q_tiles)
    return max(1, min(want, -(-N // _CORPUS_TILE), _MAX_SPLITS))


def dense_topk_cuda(q: torch.Tensor, d: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hand-written CUDA kernel: (scores f32 [B, k], ids int32 [B, k]).

    q: contiguous f32 [B, dim] on a CUDA device; d: contiguous f32 or bf16
    [N, dim] on the same device; 1 <= k <= min(N, 256)."""
    if not (q.is_cuda and d.is_cuda):
        raise ValueError("dense_topk_cuda takes CUDA tensors "
                         f"(got {q.device} and {d.device})")
    if q.device != d.device:
        raise ValueError(f"q on {q.device} but d on {d.device}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"d must be float32 or bfloat16, got {d.dtype}")
    if q.dim() != 2 or d.dim() != 2 or q.shape[1] != d.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"d {tuple(d.shape)}")
    if not (q.is_contiguous() and d.is_contiguous()):
        raise ValueError("q and d must be contiguous")
    B, dim = q.shape
    N = d.shape[0]
    if k > N:
        raise ValueError(f"k={k} > corpus size {N}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if B == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    lib, _ = _library()
    S = _num_splits(B, N, q.device)
    part_s = torch.empty((B, S, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((B, S, k), dtype=torch.int32, device=q.device)
    out_s = torch.empty((B, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.dense_topk_launch(
            q.data_ptr(), d.data_ptr(), int(d.dtype == torch.bfloat16),
            B, N, dim, k, S, part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        msg = lib.dense_topk_error_string(err).decode()
        raise RuntimeError(f"dense_topk kernel launch failed: {msg} ({err})")
    dense_topk_cuda.launches += 1
    return out_s, out_i


dense_topk_cuda.launches = 0


def dense_topk(q: torch.Tensor, d: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CPU tensors -> `dense_topk_reference`; CUDA tensors -> the kernel."""
    if q.device.type == "cuda":
        return dense_topk_cuda(q, d, k)
    if q.device.type == "cpu" and d.device.type == "cpu":
        return dense_topk_reference(q, d, k)
    raise ValueError(f"dense_topk: unsupported devices {q.device}, {d.device}")
