"""Fused dense similarity + exact top-k (port of
``a_modular_rag_framework_tpu/ops/topk.py``).

  scores, ids = top_k(Q @ D^T)     Q: [B, d] f32, D: [N, d] f32 or bf16

- `dense_topk_reference`: the plain version (f32 matmul + stable sort).
- `dense_topk_cuda`: the hand-written kernel (``csrc/dense_topk.cu``,
  wgmma on bf16 planes fed by TMA), which replaces ``dense_topk_pallas``;
  it never writes the [B, N] matrix.
- `split_bf16x3` / `bf16x3_scores`: the kernel's f32-faithful arithmetic
  in plain torch (exact three-plane bf16 split; the plane-product sum).
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
MAX_DIM = 2048  # csrc/dense_topk.cu kMaxDStream
# csrc/dense_topk.cu kMaxD: the widest query planes a block holds resident;
# wider ones stream through the ring beside the corpus
_RESIDENT_DIM = 256
# csrc/dense_topk.cu: kMaxSplits, kTN, kStages, kCand, kMaxSmem
_MAX_SPLITS = 1024
_CORPUS_TILE = 128
_STAGES = 3
_CAND = 32
_MAX_SMEM = 232448
_WAVES = 1  # pass-1 blocks per SM (one block is resident at a time)
# streamed query planes: query tiles the resident blocks share (8 x 786 KB
# of planes at d 2048)
_STREAM_Q_TILES = 8


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


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """Exact split of f32 ``x`` [..., d] into three bf16 planes [3, ..., d]:
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), with
    hi + mid + lo == x for normal floats (each difference is exact in
    f32). The kernel's f32-faithful arithmetic: each plane times a bf16
    value is exact in f32."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def bf16x3_scores(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The scores as the kernel forms them, in plain torch: the sum of the
    plane products of `split_bf16x3` in f32 -- the three query planes
    times a bf16 corpus, or, for an f32 corpus, the plane pairs (i, j)
    with i + j <= 2. Equal to ``q @ d.T`` up to summation order."""
    qp = split_bf16x3(q).float()
    if d.dtype == torch.bfloat16:
        dps = [d.float()]
    else:
        dps = list(split_bf16x3(d).float())
    scores = torch.zeros((q.shape[0], d.shape[0]), dtype=torch.float32,
                         device=q.device)
    for i in range(3):
        for j, dp in enumerate(dps):
            if i + j <= 2:
                scores += qp[i] @ dp.T
    return scores


def _library():
    lib, info = load_library("dense_topk")
    if not getattr(lib, "_bound", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.dense_topk_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p,
                                          p, p, p, p]
        lib.dense_topk_launch.restype = i
        lib.dense_topk_error_string.argtypes = [i]
        lib.dense_topk_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib, info


def build_dense_topk() -> dict:
    """Build (or find built) the kernel's library; returns its build info."""
    return _library()[1]


def _padded_dim(dim: int) -> int:
    """The kernel's feature width: a multiple of 16 (one wgmma k-step)."""
    return -(-dim // 16) * 16


def _streams(dpad: int) -> bool:
    """Whether the query planes stream through the ring (d > 256)."""
    return dpad > _RESIDENT_DIM


def _partial_smem(nwg: int, dpad: int, k: int, smem_lists: bool) -> int:
    """Pass 1's dynamic shared memory (csrc/dense_topk.cu partial_smem):
    the query planes (all resident, or one chunk a ring stage where they
    stream), the corpus ring, the barriers, the per-row candidate buffers
    and thresholds, and, with ``smem_lists``, the running top-k lists."""
    kc = _STAGES if _streams(dpad) else -(-dpad // 64)
    return (1024 + 3 * kc * nwg * 8192 + _STAGES * _CORPUS_TILE * 128
            + (2 * _STAGES + 2) * 8 + nwg * 64 * (_CAND * 8 + 12)
            + (nwg * 64 * k * 8 if smem_lists else 0))


def _layout(dim: int, k: int) -> Tuple[int, bool]:
    """(consumer warpgroups per block, lists in shared memory): 128 query
    rows (two 64-row warpgroups) while the query planes fit (d <= 128),
    else 64 (always where the planes stream, d > 256); the running lists
    in shared memory where they fit beside the rest, trading the second
    warpgroup for them if need be, else in the partial outputs in device
    memory."""
    dpad = _padded_dim(dim)
    widths = (2, 1) if -(-dpad // 64) <= 2 else (1,)
    for nwg in widths:
        if _partial_smem(nwg, dpad, k, True) <= _MAX_SMEM:
            return nwg, True
    return widths[0], False


def _splits(B: int, N: int, nwg: int, device: torch.device,
            stream: bool = False) -> Tuple[int, int]:
    """(S, slice) of pass 1: about `_WAVES` blocks per SM, never more
    splits than corpus tiles; each split a whole number of tiles and none
    empty. Where the query planes stream, enough splits that the blocks
    resident at one time hold at most `_STREAM_Q_TILES` query tiles, whose
    planes then stay in L2 (the grid runs the splits fastest)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-B // (64 * nwg))
    tiles = -(-N // _CORPUS_TILE)
    if stream:
        want = max(1, min(sms // min(q_tiles, _STREAM_Q_TILES), tiles,
                          _MAX_SPLITS))
    else:
        want = max(1, min(_WAVES * sms // q_tiles, tiles, _MAX_SPLITS))
    slice_ = -(-tiles // want) * _CORPUS_TILE
    return -(-N // slice_), slice_


def dense_topk_cuda(q: torch.Tensor, d: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hand-written CUDA kernel: (scores f32 [B, k], ids int32 [B, k]).

    q: contiguous f32 [B, dim] on a CUDA device; d: contiguous f32 or bf16
    [N, dim] on the same device; dim <= 2048; 1 <= k <= min(N, 256). The
    query is split into bf16 planes here (`split_bf16x3`), an f32 corpus
    too; a bf16 corpus whose dim is a multiple of 16 goes to the kernel as
    it is, any other is zero-padded to the next multiple of 16."""
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
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"dim={dim} outside [1, {MAX_DIM}]")
    if B == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    dpad = _padded_dim(dim)
    if dpad != dim:
        q = torch.nn.functional.pad(q, (0, dpad - dim))
        d = torch.nn.functional.pad(d, (0, dpad - dim))
    q_planes = split_bf16x3(q)
    d_planes = d[None] if d.dtype == torch.bfloat16 else split_bf16x3(d)
    for name, t in (("q planes", q_planes), ("corpus", d_planes)):
        if t.data_ptr() % 16 or (t.stride(1) * t.element_size()) % 16:
            raise ValueError(f"{name}: the kernel's TMA needs 16-byte "
                             "aligned rows")
    nwg, smem_lists = _layout(dim, k)
    S, slice_ = _splits(B, N, nwg, q.device, _streams(dpad))
    out_s, out_i = torch.ops.amrf.dense_topk_launch(
        q_planes, d_planes, k, nwg, smem_lists, S, slice_)
    dense_topk_cuda.launches += 1
    return out_s, out_i


dense_topk_cuda.launches = 0


def _launch(q_planes: torch.Tensor, d_planes: torch.Tensor, k: int,
            nwg: int, smem_lists: bool, S: int, slice_: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launches (``topk_partial`` over ``S`` splits of
    ``slice_`` rows, then ``topk_merge``) on the current stream, from the
    planes `dense_topk_cuda` checked: (scores f32 [B, k], ids int32
    [B, k])."""
    lib, _ = _library()
    _, B, dpad = q_planes.shape
    N = d_planes.shape[1]
    dev = q_planes.device
    part_s = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.dense_topk_launch(
            q_planes.data_ptr(), d_planes.data_ptr(), d_planes.shape[0],
            B, N, dpad, k, nwg, int(smem_lists), S, slice_,
            part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        msg = lib.dense_topk_error_string(err).decode()
        raise RuntimeError(f"dense_topk kernel launch failed: {msg} ({err})")
    return out_s, out_i


# The kernel's launch is a torch operator. A profiler ties a launch to the
# thread that made it through the innermost operator the launch is made in,
# as it does an aten kernel's; a ctypes launch inside a ``record_function``
# range alone has no operator, and the profiler put it on the thread that
# read the trace.
_OPS = torch.library.Library("amrf", "FRAGMENT")
_OPS.define("dense_topk_launch(Tensor q_planes, Tensor d_planes, int k, "
            "int nwg, bool smem_lists, int S, int slice_) -> (Tensor, Tensor)")
_OPS.impl("dense_topk_launch", _launch, "CUDA")


def dense_topk(q: torch.Tensor, d: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CPU tensors -> `dense_topk_reference`; CUDA tensors -> the kernel."""
    if q.device.type == "cuda":
        return dense_topk_cuda(q, d, k)
    if q.device.type == "cpu" and d.device.type == "cpu":
        return dense_topk_reference(q, d, k)
    raise ValueError(f"dense_topk: unsupported devices {q.device}, {d.device}")
