"""Hash embedding of packed text bytes: tokenize, crc32 features, signed
buckets, unit rows.

    rows = hash_embed(data, offsets, dim, max_features)
    data: uint8 [nbytes], offsets: int32 [B + 1] -> f32 [B, dim]

Row ``r`` is ``data[offsets[r]:offsets[r + 1]]`` cut at its first NUL, as
`models.hash_embed.pack_texts` packs it. The function is the native host
path's (``csrc/text_native.cpp::hash_embed_batch``), bit for bit: ASCII-only
lowering, tokens the runs of ``[a-zA-Z0-9]``, unigrams then ``'_'``-joined
bigrams cut at ``max_features``, zlib's crc32, bucket ``h % dim``, sign
from bit 16, then ``acc / max((float)sqrt(double sum acc^2), 1e-9)``.

- `hash_embed_reference`: the plain version (Python, per row).
- `hash_embed_cuda`: the hand-written kernel (``csrc/hash_embed.cu``), one
  warp a row; it replaces no TPU kernel (the JAX package hashes on the
  host).
- `hash_embed`: dispatch on the tensors' device -- CPU tensors take the
  plain version, CUDA tensors the kernel. There is no fallback.
"""
from __future__ import annotations

import ctypes
import math
import re
import zlib

import numpy as np
import torch

from ._build import load_library

# csrc/hash_embed.cu's byte positions are int32
MAX_BYTES = 2**31 - 33

_TOKEN = re.compile(rb"[a-z0-9]+")
_ASCII_LOWER = bytes.maketrans(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ",
                               b"abcdefghijklmnopqrstuvwxyz")


def hash_embed_reference(data: torch.Tensor, offsets: torch.Tensor,
                         dim: int, max_features: int) -> torch.Tensor:
    """The plain version: each row's tokens, their crc32s (a bigram's
    chained through ``'_'`` from its first token's, as the kernel does),
    the signed integer bucket sums, and the unit row, on the host."""
    raw = data.cpu().numpy().tobytes()
    offs = offsets.cpu().tolist()
    B = len(offs) - 1
    out = np.zeros((B, dim), dtype=np.float32)
    for r in range(B):
        row = raw[offs[r]:offs[r + 1]].split(b"\0", 1)[0]
        toks = _TOKEN.findall(row.translate(_ASCII_LOWER))
        uni = [zlib.crc32(t) for t in toks[:max_features]]
        n_big = min(len(toks) - 1, max_features - len(uni))
        big = [zlib.crc32(toks[j + 1], zlib.crc32(b"_", uni[j]))
               for j in range(max(n_big, 0))]
        acc = np.zeros(dim, dtype=np.int64)
        for h in uni + big:
            acc[h % dim] += 1 if (h >> 16) & 1 else -1
        norm = max(np.float32(math.sqrt(float(np.dot(acc, acc)))),
                   np.float32(1e-9))
        out[r] = acc.astype(np.float32) / norm
    return torch.from_numpy(out)


def _library():
    lib, info = load_library("hash_embed")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hash_embed_launch.argtypes = [p, i, p, i, i, i, p, p]
        lib.hash_embed_launch.restype = i
        lib.hash_embed_error_string.argtypes = [i]
        lib.hash_embed_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib, info


def build_hash_embed() -> dict:
    """Build (or find built) the kernel's library; returns its build info."""
    return _library()[1]


def hash_embed_cuda(data: torch.Tensor, offsets: torch.Tensor, dim: int,
                    max_features: int) -> torch.Tensor:
    """The hand-written kernel: f32 [B, dim] unit rows on the card.

    data: contiguous uint8 [nbytes] on a CUDA device, nbytes <=
    `MAX_BYTES`; offsets: contiguous int32 [B + 1] on the same device,
    nondecreasing from 0 (the kernel clamps each row to the buffer). A
    launch fails where one row's shared memory (a block's rows are chosen
    in ``csrc/hash_embed.cu``) would exceed 48 KB: ``dim + 3 *
    max_features`` above 12,032 words."""
    if not (data.is_cuda and offsets.is_cuda):
        raise ValueError("hash_embed_cuda takes CUDA tensors "
                         f"(got {data.device} and {offsets.device})")
    if data.device != offsets.device:
        raise ValueError(f"data on {data.device} but offsets on "
                         f"{offsets.device}")
    if data.dtype != torch.uint8 or offsets.dtype != torch.int32:
        raise TypeError("data must be uint8 and offsets int32, got "
                        f"{data.dtype} and {offsets.dtype}")
    if data.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1:
        raise ValueError(f"data {tuple(data.shape)} and offsets "
                         f"{tuple(offsets.shape)} must be 1-D, offsets "
                         "non-empty")
    if not (data.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("data and offsets must be contiguous")
    if data.numel() > MAX_BYTES:
        raise ValueError(f"{data.numel()} bytes > {MAX_BYTES}")
    if dim < 1 or max_features < 1:
        raise ValueError(f"dim={dim}, max_features={max_features} must be "
                         ">= 1")
    if offsets.numel() == 1:
        return torch.empty((0, dim), dtype=torch.float32, device=data.device)
    out = torch.ops.amrf.hash_embed_launch(data, offsets, dim, max_features)
    hash_embed_cuda.launches += 1
    return out


hash_embed_cuda.launches = 0


def _launch(data: torch.Tensor, offsets: torch.Tensor, dim: int,
            max_features: int) -> torch.Tensor:
    """The kernel's launch on the current stream, from the tensors
    `hash_embed_cuda` checked: f32 [B, dim]."""
    lib, _ = _library()
    B = offsets.numel() - 1
    dev = data.device
    out = torch.empty((B, dim), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.hash_embed_launch(
            data.data_ptr() if data.numel() else None, data.numel(),
            offsets.data_ptr(), B, dim, max_features, out.data_ptr(), stream)
    if err != 0:
        msg = lib.hash_embed_error_string(err).decode()
        raise RuntimeError(f"hash_embed kernel launch failed: {msg} ({err})")
    return out


# A torch operator, as ops/topk.py's launch is: a profiler ties the launch
# to its caller's thread and range through it.
_OPS = torch.library.Library("amrf", "FRAGMENT")
_OPS.define("hash_embed_launch(Tensor data, Tensor offsets, int dim, "
            "int max_features) -> Tensor")
_OPS.impl("hash_embed_launch", _launch, "CUDA")


def hash_embed(data: torch.Tensor, offsets: torch.Tensor, dim: int,
               max_features: int) -> torch.Tensor:
    """CPU tensors -> `hash_embed_reference`; CUDA tensors -> the kernel."""
    if data.device.type == "cuda":
        return hash_embed_cuda(data, offsets, dim, max_features)
    if data.device.type == "cpu" and offsets.device.type == "cpu":
        return hash_embed_reference(data, offsets, dim, max_features)
    raise ValueError(f"hash_embed: unsupported devices {data.device}, "
                     f"{offsets.device}")
