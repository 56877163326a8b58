"""The encoder's sharded train step on a (data, model) mesh (port of
``shard_train_step`` in ``a_modular_rag_framework_tpu/models/encoder.py``).

JAX jits the single-device step over sharded arrays and lets GSPMD insert
the collectives. The port writes them out, tensor parallel in the
Megatron form, over `parallel.collectives`:

- **parameters** are split into the contiguous blocks their
  `models.encoder.param_partition_specs` name, JAX's blocks exactly:
  ``wqkv`` [d, 3d] and ``w1`` by columns, ``wo`` and ``w2`` by rows,
  ``tok_emb`` and ``pos_emb`` by features; norms are replicated. Block j
  lives on the mesh position (data 0, model j); the replicated leaves on
  (0, 0). `gather_params` rebuilds the JAX layout (so ``.npz`` train
  states cross between the packages);
- **products**: a column-split product is one local product per block.
  The ``wqkv`` output is all-gathered on features before attention (a
  block holds q and part of k, not whole heads); the ``w1`` output goes
  straight into GELU and ``w2``. A row-split product is a local partial
  product, then `all_reduce_sum`. The embedding gathers run per feature
  block (`models.encoder.gather_rows`, a repeatable backward), then one
  `all_gather`. LayerNorms, residuals, attention and pooling run once per
  data replica, on its lead position;
- **batch**: split over ``data``. The loss's in-batch negatives span the
  GLOBAL batch, as JAX's jit over a data-sharded batch has them: the
  pooled embeddings of every replica are gathered on the first position
  and the loss is taken once. Each replica reads the master blocks through
  ``.to`` (a copy between cards, nothing on one device), so autograd sums
  the replicas' gradients into the masters;
- **optimizer**: `models.optim`'s AdamW, elementwise, per block (one pass
  per device).

The row-parallel sums change the summation order, so the step equals the
single-device one within a tolerance, not bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.encoder import (EncoderConfig, _dot, _in_batch_nce,
                              _layer_norm, attend, gather_rows,
                              param_partition_specs, pool_normalize)
from ..models.optim import make_step
from .collectives import all_gather, all_reduce_sum
from .mesh import DeviceMesh, PartitionSpec


def _grid(mesh: DeviceMesh) -> List[List[torch.device]]:
    """The positions as [data index][model index]; the mesh's axes are
    ``data`` and ``model`` (JAX's step names both)."""
    if sorted(mesh.axis_names) != ["data", "model"]:
        raise ValueError(f"the train step's mesh has axes data and model, "
                         f"got {mesh.shape}")
    devs = (mesh.devices if mesh.axis_names == ("data", "model")
            else mesh.devices.T)
    return [list(row) for row in devs]


def _zip_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over the spec tree and trees shaped like it
    (a split leaf of a placed tree is its list of blocks)."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    return [_zip_specs(fn, s, *(t[i] for t in trees))
            for i, s in enumerate(specs)]


def _split_dim(spec: PartitionSpec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def place_params(params, cfg: EncoderConfig, mesh: DeviceMesh):
    """A JAX-layout parameter tree -> the placed tree: each split leaf a
    list of its model-axis blocks (block j on position (0, j)), each
    replicated leaf on (0, 0). The inputs are copied, never aliased."""
    row = _grid(mesh)[0]

    def place(spec, t):
        dim = _split_dim(spec)
        if dim is None:
            return t.detach().to(row[0], copy=True)
        if t.shape[dim] % len(row):
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf does not "
                             f"split into {len(row)} blocks")
        return [b.detach().to(dev, copy=True).contiguous() for b, dev in
                zip(torch.chunk(t, len(row), dim=dim), row)]

    return _zip_specs(place, param_partition_specs(cfg), params)


def gather_params(placed, cfg: EncoderConfig, device="cpu"):
    """A placed tree (parameters, gradients or AdamW moments) -> the JAX
    layout on ``device``."""
    def gather(spec, t):
        dim = _split_dim(spec)
        if dim is None:
            return t.detach().to(device)
        return torch.cat([b.detach().to(device) for b in t], dim=dim)

    return _zip_specs(gather, param_partition_specs(cfg), placed)


def place_batch(batch: Dict[str, Any], mesh: DeviceMesh
                ) -> Dict[str, List[torch.Tensor]]:
    """Each batch array [B, ...] (numpy or tensor) -> its ``data``-axis
    blocks, block i on position (i, 0); B must divide evenly."""
    leads = [row[0] for row in _grid(mesh)]
    out = {}
    for name, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if t.shape[0] % len(leads):
            raise ValueError(f"batch {name} of {t.shape[0]} rows does not "
                             f"split over data {len(leads)}")
        out[name] = [b.to(dev, copy=True) for b, dev in
                     zip(torch.chunk(t, len(leads)), leads)]
    return out


def _row_parallel(x: torch.Tensor, blocks, devs, dtype) -> torch.Tensor:
    """``x @ w`` for a row-split ``w``: each position multiplies its slice
    of x's features by its block; the partial products are summed."""
    r = blocks[0].shape[0]
    return all_reduce_sum(
        [_dot(x[..., j * r:(j + 1) * r].to(dev), w.to(dev), dtype)
         for j, (w, dev) in enumerate(zip(blocks, devs))], devs[0])


def _block(x, layer, mask, cfg: EncoderConfig, devs):
    lead = devs[0]

    def ln(p, h):
        return _layer_norm(h, p["g"].to(lead), p["b"].to(lead))

    h = ln(layer["ln1"], x)
    qkv = all_gather([_dot(h.to(dev), w.to(dev), cfg.dtype) for w, dev in
                      zip(layer["wqkv"], devs)], lead, dim=-1)
    x = x + _row_parallel(attend(qkv, mask, cfg.n_heads, cfg.attn_dtype),
                          layer["wo"], devs, cfg.dtype)
    h = ln(layer["ln2"], x)
    parts = []
    for w1, w2, dev in zip(layer["w1"], layer["w2"], devs):
        a = F.gelu(_dot(h.to(dev), w1.to(dev), cfg.dtype), approximate="tanh")
        parts.append(_dot(a, w2.to(dev), cfg.dtype))
    return x + all_reduce_sum(parts, lead)


def apply_encoder_tp(params, token_ids: torch.Tensor, mask: torch.Tensor,
                     cfg: EncoderConfig, devs: List[torch.device]
                     ) -> torch.Tensor:
    """`models.encoder.apply_encoder` of one data replica over its model
    positions ``devs``, the parameters as placed blocks -> [B, d] on
    ``devs[0]``."""
    lead = devs[0]
    L = token_ids.shape[1]
    xs = []
    for tok, pos, dev in zip(params["tok_emb"], params["pos_emb"], devs):
        x = gather_rows(tok.to(dev), token_ids.to(dev))
        if token_ids.dim() == 3:
            x = x.mean(dim=2)
        xs.append(x + pos.to(dev)[None, :L, :])
    x = all_gather(xs, lead, dim=-1).float()
    mask = mask.to(lead)
    for layer in params["layers"]:
        x = _block(x, layer, mask, cfg, devs)
    out = params["out_ln"]
    x = _layer_norm(x, out["g"].to(lead), out["b"].to(lead))
    return pool_normalize(x, mask)


def sharded_info_nce(cfg: EncoderConfig, mesh: DeviceMesh,
                     temperature: float = 0.05):
    """``loss_fn(placed params, placed batch) -> (loss, {"accuracy"})``:
    `models.encoder.info_nce_loss` over the mesh, the pooled embeddings of
    all data replicas gathered before the loss."""
    grid = _grid(mesh)

    def loss_fn(params, batch):
        q = [apply_encoder_tp(params, batch["q_ids"][i], batch["q_mask"][i],
                              cfg, devs) for i, devs in enumerate(grid)]
        p = [apply_encoder_tp(params, batch["p_ids"][i], batch["p_mask"][i],
                              cfg, devs) for i, devs in enumerate(grid)]
        lead = grid[0][0]
        q, p = all_gather(q, lead), all_gather(p, lead)
        loss, acc = _in_batch_nce(torch.matmul(q, p.T) / temperature)
        return loss, {"accuracy": acc}

    return loss_fn


def shard_train_step(cfg: EncoderConfig, mesh: DeviceMesh,
                     learning_rate: float = 1e-3):
    """-> ``(place_params, place_batch, init_state, step)`` as in JAX:
    ``place_params(params)`` splits a JAX-layout tree by the specs,
    ``place_batch(batch)`` splits over ``data``, ``init_state`` gives AdamW
    moments shaped like the placed tree, and ``step(params, opt_state,
    batch) -> (params, opt_state, {"loss", "accuracy"})`` updates the
    placed trees in place (`models.optim.make_step`)."""
    init_state, step = make_step(sharded_info_nce(cfg, mesh), learning_rate)
    return (lambda params: place_params(params, cfg, mesh),
            lambda batch: place_batch(batch, mesh), init_state, step)

