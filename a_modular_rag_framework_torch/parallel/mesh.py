"""Device mesh (port of ``a_modular_rag_framework_tpu/parallel/mesh.py``).

The JAX package is single-controller: one Python process drives every
device of a ``jax.sharding.Mesh`` through ``shard_map``. The port keeps
that design. A `DeviceMesh` is named axes over an array of
``torch.device`` positions, and the sharded engines and the sharded train
step loop over its positions from one process, moving tensors between
them with ``.to`` (`parallel.collectives`). No process group exists.

Positions may repeat: ``build_mesh({"data": 4}, devices=["cuda:0"] * 4)``
runs four shards on one card, ``["cpu"] * 8`` eight on the CPU; on a
machine with several cards the default list is one position per card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


class PartitionSpec(tuple):
    """The mesh axis (or None) that splits each dimension of an array,
    written like ``jax.sharding.PartitionSpec``: ``PartitionSpec(None,
    "model")`` splits the columns over ``model``; ``PartitionSpec()``
    replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


@dataclass(frozen=True)
class DeviceMesh:
    """Named axes over an array of ``torch.device`` positions (shape = the
    axes' sizes, in ``axis_names`` order)."""

    axis_names: tuple
    devices: np.ndarray  # object array of torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def groups(self, axis: str) -> List[List[torch.device]]:
        """The positions along ``axis``, one list per position of the other
        axes (those in C order): the devices that one collective over
        ``axis`` spans. With no other axes, one group."""
        k = self.axis_names.index(axis)
        return [list(row) for row in
                np.moveaxis(self.devices, k, -1).reshape(
                    -1, self.devices.shape[k])]


def resolve_axes(axis_sizes: Dict[str, int], n_devices: int
                 ) -> Dict[str, int]:
    """``{axis: size}`` with the one -1 filled so that the sizes multiply
    to ``n_devices``; ValueError where they cannot (the JAX rules)."""
    axes = dict(axis_sizes)
    fixed = 1
    fill_axis = None
    for name, size in axes.items():
        if size == -1:
            if fill_axis is not None:
                raise ValueError("only one axis may be -1")
            fill_axis = name
        else:
            fixed *= int(size)
    if fill_axis is not None:
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes {axes}")
        axes[fill_axis] = n_devices // fixed
    total = int(np.prod(list(axes.values())))
    if total != n_devices:
        raise ValueError(
            f"mesh {axes} needs {total} devices, have {n_devices}")
    return axes


def visible_devices(device) -> int:
    """How many devices of ``device``'s kind a mesh could span: the CUDA
    device count, or 1 for the CPU."""
    return (torch.cuda.device_count() if torch.device(device).type == "cuda"
            else 1)


def mesh_devices(device, n: int) -> List[torch.device]:
    """``n`` mesh positions of ``device``'s kind: ``cuda:0..n-1``, or the
    CPU ``n`` times."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")] * n


def build_mesh(axis_sizes: Optional[Dict[str, int]] = None, *,
               devices: Optional[Sequence[Any]] = None) -> DeviceMesh:
    """A mesh from ``{axis: size}`` where one size may be -1 (fill).
    Default: every visible card on one ``data`` axis (one CPU position
    where there is no card). ``devices`` may repeat a device."""
    if devices is None:
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        devices = mesh_devices(dev, visible_devices(dev))
    devs = [torch.device(d) for d in devices]
    axes = resolve_axes(axis_sizes or {"data": -1}, len(devs))
    names = tuple(axes)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return DeviceMesh(names, arr.reshape(tuple(axes[a] for a in names)))


def mesh_from_settings(settings: Dict[str, Any], *,
                       devices: Optional[Sequence[Any]] = None
                       ) -> DeviceMesh:
    """Mesh from the settings ``mesh:`` section. ``dcn_axes`` compose
    OUTERMOST: the sharded engine splits the query batch over them and
    keeps every collective inside one group of the inner axes."""
    mesh_cfg = settings.get("mesh") or {}
    axes = dict(mesh_cfg.get("axes") or {"data": -1})
    dcn = dict(mesh_cfg.get("dcn_axes") or {})
    if set(dcn) & set(axes):
        raise ValueError(f"dcn_axes and axes share names: {set(dcn) & set(axes)}")
    return build_mesh({**dcn, **axes}, devices=devices)
