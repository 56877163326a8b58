"""Training-state checkpoint / resume (port of the ``.npz`` form of
``a_modular_rag_framework_tpu/models/checkpoint.py``).

A training loop can stop and resume exactly: ``(params, opt_state, step)``
round-trip through one file per step,

    <dir>/state_<step>.npz     params/<keystr>  and  opt/<keystr>  entries
    <dir>/latest.json          {"step": <step>}

with the JAX package's key strings: a parameter leaf is
``params/['layers'][0]['wqkv']``, and the optimizer state (the
`models.optim` tree ``{"count", "mu", "nu"}``) is written as optax's
``adamw`` state flattens there, ``opt/[0].count``,
``opt/[0].mu['layers'][0]['wqkv']``, ``opt/[0].nu[...]``. A state written
here restores in the JAX package against an ``optax.adamw`` template, and
the ``.npz`` the JAX package writes restores here. (The JAX package
prefers an orbax directory where orbax is installed; that form is not
read here.)
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np

from .params import Tree, flatten_params, tree_leaves, unflatten_params

# optax.adamw's state is a chain of three; only its first element, the
# ScaleByAdamState, has leaves
_OPT_PREFIX = "[0]."


def _flatten_opt(opt_state) -> dict:
    out = {f"{_OPT_PREFIX}count": opt_state["count"].detach().cpu().numpy()}
    for name in ("mu", "nu"):
        for k, v in flatten_params(opt_state[name]).items():
            out[f"{_OPT_PREFIX}{name}{k}"] = v
    return out


def save_train_state(path: str | Path, params: Tree, opt_state,
                     step: int) -> None:
    """Write ``state_<step>.npz`` and point ``latest.json`` at it."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / f"state_{step}.npz",
             **{f"params/{k}": v for k, v in flatten_params(params).items()},
             **{f"opt/{k}": v for k, v in _flatten_opt(opt_state).items()})
    (path / "latest.json").write_text(json.dumps({"step": step}))


def restore_train_state(path: str | Path, params_template: Tree,
                        opt_state_template
                        ) -> Optional[Tuple[Any, Any, int]]:
    """(params, opt_state, step) of the latest checkpoint, shaped, typed
    and placed like the templates; None when there is no ``latest.json``
    (or no ``.npz`` for its step). A leaf the file lacks raises KeyError,
    as in the JAX package."""
    path = Path(path)
    latest = path / "latest.json"
    if not latest.exists():
        return None
    step = int(json.loads(latest.read_text())["step"])
    npz = path / f"state_{step}.npz"
    if not npz.exists():
        return None
    device = tree_leaves(params_template)[0].device
    with np.load(npz) as data:
        def part(prefix):
            return {k[len(prefix):]: data[k] for k in data.files
                    if k.startswith(prefix)}

        kw = dict(device=device, source=str(npz))
        params = unflatten_params(part("params/"), params_template, **kw)
        opt_state = {
            name: unflatten_params(part(f"opt/{_OPT_PREFIX}{name}"),
                                   opt_state_template[name], **kw)
            for name in ("count", "mu", "nu")}
    return params, opt_state, step
