"""The optimizer of the three trainers: AdamW as ``optax.adamw(lr)`` runs
it in the JAX package, and the train step built around a loss.

`adamw(lr)` is optax's chain ``scale_by_adam -> add_decayed_weights ->
scale_by_learning_rate`` with optax's defaults, written out:

    count' = count + 1
    mu'    = b1 * mu + (1 - b1) * g            b1 0.9
    nu'    = b2 * nu + (1 - b2) * g^2          b2 0.999
    u      = (mu' / (1 - b1^count')) / (sqrt(nu' / (1 - b2^count')) + eps)
    p'     = p + (-lr) * (u + wd * p)          eps 1e-8, wd 1e-4

The weight decay is 1e-4 on EVERY leaf, LayerNorm gains and biases
included (optax's ``mask=None``), and it is added to the Adam direction
before the learning rate scales both. ``torch.optim.AdamW`` is not used:
its default decay is 1e-2 and it shrinks ``p`` by ``1 - lr * wd`` before
the Adam update, which rounds differently.

The state is a tree with optax's leaves: ``count`` (int32 scalar), ``mu``
and ``nu`` (the parameter tree's shape each). `models.checkpoint` writes
it under optax's key strings, so a train state crosses between the
packages.

The update runs as ``torch._foreach_*`` calls over the flattened leaves,
in place, with the step count kept on the device: no host fetch in a step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from .params import Tree, tree_leaves, tree_map, tree_unflatten

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4

OptState = Dict[str, Any]  # {"count": int32 scalar, "mu": Tree, "nu": Tree}


def adamw_init(params: Tree) -> OptState:
    """Zero moments shaped like ``params`` (on their device) and a zero
    int32 count: ``optax.adamw(lr).init(params)``'s leaves."""
    first = tree_leaves(params)[0]
    return {"count": torch.zeros((), dtype=torch.int32, device=first.device),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: OptState,
                 learning_rate: float) -> None:
    """One AdamW step, IN PLACE on ``params`` and ``state`` (module
    docstring for the formula)."""
    p, g = tree_leaves(params), tree_leaves(grads)
    mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    count = state["count"]
    count.add_(1)
    step = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(step, B1), step)
    bc2 = 1.0 - torch.pow(torch.full_like(step, B2), step)

    # one pass per device (a sharded tree's blocks sit on several)
    by_device: Dict[torch.device, list] = {}
    for i, t in enumerate(p):
        by_device.setdefault(t.device, []).append(i)
    for dev, idx in by_device.items():
        _adamw_leaves([p[i] for i in idx], [g[i] for i in idx],
                      [mu[i] for i in idx], [nu[i] for i in idx],
                      bc1.to(dev), bc2.to(dev), learning_rate)


def _adamw_leaves(p, g, mu, nu, bc1, bc2, learning_rate: float) -> None:
    """The AdamW update of leaves on one device, in place."""
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, g, alpha=1.0 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)

    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    u = torch._foreach_div(mu, bc1)
    torch._foreach_div_(u, denom)
    torch._foreach_add_(u, p, alpha=WEIGHT_DECAY)
    torch._foreach_add_(p, u, alpha=-learning_rate)


def make_step(loss_fn: Callable[[Tree, Dict[str, torch.Tensor]],
                                Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
              learning_rate: float):
    """``(init_state, train_step)`` around ``loss_fn(params, batch) ->
    (loss, aux dict)``.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": ..., **aux})`` differentiates the loss with autograd and
    applies `adamw_update`. Like the JAX steps, which are jitted with
    their first two arguments donated, it consumes what it is given: the
    parameter and state tensors are updated in place and the same trees
    are returned. A caller that wants to keep an earlier state copies it
    first (`clone_tree`). The metrics are detached 0-dim tensors on the
    parameters' device; reading one (``float(m["loss"])``) is the only
    host fetch, and the step itself makes none."""

    def train_step(params: Tree, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]):
        loss, aux, grads = value_and_grad(loss_fn, params, batch)
        adamw_update(params, grads, opt_state, learning_rate)
        return params, opt_state, {"loss": loss, **aux}

    return adamw_init, train_step


def value_and_grad(loss_fn, params: Tree, batch) -> Tuple[torch.Tensor,
                                                          Dict[str, Any],
                                                          Tree]:
    """``(loss, aux, grads)`` of ``loss_fn(params, batch)``, the gradients
    as a tree shaped like ``params`` (``jax.value_and_grad(...,
    has_aux=True)``'s counterpart); ``params`` is left untouched."""
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree_unflatten(params, grads))


def clone_tree(tree: Tree) -> Tree:
    """A real copy of every leaf (a snapshot that later in-place steps do
    not touch)."""
    return tree_map(lambda t: t.detach().clone(), tree)
