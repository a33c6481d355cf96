"""Train-step factory (port of ``repro.training.step``): autograd in place
of ``value_and_grad``, AdamW, microbatch accumulation and an optional
gradient transform."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.spans import span
from repro_torch.training.tree import as_tree, leaves, tree_map, unflatten


def _grads(loss, params: list) -> list:
    # a parameter the loss does not reach gets zeros, as jax.grad gives
    return list(torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True))


def make_train_step(
    loss_fn: Callable,
    optimizer,
    *,
    microbatches: int = 1,
    grad_transform: Callable | None = None,
):
    """``loss_fn(params, batch) -> (loss, metrics)``, ``params`` a tree of
    tensors that require grad (an ``nn.Module``: its parameters).

    Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the optimizer writes ``params`` and ``opt_state`` in place.
    With ``microbatches`` > 1 the leading batch dimension is split into that
    many contiguous parts, one forward and backward each; the gradients
    accumulate in fp32 and are divided by ``microbatches``, the loss is the
    mean of the parts' and each metric the mean of its parts'.
    ``grad_transform`` maps the gradient tree (``training/compression.py``)
    before the optimizer.  The forward passes and the optimizer's update
    run inside program spans (``repro_torch.spans``: "train_step.forward",
    "train_step.update"), so a profile splits a step's device time into
    forward, update and (the rest) backward.
    """

    def step(params, opt_state, batch):
        tree = as_tree(params)
        flat = leaves(tree)
        if microbatches == 1:
            with span("train_step.forward"):
                loss, metrics = loss_fn(params, batch)
            flat_g = _grads(loss, flat)
            loss = loss.detach()
            metrics = tree_map(torch.Tensor.detach, metrics)
        else:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))

            parts = tree_map(split, batch)
            flat_g = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for p in flat]
            loss, ms = 0.0, []
            for i in range(microbatches):
                with span("train_step.forward"):
                    l, m = loss_fn(params, tree_map(lambda x: x[i], parts))
                for acc, g in zip(flat_g, _grads(l, flat)):
                    acc.add_(g)
                loss = loss + l.detach()
                ms.append(tree_map(torch.Tensor.detach, m))
            flat_g = [g / microbatches for g in flat_g]
            loss = loss / microbatches
            metrics = tree_map(lambda *xs: torch.stack(xs).mean(), *ms)
        grads = unflatten(tree, flat_g)
        if grad_transform is not None:
            grads = grad_transform(grads)
        with span("train_step.update"):
            params, opt_state, opt_metrics = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return step
