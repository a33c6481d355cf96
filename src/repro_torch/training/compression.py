"""Gradient compression for slow links (port of
``repro.training.compression``).

Two transforms of the gradient tree, applied inside the train step before
the optimizer (``make_train_step``'s ``grad_transform`` hook):

* ``int8_compress``: per-tensor scale + int8 quantization (round half to
  even, as ``jnp.round``), dequantized again: the wire format simulated;
* ``TopKErrorFeedback``: keeps each tensor's entries whose magnitude is at
  least its k-th largest (k = ``fraction`` of the entries, at least 1) and
  carries the rest as a residual into the next step (error feedback).

Both keep every shape and dtype.
"""
from __future__ import annotations

import torch

from repro_torch.training.tree import as_tree, leaves, tree_map, unflatten

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def int8_compress(grads, key=None):
    """Quantize-dequantize every floating leaf at int8 (``key`` is unused,
    as in the reference)."""

    def q(g):
        if g.dtype not in _FLOATS:
            return g
        gf = g.float()
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        qv = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return (qv.float() * scale).to(g.dtype)

    return tree_map(q, grads)


class TopKErrorFeedback:
    """Stateful top-k sparsification with error feedback: ``grads, residual
    = ef(grads, residual)``, the residual a fp32 tree of the gradients'
    shapes (``init``)."""

    def __init__(self, fraction: float = 0.01):
        self.fraction = fraction

    def init(self, params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), as_tree(params))

    def __call__(self, grads, residual):
        frac = self.fraction

        def one(g, r):
            gf = g.float() + r
            flat = gf.reshape(-1)
            k = max(1, int(flat.shape[0] * frac))
            thresh = torch.topk(flat.abs(), k).values[-1]  # the k-th largest
            sent = torch.where(gf.abs() >= thresh, gf, 0.0)
            return sent.to(g.dtype), gf - sent

        outs = [one(g, r) for g, r in zip(leaves(grads), leaves(residual))]
        return (unflatten(grads, [o[0] for o in outs]),
                unflatten(grads, [o[1] for o in outs]))
