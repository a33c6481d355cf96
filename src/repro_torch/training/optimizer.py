"""AdamW with a configurable state dtype, and its schedules (port of
``repro.training.optimizer``).

``state_dtype=torch.bfloat16`` halves the optimizer's memory; the update
itself runs in fp32 and rounds the new parameters and moments back to
their dtypes, in the reference's order of operations (``torch.optim.AdamW``
rounds differently with bf16 state and decays the weights outside the
bias-corrected step, so it is not used).  Unlike the reference, whose
update returns new trees, ``update`` writes the parameters and the state in
place and returns them: a 1 B-parameter model is not copied each step.
Parameters are any tree of ``training.tree`` (an ``nn.Module`` stands for
its named parameters); the moments ``mu`` / ``nu`` have the parameters'
tree structure.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.training.tree import as_tree, leaves, tree_map

Tensor = torch.Tensor
Schedule = Callable[[Tensor], Tensor]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def warmup_cosine_schedule(peak: float, warmup: int, total: int,
                           floor: float = 0.0) -> Schedule:
    def fn(step: Tensor) -> Tensor:
        step = step.float()
        warm = peak * step / max(warmup, 1)
        prog = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return fn


@dataclass(frozen=True)
class AdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32

    def init(self, params) -> dict:
        """Zero moments in ``state_dtype`` beside each parameter, and the
        step count (int32, 0) on the first parameter's device."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.state_dtype, device=p.device)

        tree = as_tree(params)
        return dict(mu=tree_map(zeros, tree), nu=tree_map(zeros, tree),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=leaves(tree)[0].device))

    @torch.no_grad()
    def update(self, grads, state: dict, params):
        """One step: global-norm clip, bias-corrected Adam moments, decoupled
        weight decay inside the step.  Writes ``params`` and ``state`` in
        place; returns ``(params, state, dict(grad_norm=, lr=))`` (fp32
        scalars on the parameters' device)."""
        flat_g = leaves(grads)
        flat_p = leaves(params)
        flat_m, flat_v = leaves(state["mu"]), leaves(state["nu"])
        if not len(flat_g) == len(flat_p) == len(flat_m) == len(flat_v):
            raise ValueError("AdamW.update: grads, params and state differ in leaves")
        count = state["count"]
        count.add_(1)
        cf = count.float()
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat_g))
        # a true division, as the reference's (a Python number over a tensor
        # multiplies by the reciprocal in torch)
        scale = torch.clamp(torch.full_like(gnorm, self.clip_norm)
                            / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = self.schedule(count)
        bc1 = 1.0 - self.b1**cf
        bc2 = 1.0 - self.b2**cf
        for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
            g = g.float() * scale
            m32 = m.float() * self.b1 + (1 - self.b1) * g
            v32 = v.float() * self.b2 + (1 - self.b2) * g * g
            step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
            step = step + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            m.copy_(m32)
            v.copy_(v32)
        return params, state, dict(grad_norm=gnorm, lr=lr)
