"""``session``: drained top-k batches through ``SimRankSession`` on the
local backend, the program's main path (``fused_serve``, the ``lane_probe``
kernel every level).

Each unit submits ``batch_q`` top-k queries (``top_k``, walk seeds
pinned) over ``walk_chunk`` lanes and drains them.  Mix keys: ``batch_q``,
``walk_chunk``, ``top_k``, ``check_units`` (whole drained batches
compared), ``trace_units``.  The control runs the program's own lane
buffers in the configuration's ``control.kernel_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import check, deploy, traffic
from portbench.reference import simrank as ref


class Cell:
    def __init__(self, cfg, mix, seed, device, spans, *, devices=(), control=False):
        from repro_torch.api.handle import GraphHandle
        from repro_torch.api.session import SimRankSession

        self.mix, self.device, self.spans = mix, device, spans
        self.graph = g = deploy.make_graph(cfg, seed, device)
        self.n = cfg["n"]
        self.b = deploy.budget(self.n, cfg["c"], cfg["eps_a"], cfg["delta"])
        handle = GraphHandle.from_edges(g["src_h"], g["dst_h"], self.n,
                                        k_max=cfg["graph"]["max_deg"], device=device)
        dtype = cfg["control"]["kernel_dtype"] if control else cfg["precision"]
        self.sess = SimRankSession(
            handle, c=cfg["c"], eps_a=cfg["eps_a"], delta=cfg["delta"],
            walk_chunk=mix["walk_chunk"], top_k=mix["top_k"],
            batch_q=mix["batch_q"], use_kernel=True, kernel_dtype=dtype)
        del handle
        self.queries = traffic.QueryStream(seed, g["candidates"])
        self.warm_queries = traffic.QueryStream(seed, g["candidates"], traffic.WARM)
        self.units: list[dict] = []
        self.failed = 0
        self._csr = None

    def _batch(self, stream) -> dict:
        from repro_torch.api.spec import QuerySpec

        nodes, seeds, _ = stream.take(self.mix["batch_q"])
        for u, s in zip(nodes, seeds):
            self.sess.submit(QuerySpec(kind="topk", node=u, k=self.mix["top_k"],
                                       key=s))
        with self.spans.span("drain"):
            envs = self.sess.drain()
        answers = [dict(node=u, seed=s, idx=np.asarray(e.topk_nodes),
                        vals=np.asarray(e.topk_scores))
                   for u, s, e in zip(nodes, seeds, envs)]
        return dict(answers=answers, walks=sum(int(e.walks_used) for e in envs))

    def warm(self) -> None:
        self._batch(self.warm_queries)

    def unit(self) -> None:
        self.units.append(self._batch(self.queries))

    def walks(self) -> int:
        return sum(u["walks"] for u in self.units)

    def attempted(self) -> int:
        return sum(len(u["answers"]) for u in self.units)

    def facts(self) -> dict:
        eg, g = self.sess.handle.eg, self.sess.handle.g
        return dict(live_slots=int(eg.in_deg.sum()), n=self.n,
                    lanes=self.mix["walk_chunk"],
                    sources=int(torch.unique(g.src[: g.num_edges]).numel()),
                    itemsize=2 if self.sess.backend.kernel_dtype == "bfloat16" else 4)

    def counters(self) -> dict:
        from repro_torch.kernels.lane_probe.ops import lane_probe_level

        return dict(lane_probe_launches=getattr(lane_probe_level, "launches", 0))

    def free(self) -> None:
        del self.sess

    def reference(self, a: dict) -> torch.Tensor:
        """The reference's estimates [n] (float64) for answer ``a``."""
        b, dev, n = self.b, self.device, self.n
        if self._csr is None:
            self._csr = deploy.reference_graph(self.graph, n, dev)
        csr, src, dst = self._csr
        cont, pick = ref.draw(a["seed"], b["n_r"], b["max_len"] - 1, b["sqrt_c"],
                              dev, steps_first=False)
        starts = torch.full((b["n_r"],), a["node"], dtype=torch.int64, device=dev)
        walks = ref.walks_from(csr, starts, cont, pick, n)
        return ref.probe_sum(csr, src, dst, walks, sqrt_c=b["sqrt_c"],
                             eps_p=b["eps_p"]) / b["n_r"]

    compared = check.topk_compared
