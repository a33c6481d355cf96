"""``serve_step``: the production serve step (``make_serve_step`` over
``build_sharded_graph``) on one row block: the CSR walk sampler and the
push (``coo_push``: one ``spmm_csr`` launch a level over the block's
in-CSR).

Each unit is one step of ``queries`` top-k queries x ``walk_chunk``
walks (one walk seed a step).  Mix keys: ``queries``, ``walk_chunk``,
``top_k``, ``edge_chunks``, ``check_units`` (whole steps compared, every
query of each), ``trace_units``.  The control puts the reference in the
step's place with its frontier stored in bfloat16.
"""
from __future__ import annotations

import torch

from portbench import check, deploy, traffic
from portbench.reference import simrank as ref


class Cell:
    def __init__(self, cfg, mix, seed, device, spans, *, devices=(), control=False):
        from repro_torch.configs.base import ProbeSimConfig
        from repro_torch.core.distributed import build_sharded_graph, make_serve_step
        from repro_torch.launch.mesh import ShardMesh

        self.mix, self.device, self.spans = mix, device, spans
        self.graph = g = deploy.make_graph(cfg, seed, device)
        self.n = cfg["n"]
        self.b = deploy.budget(self.n, cfg["c"], cfg["eps_a"], cfg["delta"])
        self.sg = build_sharded_graph(
            g["src_h"], g["dst_h"], self.n, mesh=ShardMesh([device]),
            pad_nodes=cfg["pad_nodes"], pad_edges=cfg["pad_edges"])
        pcfg = ProbeSimConfig(name=cfg["name"], n=self.n, m=g["m"], c=cfg["c"],
                              eps_a=cfg["eps_a"], delta=cfg["delta"])
        self.step = make_serve_step(
            pcfg, queries=mix["queries"], walk_chunk=mix["walk_chunk"],
            max_len=self.b["max_len"], top_k=mix["top_k"],
            edge_chunks=mix["edge_chunks"])
        self.control = control
        self.queries = traffic.QueryStream(seed, g["candidates"])
        self.warm_queries = traffic.QueryStream(seed, g["candidates"], traffic.WARM)
        self.units: list[dict] = []
        self.failed = 0
        self._csr = None

    def _step(self, stream) -> dict:
        nodes, seeds, _ = stream.take(self.mix["queries"])
        with self.spans.span("step"):
            if self.control:
                idx, vals = self.control_step(nodes, seeds[0])
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seeds[0])
                q = torch.tensor(nodes, dtype=torch.int32, device=self.device)
                idx, vals = self.step(self.sg, q, gen)
            idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
        return dict(answers=[dict(node=u, seed=seeds[0], slot=j, idx=idx[j],
                                  vals=vals[j]) for j, u in enumerate(nodes)])

    def warm(self) -> None:
        self._step(self.warm_queries)

    def unit(self) -> None:
        self.units.append(self._step(self.queries))

    def walks(self) -> int:
        return len(self.units) * self.mix["queries"] * self.mix["walk_chunk"]

    def attempted(self) -> int:
        return len(self.units) * self.mix["queries"]

    def facts(self) -> dict:
        return dict(live_edges=sum(self.sg.counts), n_pad=self.sg.n_pad,
                    cols=self.mix["queries"] * self.mix["walk_chunk"], itemsize=4)

    def counters(self) -> dict:
        return {}

    def free(self) -> None:
        del self.sg

    def reference(self, a: dict, *, store=None) -> torch.Tensor:
        """The reference's estimates [n] for query slot ``a["slot"]`` of the
        step seeded ``a["seed"]`` (float64, or ``store``-rounded levels)."""
        b, q, wc = self.b, self.mix["queries"], self.mix["walk_chunk"]
        if self._csr is None:
            self._csr = deploy.reference_graph(self.graph, self.n, self.device)
        csr, src, dst = self._csr
        cont, pick = ref.draw(a["seed"], q * wc, b["max_len"] - 1, b["sqrt_c"],
                              self.device, steps_first=True)
        rows = slice(a["slot"] * wc, (a["slot"] + 1) * wc)
        starts = torch.full((wc,), a["node"], dtype=torch.int64, device=self.device)
        walks = ref.walks_from(csr, starts, cont[rows], pick[rows], self.n)
        dtype = torch.float64 if store is None else torch.float32
        return ref.probe_sum(csr, src, dst, walks, sqrt_c=b["sqrt_c"], eps_p=0.0,
                             dtype=dtype, store=store) / wc

    def control_step(self, nodes, seed):
        """The control: the reference in the program's place, its frontier
        stored in bfloat16 (the precision below the deployment's fp32)."""
        k = self.mix["top_k"]
        idx, vals = [], []
        for j, u in enumerate(nodes):
            est = self.reference(dict(node=u, seed=seed, slot=j),
                                 store=torch.bfloat16).double()
            v, i = ref.topk_excluding(est, u, k)
            idx.append(i)
            vals.append(v)
        return torch.stack(idx), torch.stack(vals)

    compared = check.topk_compared
