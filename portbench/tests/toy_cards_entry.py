"""A toy entry across a cell's cards, for the test that adds a four-card
cell to a copy of the benchmark: each unit multiplies a seeded matrix by
a vector, one row block a card, and gathers the blocks on the first.
Its check compares the product with float64 and counts the cards it got
short of four."""
import torch

from portbench import check


class Cell:
    def __init__(self, cfg, mix, seed, device, spans, *, devices=(), control=False):
        self.devices, self.mix, self.spans = list(devices), mix, spans
        self.n = cfg["n"]
        self.graph, self.b = dict(m=self.n * self.n), dict(n_r=1, max_len=1)
        gen = torch.Generator().manual_seed(seed % 2**63)
        self.a = torch.rand(self.n, self.n, generator=gen, dtype=torch.float64)
        self.blocks = [blk.float().to(d) for blk, d in
                       zip(self.a.chunk(len(self.devices)), self.devices)]
        self.units: list[dict] = []
        self.failed = 0

    def _unit(self) -> dict:
        x = torch.full((self.n,), 1.0 / (len(self.units) + 1))
        with self.spans.span("unit"):
            y = torch.cat([(b @ x.to(b.device)).to(self.devices[0])
                           for b in self.blocks])
        return dict(x=x, y=y.cpu())

    def warm(self) -> None:
        self._unit()

    def unit(self) -> None:
        self.units.append(self._unit())

    def walks(self) -> int:
        return len(self.units)

    def attempted(self) -> int:
        return len(self.units)

    def facts(self) -> dict:
        return {}

    def counters(self) -> dict:
        return {}

    def free(self) -> None:
        del self.blocks

    def compared(self, seed: int) -> tuple[dict, int]:
        picked = check.pick_units(seed, len(self.units), self.mix["check_units"])
        gap = max((float((self.units[i]["y"].double()
                          - self.a @ self.units[i]["x"].double()).abs().max())
                   for i in picked), default=0.0)
        return (dict(gap=gap, cards_short=float(4 - len(self.devices))),
                0 if picked else 1)
