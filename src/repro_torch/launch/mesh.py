"""`ShardMesh` — the device list the sharded backend runs on (the port's
counterpart of the JAX package's ``("data", "model")`` mesh).

One controller drives S row blocks, one per entry of ``devices``: block s
holds rows ``[s * rows, (s + 1) * rows)`` of every frontier and lives on
``devices[s]``.  The two exchanges a probe level needs are methods here:

* ``all_gather_rows(blocks)`` gives every shard the whole ``[n_pad, W]``
  frontier (fp32, or rounded to bf16 for the exchange and widened back);
* ``ring_shift(bufs)`` moves block s to shard ``s + 1`` (mod S).

Entries may repeat: ``ShardMesh(["cuda:0"] * 4)`` runs four real row
blocks on one card, as the JAX package's forced host device count does on
the CPU.  Then an all-gather is one ``torch.cat`` shared by every shard and
a ring step is a rotation of the list.  On distinct devices both are peer
copies (``Tensor.to``), ordered by PyTorch's cross-device copy.  Under a
``roofline.analysis.OpCounter`` each exchange counts the bytes the blocks
receive from other blocks (``all-gather`` / ``collective-permute``), the
same whether the blocks share a device or not.

``meta`` entries stand for cards that are not there: ``make_production_mesh``
gives 256 (or 512) ``meta`` blocks, the counterparts of the reference's
16 x 16 and 2 x 16 x 16 meshes, so a dry-run runs the step over the
production layout and allocates nothing.  A ``meta`` mesh is never
``single_device``: each block keeps its own gathered frontier, as on
distinct cards, and ``chips`` counts one card a block.

``HW`` holds the H100's published peaks (the reference's ``HW`` holds its
TPU's), under the reference's keys.

There is no data axis: the JAX package only replicates the same program
over it, so it changes no answer.  ``ShardMesh()`` takes one shard per
visible CUDA device; ``shards=S`` takes the first S of them and requires
the device count to be divisible by S.
"""
from __future__ import annotations

import math

import torch

from repro_torch.graph.structs import resolve_device
from repro_torch.roofline.analysis import Work, counted_op

Tensor = torch.Tensor

WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# NVIDIA H100 SXM, published dense rates at the 700 W power limit (NVIDIA's
# H100 data sheet).  fp32 runs outside the tensor cores; NVLink 4 is 900 GB/s
# in both directions together, 450 GB/s each way (the bytes a card receives).
HW = dict(
    peak_flops_bf16=989e12,  # FLOP/s per card, tensor cores, bf16 / fp16
    peak_flops_fp32=67e12,  # FLOP/s per card, CUDA cores
    hbm_bw=3.35e12,  # B/s per card (HBM3)
    hbm_bytes=80e9,  # B per card
    ici_bw=450e9,  # B/s per card each way over NVLink (the reference's key)
)
# exp2 on the special-function units: 16 a clock on each of the 132 SMs at
# the 1.83 GHz boost clock
PEAK_EXP_PER_S = 132 * 16 * 1.83e9


def _gather_work(mesh, blocks, *, wire: str = "float32") -> Work:
    """An all-gather's bytes over the links: each block receives every
    other block in the wire dtype."""
    itemsize = WIRE_DTYPES[wire].itemsize
    rows = sum(b.shape[0] for b in blocks)
    got = sum((rows - b.shape[0]) * math.prod(b.shape[1:]) * itemsize
              for b in blocks)
    return Work(collective={"all-gather": got})


def _shift_work(mesh, bufs) -> Work:
    """A ring step's bytes over the links: every block moves to the next
    shard (nothing moves on a one-block ring)."""
    moved = sum(b.numel() * b.element_size() for b in bufs) if len(bufs) > 1 else 0
    return Work(collective={"collective-permute": moved})


class ShardMesh:
    """An explicit list of S devices, one per row block."""

    def __init__(self, devices=None, *, shards: int | None = None):
        if devices is None:
            ndev = torch.cuda.device_count()
            if ndev == 0:
                raise RuntimeError(
                    "CUDA is not available; pass devices=['cpu'] * shards "
                    "to run the shards on the CPU"
                )
            s = ndev if shards is None else int(shards)
            if s < 1 or ndev % s:
                raise ValueError(
                    f"{s} shards need a device count divisible by {s}; "
                    f"have {ndev} (pass an explicit mesh= to override)"
                )
            devices = [f"cuda:{i}" for i in range(s)]
        devices = tuple(resolve_device(d) for d in devices)
        if not devices:
            raise ValueError("a ShardMesh needs at least one device")
        if shards is not None and int(shards) != len(devices):
            raise ValueError(
                f"shards={shards} != {len(devices)} devices in the mesh"
            )
        self.devices = devices
        # one device for every block: exchanges are a cat and a rotation
        # (meta blocks stand for distinct cards)
        self.single_device = (len(set(devices)) == 1
                              and devices[0].type != "meta")

    @property
    def shards(self) -> int:
        return len(self.devices)

    @property
    def chips(self) -> int:
        """The cards the blocks run on: one a block on ``meta`` (a dry-run's
        blocks are the production mesh's cards), else the distinct
        devices."""
        if self.devices[0].type == "meta":
            return self.shards
        return len(set(self.devices))

    @property
    def home(self) -> torch.device:
        """Shard 0's device: the lane cursors, walk pools and answers."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"ShardMesh({[str(d) for d in self.devices]})"

    def broadcast(self, x: Tensor) -> list[Tensor]:
        """``x`` on every shard's device, read-only (no copy on its own
        device)."""
        return [x.to(d) for d in self.devices]

    def replicate(self, x: Tensor) -> list[Tensor]:
        """A copy of ``x`` for every shard, each its own tensor even where
        two shards share a device (per-shard state written per shard)."""
        return [x.to(d, copy=True) for d in self.devices]

    @counted_op("all_gather_rows", _gather_work)
    def all_gather_rows(self, blocks: list[Tensor], *,
                        wire: str = "float32") -> list[Tensor]:
        """Every shard's view of the whole frontier: the S ``[rows, W]``
        blocks stacked in row order, on each shard's device.  With
        ``wire="bfloat16"`` the blocks cross as bf16 and are widened back
        to fp32 on arrival."""
        dt = WIRE_DTYPES[wire]
        sent = [b.to(dt) for b in blocks]
        if self.single_device:
            full = torch.cat(sent)
            if dt != torch.float32:
                full = full.float()
            return [full] * self.shards
        out = []
        for d in self.devices:
            full = torch.cat([b if b.device == d else b.to(d) for b in sent])
            out.append(full.float() if dt != torch.float32 else full)
        return out

    @counted_op("ring_shift", _shift_work)
    def ring_shift(self, bufs: list[Tensor]) -> list[Tensor]:
        """Block s moves to shard s + 1 (mod S)."""
        s = self.shards
        return [bufs[(i - 1) % s].to(self.devices[i]) for i in range(s)]

    def gather_rows(self, blocks: list[Tensor]) -> Tensor:
        """The S blocks stacked in row order on the home device (one block
        is returned as it is, not copied)."""
        if len(blocks) == 1:
            return blocks[0].to(self.home)
        return torch.cat([b.to(self.home) for b in blocks])


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> ShardMesh:
    """The production mesh: 256 row blocks, or 512 with ``multi_pod`` (the
    block counts of the reference's 16 x 16 and 2 x 16 x 16 meshes), on
    ``meta`` unless ``devices`` names them (then it must name that many)."""
    shards = 512 if multi_pod else 256
    if devices is None:
        devices = ["meta"] * shards
    return ShardMesh(devices, shards=shards)


def mesh_for(device="cuda", shards: int | None = None) -> ShardMesh:
    """The mesh a command line's ``--device`` / ``--shards`` ask for: one
    block per visible card for ``"cuda"``, else every block on ``device``
    (``"cpu"``, ``"cuda:0"``).  ``shards`` defaults to the CUDA device
    count (at least 1)."""
    if shards is None:
        shards = max(torch.cuda.device_count(), 1)
    if str(device) == "cuda":
        return ShardMesh(shards=shards)
    return ShardMesh([device] * shards)
