"""Roofline analysis of one step, counted op by op (port of
``repro.roofline.analysis``).

Three terms per (arch x shape x mesh), in seconds, per device:

    compute    = tensor_core_FLOPs / peak_bf16 + other_FLOPs / peak_fp32
    memory     = bytes / HBM_bw
    collective = collective_bytes / link_bw

The reference reads FLOPs and bytes from ``compiled.cost_analysis()`` and
parses collectives out of the optimized HLO.  The port has no HLO: its
counts come from ``OpCounter``, a ``TorchDispatchMode`` that sees every
aten op a step dispatches, the same on ``cuda``, ``cpu`` and ``meta``
tensors (a ``meta`` step allocates nothing, so a dry-run counts a step of
any size).  ``parse_collectives`` and ``_shape_bytes`` have no counterpart:
they parse HLO text.

The rules (one op at a time):

* **FLOPs.** Matmul-class ops (``mm``, ``bmm``, ``addmm``, ...) count
  ``torch.utils.flop_counter``'s formulas (2mnk); with bf16 or fp16
  operands they run on the tensor cores and are kept apart
  (``tensor_core_flops``).  Data movement (copies, casts, ``cat``, fills,
  gathers) counts none.  Every other op counts one operation per element
  of its largest tensor: per output element for an elementwise op, per
  input element for a reduction.  Two ops of the MoE dispatch compare an element
  more than once: ``sort`` counts ``n * ceil(log2 n)`` comparisons per
  slice of n along its dimension, ``searchsorted`` ``ceil(log2 (m + 1))``
  per value searched in m boundaries.
* **Bytes.** Each input read once, each output written once (an in-place
  op reads and writes its target); a broadcast input counts its distinct
  elements.  Index ops count the rows they touch, not the whole tensor:
  a gather (``index``, ``index_select``, ``gather``, ``embedding``) reads
  as many elements as it writes; ``index_add_`` and ``index_put_`` read
  their sources and indices and read-modify-write (or, without
  accumulation, write) the addressed elements; a ``scatter`` without a
  reduction reads its index and source and writes as many elements;
  ``scatter_add`` and ``scatter_reduce`` (any reduction: the GNN's
  segment max, the backward of a ``gather``) count one operation per
  source element, read the index and the source, and in place
  read-modify-write one addressed element per source element, out of
  place read ``self`` and write the whole output instead.  Views, metadata ops,
  allocations without writes (``empty``) and a ``.to`` that returns its
  input count nothing.
* **Kernels.** The hand-written kernels' public ops (``lane_probe_level``,
  ``spmm_ell`` / ``spmm_ell_padded``, ``probe_push``, ``flash_attention``)
  count as one op each, by their least-work formulas below, whichever
  route runs (the CUDA kernel, the plain version on the CPU, the meta
  route); nothing inside them is counted again.  ``lane_probe_work`` and
  ``spmm_work`` read the data (live slots, distinct gathered rows): on
  ``meta`` they raise.
* **Collectives.** ``ShardMesh.all_gather_rows`` counts ``all-gather`` and
  ``ShardMesh.ring_shift`` ``collective-permute``: the bytes the blocks
  receive from other blocks in the wire dtype, whether the blocks share a
  device or not (a one-card run and a four-card run count the same); the
  ops inside an exchange are not counted.  The reference instead sums the
  result buffers of the HLO collectives (an upper bound that includes a
  device's own block).
* **Per device.** The counter sees the whole step of every block; a
  report divides its totals by ``chips`` (the step is taken to be
  balanced over the blocks).
* **Memory.** ``OpCounter`` tracks every storage an op (or a counted
  kernel) allocates until its last tensor dies; ``peak_bytes`` is the most
  alive at once: the step's intermediates and outputs.  The state and
  inputs that existed before the step are not in it.
"""
from __future__ import annotations

import functools
import math
import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

Tensor = torch.Tensor

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)


@dataclass
class Work:
    """What an op or a step costs: all operations (``flops``), the part of
    them on the tensor cores (``tc_flops``), HBM bytes and, per collective
    kind, bytes over the links."""

    flops: float = 0.0
    tc_flops: float = 0.0
    bytes: float = 0.0
    collective: dict = field(default_factory=dict)

    def compute_s(self, hw: dict) -> float:
        other = self.flops - self.tc_flops
        return (self.tc_flops / hw["peak_flops_bf16"]
                + other / hw.get("peak_flops_fp32", hw["peak_flops_bf16"]))

    def bound_s(self, hw: dict) -> tuple[float, str]:
        """The least time of this work on one device without its
        collectives: the larger of bytes over HBM bandwidth and the compute
        term, and which of the two it is ("bytes" or "operations")."""
        t_bytes = self.bytes / hw["hbm_bw"]
        t_ops = self.compute_s(hw)
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# The kernels' least work
# ---------------------------------------------------------------------------


def _live_ids(nbrs: Tensor, row_len: Tensor, n_live: int, what: str) -> tuple[int, int]:
    """The live slots of an ELL table read up to ``row_len`` (ids below
    ``n_live``) and how many distinct rows they name."""
    if nbrs.device.type == "meta":
        raise ValueError(f"{what}: the least work reads the table's live slots "
                         "and distinct ids; a meta tensor has no data")
    live_mask = (torch.arange(nbrs.shape[1], device=nbrs.device)[None, :]
                 < row_len[:, None]) & (nbrs < n_live)
    ids = nbrs[live_mask]
    return int(ids.numel()), int(torch.unique(ids).numel())


def lane_probe_work(nbrs: Tensor, row_len: Tensor, n_live: int, width: int,
                    fin: Tensor, *, tot_inplace: bool = False,
                    itemsize: int = 4) -> Work:
    """One lane_probe level over these rows with this data: each live id
    read once, each distinct gathered table row read once in the unfinished
    columns, ``dep`` read in the finished ones, ``total`` read and ``out``
    / ``tot`` written (``out`` alone when ``tot`` is ``total``), the [W]
    vectors and row_len / weights read once; four operations per live slot
    and open column (prune compare, inject compare, add, weight) and two
    per row and column (deposit, exclusion)."""
    r = nbrs.shape[0]
    live, distinct = _live_ids(nbrs, row_len, n_live, "lane_probe")
    n_fin = int(fin.sum())
    w_open = width - n_fin
    nbytes = (live * 4 + r * 8 + distinct * w_open * itemsize
              + r * n_fin * itemsize
              + r * width * itemsize * (1 if tot_inplace else 3) + 4 * width * 4)
    return Work(flops=live * w_open * 4 + r * width * 2, bytes=nbytes)


def spmm_work(nbrs: Tensor, row_len: Tensor, n: int, b: int, *,
              push: bool = False, itemsize: int = 4) -> Work:
    """One spmm_ell call (``push``: one probe_push call): the live ids, each
    distinct gathered score row once, row_len / weights, the [R, B] output;
    ``push`` also reads the B exclusion ids and compares each gathered
    value with the threshold beside its add."""
    r = nbrs.shape[0]
    live, distinct = _live_ids(nbrs, row_len, n, "probe_push" if push else "spmm_ell")
    nbytes = (live * 4 + r * 8 + distinct * b * itemsize + r * b * itemsize
              + push * b * 4)
    return Work(flops=live * b * (1 + push) + r * b, bytes=nbytes)


def flash_work(q_shape, kv_shape, *, causal: bool, dtype: torch.dtype) -> Work:
    """FlashAttention forward: four operations per (query, key) pair and
    head dimension (the two products, 2 x 2 dh), over the causal triangle
    when ``causal``; q, k, v read once and the output written once.  bf16
    and fp16 run on the tensor cores."""
    B, S, H, dh = q_shape
    T, Hkv = kv_shape[1], kv_shape[2]
    pairs = B * H * S * (S + 1) / 2 if causal else B * H * S * T
    flops = pairs * 4 * dh
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = itemsize * (2 * B * S * H * dh + 2 * B * T * Hkv * dh)
    return Work(flops=flops, tc_flops=flops if dtype in TENSOR_CORE_DTYPES else 0.0,
                bytes=nbytes)


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

_local = threading.local()


def active_counter() -> "OpCounter | None":
    """The innermost ``OpCounter`` entered on this thread, if any."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def counted_op(name: str, work):
    """Decorate a public op so that, under an ``OpCounter``, it counts as one
    op with ``work(*args, **kwargs)`` (a ``Work``) and nothing it runs
    inside is counted.  Without a counter the op runs as it is."""

    def wrap(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            c = active_counter()
            if c is None or c._quiet:
                return fn(*args, **kwargs)
            return c._count_call(name, work, fn, args, kwargs)

        return op

    return wrap


_MOVES = frozenset((
    "to", "_to_copy", "copy_", "clone", "cat", "stack", "fill_", "zero_", "zeros",
    "ones", "full", "zeros_like", "ones_like", "full_like", "new_zeros",
    "new_ones", "new_full", "arange", "scalar_tensor", "repeat",
    "repeat_interleave", "expand_copy", "flip", "roll", "constant_pad_nd",
    "lift_fresh_copy",
))
_FREE = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "detach", "alias", "lift_fresh", "set_", "resize_",
    "record_stream", "_unsafe_view",
    # profiler ranges (``record_function``): markers, no work
    "_record_function_enter_new", "_record_function_exit",
))
_GATHERS = frozenset(("index", "_unsafe_index", "index_select", "gather",
                      "embedding"))
_SCATTERS = frozenset(("scatter_add", "scatter_add_", "scatter_reduce",
                       "scatter_reduce_"))


def _distinct_elems(t: Tensor) -> int:
    """Elements a tensor addresses (a broadcast dimension counts once)."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)


def _nbytes(t: Tensor) -> int:
    return _distinct_elems(t) * t.element_size()


def _tensors(*trees) -> list[Tensor]:
    """The distinct tensors of aten arguments or results: tensors, and lists
    or tuples of them (one level deep, as aten passes them)."""
    seen, out = set(), []
    for tree in trees:
        items = tree.values() if isinstance(tree, dict) else (
            tree if isinstance(tree, (list, tuple)) else (tree,))
        for a in items:
            for x in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(x, Tensor) and id(x) not in seen:
                    seen.add(id(x))
                    out.append(x)
    return out


def _touched(index_tensors, trailing: int) -> int:
    """Elements addressed by advanced indices (broadcast together) times
    the size of the dimensions they leave whole."""
    shapes = [t.shape for t in index_tensors if t is not None]
    return math.prod(torch.broadcast_shapes(*shapes)) * trailing if shapes else 0


def op_work(func, args, kwargs, out, ins=None, outs=None) -> Work:
    """One aten op's work by the rules of the module docstring (``ins`` /
    ``outs``: the op's distinct input / output tensors, if already known)."""
    name = func.overloadpacket.__name__
    if _is_view(func) or name in _FREE:
        return Work()
    ins = _tensors(args, kwargs) if ins is None else ins
    outs = _tensors(out) if outs is None else outs
    if name == "to" and outs[0] is ins[0]:
        return Work()  # a .to that had nothing to do returns its input
    if name in _GATHERS:
        idx = sum(_nbytes(t) for t in ins[1:])
        moved = sum(_nbytes(t) for t in outs)
        return Work(bytes=idx + 2 * moved)
    if name in ("index_add_", "index_add"):
        self_, index, source = args[0], args[2], args[3]
        rmw = source.numel() * self_.element_size() * 2
        return Work(flops=source.numel(),
                    bytes=_nbytes(index) + _nbytes(source) + rmw)
    if name in _SCATTERS:
        self_, index, src = args[0], args[2], args[3]
        nbytes = _nbytes(index) + _nbytes(src)
        if name.endswith("_"):  # read-modify-write of the addressed elements
            nbytes += 2 * src.numel() * self_.element_size()
        else:
            nbytes += _nbytes(self_) + sum(_nbytes(t) for t in outs)
        return Work(flops=src.numel(), bytes=nbytes)
    if name in ("scatter", "scatter_") and len(args) == 4 and not kwargs:
        index, src = args[2], args[3]
        if isinstance(src, Tensor):
            return Work(bytes=_nbytes(index) + 2 * _nbytes(src))
    if name == "sort":
        t = args[0]
        # sort(self, dim, descending) or sort.stable(self, *, stable, dim, ...)
        dim = args[1] if len(args) > 1 else kwargs.get("dim", -1)
        n = t.shape[dim] if t.dim() else 1
        nbytes = sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
        return Work(flops=t.numel() * max(1, math.ceil(math.log2(max(n, 2)))),
                    bytes=nbytes)
    if name == "searchsorted":
        bounds, values = args[0], args[1]
        m = bounds.shape[-1]
        nbytes = sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
        return Work(flops=values.numel() * math.ceil(math.log2(m + 1)), bytes=nbytes)
    if name in ("index_put_", "index_put", "_index_put_impl_"):
        self_, indices, values = args[0], args[1], args[2]
        acc = bool(args[3]) if len(args) > 3 else bool(kwargs.get("accumulate", False))
        nidx = sum(1 for t in indices if t is not None)
        touched = _touched(indices, math.prod(self_.shape[nidx:]))
        idx = sum(_nbytes(t) for t in indices if t is not None)
        return Work(flops=touched if acc else 0,
                    bytes=idx + _nbytes(values)
                    + touched * self_.element_size() * (2 if acc else 1))
    nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
    mm = _matmul_flops(func)
    if mm is not None:
        flops = float(mm(*args, **kwargs, out_val=out))
        tc = any(t.dtype in TENSOR_CORE_DTYPES for t in ins)
        return Work(flops=flops, tc_flops=flops if tc else 0.0, bytes=nbytes)
    if name in _MOVES:
        return Work(bytes=nbytes)
    elems = max((t.numel() for t in ins + outs), default=0)
    return Work(flops=elems, bytes=nbytes)


@functools.lru_cache(maxsize=None)
def _matmul_flops(func):
    from torch.utils.flop_counter import flop_registry

    return flop_registry.get(func.overloadpacket)


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    """An op whose result always aliases its input (``.to`` only may)."""
    return func.is_view and func.overloadpacket.__name__ != "to"


@functools.lru_cache(maxsize=None)
def _decomposes(func) -> bool:
    """A composite op the counter splits into the ops it is made of (a
    ``.to`` is counted whole: a copy, or nothing when it returns its input)."""
    return (func.overloadpacket.__name__ != "to"
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"))


def _key(t: Tensor):
    return t.untyped_storage()._cdata


# --- meta kernels, memoized -------------------------------------------------
# A meta kernel computes its result's shape, strides and dtype from its
# inputs' alone, so two calls that agree on those (and on every other
# argument) give the same result: the counter replays it instead of running
# the kernel again (many meta kernels are Python and cost 0.1-1 ms a call).


_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
          torch.memory_format, type(None))


def _meta_arg(a):
    if isinstance(a, Tensor):
        if a.device.type != "meta":
            raise TypeError
        return (a.shape, a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple([_meta_arg(x) for x in a])
    if isinstance(a, _PLAIN):
        return a
    raise TypeError


def _meta_record(out, args):
    """How to rebuild ``out``: per tensor ("arg", i) when it is argument i
    itself (an in-place op), else ("new", shape, stride, dtype); None when
    an output is anything else (a view, a scalar)."""
    outs = out if isinstance(out, tuple) else (out,)
    recs = []
    for t in outs:
        if not isinstance(t, Tensor):
            return None
        pos = next((i for i, a in enumerate(args) if a is t), None)
        recs.append(("arg", pos) if pos is not None
                    else ("new", tuple(t.shape), t.stride(), t.dtype))
    return isinstance(out, tuple), recs


def _meta_replay(rec, args):
    is_tuple, recs = rec
    outs = tuple(args[r[1]] if r[0] == "arg" else
                 torch.empty_strided(r[1], r[2], dtype=r[3], device="meta")
                 for r in recs)
    return outs if is_tuple else outs[0]


class OpCounter(TorchDispatchMode):
    """Count every aten op dispatched while entered (see the module
    docstring for the rules).

    ``flops``, ``tc_flops``, ``bytes`` are totals over the whole step;
    ``collective_bytes`` / ``collective_counts`` are per kind;
    ``by_op[name] = [calls, Work]``; ``peak_bytes`` is the most
    bytes the step's own allocations held at once.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.tc_flops = 0.0
        self.bytes = 0.0
        self.collective_bytes = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.collective_counts = {k: 0 for k in COLLECTIVE_KINDS}
        self.by_op: dict[str, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held: dict[int, list] = {}  # storage key -> [holders, nbytes]
        self._quiet = 0
        self._meta: dict = {}

    # --- the mode ----------------------------------------------------------
    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _local.stack.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._quiet and _decomposes(func):
            # a composite op (matmul, einsum, .to, ...) reaches the mode whole
            # when autograd is off: count the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if _is_view(func):
            out = func(*args, **kwargs)
            if self._held and not self._quiet:
                self._track(_tensors(out), _tensors(args, kwargs))
            return out
        out = self._run(func, args, kwargs)
        if self._quiet:
            return out
        ins, outs = _tensors(args, kwargs), _tensors(out)
        self.add(func.overloadpacket.__name__,
                 op_work(func, args, kwargs, out, ins, outs))
        self._track(outs, ins)
        return out

    def _run(self, func, args, kwargs):
        if not args or not isinstance(args[0], Tensor) \
                or args[0].device.type != "meta":
            return func(*args, **kwargs)
        try:
            key = (func, _meta_arg(args), _meta_arg(tuple(kwargs.items())))
        except TypeError:
            return func(*args, **kwargs)
        rec = self._meta.get(key)
        if rec is not None:
            return _meta_replay(rec, args)
        out = func(*args, **kwargs)
        rec = _meta_record(out, args)
        if rec is not None:
            self._meta[key] = rec
        return out

    # --- totals ------------------------------------------------------------
    def add(self, name: str, w: Work) -> None:
        self.flops += w.flops
        self.tc_flops += w.tc_flops
        self.bytes += w.bytes
        for kind, b in w.collective.items():
            self.collective_bytes[kind] += b
            self.collective_counts[kind] += 1
        row = self.by_op.setdefault(name, [0, Work()])
        row[0] += 1
        row[1].flops += w.flops
        row[1].tc_flops += w.tc_flops
        row[1].bytes += w.bytes

    def totals(self) -> dict:
        """FLOPs, bytes and collective bytes (the numbers two runs of the
        same step must share)."""
        return dict(flops=self.flops, tc_flops=self.tc_flops, bytes=self.bytes,
                    collective_bytes=dict(self.collective_bytes))

    def top_ops(self, hw: dict, k: int = 5) -> list[tuple[str, int, float]]:
        """The ``k`` op names whose counted work takes the most roofline
        time: ``(name, calls, seconds)``."""
        rows = sorted(((n, c, w.bound_s(hw)[0]) for n, (c, w) in self.by_op.items()),
                      key=lambda r: -r[2])
        return rows[:k]

    # --- counted calls -----------------------------------------------------
    def _count_call(self, name, work, fn, args, kwargs):
        self._quiet += 1
        try:
            w = work(*args, **kwargs)
            out = fn(*args, **kwargs)
        finally:
            self._quiet -= 1
        self.add(name, w)
        self._track(_tensors(out), _tensors(args, kwargs))
        return out

    # --- memory ------------------------------------------------------------
    def _track(self, outs, ins) -> None:
        """Hold each output tensor's storage until its last tensor dies: a
        storage the step made already, or a new one (not an input's: a view
        or an in-place op of the state holds nothing)."""
        if not outs:
            return
        in_ids = {id(t) for t in ins}
        in_keys = None
        for t in outs:
            if id(t) in in_ids or t.layout != torch.strided:
                continue
            key = _key(t)
            held = self._held.get(key)
            if held is None:
                if in_keys is None:
                    in_keys = {_key(x) for x in ins if x.layout == torch.strided}
                if key in in_keys:
                    continue
                nbytes = t.untyped_storage().nbytes()
                held = self._held[key] = [0, nbytes]
                self.live_bytes += nbytes
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            held[0] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        held = self._held.get(key)
        if held is None:
            return
        held[0] -= 1
        if held[0] == 0:
            self.live_bytes -= held[1]
            del self._held[key]


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per-device (the counter's total / chips)
    hlo_bytes: float  # per-device
    collective_bytes: float  # per-device (bytes received over the links)
    model_flops: float  # global MODEL_FLOPS (6ND etc.)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flops_ratio: float = 0.0
    collectives: dict = field(default_factory=dict)
    memory_per_device: dict = field(default_factory=dict)
    tensor_core_flops: float = 0.0  # per-device, the part of hlo_flops on tensor cores

    def finalize(self, hw: dict) -> "RooflineReport":
        """The three terms from ``hw`` (``launch.mesh.HW`` keys; without
        ``peak_flops_fp32``, as in the reference's table, every FLOP is
        divided by ``peak_flops_bf16``)."""
        self.compute_s = Work(flops=self.hlo_flops,
                              tc_flops=self.tensor_core_flops).compute_s(hw)
        self.memory_s = self.hlo_bytes / hw["hbm_bw"]
        self.collective_s = self.collective_bytes / hw["ici_bw"]
        terms = dict(
            compute=self.compute_s, memory=self.memory_s,
            collective=self.collective_s,
        )
        self.bottleneck = max(terms, key=terms.get)
        global_hlo_flops = self.hlo_flops * self.chips
        self.useful_flops_ratio = (
            self.model_flops / global_hlo_flops if global_hlo_flops else 0.0
        )
        return self

    @property
    def roofline_s(self) -> float:
        """The least time of the step: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            k: v for k, v in self.__dict__.items()
        }


def analyze(
    *, arch: str, shape: str, mesh_name: str, chips: int, counter: OpCounter,
    model_flops: float, hw: dict, memory: dict | None = None,
) -> RooflineReport:
    """A finalized report from a counter that saw the whole step of every
    block; each total is divided by ``chips``."""
    per = 1.0 / chips
    coll = counter.collective_bytes
    rep = RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=counter.flops * per,
        hlo_bytes=counter.bytes * per,
        collective_bytes=sum(coll.values()) * per,
        model_flops=model_flops,
        tensor_core_flops=counter.tc_flops * per,
        collectives=dict(
            by_kind={k: v * per for k, v in coll.items()},
            counts=dict(counter.collective_counts),
            total_bytes=sum(coll.values()) * per,
        ),
        memory_per_device=dict(memory or {}),
    )
    return rep.finalize(hw)
