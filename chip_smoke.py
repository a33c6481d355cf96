#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero before the result line):

1. the card's name and power limit; build the four CUDA kernels with nvcc,
   one process per source, all at once;
2. each kernel against its plain PyTorch version on the card: small edge
   cases (for lane_probe, spmm_ell and probe_push also live-first tables
   with empty rows, a hub row over several chunks and cut row extents), then the
   shapes of the paths below, with timings (kernel, plain version, bound,
   library call): the live-prefix rule and the chunk plan of the HepPh ELL
   table, lane_probe (hub and no-hub slices, full table), spmm_ell and
   probe_push on that table, flash_attention at Llama-3.2-1B's 32k prefill
   shape (its tensor-core route, held against the bf16-probability plain
   version, and repeated bit for bit) and, timed only, at dh 128;
3. the SimRank path at real size: 16 top-k queries on the HepPh stand-in
   (``paper_dataset("hepph", 1.0)``) submitted to ``SimRankSession`` and
   drained in batches of 8, then one ``single_source(variant="tree")`` on
   the ELL table — with the launch and plan-build counters read around
   that window; then serial and kernel-off runs under the same seeds must
   agree, and one more drained batch is profiled;
4. accuracy: node a of the paper's toy graph at c = 0.25 within the
   Thm-1/2 bound of the paper's Table 2; then ``accuracy_phase`` on the
   HepPh stand-in: the exact Power-Method oracle (``simrank_power``, 55
   iterations, first held against its numpy copy on a 300-node graph and
   against Table 2), 16 adaptive single-source queries (``epsilon``) at
   eps 0.1 and 0.05 drained in batches of 8, each within its certified
   bound of the oracle, beside the same 16 served flat; an escalated query
   bitwise equal to a one-shot query capped at its walks; 8 hub queries
   drained twice, the second drain from the probe cache with no lane_probe
   launch; MC, TSF, the truncated Power Method and the randomized probe
   against the oracle, and one pooling evaluation of their top-50 lists;
   then ``service_phase``: ``SimRankService`` (a copy of the HepPh handle)
   behind ``start_server`` on loopback, driven by
   ``benchmarks/bench_service.py``'s non-quick protocol (256 closed-loop
   clients x 8 top-k queries, 512 walks, micro-batches of 16, admission
   bound 192), with 0 unhandled errors, 16 pinned answers bitwise equal
   to a direct session's solo replays, one ``POST /update`` seen by the
   next answer's version and one adaptive request past its deadline
   answered 200; then the launcher (``repro_torch.launch.serve.main``) at
   its defaults, plain and with ``--epochs``; then ``shard_phase``: the
   sharded backend on the same graph, S row blocks all on ``cuda:0``
   (``ShardMesh(["cuda:0"] * S)``), every level through lane_probe: the 16
   top-k queries drained in batches of 8 at 1 and 4 spmd blocks (bitwise
   equal to the local kernel serve) and 4 ring blocks (1e-5), a warm drain
   building no chunk plan; at 4 spmd blocks also the kernel off (1e-5), the
   bf16 exchange (1e-3), one profiled batch, lane_probe at the per-shard
   shape against its plain version, an adaptive spec (bitwise against the
   local one) and ``update()``; ``SimRankService(backend="sharded")`` over
   HTTP and the launcher with ``--backend sharded``; then 16 mixed epochs
   at 4 blocks (phase 5's ops) whose applied masks equal a host replay and
   whose blocks equal ``build_shard_epoch_graph`` over the host state, and
   one overflow of the hub row regrown; then ``production_phase``: the
   paper's production serve step (the ``probesim`` arch family, through
   ``arch.build_with_cfg``) on its Twitter config cut to 1/32 (the cut and
   its reason at ``PROD_CUT``), serve_batch and serve_online at 1 and 4
   blocks and on the ring in fp32 and bf16, the walks bitwise equal to the
   CPU sampler's, the estimates within 1e-5 of each query's largest score
   of the plain local probe on the same walks, with ms per step, peak memory and one profiled step;
5. dynamic graphs on the HepPh stand-in.  The correctness stream
   (capacity 2m, k_max = max in-degree + 128): 16 fused epochs
   (``SimRankSession.epoch``) of 64 edge ops (32 deletes of live edges, 32
   inserts; hub-row ops and a short row taken past CHUNK_SLOTS) and 8
   top-k queries each.  After epochs 1, 8 and 16 both mirrors must equal a
   rebuild from a host edge list that took the same ops, bit for bit, and
   the epoch's top-k the rebuild's serve under the same seeds (at epoch 16
   also with the kernel off); every applied mask equals the host replay's
   and each changed batch builds one chunk plan, an unchanged one none.
   The apply alone is timed on insert-only and mixed batches, and 200
   inserts past the hub row's room force one regrow, after which the
   mirrors and a serve, kernel on and off, are held against a rebuild
   again.  Then the timed cell, on ``benchmarks/bench_dynamic.py``'s
   traffic (insert-only batches of 128 random edges, 4 top-k queries an
   epoch): the apply alone, update-only epochs (update->queryable), fused
   epochs and query-only epochs, its end state held against a rebuild;
   then ``stream_phase``: ``StreamDriver`` at HepPh's node count on the
   four scenarios of ``benchmarks/bench_stream.py``'s full config (steady,
   turnover, bursty through ``ServiceTransport``, pooled checkpoints), the
   rate scaled with n and the other changes listed at ``STREAM_N``; each
   run applies every op, ends without sticky overflow and with mirrors
   bitwise equal to a rebuild of its live window;
6. the LM path at Llama-3.2-1B's full width (random bf16 weights from a
   seeded generator) through ``repro_torch.arch``: a 32,768-token prefill
   (``prefill_32k``, batch cut from 32 to 1) and 16 greedy decode steps over
   an 8 x 32,768 cache (``decode_32k``, batch cut from 128 to 8), with the
   launch counters read around that window (all 16 prefill launches on the
   tensor-core route); then kernel-off prefill and 64
   teacher-forced decode steps against the kernel-on forward must agree;
   then ``moe_phase``: Qwen1.5-MoE-A2.7B (GQA, 60 experts top-4) and
   DeepSeek-V2-Lite (MLA, 64 experts top-6, one dense layer first) at full
   width and depth (random bf16 weights), through ``arch.build_with_cfg``:
   flash_attention at Qwen's prefill shape against its plain version; per
   config a 32,768-token prefill window (Qwen: 24 flash launches, all on
   the tensor cores; DeepSeek: the plain ``sdpa`` with use_kernel=False,
   since the kernel takes one head width and ``use_kernel=True`` raises
   there, checked), the parameter count against ``params_dense`` plus the
   norms, a profiled second prefill bitwise equal to the first (no atomics
   in the combine) with the dropped assignments counted, the prefill under
   the op counter, Qwen's kernel on against off in fp32 compute (and the
   bf16 gap printed), 16 greedy decode steps over the 32,768 cache at the
   largest batch up to 8 that fits (``decode_batch``), a profiled decode
   step, and 32 teacher-forced decode steps against the forward on a copy
   whose capacity factor drops nothing, in fp32 compute (the bf16 gap
   printed: see ``MOE_TF_STEPS``);
7. the roofline (``roofline_phase``): the dry-run's records
   (``repro_torch.launch.dryrun`` on ``meta``: the probesim config uncut
   at 256 and 512 blocks, the ring at 256, the three dense LMs and the two
   MoE configs at prefill_32k and decode_32k), counted in niced processes on the host
   from the start, each with its three terms and memory per block; the
   op counter (``repro_torch.roofline``) on the card around the
   production cut's steps (each also counted on ``meta``: equal FLOPs,
   bytes and collective bytes), a HepPh drain of 8 and tree query, and
   the Llama, Qwen and DeepSeek prefills, each run's least time at most 105 % of its
   measured time; the kernel bounds at their known values (lane_probe
   142.4 MB, spmm_ell 18.56 MB).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FP32_RTOL = 1e-5  # kernel vs plain in fp32: only the summation order differs
BF16_RTOL = 1e-3  # bf16 storage: ... or one bf16 step, see bf16_close
SLICE_ROWS = 4096
# the LM path's attention shape: Llama-3.2-1B prefill of 32,768 tokens
# (B, S = T, H, Hkv, dh)
FLASH_SHAPE = (1, 32768, 32, 8, 64)
# LM logits in bf16 compute, kernel-on against kernel-off and decode against
# forward: both sides round every activation to bf16 over 16 layers, in
# different orders (flash vs chunked softmax, one query vs all).  Held at
# 3e-2 of the logits' scale (the CPU port-vs-reference bf16 check at 2
# layers measures 0.0078 at scale 1).
LM_TOL = 3e-2


def log(*args) -> None:
    print(*args, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


class SmokeFailure(RuntimeError):
    pass


def require(cond, what) -> None:
    """A check of the run (kept under ``python -O``, unlike ``assert``)."""
    if not cond:
        raise SmokeFailure(str(what))


def fp32_err(out, ref) -> float:
    """max |out - ref|, required <= FP32_RTOL * max(1, max |ref|)."""
    err = float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0
    scale = max(1.0, float(ref.float().abs().max()) if ref.numel() else 0.0)
    require(err <= FP32_RTOL * scale, f"fp32 mismatch {err} (scale {scale})")
    return err


def bf16_close(out, ref) -> float:
    """bf16 outputs: each element within BF16_RTOL * max(1, max|ref|) or one
    bf16 step of ref (kernel and plain version round differently ordered fp32
    sums to bf16).  Returns max |out - ref|."""
    import torch

    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    scale = max(1.0, float(r.abs().max()) if r.numel() else 0.0)
    step = torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=1e-30))) - 7)
    bad = (diff > BF16_RTOL * scale) & (diff > step)
    require(not bool(bad.any()), f"bf16 mismatch {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def tc_close(out, ref, pv_abs) -> tuple[float, bool]:
    """flash_attention's tensor-core route against ``attention_ref(probs_dtype=
    torch.bfloat16)``.  Both round p to bf16, at different points: the kernel
    rounds exp(s - m_tile) before the rescale, the plain version the
    normalised probability.  So where ``bf16_close`` fails, this one
    comparison is widened by exactly one term per element: 2^-8 * sum_j p_j
    |v_j| (``pv_abs``, the plain version's attention over |v|), the most that
    two roundings of each p_j to bf16 can move it.  Returns max |out - ref|
    and whether the widening was needed."""
    try:
        return bf16_close(out, ref), False
    except SmokeFailure:
        pass
    import torch

    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    scale = max(1.0, float(r.abs().max()))
    step = torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=1e-30))) - 7)
    allowed = torch.maximum(step, torch.full_like(step, BF16_RTOL * scale))
    bad = diff > allowed + pv_abs.float() * 2.0**-8
    require(not bool(bad.any()), f"tensor-core flash mismatch {float(diff.max())} "
            "beyond bf16_close widened by 2^-8 sum_j p_j |v_j|")
    return float(diff.max()), True


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, warmed).  A spin kernel holds the stream while the host queues
    the calls, so a kernel faster than its wrapper's host work is timed on
    the device and not at the host's enqueue rate; the spin is lengthened
    until it outlasts the enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    for _ in range(6):
        events[0].record()
        torch.cuda._sleep(cycles)
        events[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        events[2].record()
        torch.cuda.synchronize()
        if events[0].elapsed_time(events[1]) > host_ms:
            break
        cycles *= 4
    return events[1].elapsed_time(events[2]) / reps


def hw() -> dict:
    """The H100's published peaks (``repro_torch.launch.mesh.HW``)."""
    from repro_torch.launch.mesh import HW

    return HW


def bound_ms(work) -> tuple[float, str]:
    """The least time of ``work`` (a ``repro_torch.roofline.analysis.Work``)
    on the card in ms, and what bounds it ("bytes" or "operations")."""
    t, by = work.bound_s(hw())
    return t * 1e3, by


def byte_bound_ms(nbytes: float) -> float:
    """``nbytes`` over the card's HBM bandwidth, in ms."""
    return nbytes / hw()["hbm_bw"] * 1e3


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def lane_inputs(gen, nbrs, table_rows, w, *, dtype, n_live, row0=0):
    """One random lane-probe level over the rows of ``nbrs``: some finished
    columns, injections and exclusions inside the rows, some sentinels."""
    import torch

    dev = nbrs.device
    r = nbrs.shape[0]

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ids(lo, hi):
        x = torch.randint(lo, hi, (w,), generator=gen, device=dev)
        return torch.where(rand(w) < 0.5, x, torch.full_like(x, n_live)).int()

    return dict(
        nbrs=nbrs,
        weights=rand(r),
        table=rand(table_rows, w).to(dtype),
        dep=rand(r, w).to(dtype),
        total=rand(r, w).to(dtype),
        fin=rand(w) < 0.4,
        u_p=ids(row0, row0 + r),
        u_prev=ids(row0, row0 + r),
        thr=rand(w) * 0.3,
    )


def full_len(nbrs):
    """row_len reading every slot (for random tables with sentinels anywhere)."""
    import torch

    return torch.full((nbrs.shape[0],), nbrs.shape[1], dtype=torch.int32,
                      device=nbrs.device)


def live_first(gen, dev, n, k, lens):
    """An [n, k] ELL table whose row v holds lens[v] random live ids first."""
    import torch

    deg = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    ids = torch.randint(0, n, (n, k), generator=gen, device=dev).int()
    keep = torch.arange(k, device=dev)[None, :] < deg[:, None]
    return torch.where(keep, ids, torch.full_like(ids, n)), deg


def check_lane(args, *, row_len=None, row0=0, tab0=0, n_live, prune):
    import torch

    from repro_torch.kernels.lane_probe.ops import lane_probe_level
    from repro_torch.kernels.lane_probe.ref import lane_probe_level_ref

    row_len = full_len(args["nbrs"]) if row_len is None else row_len
    kw = dict(row0=row0, tab0=tab0, n_live=n_live, prune=prune, row_len=row_len)
    out, tot = lane_probe_level(**args, **kw)
    ref_out, ref_tot = lane_probe_level_ref(**args, **kw)
    cmp = fp32_err if args["table"].dtype == torch.float32 else bf16_close
    return max(cmp(out, ref_out), cmp(tot, ref_tot)), out


@contextlib.contextmanager
def chunk_slots(c: int):
    """Plans of ``c``-slot chunks inside the block."""
    from repro_torch.kernels import ell_plan

    old, ell_plan.CHUNK_SLOTS = ell_plan.CHUNK_SLOTS, c
    try:
        yield
    finally:
        ell_plan.CHUNK_SLOTS = old


def small_lane_cases(gen, dev) -> None:
    import torch

    from repro_torch.kernels.ell_plan import CHUNK_SLOTS

    for dtype in (torch.float32, torch.bfloat16):
        for n, w in ((50, 24), (30, 37), (130, 24), (7, 300)):
            nbrs = torch.randint(0, n + 1, (n, 6), generator=gen, device=dev).int()
            for prune in (False, True):
                check_lane(lane_inputs(gen, nbrs, n + 1, w, dtype=dtype, n_live=n),
                           n_live=n, prune=prune)
        n, w = 30, 12
        nbrs = torch.randint(0, n + 1, (n, 6), generator=gen, device=dev).int()
        # all lanes dead: every column finished, no injection
        a = lane_inputs(gen, nbrs, n + 1, w, dtype=dtype, n_live=n)
        a["fin"] = torch.ones(w, dtype=torch.bool, device=dev)
        a["u_p"] = torch.full((w,), n, dtype=torch.int32, device=dev)
        _, out = check_lane(a, n_live=n, prune=False)
        require(bool((out == 0).all()), "all-dead level pushed mass")
        # a single active column among finished ones
        a = lane_inputs(gen, nbrs, n + 1, w, dtype=dtype, n_live=n)
        a["fin"] = torch.ones(w, dtype=torch.bool, device=dev)
        a["fin"][4] = False
        check_lane(a, n_live=n, prune=True)
        # sentinel u_p / u_prev everywhere, and a row of nothing but sentinels
        a = lane_inputs(gen, nbrs.clone(), n + 1, w, dtype=dtype, n_live=n)
        a["nbrs"][7] = n
        a["u_p"] = torch.full((w,), n, dtype=torch.int32, device=dev)
        a["u_prev"] = torch.full((w,), n, dtype=torch.int32, device=dev)
        _, out = check_lane(a, n_live=n, prune=False)
        require(bool((out[7] == 0).all()), "sentinel row pushed mass")
        # offset addressing: spmd (tab0 = row0) and ring (tab0 = 0) layouts
        nb = torch.randint(0, 121, (40, 6), generator=gen, device=dev).int()
        check_lane(lane_inputs(gen, nb, 120, 16, dtype=dtype, n_live=120, row0=40),
                   row0=40, tab0=40, n_live=120, prune=True)
        check_lane(lane_inputs(gen, nb, 40, 16, dtype=dtype, n_live=120, row0=80),
                   row0=80, tab0=0, n_live=120, prune=False)
        # live slots first: empty rows, rows of C and C + 1 slots, a hub row
        # over several pieces, a cut extent, small chunks; W of 1 to 257
        n, k, c = 1500, 1400, CHUNK_SLOTS
        lens = torch.randint(0, 6, (n,), generator=gen, device=dev).tolist()
        lens[3] = lens[9] = 0
        lens[10], lens[11], lens[700], lens[701] = c, c + 1, k, 2 * c + 3
        nbrs, deg = live_first(gen, dev, n, k, lens)
        for w in (1, 63, 64, 256, 257):
            a = lane_inputs(gen, nbrs, n + 1, w, dtype=dtype, n_live=n)
            check_lane(a, row_len=deg, n_live=n, prune=True)
            check_lane(a, row_len=deg // 2, n_live=n, prune=False)
            with chunk_slots(64):
                check_lane(a, row_len=deg, n_live=n, prune=True)


def small_spmm_cases(gen, dev) -> None:
    import torch

    from repro_torch.kernels.ell_plan import CHUNK_SLOTS
    from repro_torch.kernels.spmm_ell.ops import spmm_ell, spmm_ell_padded
    from repro_torch.kernels.spmm_ell.ref import spmm_ell_padded_ref, spmm_ell_ref

    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        cmp = fp32_err if dtype == torch.float32 else bf16_close
        for n, k, b in ((128, 4, 8), (100, 3, 8), (384, 16, 32), (33, 7, 300)):
            nbrs = torch.randint(0, n + 1, (n, k), generator=gen, device=dev).int()
            scores = torch.randn((n, b), generator=gen, device=dev).to(dtype)
            w = torch.rand(n, generator=gen, device=dev) + 0.1
            full = full_len(nbrs)
            cmp(spmm_ell(nbrs, scores, w, row_len=full),
                spmm_ell_ref(nbrs, scores, w, row_len=full))
        vec = torch.randn(n, generator=gen, device=dev).to(dtype)
        cmp(spmm_ell(nbrs, vec, w, row_len=full),
            spmm_ell_ref(nbrs, vec, w, row_len=full))
        n, k, c = 1500, 1400, CHUNK_SLOTS
        lens = torch.randint(0, 6, (n,), generator=gen, device=dev).tolist()
        lens[3] = lens[9] = 0
        lens[10], lens[11], lens[700], lens[701] = c, c + 1, k, 2 * c + 3
        nbrs, deg = live_first(gen, dev, n, k, lens)
        w = torch.rand(n, generator=gen, device=dev) + 0.1
        for b in (1, 63, 64, 257):
            scores = torch.randn((n + 1, b), generator=gen, device=dev).to(dtype)
            scores[n] = 0
            for lens_, c in ((deg, CHUNK_SLOTS), (deg // 3, CHUNK_SLOTS),
                             (deg, 64)):
                with chunk_slots(c):
                    cmp(spmm_ell_padded(nbrs, scores, w, row_len=lens_),
                        spmm_ell_padded_ref(nbrs, scores, w, row_len=lens_))


def lane_bound(nbrs, row_len, n_live, w, fin, *, tot_inplace=False):
    """One lane_probe level's least work with this run's data
    (``repro_torch.roofline.analysis.lane_probe_work``).  Returns
    (bound_ms, by, bytes)."""
    from repro_torch.roofline.analysis import lane_probe_work

    work = lane_probe_work(nbrs, row_len, n_live, w, fin, tot_inplace=tot_inplace)
    return (*bound_ms(work), work.bytes)


def spmm_bound(nbrs, row_len, n, b, *, push=False):
    """One spmm_ell (``push``: probe_push) call's least work with this run's
    data (``repro_torch.roofline.analysis.spmm_work``).  Returns (bound_ms,
    by, bytes)."""
    from repro_torch.roofline.analysis import spmm_work

    work = spmm_work(nbrs, row_len, n, b, push=push)
    return (*bound_ms(work), work.bytes)


def kernel_phase(h, params, gen) -> dict:
    """The live-prefix check, the chunk plan, slice and full-shape
    comparisons plus timings; returns the kernel rows."""
    import torch

    from repro_torch.graph import check_live_prefix
    from repro_torch.kernels.ell_plan import clear_plans, plan_of
    from repro_torch.kernels.lane_probe.ops import lane_probe_level
    from repro_torch.kernels.lane_probe.ref import lane_probe_level_ref
    from repro_torch.kernels.spmm_ell.ops import spmm_ell_padded
    from repro_torch.kernels.spmm_ell.ref import spmm_ell_padded_ref

    eg = h.eg
    n, k = eg.n, eg.k_max
    w_lanes = 256
    deg = eg.in_deg
    hub = int(torch.argmax(deg))
    s0 = max(0, min(hub - SLICE_ROWS // 2, n - SLICE_ROWS))
    rows = eg.in_nbrs[s0 : s0 + SLICE_ROWS]
    live_slots = int((eg.in_nbrs < n).sum())
    log(f"hepph ELL: n={n} K={k} live slots={live_slots} "
        f"({eg.in_nbrs.numel() * 4 / 1e9:.3f} GB int32); slice rows "
        f"[{s0}, {s0 + SLICE_ROWS}) holds the hub row {hub} "
        f"(in-degree {int(deg[hub])})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check_live_prefix(eg.in_nbrs, deg, n)
    log(f"live-prefix rule holds on the hepph table (nbrs[v, k] < n exactly "
        f"when k < in_deg[v]): checked on the card in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    clear_plans()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = plan_of(deg, k)  # the plan the wrappers find for row_len = deg
    torch.cuda.synchronize()
    log(f"chunk plan of the {n} rows: {plan.n_chunks} chunks ({plan.n_pieces} "
        f"pieces of {plan.n_long} long rows, {plan.n_chunks - plan.n_pieces} "
        f"packed), chunk_slots={plan.chunk_slots}, at most {plan.max_slots} "
        f"ids / {plan.max_rows} rows a chunk; built in "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

    # --- lane_probe: slice with row0 = tab0 = slice start, fp32 and bf16,
    # the main path's push weights (sqrt(c) / in-degree) ---------------------
    w_push = eg.inv_in_deg * params.sqrt_c
    w_rows = w_push[s0 : s0 + SLICE_ROWS].contiguous()
    d_rows = deg[s0 : s0 + SLICE_ROWS]
    for dtype in (torch.float32, torch.bfloat16):
        for prune in (False, True):
            a = lane_inputs(gen, rows, n + 1, w_lanes, dtype=dtype, n_live=n,
                            row0=s0)
            a["weights"] = w_rows
            err, _ = check_lane(a, row_len=d_rows, row0=s0, tab0=s0, n_live=n,
                                prune=prune)
            log(f"lane_probe slice {dtype} prune={prune}: max_abs_err={err:.3e}")
    # where a level's time goes: the slice holding the hub row vs one without
    s1 = (s0 + n // 2) % (n - SLICE_ROWS)
    if s1 <= hub < s1 + SLICE_ROWS:
        s1 = (s1 + SLICE_ROWS) % (n - SLICE_ROWS)
    slice_ms = {}
    for name, lo in (("with the hub row", s0), ("without it", s1)):
        a = lane_inputs(gen, eg.in_nbrs[lo : lo + SLICE_ROWS], n + 1, w_lanes,
                        dtype=torch.float32, n_live=n, row0=lo)
        a["weights"] = w_push[lo : lo + SLICE_ROWS].contiguous()
        lens = deg[lo : lo + SLICE_ROWS]
        sp = plan_of(lens, k)
        ms = time_ms(lambda: lane_probe_level(**a, row_len=lens, row0=lo,
                                              tab0=lo, n_live=n, prune=True), 20)
        slice_ms[name] = ms
        live = int((a["nbrs"] < n).sum())
        new_b, _, _ = lane_bound(a["nbrs"], lens, n, w_lanes, a["fin"])
        log(f"lane_probe {SLICE_ROWS}-row slice [{lo}, {lo + SLICE_ROWS}) "
            f"{name}: {ms:.4f} ms, {live} live slots in {sp.n_chunks} chunks, "
            f"live-slot bound {new_b:.4f} ms, full-scan bound "
            f"{byte_bound_ms(SLICE_ROWS * k * 4):.4f} ms")
    log(f"lane_probe hub slice / no-hub slice: "
        f"{slice_ms['with the hub row'] / slice_ms['without it']:.2f}x")

    # --- lane_probe at the main path's shape: R = n, T = n + 1, W = 256 ---
    full = lane_inputs(gen, eg.in_nbrs, n + 1, w_lanes, dtype=torch.float32,
                       n_live=n)
    full["weights"] = w_push
    kw = dict(row0=0, tab0=0, n_live=n, prune=True, row_len=deg)
    lane_ms = time_ms(lambda: lane_probe_level(**full, **kw), 20)
    out, tot = lane_probe_level(**full, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_out, ref_tot = lane_probe_level_ref(**full, **kw)
    torch.cuda.synchronize()
    lane_plain_ms = (time.perf_counter() - t0) * 1e3
    lane_err = max(fp32_err(out, ref_out), fp32_err(tot, ref_tot))
    again = lane_probe_level(**full, **kw)
    require(torch.equal(again[0], out) and torch.equal(again[1], tot),
            "lane_probe: two runs on the same inputs differ in their bits")
    # the serve path's form: tot written into total in place, out into a
    # second buffer
    total = full["total"].clone()
    buf = torch.empty_like(full["dep"])
    inplace_ms = time_ms(lambda: lane_probe_level(
        **dict(full, total=total), **kw, out=buf, tot=total), 20)
    lane_bound_ms, lane_by, lane_bytes = lane_bound(eg.in_nbrs, deg, n, w_lanes,
                                                    full["fin"])
    ip_bound, _, _ = lane_bound(eg.in_nbrs, deg, n, w_lanes, full["fin"],
                                tot_inplace=True)
    old_bytes = (n * k * 4 + n * 4 + (n + 1) * w_lanes * 4 + 4 * n * w_lanes * 4
                 + 4 * w_lanes * 4)
    log(f"lane_probe full [{n}x{k}] W={w_lanes} fin={float(full['fin'].float().mean()):.2f}: "
        f"max_abs_err={lane_err:.3e} kernel {lane_ms:.4f} ms (in place "
        f"{inplace_ms:.4f} ms, its bound {ip_bound:.4f} ms), plain "
        f"{lane_plain_ms:.1f} ms, live-slot bound {lane_bound_ms:.4f} ms "
        f"({lane_by}, {lane_bytes / 1e6:.1f} MB), full-scan bound "
        f"{byte_bound_ms(old_bytes):.4f} ms; bits equal on a second run")

    # --- spmm_ell: slice at B = 64, then the full table ---------------------
    b = 64
    scores = torch.rand((n + 1, b), generator=gen, device=eg.device)
    scores[n] = 0.0
    out = spmm_ell_padded(rows, scores, w_rows, row_len=d_rows)
    ref = spmm_ell_padded_ref(rows, scores, w_rows, row_len=d_rows)
    log(f"spmm_ell slice fp32 B={b}: max_abs_err={fp32_err(out, ref):.3e}")
    sb = scores.to(torch.bfloat16)
    out = spmm_ell_padded(rows, sb, w_rows, row_len=d_rows)
    ref = spmm_ell_padded_ref(rows, sb, w_rows, row_len=d_rows)
    log(f"spmm_ell slice bf16 B={b}: max_abs_err={bf16_close(out, ref):.3e}")

    def spmm():
        return spmm_ell_padded(eg.in_nbrs, scores, w_push, row_len=deg)

    spmm_ms = time_ms(spmm, 20)
    out = spmm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = spmm_ell_padded_ref(eg.in_nbrs, scores, w_push, row_len=deg)
    torch.cuda.synchronize()
    spmm_plain_ms = (time.perf_counter() - t0) * 1e3
    spmm_err = fp32_err(out, ref)
    require(torch.equal(spmm(), out),
            "spmm_ell: two runs on the same inputs differ in their bits")
    # library yardstick: one CSR sparse-dense product on the same operands
    live = eg.in_nbrs < n
    crow = torch.zeros(n + 1, dtype=torch.int64, device=eg.device)
    crow[1:] = torch.cumsum(live.sum(dim=1), 0)
    colx = eg.in_nbrs[live].long()
    vals = w_push[:, None].expand(n, k)[live]
    csr = torch.sparse_csr_tensor(crow, colx, vals, size=(n, n + 1))
    del live
    fp32_err(torch.sparse.mm(csr, scores), out)
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, scores), 20)
    spmm_bound_ms, spmm_by, spmm_bytes = spmm_bound(eg.in_nbrs, deg, n, b)
    old_bytes = n * k * 4 + (n + 1) * b * 4 + n * 4 + n * b * 4
    log(f"spmm_ell full [{n}x{k}] B={b}: max_abs_err={spmm_err:.3e} "
        f"kernel {spmm_ms:.4f} ms, plain {spmm_plain_ms:.1f} ms, "
        f"torch.sparse.mm {lib_ms:.4f} ms, live-slot bound {spmm_bound_ms:.4f} ms "
        f"({spmm_by}, {spmm_bytes / 1e6:.2f} MB), full-scan bound "
        f"{byte_bound_ms(old_bytes):.4f} ms; bits equal on a second run")
    del csr, full, scores, sb, out, ref, ref_out, ref_tot, tot, total, buf
    torch.cuda.empty_cache()
    return {
        "lane_probe": dict(
            name="lane_probe", route="cuda",
            source="src/repro_torch/kernels/csrc/lane_probe.cu",
            replaces="src/repro/kernels/lane_probe/lane_probe.py:57",
            max_abs_err=lane_err, ms=lane_ms, plain_ms=lane_plain_ms,
            bound_ms=lane_bound_ms, bound_by=lane_by, library_ms=None,
            bound_mb=lane_bytes / 1e6,
        ),
        "spmm_ell": dict(
            name="spmm_ell", route="cuda",
            source="src/repro_torch/kernels/csrc/spmm_ell.cu",
            replaces="src/repro/kernels/spmm_ell/spmm_ell.py:31",
            max_abs_err=spmm_err, ms=spmm_ms, plain_ms=spmm_plain_ms,
            bound_ms=spmm_bound_ms, bound_by=spmm_by, library_ms=lib_ms,
            bound_mb=spmm_bytes / 1e6,
        ),
    }


def plain_ms(fn):
    """Host time of one call of a plain version (synchronized), and its result."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def small_probe_push_cases(gen, dev) -> None:
    """probe_push against its plain version: awkward n and B, thresholds,
    exclusions of n (none) and in range, rows of sentinels, ids past n on
    random tables read in full; then live-first tables (empty rows, rows of
    C and C + 1 slots, a hub row over several chunks) read up to their
    in-degree, at two chunk sizes, with a split row excluded.  Excluded
    entries must be exactly zero, and a second launch must give the same
    bits."""
    import torch

    from repro_torch.kernels.ell_plan import CHUNK_SLOTS
    from repro_torch.kernels.probe_push.ops import probe_push
    from repro_torch.kernels.probe_push.ref import probe_push_ref

    def check(nbrs, scores, w, excl, thr, row_len, cmp):
        out = probe_push(nbrs, scores, w, excl, prune_thresh=thr, row_len=row_len)
        cmp(out, probe_push_ref(nbrs, scores, w, excl, thr, row_len=row_len))
        cols = torch.nonzero(excl < nbrs.shape[0]).flatten()
        require(bool((out[excl[cols].long().clamp(min=0), cols] == 0).all()),
                "excluded row kept mass")
        require(torch.equal(out, probe_push(nbrs, scores, w, excl, prune_thresh=thr,
                                            row_len=row_len)),
                "probe_push: two runs on the same inputs differ in their bits")
        return out

    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        cmp = fp32_err if dtype == torch.float32 else bf16_close
        for n, k, b in ((128, 4, 8), (100, 3, 8), (33, 700, 300), (7, 5, 1),
                        (1000, 16, 37)):
            nbrs = torch.randint(0, n + 1, (n, k), generator=gen, device=dev).int()
            nbrs[n // 2] = n  # a row of nothing but sentinels
            nbrs[0, 0] = n + 5  # an id past the sentinel reads the zero row
            scores = torch.rand((n, b), generator=gen, device=dev).to(dtype)
            w = torch.rand(n, generator=gen, device=dev) + 0.1
            excl = torch.randint(0, n + 1, (b,), generator=gen, device=dev).int()
            excl[0] = n  # excludes nothing
            for thr in (0.0, 0.3, 2.0):  # 2.0 is above every score
                out = check(nbrs, scores, w, excl, thr, full_len(nbrs), cmp)
                require(bool((out[n // 2] == 0).all()), "sentinel row pushed mass")
                if thr == 2.0:
                    require(bool((out == 0).all()), "threshold above all kept mass")
        all_sent = torch.full((50, 4), 50, dtype=torch.int32, device=dev)
        s = torch.rand((50, 9), generator=gen, device=dev).to(dtype)
        out = probe_push(all_sent, s, torch.ones(50, device=dev),
                         torch.full((9,), 50, dtype=torch.int32, device=dev),
                         row_len=full_len(all_sent))
        require(bool((out == 0).all()), "all-sentinel table pushed mass")
        # live slots first: rows of 0, C, C + 1, K and 2C + 3 slots
        n, k, c = 1500, 1400, CHUNK_SLOTS
        lens = torch.randint(0, 6, (n,), generator=gen, device=dev).tolist()
        lens[3] = lens[9] = 0
        lens[10], lens[11], lens[700], lens[701] = c, c + 1, k, 2 * c + 3
        nbrs, deg = live_first(gen, dev, n, k, lens)
        w = torch.rand(n, generator=gen, device=dev) + 0.1
        for b in (1, 63, 64, 257):
            scores = torch.rand((n, b), generator=gen, device=dev).to(dtype)
            excl = torch.randint(-2, n + 3, (b,), generator=gen, device=dev).int()
            excl[-1] = 701  # split rows excluded: the 2C + 3 row
            excl[0] = 700  # and the hub row
            for lens_, cs, thr in ((deg, CHUNK_SLOTS, 0.3),
                                   (deg // 3, CHUNK_SLOTS, 0.0), (deg, 64, 0.5)):
                with chunk_slots(cs):
                    check(nbrs, scores, w, excl, thr, lens_, cmp)


def flash_inputs(gen, dev, B, S, T, H, Hkv, dh, dtype):
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return rn(B, S, H, dh), rn(B, T, Hkv, dh), rn(B, T, Hkv, dh)


def check_flash(q, k, v, causal) -> tuple[float, bool]:
    """One flash_attention call against its route's plain version, with the
    counter of that route required to move; returns the difference and
    whether ``tc_close`` needed its widening."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention, route
    from repro_torch.kernels.flash_attention.ref import attention_ref

    tensor_core = route(q.dtype, q.shape[-1]) == "tensor_core"
    before, tc_before = flash_attention.launches, flash_attention.tc_launches
    out = flash_attention(q, k, v, causal=causal)
    require(flash_attention.launches == before + 1
            and flash_attention.tc_launches == tc_before + int(tensor_core),
            f"flash {q.dtype} dh={q.shape[-1]} took the wrong route")
    require(out.dtype == q.dtype and out.shape == q.shape, "flash output")
    if not tensor_core:
        cmp = fp32_err if q.dtype == torch.float32 else bf16_close
        return cmp(out, attention_ref(q, k, v, causal=causal)), False
    ref = attention_ref(q, k, v, causal=causal, probs_dtype=torch.bfloat16)
    return tc_close(out, ref, attention_ref(q, k, v.abs(), causal=causal))


def small_flash_cases(gen, dev) -> int:
    """flash_attention against its plain version on both routes: MHA, GQA,
    MQA; S and T off the 64- and 128-row tiles; causal and not; fp32 and
    bf16; head widths 8 to 128 (bf16 with dh % 8 != 0 stays on the CUDA
    cores).  Returns the number of tensor-core cases that needed tc_close's
    widening."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention

    cases = (  # B, S, T, H, Hkv, dh, causal
        (1, 128, 128, 2, 2, 16, True),     # MHA, one tile
        (2, 200, 200, 8, 2, 64, True),     # GQA, S off the tile, B = 2
        (1, 70, 70, 4, 1, 128, True),      # MQA, dh 128
        (2, 33, 150, 4, 4, 100, False),    # S != T, dh % 8 != 0 (CUDA cores)
        (1, 1, 1, 32, 8, 64, True),        # one token
        (2, 1000, 1000, 32, 8, 64, True),  # Llama-3.2-1B heads
        (1, 300, 300, 8, 8, 128, False),
        (2, 300, 300, 4, 4, 72, True),     # dh 72: two boxes, padded to 128
        (1, 130, 257, 8, 1, 64, False),    # S != T, MQA, both off the tile
        (1, 515, 515, 4, 2, 16, True),     # dh 16 padded to 64, ragged tile
        (2, 129, 129, 6, 3, 8, True),      # dh 8, one row past the tile
        (1, 384, 384, 8, 2, 128, True),    # three full tiles of dh 128
        (1, 77, 77, 2, 2, 20, True),       # bf16 dh % 8 != 0: CUDA cores
    )
    widened = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, T, H, Hkv, dh, causal in cases:
            q, k, v = flash_inputs(gen, dev, B, S, T, H, Hkv, dh, dtype)
            widened += check_flash(q, k, v, causal)[1]
    # the tensor-core route gives the same bits on every run
    q, k, v = flash_inputs(gen, dev, 2, 700, 700, 8, 2, 64, torch.bfloat16)
    require(torch.equal(flash_attention(q, k, v, causal=True),
                        flash_attention(q, k, v, causal=True)),
            "tensor-core flash is not bit-for-bit repeatable")
    return widened


def probe_push_phase(h, params, gen) -> dict:
    """probe_push on the HepPh ELL table at B = 64, read up to the rows'
    in-degree (a threshold, exclusions inside the table, one on the hub
    row, and of n): kernel against plain version, timings, bounds."""
    import torch

    from repro_torch.kernels.probe_push.ops import probe_push
    from repro_torch.kernels.probe_push.ref import probe_push_ref

    eg = h.eg
    n, k, b = eg.n, eg.k_max, 64
    dev = eg.device
    deg = eg.in_deg
    scores = torch.rand((n, b), generator=gen, device=dev)
    w = (eg.inv_in_deg * params.sqrt_c).contiguous()
    excl = torch.randint(0, n + 1, (b,), generator=gen, device=dev).int()
    excl[: b // 4] = n
    excl[-1] = int(torch.argmax(deg))
    thr = 0.05

    def push(s):
        return probe_push(eg.in_nbrs, s, w, excl, prune_thresh=thr, row_len=deg)

    ms = time_ms(lambda: push(scores), 20)
    out = push(scores)
    p_ms, ref = plain_ms(lambda: probe_push_ref(eg.in_nbrs, scores, w, excl, thr,
                                                row_len=deg))
    err = fp32_err(out, ref)
    require(torch.equal(push(scores), out),
            "probe_push: two runs on the same inputs differ in their bits")
    require(bool(out[excl[-1].long(), -1] == 0), "excluded hub row kept mass")
    bound, by, nbytes = spmm_bound(eg.in_nbrs, deg, n, b, push=True)
    full_bytes = n * k * 4 + n * b * 4 + n * 4 + b * 4 + n * b * 4
    sb = scores.to(torch.bfloat16)
    bf_err = bf16_close(push(sb), probe_push_ref(eg.in_nbrs, sb, w, excl, thr,
                                                 row_len=deg))
    log(f"probe_push full [{n}x{k}] B={b} thr={thr}: max_abs_err={err:.3e} "
        f"(bf16 {bf_err:.3e}), kernel {ms:.4f} ms, plain {p_ms:.1f} ms, "
        f"live-slot bound {bound:.4f} ms ({by}, {nbytes / 1e6:.2f} MB), "
        f"full-scan bound {byte_bound_ms(full_bytes):.4f} ms; bits equal on a "
        "second run; no single PyTorch call computes it")
    return dict(
        name="probe_push", route="cuda",
        source="src/repro_torch/kernels/csrc/probe_push.cu",
        replaces="src/repro/kernels/probe_push/probe_push.py:22",
        max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
        library_ms=None,
    )


def flash_phase(gen, dev) -> dict:
    """flash_attention at the LM prefill shape (B 1, S = T 32,768, 32 heads,
    8 kv heads, dh 64, bf16, causal): kernel against the plain version
    (chunked queries), timings, and the library call as a yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention, route
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.mesh import PEAK_EXP_PER_S
    from repro_torch.roofline.analysis import flash_work

    B, S, H, Hkv, dh = FLASH_SHAPE
    q, k, v = flash_inputs(gen, dev, B, S, S, H, Hkv, dh, torch.bfloat16)
    require(route(q.dtype, dh) == "tensor_core", "the prefill shape left the tensor cores")
    tc_before = flash_attention.tc_launches
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), 3)
    out = flash_attention(q, k, v, causal=True)
    require(flash_attention.tc_launches > tc_before, "no tensor-core launch")
    require(torch.equal(out, flash_attention(q, k, v, causal=True)),
            "tensor-core flash is not bit-for-bit repeatable at the prefill shape")
    # the route's plain version rounds p to bf16 (timed); the fp32-probability
    # one is the function's definition
    p_ms, ref = plain_ms(lambda: attention_ref(q, k, v, causal=True,
                                               probs_dtype=torch.bfloat16))
    err, widened = tc_close(out, ref, attention_ref(q, k, v.abs(), causal=True))
    ref32 = attention_ref(q, k, v, causal=True)
    err32 = float((out.float() - ref32.float()).abs().max())

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    lib_out = library()
    lib_err = float((lib_out.float() - ref32.float()).abs().max())
    lib_vs_kernel = float((lib_out.float() - out.float()).abs().max())
    del lib_out
    lib_ms = time_ms(library, 5)
    pairs = B * H * S * (S + 1) / 2
    bound, by = bound_ms(flash_work(q.shape, k.shape, causal=True, dtype=q.dtype))
    log(f"flash_attention B={B} S=T={S} H={H} Hkv={Hkv} dh={dh} bf16 causal "
        f"(tensor cores): max |diff| vs plain bf16-p {err:.3e}"
        f"{' (tc_close widened)' if widened else ' (bf16_close)'}, vs plain fp32-p "
        f"{err32:.3e}, vs scaled_dot_product_attention {lib_vs_kernel:.3e}; "
        f"kernel {ms:.3f} ms ({pairs * 4 * dh / ms / 1e9:.1f} TFLOP/s), plain "
        f"(chunked, bf16 p) {p_ms:.1f} ms, scaled_dot_product_attention "
        f"{lib_ms:.3f} ms (vs plain fp32-p {lib_err:.3e}), bound {bound:.3f} ms "
        f"({by}); exp bound {pairs / PEAK_EXP_PER_S * 1e3:.3f} ms")
    del q, k, v, out, ref, ref32
    torch.cuda.empty_cache()
    wide_flash(gen, dev)
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:27",
        max_abs_err=err, ms=ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
        library_ms=lib_ms,
    )


def wide_flash(gen, dev) -> None:
    """The tensor-core route at dh 128, the head width of the repo's larger
    LM configs (Yi-34B's 56 heads over 8 kv heads), S = T = 32,768, causal:
    its time beside the library call's, logged only (the small cases hold
    dh 128 against the plain version)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.roofline.analysis import flash_work

    B, S, H, Hkv, dh = 1, 32768, 56, 8, 128
    q, k, v = flash_inputs(gen, dev, B, S, S, H, Hkv, dh, torch.bfloat16)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), 3)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    diff = float((flash_attention(q, k, v, causal=True).float()
                  - library().float()).abs().max())
    lib_ms = time_ms(library, 3)
    work = flash_work(q.shape, k.shape, causal=True, dtype=q.dtype)
    flops = work.flops
    log(f"flash_attention B={B} S=T={S} H={H} Hkv={Hkv} dh={dh} bf16 causal "
        f"(tensor cores): kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
        f"scaled_dot_product_attention {lib_ms:.3f} ms, max |diff| {diff:.3e}, "
        f"bound {bound_ms(work)[0]:.3f} ms ({bound_ms(work)[1]})")
    del q, k, v
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3: the SimRank path at real size
# ---------------------------------------------------------------------------


def topk_agree(env_a, env_b, tol: float) -> float:
    """Top-k scores within ``tol``; ids equal wherever the scores are untied."""
    import numpy as np

    sa, sb = np.asarray(env_a.topk_scores), np.asarray(env_b.topk_scores)
    err = float(np.abs(sa - sb).max())
    require(err <= tol, f"top-k scores differ by {err}")
    gaps = np.abs(np.diff(sa))
    untied = np.ones(len(sa), bool)
    untied[:-1] &= gaps > 2 * tol
    untied[1:] &= gaps > 2 * tol
    require(np.array_equal(np.asarray(env_a.topk_nodes)[untied],
                          np.asarray(env_b.topk_nodes)[untied]), "top-k ids differ")
    return err


def main_path(h, params) -> dict:
    import numpy as np
    import torch

    from repro_torch.api import SimRankSession
    from repro_torch.core import single_source
    from repro_torch.kernels.ell_plan import build_plan, clear_plans
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.lane_probe.ops import lane_probe_level
    from repro_torch.kernels.probe_push.ops import probe_push
    from repro_torch.kernels.spmm_ell.ops import spmm_ell_padded

    deg = h.eg.in_deg.cpu().numpy()
    cand = np.flatnonzero(deg >= 1)
    nodes = np.random.default_rng(0).choice(cand, 16, replace=False).tolist()
    sess = SimRankSession(h, walk_chunk=256, batch_q=8, seed=0)
    n_r = sess.params.n_r

    # the main path, with every launch counter read around it; no plan is
    # kept from the kernel phase, so the drain's builds are its own
    clear_plans()
    for fn in (lane_probe_level, spmm_ell_padded, probe_push, flash_attention,
               build_plan):
        setattr(fn, "builds" if fn is build_plan else "launches", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [sess.submit(u) for u in nodes]
    envs = sess.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    drain_builds = build_plan.builds
    u_tree = nodes[0]
    t0 = time.perf_counter()
    tree = single_source(7, h.eg, h.eg, u_tree, sess.params, variant="tree",
                         walk_chunk=256)
    torch.cuda.synchronize()
    tree_s = time.perf_counter() - t0
    launches = {"lane_probe": lane_probe_level.launches,
                "spmm_ell": spmm_ell_padded.launches,
                "probe_push": probe_push.launches,
                "flash_attention": flash_attention.launches}
    batches = sess.stats.steps
    log(f"main path: {len(envs)} top-k queries in {batches} batches, "
        f"{drain_s:.3f} s ({len(envs) / drain_s:.2f} queries/s, "
        f"{drain_s / batches * 1e3:.1f} ms per drained batch); "
        f"tree single_source {tree_s:.3f} s; launches {launches}; chunk plans "
        f"built: {drain_builds} in the drain, {build_plan.builds} in the window")
    require(launches["lane_probe"] > 0 and launches["spmm_ell"] > 0,
            f"a kernel of the main path never launched: {launches}")
    require(drain_builds <= batches,
            f"{drain_builds} chunk plans built in {batches} drained batches")

    bound = sess.error_bound(n_r)
    for u, t, env in zip(nodes, tickets, envs):
        require(t.envelope is env and env.node == u, f"ticket of node {u}")
        require(env.version == 0 and env.walks_used == n_r,
                f"envelope version/walks {env.version}/{env.walks_used}")
        require(env.error_bound == bound <= sess.params.eps_a + 1e-3,
                f"error bound {env.error_bound}")
        s = np.asarray(env.topk_scores)
        require(s.shape == (50,) and np.isfinite(s).all(), f"top-k scores {s}")
        require((np.diff(s) <= 0).all() and u not in set(env.topk_nodes.tolist()),
                f"top-k of node {u} unsorted or holds u")
    tree = tree.cpu().numpy()
    require(np.isfinite(tree).all() and tree[u_tree] == 1.0, "tree estimate")

    # the same queries served one at a time under the same seeds
    serial = SimRankSession(h, walk_chunk=256, batch_q=1, seed=0, own_graph=False)
    for u in nodes[:2]:
        serial.submit(u)
    serr = max(topk_agree(a, b, 1e-5) for a, b in zip(envs, serial.drain()))
    # the same batch with the kernel off (COO push), same seeds
    off = SimRankSession(h, walk_chunk=256, batch_q=8, seed=0, use_kernel=False,
                         own_graph=False)
    for u in nodes:
        off.submit(u)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off_envs = off.drain()
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    oerr = max(topk_agree(a, b, 1e-5) for a, b in zip(envs, off_envs))
    log(f"drain of {len(nodes)} top-k queries: kernel path {drain_s:.3f} s, "
        f"kernel-off (COO push) {off_s:.3f} s: {off_s / drain_s:.2f}x")
    # tree vs telescoped on one node: two estimates of the same SimRank
    tele = single_source(7, h.g, h.eg, u_tree, sess.params).cpu().numpy()
    terr = float(np.abs(tele - tree).max())
    require(terr <= 2 * bound, f"|tree - telescoped| = {terr}")
    log(f"serial == batched within {serr:.3e}; kernel-off == kernel within "
        f"{oerr:.3e} (kernel-off drain {off_s:.3f} s); |tree - telescoped| "
        f"= {terr:.3e} <= 2 x bound {2 * bound:.4f}")
    del sess, serial, off
    torch.cuda.empty_cache()
    return launches, nodes


def profile(label: str, fn, host_rows: int = 0) -> dict:
    """Device time by kernel over one call of ``fn``, from torch.profiler;
    the busy share is the kernels' summed device time over the call's wall
    time (one stream, so kernels do not overlap).  ``host_rows`` > 0 also
    logs that many ops with the most host time of their own.  Returns each
    kernel name's launch count."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"profiled {label}: wall {wall_ms:.1f} ms (profiler on), "
        f"device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), "
        f"{len(rows)} kernel names")
    for key, ms, count in rows[:6]:
        log(f"  {ms:10.3f} ms  {count:6d} x  {key[:90]}")
    if host_rows:
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)
        log(f"  host time by op ({label}):")
        for e in ops[:host_rows]:
            log(f"  {e.self_cpu_time_total / 1e3:10.3f} ms  {e.count:6d} x  "
                f"{e.key[:90]}")
    return {key: count for key, _, count in rows}


def profile_batch(h, nodes) -> None:
    """One more drained batch of 8 (a new seed) under the profiler."""
    from repro_torch.api import SimRankSession

    sess = SimRankSession(h, walk_chunk=256, batch_q=8, seed=1, own_graph=False)
    for u in nodes[:8]:
        sess.submit(u)
    counts = profile("drain of 8 queries", sess.drain)
    levels = sum(c for k, c in counts.items() if "lane_probe_kernel" in k)
    cats = sum(c for k, c in counts.items() if "CatArray" in k)
    log(f"profiled drain: {levels} lane_probe levels, {cats} torch.cat launches")
    require(cats < levels, f"{cats} torch.cat launches in {levels} levels")


def toy_accuracy(dev) -> None:
    import numpy as np

    from repro_torch.api import GraphHandle, QuerySpec, SimRankSession
    from repro_torch.graph import TOY_TABLE2, toy_graph
    from repro_torch.graph.generators import TOY_NODES
    from repro_torch.kernels.lane_probe.ops import lane_probe_level

    src, dst, n = toy_graph()
    h = GraphHandle.from_edges(src, dst, n, device=dev)
    sess = SimRankSession(h, c=0.25, eps_a=0.1, seed=0)
    before = lane_probe_level.launches
    sess.submit(QuerySpec(kind="single_source", node=0))
    (env,) = sess.drain()
    require(lane_probe_level.launches > before, "toy drain launched no lane_probe")
    bound = env.error_bound
    err = max(abs(float(env.scores[i]) - TOY_TABLE2[ch])
              for i, ch in enumerate(TOY_NODES))
    require(err <= bound, f"toy: max error {err} > bound {bound}")
    require(np.isfinite(env.scores).all(), "toy scores not finite")
    log(f"toy graph (c=0.25): max |estimate - Table 2| = {err:.4f} <= {bound:.4f}")


# ---------------------------------------------------------------------------
# Phase 4b: adaptive accuracy and the oracles at real size
# ---------------------------------------------------------------------------

ACC_EPS = (0.1, 0.05)  # benchmarks/bench_abserror.py's quick epsilon sweep
ACC_Q = 16
ACC_BASELINE_Q = 3  # queries per baseline (benchmarks/bench_abserror.py's N_QUERIES)


def precision_at_10(scores, truth_u, u: int, k: int = 10) -> float:
    """|est top-k ∩ truth top-k| / k with u excluded, k cut to the count of
    positive truths (benchmarks/bench_abserror.py's ``_precision_at_k``)."""
    import numpy as np

    s = np.asarray(scores, np.float64).copy()
    t = np.asarray(truth_u, np.float64).copy()
    s[u] = t[u] = -np.inf
    kk = min(k, int((t > 0).sum()))
    if kk == 0:
        return 1.0
    est = set(np.argsort(-s, kind="stable")[:kk].tolist())
    return len(est & set(np.argsort(-t, kind="stable")[:kk].tolist())) / kk


def max_err(est, truth_u, u: int) -> float:
    """max over v != u of |est[v] - S[u, v]|."""
    import numpy as np

    e = np.abs(np.asarray(est, np.float64) - truth_u)
    e[u] = 0.0
    return float(e.max())


def oracle_checks(dev) -> None:
    """The Power Method on the card against its numpy copy (fp32, 1e-5) on a
    300-node power-law graph, and node a of the toy graph against Table 2."""
    import numpy as np

    from repro_torch.api import GraphHandle
    from repro_torch.core import simrank_power, simrank_power_host
    from repro_torch.graph import TOY_TABLE2, powerlaw_graph, toy_graph
    from repro_torch.graph.generators import TOY_NODES

    src, dst, n = powerlaw_graph(300, 2400, seed=7)
    s = simrank_power(GraphHandle.from_edges(src, dst, n, device=dev).g,
                      c=0.6, iters=55).cpu().numpy()
    err = float(np.abs(s - simrank_power_host(src, dst, n, c=0.6, iters=55)).max())
    require(err <= 1e-5, f"simrank_power vs its numpy copy: {err}")
    src, dst, n = toy_graph()
    t = simrank_power(GraphHandle.from_edges(src, dst, n, device=dev).g,
                      c=0.25, iters=55).cpu().numpy()[0]
    terr = max(abs(float(t[i]) - TOY_TABLE2[ch]) for i, ch in enumerate(TOY_NODES))
    require(terr <= 1e-3, f"toy graph vs Table 2: {terr}")  # printed to 3 digits
    log(f"oracle on the card: 300-node power-law graph vs simrank_power_host "
        f"max |diff| {err:.3e} (<= 1e-5); toy node a vs Table 2 {terr:.2e}")


def adaptive_cell(h, truth, nodes, eps: float, launches: dict) -> dict:
    """16 adaptive single-source queries (``epsilon = eps_a = eps``) drained
    in batches of 8, every answer held against the oracle rows ``truth``
    ([16, n], host); then the same 16 nodes as a flat drain.  Returns the
    adaptive answers by node."""
    import collections

    import numpy as np
    import torch

    from repro_torch.api import QuerySpec, SimRankSession

    counters = kernel_counters()
    kw = dict(c=0.6, eps_a=eps, delta=0.01, walk_chunk=256, batch_q=8, seed=17,
              own_graph=False)
    sess = SimRankSession(h, initial_budget=64, confidence=0.99, **kw)
    flat = sess.params.n_r
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u in nodes:
        sess.submit(QuerySpec(kind="single_source", node=u, epsilon=eps))
    envs = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, fn in counters.items():
        launches[k] += fn.launches
    lane = counters["lane_probe"].launches  # the adaptive drain's own
    batches = -(-len(nodes) // 8)
    walks = np.array([e.walks_used for e in envs])
    errs = np.array([max_err(e.scores, truth[i], u)
                     for i, (u, e) in enumerate(zip(nodes, envs))])
    bounds = np.array([e.certified_bound for e in envs])
    violations = int((errs > bounds).sum())
    precs = [precision_at_10(e.scores, truth[i], u)
             for i, (u, e) in enumerate(zip(nodes, envs))]
    certs = collections.Counter(e.certificate for e in envs)
    ratio = flat / float(walks.mean())
    log(f"adaptive eps={eps}: flat n_r {flat}; walks used mean "
        f"{walks.mean():.1f}, max {walks.max()}; walks_saved_ratio {ratio:.3f}; "
        f"rounds {sorted(collections.Counter(e.rounds for e in envs).items())}; "
        f"escalations {sess.stats.escalations}; certificates {dict(certs)}; "
        f"max |est - S| {errs.max():.4e} (mean {errs.mean():.4e}) vs certified "
        f"bound max {bounds.max():.4f}; bound_violations {violations}; "
        f"precision@10 {np.mean(precs):.4f}; drain {wall:.3f} s, "
        f"{wall / batches * 1e3:.1f} ms per drained batch, {lane} lane_probe "
        f"launches, {sess.stats.steps} serve dispatches")
    require(len(envs) == len(nodes) and all(e.epsilon == eps for e in envs),
            "adaptive envelopes")
    require(all(np.isfinite(e.scores).all() and e.scores.shape == truth[0].shape
                for e in envs), "adaptive scores not finite or misshapen")
    require(violations == 0, f"{violations} queries broke their certified bound")
    require(ratio >= 1.0 and walks.max() <= flat, f"walks_saved_ratio {ratio}")
    require(lane > 0, "the adaptive drain launched no lane_probe")

    off = SimRankSession(h, **kw)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u in nodes:
        off.submit(QuerySpec(kind="single_source", node=u))
    fenvs = off.drain()
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    for k, fn in counters.items():
        launches[k] += fn.launches
    ferrs = [max_err(e.scores, truth[i], u)
             for i, (u, e) in enumerate(zip(nodes, fenvs))]
    log(f"flat eps_a={eps}: n_r {flat} for each of {len(nodes)} queries, drain "
        f"{fwall:.3f} s ({fwall / batches * 1e3:.1f} ms per batch; adaptive "
        f"{wall / fwall:.3f}x of it), {counters['lane_probe'].launches} "
        f"lane_probe launches; max |est - S| {max(ferrs):.4e} <= "
        f"bound {fenvs[0].error_bound:.4f}")
    require(max(ferrs) <= fenvs[0].error_bound, "flat drain beyond its bound")
    return {u: e for u, e in zip(nodes, envs)}


def bitwise_checks(h, nodes, launches: dict) -> None:
    """On the card: an escalated query equals a one-shot query capped at its
    cumulative walks, and 8 hub queries drained twice answer the second
    time from the probe cache alone, with no lane_probe launch."""
    import numpy as np
    import torch

    from repro_torch.api import QuerySpec, SimRankSession

    counters = kernel_counters()
    lane = counters["lane_probe"]
    sess = SimRankSession(h, c=0.6, eps_a=0.1, walk_chunk=256, batch_q=8,
                          seed=5, own_graph=False)
    u = nodes[0]
    before = lane.launches
    env = sess.query(QuerySpec(kind="single_source", node=u, epsilon=0.1, key=7))
    ref = sess.query(QuerySpec(kind="single_source", node=u, epsilon=0.0,
                               budget_walks=env.walks_used, key=7))
    require(ref.certificate == "budget" and ref.rounds == env.rounds
            and ref.walks_used == env.walks_used, f"one-shot run {ref}")
    require(np.array_equal(env.scores, ref.scores),
            "escalated != one-shot: "
            f"{float(np.abs(env.scores - ref.scores).max())}")
    log(f"escalated == one-shot, bitwise: node {u}, {env.rounds} rounds, "
        f"{env.walks_used} walks, certificate {env.certificate}")

    hubs = sorted(sess.backend.hub_nodes(90.0))
    pick = np.random.default_rng(3).choice(hubs, 8, replace=False).tolist()

    def drain():
        for v in pick:
            sess.submit(QuerySpec(kind="single_source", node=v, epsilon=0.1))
        return sess.drain()

    first = drain()
    hits, steps = sess.stats.hub_hits, sess.stats.steps
    torch.cuda.synchronize()
    mid = lane.launches
    t0 = time.perf_counter()
    second = drain()
    wall = time.perf_counter() - t0
    cached = lane.launches - mid
    launches["lane_probe"] += lane.launches - before
    rounds = max(e.rounds for e in first)
    log(f"hub cache: {len(hubs)} hubs at the 90th percentile, 8 drained twice: "
        f"second drain {sess.stats.hub_hits - hits} hub hits for {rounds} "
        f"rounds, {sess.stats.steps - steps} serve dispatches, {cached} "
        f"lane_probe launches, {wall * 1e3:.2f} ms")
    require(cached == 0 and sess.stats.steps == steps,
            f"the cached drain launched lane_probe {cached} times")
    require(sess.stats.hub_hits - hits == rounds, "hub hits != rounds")
    require(all(np.array_equal(a.scores, b.scores) for a, b in zip(first, second)),
            "cached rows differ from the served ones")


def profile_adaptive(h, nodes, launches: dict) -> None:
    """One adaptive drained batch of 8 (eps 0.05, a new seed) under the
    profiler: the device's busy share between the controller's rounds."""
    from repro_torch.api import QuerySpec, SimRankSession

    counters = kernel_counters()
    sess = SimRankSession(h, c=0.6, eps_a=0.05, walk_chunk=256, batch_q=8,
                          seed=18, own_graph=False)
    for u in nodes[:8]:
        sess.submit(QuerySpec(kind="single_source", node=u, epsilon=0.05))
    before = {k: fn.launches for k, fn in counters.items()}
    profile("adaptive drain of 8 (eps 0.05)", sess.drain, host_rows=6)
    for k, fn in counters.items():
        launches[k] += fn.launches - before[k]
    log(f"profiled adaptive drain: {sess.stats.steps} serve dispatches, "
        f"{counters['lane_probe'].launches - before['lane_probe']} lane_probe "
        f"launches")


def baselines(h, truth, nodes, adaptive: dict) -> None:
    """Figure 4 on the card: MC (r 1,000), TSF (r_g 300, r_q 40, t 10), the
    truncated Power Method (T 3) and the randomized probe (256 walks) on
    three queries each against the oracle, then one pooling evaluation of
    every system's top-50 list.  The queries are the three of the 16 whose
    oracle rows hold the largest similarity to another node: on the HepPh
    stand-in most rows hold none above 1e-3, and a baseline that answers 0
    everywhere would look exact there."""
    import numpy as np
    import torch

    from repro_torch.core import (
        abs_error_bound,
        build_oneway_index,
        evaluate_with_pool,
        make_params,
        mc_single_source,
        simrank_truncated_single_source,
        single_source,
        tsf_single_source,
    )

    dev, n = h.device, h.n
    sqrt_c = float(np.sqrt(0.6))
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rand_p = make_params(n, c=0.6, eps_a=0.1, delta=0.01, n_r_override=256)
    rand_bound = abs_error_bound(rand_p, n=n, n_r=256)
    t0 = time.perf_counter()
    index = build_oneway_index(gen, h.eg, r_g=300)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    systems = {
        "mc_r1000": lambda u: mc_single_source(gen, h.eg, u, r=1000, max_len=16,
                                               sqrt_c=sqrt_c),
        "tsf_rg300": lambda u: tsf_single_source(gen, index, h.eg, u, r_q=40,
                                                 t=10, c=0.6),
        "topsim_T3": lambda u: simrank_truncated_single_source(h.g, u, c=0.6,
                                                               iters=3),
        "randomized_256": lambda u: single_source(
            int(u), h.g, h.eg, u, rand_p, variant="randomized", walk_chunk=64),
    }
    off_diag = truth.copy()
    off_diag[np.arange(len(nodes)), nodes] = 0.0
    scale = off_diag.max(axis=1)
    picked = np.argsort(-scale, kind="stable")[:ACC_BASELINE_Q].tolist()
    log(f"baselines: max_v S[u, v] (v != u) over the 16 queries: median "
        f"{np.median(scale):.3e}, max {scale.max():.3e}; queries "
        f"{[nodes[i] for i in picked]} ({[float(f'{scale[i]:.4g}') for i in picked]})")
    tops = {"probesim_adaptive": adaptive}
    rows = []
    for name, fn in systems.items():
        errs, ts = [], []
        for j, i in enumerate(picked):
            u = nodes[i]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est = fn(u).cpu().numpy()
            ts.append(time.perf_counter() - t0)
            require(np.isfinite(est).all() and est.shape == (n,), f"{name} estimate")
            errs.append(max_err(est, truth[i], u))
            if j == 0:
                tops[name] = est
        rows.append((name, float(np.mean(errs)), max(errs), float(np.mean(ts))))
    ours = [max_err(adaptive[nodes[i]].scores, truth[i], nodes[i]) for i in picked]
    log(f"  {f'probesim_eps{ACC_EPS[0]}':16s} mean abs error {np.mean(ours):.4e}  (the "
        f"adaptive drain above)")
    for name, err, _, t in rows:
        log(f"  {name:16s} mean abs error {err:.4e}  time per query {t * 1e3:9.2f} ms")
    log(f"  one-way index (r_g 300): {index.numel() * 4 / 1e6:.2f} MB, built in "
        f"{index_s * 1e3:.2f} ms; randomized probe bound at n_r 256: "
        f"{rand_bound:.4f}")
    require(rows[3][2] <= rand_bound, f"randomized error {rows[3][2]} > its bound")

    u = nodes[picked[0]]
    lists = {}
    for name, est in tops.items():
        s = np.asarray(est[u].scores if name == "probesim_adaptive" else est,
                       np.float64).copy()
        s[u] = -np.inf
        lists[name] = np.argsort(-s, kind="stable")[:50].astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdict = evaluate_with_pool(gen, h.eg, u, lists, 50, expert_r=10_000,
                                 sqrt_c=sqrt_c, max_len=24)
    pool_s = time.perf_counter() - t0
    t = truth[picked[0]].copy()
    t[u] = -np.inf
    best = np.argsort(-t, kind="stable")[:50]
    log(f"pooling evaluation, node {u}, top-50 lists, expert r 10,000 "
        f"({pool_s:.2f} s):")
    for name, v in verdict.items():
        exact = len(set(lists[name].tolist()) & set(best.tolist())) / 50
        log(f"  {name:18s} precision {v['precision']:.3f}  ndcg {v['ndcg']:.4f}  "
            f"kendall {v['kendall']:+.4f}  (precision vs the oracle {exact:.3f})")
        require(all(np.isfinite(x) for x in v.values()), f"pool verdict {name}")


def accuracy_phase(h) -> dict:
    """The exact oracle on the HepPh stand-in (55 Power-Method iterations on
    the card), adaptive serving at eps 0.1 and 0.05 held against it, the
    bitwise properties, and the Figure-4 baselines.  Returns each kernel's
    launches in the phase's serving windows."""
    import numpy as np
    import torch

    from repro_torch.api import QuerySpec, SimRankSession
    from repro_torch.core import simrank_power

    launches = dict.fromkeys(kernel_counters(), 0)
    t_phase = time.perf_counter()
    oracle_checks(h.device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    s = simrank_power(h.g, c=0.6, iters=55)
    torch.cuda.synchronize()
    power_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    deg = h.eg.in_deg.cpu().numpy()
    nodes = np.random.default_rng(17).choice(np.flatnonzero(deg >= 1), ACC_Q,
                                             replace=False).tolist()
    idx = torch.tensor(nodes, device=h.device)
    truth = s[idx].double().cpu().numpy()
    asym = float((s[idx] - s[:, idx].T).abs().max())
    diag = s.diagonal()
    require(bool(torch.isfinite(s).all()) and bool((diag == 1).all())
            and float(s.min()) >= 0.0, "oracle not finite, diag != 1 or negative")
    require(asym <= 1e-5, f"oracle rows vs columns differ by {asym}")
    log(f"oracle: simrank_power on hepph n={h.n} m={h.g.num_edges}, 55 "
        f"iterations, {power_s:.3f} s ({power_s / 55 * 1e3:.2f} ms an iteration),"
        f" peak {peak / 1e9:.3f} GB above the graph; S[u] vs S[:, u] {asym:.2e}; "
        f"card: {card()}")
    del s, diag
    torch.cuda.empty_cache()

    # one untimed adaptive query first, so neither timed cell pays first-call
    # costs (chunk plan, allocator growth) for the other
    SimRankSession(h, walk_chunk=256, own_graph=False).query(
        QuerySpec(kind="single_source", node=nodes[0], epsilon=0.1))
    answers = {}
    for eps in ACC_EPS:
        answers[eps] = adaptive_cell(h, truth, nodes, eps, launches)
    bitwise_checks(h, nodes, launches)
    profile_adaptive(h, nodes, launches)
    baselines(h, truth, nodes, answers[ACC_EPS[0]])
    log(f"accuracy phase: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 4c: the network service at real size
# ---------------------------------------------------------------------------

# benchmarks/bench_service.py's non-quick protocol: 256 closed-loop clients
# of 8 queries each over a pool of 64 query nodes, wire k 10, 512 walks a
# query, micro-batches of 16 cut every 20 ms, admission bound 192 (below
# the herd, so the 429 path runs)
SVC_CLIENTS = 256
SVC_PER_CLIENT = 8
SVC_POOL = 64
SVC_PINNED = 16  # answers held bitwise against solo replays
# an adaptive request that reaches dispatch expired gets this in-band
# deadline and four times it as the thread backstop: the backstop must
# cover the worker thread's start and a round on the card, or the request
# 504s (the default 1 ms floor gives a 4 ms backstop; with 50 ms, one such
# request took 182 ms of its 200 ms backstop on an H100 80GB HBM3 at 700 W,
# most of it in the HTTP round trip)
SVC_MIN_ADAPTIVE_S = 0.25
SVC_ADAPTIVE_CAP = 43_360  # make_params(n, eps_a=0.05).n_r at HepPh
# the reference launcher's defaults
LAUNCH_ARGS = ["--nodes", "20000", "--edges", "200000", "--queries", "10"]


def counted(fn, launches: dict):
    """Run ``fn`` with every kernel counter set to 0 just before and read
    just after (added to ``launches``); returns what ``fn`` returns."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    try:
        return fn()
    finally:
        for k, c in counters.items():
            launches[k] += c.launches


def service_herd(host: str, port: int, qnodes) -> tuple:
    """The closed-loop herd: each client opens one keep-alive connection,
    waits for all the others, then sends its queries one after another
    (the client retries a 429 after the service's Retry-After hint).
    Returns (replies by (client, j), latencies in s, 429s per query, client
    errors, threads still alive, wall s)."""
    import threading

    from repro_torch.serving import ServiceClient

    class Client(ServiceClient):
        """bench_service's client, counting the 429s it retries."""

        rejected = 0

        def _request(self, method, path, body=None):
            status, payload = super()._request(method, path, body)
            self.rejected += status == 429
            return status, payload

    replies, lat, rejected, errors = {}, [], [], []
    barrier = threading.Barrier(SVC_CLIENTS + 1)

    def client(ci):
        try:
            with Client(host, port, timeout_s=300.0) as cl:
                barrier.wait(timeout=300)
                for j in range(SVC_PER_CLIENT):
                    u = int(qnodes[(ci * SVC_PER_CLIENT + j) % len(qnodes)])
                    t, r0 = time.perf_counter(), cl.rejected
                    r = cl.query(node=u, kind="topk", k=10,
                                 seed=ci * 10_000 + j)
                    lat.append(time.perf_counter() - t)
                    rejected.append(cl.rejected - r0)
                    replies[ci, j] = (u, r)
        except Exception as e:  # every client failure fails the gate
            errors.append(f"client {ci}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(SVC_CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait(timeout=300)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    alive = sum(t.is_alive() for t in threads)
    return replies, lat, rejected, errors, alive, wall


def service_phase(h) -> dict:
    """``SimRankService`` behind ``start_server`` on loopback, on the HepPh
    stand-in (the service copies the handle: one more table on the card),
    driven by the herd of benchmarks/bench_service.py; then the pinned
    answers against a direct session's solo replays, one ``POST /update``,
    one adaptive request past its deadline, and the launcher twice.
    Returns each kernel's launches in the driven windows."""
    import numpy as np
    import torch

    from repro_torch.api import QuerySpec, SimRankSession
    from repro_torch.launch import serve
    from repro_torch.serving import (
        ServiceClient,
        ServiceConfig,
        SimRankService,
        start_server,
        stop_server,
    )

    launches = dict.fromkeys(kernel_counters(), 0)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    deg = h.eg.in_deg.cpu().numpy()
    # bench_service's pick_query_nodes: uniform over in-degree >= 1
    qnodes = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), SVC_POOL,
                                             replace=False)
    cfg = ServiceConfig(batch_window_ms=20.0, max_batch_q=16, max_inflight=192,
                        default_budget_walks=512,
                        min_adaptive_deadline_s=SVC_MIN_ADAPTIVE_S)
    svc = SimRankService(h, config=cfg, seed=0,
                         session_kwargs=dict(c=0.6, eps_a=0.1, walk_chunk=256,
                                             top_k=50))
    server, thread = start_server(svc)
    host, port = server.server_address
    try:
        with ServiceClient(host, port) as cl:  # warm-up, outside the window
            cl.query(node=int(qnodes[0]), kind="topk", k=10)
        torch.cuda.synchronize()
        replies, lat, rejected, errors, alive, wall = counted(
            lambda: service_herd(host, port, qnodes), launches)
        herd_lp = launches["lane_probe"]
        require(herd_lp > 0, f"the herd launched no lane_probe: {launches}")
        snap = svc.stats_snapshot()
        stats = snap["service"]
        unhandled = len(errors) + alive + stats["errors_5xx"]
        require(unhandled == 0,
                f"{unhandled} unhandled errors ({stats['rejected_429']} 429s, "
                f"{wall:.1f} s): {errors[:5]}")
        total = SVC_CLIENTS * SVC_PER_CLIENT
        require(len(replies) == total == len(lat)
                and all(len(r["topk_nodes"]) == 10 for _, r in replies.values())
                and all(r["version"] == 0 for _, r in replies.values()),
                "herd replies: count, width or version")
        require(stats["served"] == total + 1 and stats["shed_504"] == 0,
                f"service counters {stats}")
        # 16 pinned answers against solo replays on the caller's handle
        ref = SimRankSession(h, walk_chunk=256, batch_q=cfg.max_batch_q,
                             top_k=50, own_graph=False)
        picks = [(ci, ci % SVC_PER_CLIENT)
                 for ci in range(0, SVC_CLIENTS, SVC_CLIENTS // SVC_PINNED)]
        for ci, j in picks:
            u, r = replies[ci, j]
            tk = ref.submit(QuerySpec(kind="topk", node=u, k=10,
                                      budget_walks=512, key=ci * 10_000 + j))
            ref.drain()
            env = tk.envelope
            require(r["topk_nodes"] == env.topk_nodes.tolist()
                    and np.array_equal(np.asarray(r["topk_scores"], np.float32),
                                       env.topk_scores)
                    and r["walks_used"] == env.walks_used == 512,
                    f"client {ci} query {j} (node {u}, batch {r['batch_size']})"
                    f" differs from its solo replay")
        del ref

        def after_herd():
            with ServiceClient(host, port) as cl:
                v0 = cl.healthz()["version"]
                t = time.perf_counter()
                rep = cl.update(inserts=[(int(qnodes[1]), int(qnodes[2])),
                                         (int(qnodes[3]), int(qnodes[2]))])
                upd_s = time.perf_counter() - t
                r = cl.query(node=int(qnodes[2]), kind="topk", k=10, seed=5)
                t = time.perf_counter()
                # capped at the flat budget of eps 0.05, so only a
                # certificate or the deadline stops it, never the cap
                status, ad = cl.query_raw(node=int(qnodes[4]), kind="topk",
                                          k=10, epsilon=0.05, deadline_s=0.005,
                                          budget_walks=SVC_ADAPTIVE_CAP)
                ad_s = time.perf_counter() - t
            return v0, rep, upd_s, r, status, ad, ad_s

        v0, rep, upd_s, r, status, ad, ad_s = counted(after_herd, launches)
        require(rep["version"] == v0 + 1 and rep["applied"] == 2
                and r["version"] == rep["version"],
                f"update {rep} then answer version {r['version']}")
        require(status == 200 and ad.get("certificate") in (
            "deadline", "analytic", "empirical"),
            f"adaptive request past its deadline: {status} {ad}")
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        stop_server(server, thread)
    require(not thread.is_alive() and not svc._collector.is_alive(),
            "server or collector thread still alive")
    lat_ms = np.asarray(lat) * 1e3
    log(f"service (bench_service protocol on hepph: {SVC_CLIENTS} clients x "
        f"{SVC_PER_CLIENT} queries, k 10, 512 walks, window 20 ms, batch 16, "
        f"max_inflight 192): {total} answers in {wall:.2f} s, "
        f"{total / wall:.1f} queries/s; latency p50 "
        f"{np.percentile(lat_ms, 50):.1f} ms, p99 {np.percentile(lat_ms, 99):.1f}"
        f" ms (with 429 backoff); 429s {stats['rejected_429']} (most for one "
        f"query {max(rejected)}, the client's limit 64), 504s "
        f"{stats['shed_504']}, 5xx {stats['errors_5xx']}; {stats['batches']} "
        f"batches, sizes {stats['batch_hist']}; tenant steps "
        f"{snap['tenants']['default']['steps']}; lane_probe launches in the "
        f"herd {herd_lp}")
    log(f"  {len(picks)} pinned answers equal their solo replays bitwise; "
        f"POST /update (2 inserts past the full COO buffer: regrows "
        f"{rep['regrows']}) {upd_s * 1e3:.1f} ms, version {v0} -> "
        f"{rep['version']}, next answer at version {r['version']}; adaptive "
        f"eps 0.05 past its 5 ms deadline: {status}, certificate "
        f"{ad['certificate']}, {ad['walks_used']} walks in {ad['rounds']} "
        f"rounds, {ad_s * 1e3:.1f} ms; peak device memory "
        f"{peak / 1e9:.3f} GB above the caller's graph; card: {card()}")
    del svc, server
    torch.cuda.empty_cache()
    for extra in ([], ["--epochs"]):
        t = time.perf_counter()
        served = counted(lambda: serve.main(LAUNCH_ARGS + extra), launches)
        torch.cuda.synchronize()
        require(len(served) == 10 and all(
            e.version == i + 1 and np.isfinite(e.topk_scores).all()
            and e.topk_nodes.shape == (50,) for i, e in enumerate(served)),
            f"launcher {extra}: versions or scores")
        log(f"launcher {' '.join(LAUNCH_ARGS + extra)}: "
            f"{time.perf_counter() - t:.2f} s with the graph build")
    torch.cuda.empty_cache()
    log(f"service phase: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: dynamic graphs at real size
# ---------------------------------------------------------------------------

DYN_EPOCHS = 16
DYN_CHECKED = (1, 8, 16)  # epochs after which the mirrors meet a rebuild
DYN_HEADROOM = 128  # ELL slots past the max in-degree: the hub row's room
DYN_OVER = 200  # forced overflow: inserts into the hub row past its room
# the timed cell's traffic, that of benchmarks/bench_dynamic.py: insert-only
# batches of 128 uniform random edges, 4 top-k queries an epoch
DYN_B = 128
DYN_Q = 4
DYN_REPS = 10  # batches of each timed kind


class HostEdges:
    """The live edge list on the host, updated by the coordinated path's
    rules: a batch's deletes first (each removes the first copy of its pair,
    one copy per pair a batch), then its inserts appended in op order while
    both the COO buffer and the destination's ELL row have room."""

    def __init__(self, src, dst, n: int, capacity: int, k_max: int):
        import numpy as np

        self.src = np.asarray(src, np.int32)
        self.dst = np.asarray(dst, np.int32)
        self.n, self.capacity, self.k_max = n, capacity, k_max
        self.batches = 0  # batches that changed the graph

    def in_deg(self):
        import numpy as np

        return np.bincount(self.dst, minlength=self.n)

    def apply(self, s, d, ins):
        """Apply one batch; returns its expected applied mask."""
        import numpy as np

        applied = np.zeros(len(s), bool)
        gone, seen = [], set()
        for i in np.flatnonzero(~ins):
            pair = (int(s[i]), int(d[i]))
            if pair in seen:
                continue
            seen.add(pair)
            hit = np.flatnonzero((self.src == pair[0]) & (self.dst == pair[1]))
            if len(hit):
                gone.append(hit[0])
                applied[i] = True
        keep = np.ones(len(self.src), bool)
        keep[gone] = False
        self.src, self.dst = self.src[keep], self.dst[keep]
        rows = self.in_deg()
        m = len(self.src)
        add = []
        for i in np.flatnonzero(ins):
            if rows[d[i]] < self.k_max and m < self.capacity:
                rows[d[i]] += 1
                m += 1
                add.append(i)
                applied[i] = True
        self.src = np.concatenate([self.src, np.asarray(s)[add]]).astype(np.int32)
        self.dst = np.concatenate([self.dst, np.asarray(d)[add]]).astype(np.int32)
        self.batches += int(applied.any())
        return applied

    def rebuild(self, dev):
        from repro_torch.api import GraphHandle

        return GraphHandle.from_edges(self.src, self.dst, self.n,
                                      capacity=self.capacity, k_max=self.k_max,
                                      device=dev)


def pick_deletes(rng, host: HostEdges, hub: int, k_hub: int, k_other: int):
    """Distinct live pairs: ``k_hub`` from the hub row, ``k_other`` elsewhere."""
    import numpy as np

    out = []
    for mask, k in ((host.dst == hub, k_hub), (host.dst != hub, k_other)):
        idx = rng.permutation(np.flatnonzero(mask))
        keys = host.src[idx].astype(np.int64) * host.n + host.dst[idx]
        _, first = np.unique(keys, return_index=True)
        out.append(idx[np.sort(first)[:k]])
    idx = np.concatenate(out)
    return host.src[idx], host.dst[idx]


def mirrors_equal_rebuild(h, host: HostEdges, dev):
    """Both mirrors of ``h`` bitwise equal to a rebuild from the host list;
    returns the rebuilt handle."""
    import torch

    from repro_torch.graph import check_live_prefix

    check_live_prefix(h.eg.in_nbrs, h.eg.in_deg, h.n)
    rb = host.rebuild(dev)
    for what, a, b in (("src", h.g.src, rb.g.src), ("dst", h.g.dst, rb.g.dst),
                       ("COO in_deg", h.g.in_deg, rb.g.in_deg),
                       ("out_deg", h.g.out_deg, rb.g.out_deg),
                       ("in_nbrs", h.eg.in_nbrs, rb.eg.in_nbrs),
                       ("ELL in_deg", h.eg.in_deg, rb.eg.in_deg)):
        require(torch.equal(a, b), f"{what} differs from the rebuild")
    require(h.num_edges == rb.num_edges == len(host.src),
            f"edge count {h.num_edges} vs rebuild {rb.num_edges}")
    require(h.version == host.batches,
            f"version {h.version}, {host.batches} batches changed the graph")
    return rb


def serve_on_rebuild(rb, results, seeds, params, *, kernel_off=False) -> list:
    """The epoch's top-k envelopes against a drain of the same queries, same
    per-query seeds, on the rebuilt handle: with the kernel (a stale chunk
    plan would show here) and, with ``kernel_off``, also with the plain COO
    push (the kernel held against its plain version on the tables the
    updates made).  Returns the max |diff| of each."""
    from repro_torch.api import QuerySpec, SimRankSession

    diffs = []
    for use_kernel in (True, False)[: 1 + kernel_off]:
        sess = SimRankSession(rb, walk_chunk=256, batch_q=len(results),
                              top_k=50, own_graph=False, use_kernel=use_kernel)
        for env, seed in zip(results, seeds):
            sess.submit(QuerySpec(kind="topk", node=env.node, k=50, key=seed))
        ref = sess.drain()
        require(ref[0].walks_used == results[0].walks_used == params.n_r,
                "walk budgets differ")
        diffs.append(max(topk_agree(a, b, FP32_RTOL)
                         for a, b in zip(results, ref)))
    return diffs


def kernel_counters() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.lane_probe.ops import lane_probe_level
    from repro_torch.kernels.probe_push.ops import probe_push
    from repro_torch.kernels.spmm_ell.ops import spmm_ell_padded

    return {"lane_probe": lane_probe_level, "spmm_ell": spmm_ell_padded,
            "probe_push": probe_push, "flash_attention": flash_attention}


def epoch_runner(sess, launches: dict):
    """A function that runs one session epoch, synchronized, and returns it
    with its applied mask, its wall ms and its chunk-plan builds; each
    kernel's launches inside the epoch are added to ``launches``."""
    import torch

    from repro_torch.kernels.ell_plan import build_plan

    counters = kernel_counters()
    masks = []
    batch_fn = type(sess.backend).epoch_batch
    backend = weakref.ref(sess.backend)  # no cycle: `del sess` frees the graph

    def recording(*a, **kw):  # keeps each epoch's applied mask
        out = batch_fn(backend(), *a, **kw)
        masks.append(out[0])
        return out

    sess.backend.epoch_batch = recording

    def run():
        masks.clear()
        torch.cuda.synchronize()
        builds = build_plan.builds
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        ep = sess.epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        for k, fn in counters.items():
            launches[k] += fn.launches
        return ep, masks[0], wall, build_plan.builds - builds

    return run


def timed_apply(h, s, d, ins, dev) -> tuple[float, float, object]:
    """One batch through the coordinated apply: CUDA events around the
    enqueue, which must not sync, and the host clock to the host read of the
    results.  Returns (event ms, wall ms, applied mask)."""
    import torch

    from repro_torch.graph.dynamic import (
        apply_update_batch_async,
        make_update_batch,
        settle,
    )

    batch = make_update_batch(s, d, ins, batch_size=len(s), n=h.n, device=dev)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    e0.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = apply_update_batch_async(h.g, h.eg, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    e1.record()
    got = settle(h.g, h.eg, pending)
    return e0.elapsed_time(e1), (time.perf_counter() - t) * 1e3, got.numpy()


def dynamic_phase(dev) -> dict:
    """The correctness stream: 16 fused epochs of 64 edge ops and 8 top-k
    queries each on the HepPh stand-in, engineered to reach the apply's
    paths (hub deletes, a short row pushed past CHUNK_SLOTS), the mirrors
    and scores held against rebuilds, then one forced overflow regrown.
    Returns the launches of every kernel inside the session's epochs."""
    import numpy as np
    import torch

    from repro_torch.api import GraphHandle, SimRankSession
    from repro_torch.core.walks import derive_seed
    from repro_torch.graph import paper_dataset
    from repro_torch.graph.dynamic import apply_update_batch, make_update_batch
    from repro_torch.kernels.ell_plan import CHUNK_SLOTS, plan_of

    launches = dict.fromkeys(kernel_counters(), 0)
    torch.cuda.reset_peak_memory_stats()
    src, dst, n = paper_dataset("hepph", 1.0)
    m = len(src)
    deg = np.bincount(dst, minlength=n)
    hub = int(np.argmax(deg))
    k_max = int(deg.max()) + DYN_HEADROOM
    require(k_max == 34541 + 128, f"hepph k_max {k_max}")
    t0 = time.perf_counter()
    h = GraphHandle.from_edges(src, dst, n, capacity=2 * m, k_max=k_max,
                               device=dev)
    sess = SimRankSession(h, walk_chunk=256, batch_q=8, update_batch=64,
                          top_k=50, seed=0)
    del h  # the session's copy is the only one
    h = sess.handle
    torch.cuda.synchronize()
    params = sess.params
    require((params.n_r, params.c, params.eps_a) == (10840, 0.6, 0.1),
            f"session params {params}")
    log(f"dynamic phase: hepph n={n} m={m}, capacity {2 * m}, k_max {k_max} "
        f"(hub {hub}: in-degree {deg[hub]}, {DYN_HEADROOM} free slots); ELL "
        f"table {h.eg.in_nbrs.numel() * 4 / 1e9:.4f} GB, COO "
        f"{2 * h.g.src.numel() * 4 / 1e6:.3f} MB; built and copied into the "
        f"session in {time.perf_counter() - t0:.2f} s")
    host = HostEdges(src, dst, n, 2 * m, k_max)
    rng = np.random.default_rng(16)
    # a short row that the stream takes past CHUNK_SLOTS (packed -> split)
    short = int(rng.choice(np.flatnonzero((deg >= 1) & (deg <= 16))))
    run_epoch = epoch_runner(sess, launches)

    def queue(s, d, ins):
        for flag in (False, True):  # deletes first: no insert->delete cut
            sel = ins == flag
            if sel.any():
                sess.queue_update(s[sel], d[sel], insert=flag)

    walls, plans = [], []
    for e in range(1, DYN_EPOCHS + 1):
        ds, dd = pick_deletes(rng, host, hub, 8, 24)
        is_ = rng.integers(0, n, 32).astype(np.int32)
        id_ = rng.integers(0, n, 32).astype(np.int32)
        id_[:4] = hub
        if e <= 8:
            id_[4:24] = short
        s = np.concatenate([ds, is_]).astype(np.int32)
        d = np.concatenate([dd, id_]).astype(np.int32)
        ins = np.arange(64) >= 32
        want = host.apply(s, d, ins)
        queue(s, d, ins)
        live = np.flatnonzero(host.in_deg() >= 1)
        tickets = [sess.submit(int(u)) for u in rng.choice(live, 8, replace=False)]
        ep, got, wall, builds = run_epoch()
        require(ep.updates_submitted == 64 and ep.updates_applied == want.sum()
                and np.array_equal(got[:64], want),
                f"epoch {e}: applied mask differs from the host replay")
        require(ep.version == host.batches == e and not ep.overflow,
                f"epoch {e}: version {ep.version} overflow {ep.overflow}")
        require(len(ep.results) == 8 and all(t.envelope is r for t, r in
                                             zip(tickets, ep.results)),
                f"epoch {e}: results")
        require(builds == 1, f"epoch {e}: {builds} plan builds, want 1")
        plans.append(builds)
        walls.append(wall)
        if e in DYN_CHECKED:
            rb = mirrors_equal_rebuild(h, host, dev)
            seeds = [derive_seed(sess.seed, t.seq) for t in tickets]
            diffs = serve_on_rebuild(rb, ep.results, seeds, params,
                                     kernel_off=e == DYN_EPOCHS)
            del rb
            torch.cuda.empty_cache()
            log(f"dynamic epoch {e}: mirrors bitwise equal to the rebuild "
                f"(version {ep.version}, {h.num_edges} edges, hub in-degree "
                f"{int(h.eg.in_deg[hub])}, row {short} in-degree "
                f"{int(h.eg.in_deg[short])}); top-k vs the rebuild's serve, "
                f"kernel on{', off' if len(diffs) > 1 else ''}: max |diff| "
                + ", ".join(f"{x:.3e}" for x in diffs))
        if e == 8:
            plan = plan_of(h.eg.in_deg, k_max)
            require(int(h.eg.in_deg[short]) > CHUNK_SLOTS
                    and short in plan.long_rows.tolist(),
                    f"row {short} did not become a split row")
    log(f"correctness stream: {DYN_EPOCHS} epochs of 64 ops (32 deletes, 32 "
        f"inserts) + 8 top-k queries; epoch wall ms {np.mean(walls):.2f} mean "
        f"({min(walls):.2f} .. {max(walls):.2f}); plan builds by epoch {plans}")

    # an epoch with queries and no update: nothing written, no new plan
    tickets = [sess.submit(int(u)) for u in
               rng.choice(np.flatnonzero(host.in_deg() >= 1), 8, replace=False)]
    ep, _, wall, builds = run_epoch()
    require(ep.updates_submitted == 0 and ep.version == DYN_EPOCHS
            and builds == 0, f"query-only epoch: {ep}, {builds} builds")
    log(f"query-only epoch: {wall:.2f} ms, 0 plan builds")

    # the apply alone on this stream's 64-op batches, insert-only and mixed
    for kind in ("insert-only", "mixed"):
        ev, wl = [], []
        for _ in range(8):
            if kind == "mixed":
                ds, dd = pick_deletes(rng, host, hub, 8, 24)
                s = np.concatenate([ds, rng.integers(0, n, 32)])
                d = np.concatenate([dd, rng.integers(0, n, 32)])
                ins = np.arange(64) >= 32
            else:
                s, d = rng.integers(0, n, 64), rng.integers(0, n, 64)
                ins = np.ones(64, bool)
            want = host.apply(s, d, ins)
            e_ms, w_ms, got = timed_apply(h, s, d, ins, dev)
            require(np.array_equal(got, want), f"{kind} apply mask")
            ev.append(e_ms)
            wl.append(w_ms)
        log(f"apply, {kind} 64-op batch: {np.mean(ev):.3f} ms (CUDA events, "
            f"min {min(ev):.3f}; no host sync in the enqueue), "
            f"{np.mean(wl):.3f} ms with the host read of the results")
        # one more batch of the kind under the profiler: host or device?
        host.apply(s, d, ins)
        profile(f"apply, {kind} 64-op batch", lambda: apply_update_batch(
            h.g, h.eg, make_update_batch(s, d, ins, batch_size=64, n=n,
                                         device=dev)), host_rows=8)
    require(h.version == host.batches, "version after the timed applies")

    # forced overflow: DYN_OVER more copies of one edge than the hub row has
    # room for; auto_regrow doubles K and retries the skips
    room = k_max - int(host.in_deg()[hub])
    n_over = room + DYN_OVER
    s0 = int(rng.integers(0, n))
    sess.queue_update(np.full(n_over, s0), np.full(n_over, hub))
    eps, regrow_s, plans = [], None, []
    while sess.pending[0]:
        ep, got, wall, builds = run_epoch()
        plans.append(builds)
        k = ep.updates_submitted
        want = host.apply(np.full(k, s0), np.full(k, hub), np.ones(k, bool))
        require(np.array_equal(got[:k], want) and ep.version == host.batches,
                f"overflow epoch {len(eps) + 1}: applied mask or version")
        if ep.regrown:
            regrow_s = wall / 1e3 - ep.latency_s
            host.k_max, host.capacity = h.k_max, h.capacity
        eps.append(ep)
    regrown = [ep for ep in eps if ep.regrown]
    require(len(regrown) == 1 and sess.stats.regrows == 1
            and regrown[0].overflow and regrown[0].updates_requeued > 0,
            f"{len(regrown)} regrown epochs, {sess.stats.regrows} regrows")
    require(sum(ep.updates_applied for ep in eps) == n_over
            and not sess.overflow and h is sess.handle,
            "the forced overflow's inserts did not all apply")
    log(f"forced overflow: {n_over} inserts of ({s0}, {hub}) ({room} fit), "
        f"{len(eps)} update-only epochs, 1 regrow: K {k_max} -> {h.k_max}, "
        f"capacity {2 * m} -> {h.capacity}, ELL table "
        f"{h.eg.in_nbrs.numel() * 4 / 1e9:.4f} GB; regrow {regrow_s:.3f} s "
        f"(the regrown epoch's wall minus its dispatch); version "
        f"{eps[-1].version} after the retries; plan builds by epoch {plans} "
        f"(update-only epochs serve nothing)")
    rb = mirrors_equal_rebuild(h, host, dev)
    tickets = [sess.submit(int(u)) for u in
               rng.choice(np.flatnonzero(host.in_deg() >= 1), 8, replace=False)]
    ep, _, wall, builds = run_epoch()
    seeds = [derive_seed(sess.seed, t.seq) for t in tickets]
    diffs = serve_on_rebuild(rb, ep.results, seeds, params, kernel_off=True)
    require(builds == 1, f"{builds} plan builds on the regrown table")
    log(f"after the regrow: mirrors bitwise equal to the rebuild, top-k of 8 "
        f"queries vs the rebuild's serve, kernel on, off: max |diff| "
        f"{diffs[0]:.3e}, {diffs[1]:.3e}; serve epoch {wall:.2f} ms")
    del rb
    peak = torch.cuda.max_memory_allocated()
    log(f"correctness stream: peak device memory {peak / 1e9:.3f} GB; launches "
        f"in the session's epochs {launches}; card: {card()}")
    require(launches["lane_probe"] > 0, "the epochs launched no lane_probe")
    del sess, h
    torch.cuda.empty_cache()
    return launches


def dynamic_traffic(dev) -> dict:
    """The timed dynamic cell, on the traffic of benchmarks/bench_dynamic.py:
    insert-only batches of DYN_B uniform random edges and DYN_Q top-k
    queries an epoch, on the HepPh stand-in at the session defaults, with
    bench_dynamic's headroom (capacity for every batch streamed, k_max =
    max in-degree + 128).  Times the apply alone, update->queryable (an
    update-only epoch) and the fused epoch, with a query-only epoch for the
    serve; every mask is held against the host replay, and the end state's
    mirrors and last top-k against a rebuild.  Returns the epochs' launches."""
    import numpy as np
    import torch

    from repro_torch.api import GraphHandle, SimRankSession
    from repro_torch.core.walks import derive_seed
    from repro_torch.graph import paper_dataset

    launches = dict.fromkeys(kernel_counters(), 0)
    torch.cuda.reset_peak_memory_stats()
    src, dst, n = paper_dataset("hepph", 1.0)
    deg = np.bincount(dst, minlength=n)
    capacity = len(src) + DYN_B * (3 * DYN_REPS + 1)
    k_max = int(deg.max()) + 128
    h = GraphHandle.from_edges(src, dst, n, capacity=capacity, k_max=k_max,
                               device=dev)
    sess = SimRankSession(h, walk_chunk=256, batch_q=DYN_Q,
                          update_batch=DYN_B, top_k=50, seed=0)
    del h
    h = sess.handle
    params = sess.params
    host = HostEdges(src, dst, n, capacity, k_max)
    rng = np.random.default_rng(1)
    qnodes = [int(u) for u in np.random.default_rng(2).choice(
        np.flatnonzero(deg > 0), DYN_Q, replace=False)]
    run_epoch = epoch_runner(sess, launches)
    ins = np.ones(DYN_B, bool)

    def fresh():  # bench_dynamic's fresh_ops
        return (rng.integers(0, n, DYN_B).astype(np.int32),
                rng.integers(0, n, DYN_B).astype(np.int32))

    def epoch(queries):
        s, d = fresh()
        want = host.apply(s, d, ins)
        sess.queue_update(s, d)
        tickets = [sess.submit(u) for u in queries]
        ep, got, wall, builds = run_epoch()
        require(np.array_equal(got[:DYN_B], want) and want.all()
                and ep.version == host.batches
                and len(ep.results) == len(queries),
                f"timed epoch: mask, version {ep.version} or results")
        return ep, tickets, wall, builds

    epoch(qnodes)  # warm-up, outside the timed batches
    ap, ap_wall = [], []
    for _ in range(DYN_REPS):
        s, d = fresh()
        want = host.apply(s, d, ins)
        e_ms, w_ms, got = timed_apply(h, s, d, ins, dev)
        require(np.array_equal(got, want), "timed apply mask")
        ap.append(e_ms)
        ap_wall.append(w_ms)
    lat = [epoch([])[2] for _ in range(DYN_REPS)]
    walls, plans = [], []
    for _ in range(DYN_REPS):
        ep, tickets, wall, builds = epoch(qnodes)
        walls.append(wall)
        plans.append(builds)
    require(plans == [1] * DYN_REPS, f"plan builds by epoch {plans}")
    serve = []
    for _ in range(3):  # the same queries on the same graph, no update
        for u in qnodes:
            sess.submit(u)
        sep, _, wall, builds = run_epoch()
        require(sep.updates_submitted == 0 and builds == 0, "query-only epoch")
        serve.append(wall)
    rb = mirrors_equal_rebuild(h, host, dev)
    diffs = serve_on_rebuild(rb, ep.results,
                             [derive_seed(sess.seed, t.seq) for t in tickets],
                             params)
    del rb
    med = float(np.median(walls))
    log(f"timed dynamic cell (bench_dynamic traffic: insert-only batches of "
        f"{DYN_B} uniform random edges, {DYN_Q} top-k queries an epoch; hepph, "
        f"capacity {capacity}, k_max {k_max}):")
    log(f"  apply alone, {DYN_B}-op batch: median {np.median(ap):.3f} ms "
        f"(CUDA events; {min(ap):.3f} .. {max(ap):.3f}), "
        f"{np.median(ap_wall):.3f} ms with the host read of the results")
    log(f"  update->queryable (update-only epoch, synchronized): median "
        f"{np.median(lat):.3f} ms ({min(lat):.3f} .. {max(lat):.3f}); "
        f"{DYN_B / np.median(lat) * 1e3:.0f} edges/s")
    log(f"  epoch ({DYN_B} inserts + {DYN_Q} top-k queries): median {med:.2f} ms "
        f"({min(walls):.2f} .. {max(walls):.2f}); serve alone (query-only "
        f"epoch) median {np.median(serve):.2f} ms; apply share "
        f"{np.median(ap) / med:.2%}; plan builds by epoch {plans}")
    log(f"  end state equal to the rebuild (version {sess.version}, "
        f"{h.num_edges} edges); last epoch's top-k vs the rebuild's serve: max "
        f"|diff| {diffs[0]:.3e}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches {launches}; "
        f"card: {card()}")
    del sess, h
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 5b: temporal streams at HepPh's node count
# ---------------------------------------------------------------------------

# benchmarks/bench_stream.py's full config (run(quick=False)) with n lifted
# from 2,000 to HepPh's 34,546, and these changes, each for its reason:
# - rate 20,000 -> 345,460 edges/s, scaled with n: the bench's 5 live edges
#   a node under its 0.5 s TTL, so the steady window holds about 172,730
#   edges (computed), the HepPh stand-in's order (149,381);
# - horizon 3 s -> 1 s: the scaled rate makes 17x the bench's ops a second;
#   1 s is two TTLs, so the steady run still spends half its time at the
#   full window;
# - capacity 65,536 -> 524,288 (2^19): twice the largest window of any run
#   (the bursty run's, at most about 242,000 edges: 0.3 s of on-rate plus a
#   tick, computed), not 65,536 x 17.3 = 1.13 M, because every delete is
#   matched against the whole COO buffer;
# - update_batch 64 -> 512, the bench's burst: one burst is one epoch.  The
#   apply is bound by its launches, not its ops (this script's dynamic
#   phase: an insert-only apply of 64 ops 0.95 ms, of 128 ops 1.23 ms on an
#   H100 80GB HBM3 at 700 W), so 64-op epochs would make 8x the epochs at
#   nearly the cost of each;
# - no warm-up run: nothing compiles on first use (the kernels are built
#   before the first phase);
# - no sharded leg (ROADMAP queue 1 item 12).
# ---------------------------------------------------------------------------
# The sharded backend: S row blocks of the HepPh stand-in on one card
# ---------------------------------------------------------------------------

SHARD_DEV = "cuda:0"  # the card's one device holds every block
SHARD_S = 4
SHARD_W = 256  # the sessions' walk_chunk: lane columns of a drained batch


class _TopK:
    """An answer's top-k pair, for ``topk_agree``."""

    def __init__(self, nodes, scores):
        self.topk_nodes, self.topk_scores = nodes, scores


def shard_state_equals_rebuild(be) -> None:
    """Every block of the backend's carried device state bitwise equal to
    ``build_shard_epoch_graph`` over its host state's ``to_host_edges()``,
    every ``in_deg`` replica included."""
    import torch

    from repro_torch.core.epoch import build_shard_epoch_graph

    st = be._epoch_graph
    rb = build_shard_epoch_graph(*be.state.to_host_edges(), be.n,
                                 capacity_per_shard=st.capacity,
                                 k_max=st.k_max, mesh=be.mesh)
    for f in ("src_sh", "dst_sh", "counts", "in_nbrs", "in_deg"):
        for s, (a, b) in enumerate(zip(getattr(st, f), getattr(rb, f))):
            require(torch.equal(a, b), f"shard {s}: {f} differs from the rebuild")
    del rb
    torch.cuda.empty_cache()


def shard_kernel_shapes(st, params, gen, full_ms: float) -> None:
    """lane_probe at the spmd path's per-shard shape (R = rows, T = n_pad,
    W = 256) on each block of ``st``, against its plain version, with its
    live-slot bound, beside the full-table time."""
    import torch

    from repro_torch.core.epoch import kernel_weights
    from repro_torch.kernels.lane_probe.ops import lane_probe_level
    from repro_torch.kernels.lane_probe.ref import lane_probe_level_ref

    n, rows = st.n, st.rows
    w_push = kernel_weights(st, params.sqrt_c)
    total_ms = 0.0
    for s in range(st.shards):
        row0 = s * rows
        a = lane_inputs(gen, st.in_nbrs[s], st.n_pad, SHARD_W,
                        dtype=torch.float32, n_live=n, row0=row0)
        a["weights"] = w_push[s]
        kw = dict(row_len=st.in_deg[s][row0 : row0 + rows], row0=row0,
                  tab0=row0, n_live=n, prune=True)
        ms = time_ms(lambda: lane_probe_level(**a, **kw), 20)
        out, tot = lane_probe_level(**a, **kw)
        p_ms, (ref_out, ref_tot) = plain_ms(
            lambda: lane_probe_level_ref(**a, **kw))
        err = max(fp32_err(out, ref_out), fp32_err(tot, ref_tot))
        b_ms, by, nbytes = lane_bound(a["nbrs"], kw["row_len"], n, SHARD_W,
                                      a["fin"])
        total_ms += ms
        log(f"lane_probe shard {s} of {st.shards} [R={rows} x K={st.k_max}, "
            f"T={st.n_pad}, W={SHARD_W}, row0=tab0={row0}]: {ms:.4f} ms, plain "
            f"{p_ms:.1f} ms, max_abs_err {err:.3e}, live-slot bound "
            f"{b_ms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
    log(f"lane_probe at the spmd shape: {st.shards} launches a level "
        f"{total_ms:.4f} ms together, full table (one launch, R = n) "
        f"{full_ms:.4f} ms")


def shard_service(h, launches: dict) -> None:
    """``SimRankService(backend="sharded")`` over 4 blocks behind the HTTP
    server (pinned queries, one update), then the launcher with ``--backend
    sharded``: one block per card, and 4 blocks on ``cuda:0`` with
    ``--epochs``."""
    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.launch.mesh import ShardMesh
    from repro_torch.serving import (
        ServiceClient,
        ServiceConfig,
        SimRankService,
        start_server,
        stop_server,
    )

    t = time.perf_counter()
    svc = SimRankService(h, backend="sharded",
                         mesh=ShardMesh([SHARD_DEV] * SHARD_S),
                         config=ServiceConfig(batch_window_ms=20.0,
                                              max_batch_q=8,
                                              default_budget_walks=512))
    server, thread = start_server(svc)
    host, port = server.server_address
    try:
        with ServiceClient(host, port) as cl:
            r = counted(lambda: cl.query(node=int(h.n // 3), kind="topk", k=10,
                                         seed=5), launches)
            rep = cl.update(inserts=[(1, int(h.n // 3))])
            r2 = counted(lambda: cl.query(node=int(h.n // 3), kind="topk",
                                          k=10, seed=5), launches)
            hz = cl.healthz()
    finally:
        stop_server(server, thread)
    require(not thread.is_alive() and svc.stats.errors_5xx == 0,
            "sharded service: thread alive or 5xx")
    require(hz["backend"] == "sharded" and rep["version"] == hz["version"] == 1
            and r["version"] == 0 and r2["version"] == 1
            and len(r["topk_nodes"]) == 10
            and np.isfinite(r2["topk_scores"]).all(),
            f"sharded service answers: {hz}, {rep}")
    log(f"sharded service ({SHARD_S} blocks): 2 queries and 1 update over "
        f"HTTP in {time.perf_counter() - t:.2f} s with the device state's "
        f"build, version 0 -> 1")
    del svc, server
    torch.cuda.empty_cache()
    for extra in (["--backend", "sharded"],
                  ["--backend", "sharded", "--shards", str(SHARD_S), "--device",
                   SHARD_DEV, "--epochs"]):
        t = time.perf_counter()
        served = counted(lambda: serve.main(LAUNCH_ARGS + extra), launches)
        torch.cuda.synchronize()
        require(len(served) == 10 and all(
            e.version == i + 1 and e.variant == "sharded[spmd]"
            and np.isfinite(e.topk_scores).all() for i, e in enumerate(served)),
            f"launcher {extra}: versions, variants or scores")
        log(f"launcher {' '.join(LAUNCH_ARGS + extra)}: "
            f"{time.perf_counter() - t:.2f} s with the graph build")
    torch.cuda.empty_cache()


def shard_phase(h, params, nodes, full_lane_ms: float) -> dict:
    """The sharded backend on the HepPh stand-in, every block on the card:
    16 top-k queries drained in batches of 8 through ``SimRankSession(
    backend="sharded")`` at 1 and 4 spmd blocks (bitwise equal to the local
    kernel serve) and 4 ring blocks (1e-5); at 4 spmd blocks also with the
    kernel off (1e-5) and the bf16 exchange (1e-3), one profiled batch and
    lane_probe at the per-shard shape, an adaptive spec (bitwise against
    the local one) and a host-path update; the service and the launcher on
    the sharded backend; then 16 mixed epochs at 4 blocks (phase 5's ops)
    against a host replay and rebuilds, and one forced overflow regrown.
    Returns each kernel's launches in the counted windows (the warm drains,
    the service's and launcher's queries, the epochs)."""
    import numpy as np
    import torch

    from repro_torch.api import QuerySpec, SimRankSession
    from repro_torch.api.backend import ShardedBackend, ShardedGraphState
    from repro_torch.core.walks import derive_seed
    from repro_torch.kernels.ell_plan import build_plan
    from repro_torch.launch.mesh import ShardMesh

    t_phase = time.perf_counter()
    launches = dict.fromkeys(kernel_counters(), 0)
    counters = kernel_counters()
    lane = counters["lane_probe"]
    n = h.n
    # the main path's seeds: query i of a session seeded 0 draws from
    # derive_seed(0, i), so every drain below answers the same 16 queries
    specs = [QuerySpec(kind="topk", node=int(u), k=50, key=derive_seed(0, i))
             for i, u in enumerate(nodes)]

    def drain(sess, *, count=False):
        for sp in specs:
            sess.submit(sp)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        build_plan.builds = 0
        t = time.perf_counter()
        envs = sess.drain()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        if count:
            for k, fn in counters.items():
                launches[k] += fn.launches
        return envs, secs, lane.launches, build_plan.builds

    loc = SimRankSession(h, walk_chunk=SHARD_W, batch_q=8, seed=0,
                         own_graph=False)
    local, local_s, local_levels, _ = drain(loc)
    del loc
    log(f"shard phase: local kernel drain of {len(specs)} top-k queries "
        f"{local_s:.3f} s ({local_s / 2 * 1e3:.1f} ms per drained batch), "
        f"{local_levels} levels")
    ring_s = None
    for probe, s in (("spmd", 1), ("spmd", SHARD_S), ("ring", SHARD_S)):
        mesh = ShardMesh([SHARD_DEV] * s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess = SimRankSession(h, walk_chunk=SHARD_W, batch_q=8, seed=0,
                              backend="sharded", mesh=mesh,
                              backend_options=dict(probe=probe))
        be = sess.backend
        st = be._epoch_graph_state()
        if probe == "ring":
            be.state.ring_graph(mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        first, first_s, _, first_builds = drain(sess)
        envs, secs, lp, builds = drain(sess, count=True)
        label = f"{probe} x{s}"
        require(lp > 0 and lp % s == 0, f"{label}: {lp} lane_probe launches")
        require(builds == 0, f"{label}: {builds} plan builds in a warm drain")
        levels = lp // s
        for a, b, c in zip(local, first, envs):
            require(np.array_equal(b.topk_nodes, c.topk_nodes)
                    and np.array_equal(b.topk_scores, c.topk_scores),
                    f"{label}: two drains of the same queries differ")
            require(c.variant == f"sharded[{probe}]", f"{label}: {c.variant}")
            if probe == "spmd":
                require(np.array_equal(a.topk_nodes, c.topk_nodes)
                        and np.array_equal(a.topk_scores, c.topk_scores),
                        f"{label}: node {a.node} differs from the local "
                        "kernel serve in its bits")
        err = 0.0 if probe == "spmd" else max(
            topk_agree(a, c, FP32_RTOL) for a, c in zip(local, envs))
        wire = 0 if s == 1 else s * (s - 1) * st.rows * SHARD_W * 4
        log(f"sharded {label}: device state built in {build_s:.2f} s "
            f"(ELL blocks {s} x [{st.rows} x {st.k_max}], "
            f"{sum(x.numel() for x in st.in_nbrs) * 4 / 1e9:.3f} GB); cold "
            f"drain {first_s:.3f} s ({first_builds} plan builds), warm drain "
            f"{secs:.3f} s ({secs / 2 * 1e3:.1f} ms per drained batch, local "
            f"{local_s / 2 * 1e3:.1f}), {levels} levels, {lp} lane_probe "
            f"launches ({s} a level), 0 plan builds; vs the local kernel "
            + ("serve: bitwise equal" if probe == "spmd"
               else f"serve: max |diff| {err:.3e}")
            + f"; exchanged a level (computed, W={SHARD_W} fp32): "
            f"{wire / 1e6:.1f} MB")
        if probe == "ring":
            ring_s = secs
        if probe == "spmd" and s == SHARD_S:
            be.use_kernel = False
            off, off_s, _, _ = drain(sess)
            be.use_kernel = True
            be.frontier_dtype = "bfloat16"
            b16, b16_s, _, _ = drain(sess)
            be.frontier_dtype = "float32"
            off_err = max(topk_agree(a, b, FP32_RTOL) for a, b in zip(envs, off))
            b16_err = max(topk_agree(a, b, BF16_RTOL) for a, b in zip(envs, b16))
            log(f"sharded {label} variants: kernel off (COO push) {off_s:.3f} s,"
                f" max |diff| {off_err:.3e} <= {FP32_RTOL}; bf16 exchange "
                f"{b16_s:.3f} s, max |diff| {b16_err:.3e} <= {BF16_RTOL} "
                f"(exchanged a level {wire / 2e6:.1f} MB, computed)")
            for sp in specs[:8]:
                sess.submit(sp)
            counts = profile(f"sharded drain of 8 ({label})", sess.drain)
            lv = sum(c for k, c in counts.items() if "lane_probe_kernel" in k)
            log(f"profiled sharded drain: {lv} lane_probe launches")
            gen = torch.Generator(device=SHARD_DEV)
            gen.manual_seed(19)
            shard_kernel_shapes(st, params, gen, full_lane_ms)
            # an adaptive spec, bitwise against the local session's, then a
            # host-path update: the device state is rebuilt from the host
            u = int(nodes[2])
            spec = QuerySpec(kind="single_source", node=u, epsilon=0.1, key=7)
            a_loc = SimRankSession(h, walk_chunk=SHARD_W, batch_q=8,
                                   own_graph=False).query(spec)
            a_shd = sess.query(spec)
            require(np.array_equal(a_loc.scores, a_shd.scores)
                    and (a_loc.walks_used, a_loc.rounds, a_loc.certificate)
                    == (a_shd.walks_used, a_shd.rounds, a_shd.certificate),
                    "adaptive spec: sharded answer differs from the local one")
            rep = sess.update(inserts=(np.array([u]), np.array([int(nodes[3])])))
            sess.query(QuerySpec(kind="topk", node=int(nodes[3]), k=50, key=9))
            require(rep.applied == 1 and sess.version == 1
                    and be._epoch_graph is not st, "sharded update()")
            shard_state_equals_rebuild(be)
            log(f"sharded {label}: adaptive eps 0.1 bitwise equal to the local "
                f"session's ({a_shd.walks_used} walks, {a_shd.rounds} rounds, "
                f"{a_shd.certificate}); update() of 1 insert rebuilt the "
                f"device state, equal to the rebuild")
        del sess, be, st, envs, first
        torch.cuda.empty_cache()

    shard_service(h, launches)

    # --- 16 mixed epochs at 4 blocks, phase 5's ops ------------------------
    src, dst = h.to_host_edges()
    m = len(src)
    mesh = ShardMesh([SHARD_DEV] * SHARD_S)
    rows = -(-n // SHARD_S)
    live = int(np.bincount(dst // rows, minlength=SHARD_S).max())
    state = ShardedGraphState(src, dst, n, shards=SHARD_S,
                              capacity_per_shard=live + m // SHARD_S)
    sess = SimRankSession(
        ShardedBackend(state, params=params, mesh=mesh, walk_chunk=SHARD_W),
        batch_q=8, update_batch=64, top_k=50, seed=0)
    be = sess.backend
    st = be._epoch_graph_state()
    host = HostEdges(src, dst, n, capacity=1 << 40, k_max=st.k_max)
    deg = host.in_deg()
    hub = int(np.argmax(deg))
    rng = np.random.default_rng(16)
    short = int(rng.choice(np.flatnonzero((deg >= 1) & (deg <= 16))))
    run_epoch = epoch_runner(sess, launches)

    def queue(s, d, ins):
        for flag in (False, True):  # deletes first: no insert->delete cut
            sel = ins == flag
            if sel.any():
                sess.queue_update(s[sel], d[sel], insert=flag)

    def same_edges():
        bs, bd = be.to_host_edges()
        a = np.sort(bs.astype(np.int64) * n + bd)
        b = np.sort(host.src.astype(np.int64) * n + host.dst)
        require(np.array_equal(a, b), "sharded edges differ from the host replay")

    walls = []
    for e in range(1, DYN_EPOCHS + 1):
        ds, dd = pick_deletes(rng, host, hub, 8, 24)
        is_ = rng.integers(0, n, 32).astype(np.int32)
        id_ = rng.integers(0, n, 32).astype(np.int32)
        id_[:4] = hub
        if e <= 8:
            id_[4:24] = short
        s = np.concatenate([ds, is_]).astype(np.int32)
        d = np.concatenate([dd, id_]).astype(np.int32)
        ins = np.arange(64) >= 32
        want = host.apply(s, d, ins)
        queue(s, d, ins)
        tickets = [sess.submit(int(u)) for u in
                   rng.choice(np.flatnonzero(host.in_deg() >= 1), 8,
                              replace=False)]
        ep, got, wall, _ = run_epoch()
        require(ep.updates_submitted == 64 and np.array_equal(got[:64], want),
                f"sharded epoch {e}: applied mask differs from the host replay")
        require(ep.version == host.batches == e and not ep.overflow,
                f"sharded epoch {e}: version {ep.version} overflow "
                f"{ep.overflow}")
        require(len(ep.results) == 8
                and ep.results[0].variant == "sharded[spmd]",
                f"sharded epoch {e}: results")
        walls.append(wall)
        if e in DYN_CHECKED:
            shard_state_equals_rebuild(be)
            same_edges()
        if e == DYN_EPOCHS:
            # the epoch's answers against a serve of the same queries, same
            # seeds, on the state the epoch wrote (another lane layout)
            seeds = [derive_seed(sess.seed, t.seq) for t in tickets]
            _, idx, vals = be.serve_batch("topk", [t.spec.node for t in tickets],
                                          seeds, k=50, n_r=params.n_r)
            diff = max(topk_agree(r, _TopK(i, v), FP32_RTOL)
                       for r, i, v in zip(ep.results, idx, vals))
            log(f"sharded epoch {e}: top-k vs a serve on the written state, "
                f"same seeds: max |diff| {diff:.3e}")
    log(f"sharded epochs: {DYN_EPOCHS} of 64 ops (32 deletes, 32 inserts) + 8 "
        f"top-k queries at {SHARD_S} blocks; epoch wall ms {np.mean(walls):.2f} "
        f"mean ({min(walls):.2f} .. {max(walls):.2f}); every block equal to "
        f"the rebuild after epochs {DYN_CHECKED}")

    # forced overflow: one insert past the hub row's room
    room = st.k_max - int(host.in_deg()[hub])
    s0 = int(rng.integers(0, n))
    sess.queue_update(np.full(room + 1, s0), np.full(room + 1, hub))
    eps = []
    while sess.pending[0]:
        ep, got, wall, _ = run_epoch()
        k = ep.updates_submitted
        want = host.apply(np.full(k, s0), np.full(k, hub), np.ones(k, bool))
        require(np.array_equal(got[:k], want) and ep.version == host.batches,
                f"overflow epoch {len(eps) + 1}: applied mask or version")
        if ep.regrown:
            host.k_max = max(int(host.in_deg().max()) + 8, 16)  # the rebuild's
        eps.append(ep)
    require(sum(ep.regrown for ep in eps) == 1 and sess.stats.regrows == 1
            and sum(ep.updates_applied for ep in eps) == room + 1
            and not sess.overflow,
            f"forced overflow: {[ep.regrown for ep in eps]} regrown, "
            f"{sess.stats.regrows} regrows")
    sess.submit(int(nodes[0]))
    ep, _, wall, _ = run_epoch()
    st = be._epoch_graph
    shard_state_equals_rebuild(be)
    same_edges()
    log(f"sharded forced overflow: {room + 1} inserts into the hub row "
        f"({room} fit), {len(eps)} update-only epochs, 1 regrow: capacity per "
        f"shard {be.state.capacity_per_shard}, K {st.k_max}; blocks equal to "
        f"the rebuild; a serve epoch after it {wall:.2f} ms")
    del sess, be, st, state
    torch.cuda.empty_cache()
    log(f"shard phase: {time.perf_counter() - t_phase:.1f} s; launches in its "
        f"counted windows {launches}; card: {card()}")
    require(launches["lane_probe"] > 0, "the shard phase launched no lane_probe")
    return launches


# ---------------------------------------------------------------------------
# The production serve step (the probesim arch family) at a Twitter-shaped cut
# ---------------------------------------------------------------------------

# The probesim CONFIG is the paper's Twitter graph (Table 3: n 41,652,230,
# m 1,468,365,182).  One change, of scale only:
# - n and m cut by PROD_CUT = 32 (powerlaw_graph(1,301,632, 45,886,412,
#   seed=0); the generator's dedup keeps about 7.5 edges a node, so about
#   9.7 M).  The reason is one card's memory for serve_batch: its step
#   carries a [n_pad, Q * walk_chunk] = [n_pad, 2,048] fp32 frontier, 341 GB
#   at the full n and 10.66 GB at the cut.  The step's peak, computed from
#   the code: the frontier, the push accumulator and its weighted copy, and
#   one 268 MB gathered slice (GATHER_BUDGET_BYTES): about 32 GB at 1
#   block, about 35 GB at 4 blocks on one card (the all-gathered copy), so
#   the cut is the largest power of two under 70 GB.
# The shapes (serve_batch: 8 queries x 256 walks; serve_online: 1 x 256),
# c, eps_a, delta and max_len (12: make_params at the cut n, as at the full
# n) are the config's.
PROD_CUT = 32
PROD_N = 41_652_230 // PROD_CUT
PROD_M = -(-1_468_365_182 // PROD_CUT)
PROD_S = 4  # blocks of the 4-block cells, all on the one card
PROD_REPS = 3
PROD_PEAK_LIMIT = 70e9  # bytes: above this the cut goes to 1/64
# ring bf16 against the fp32 step, relative to the query's largest score:
# a bf16 frontier keeps 8 bits of mantissa (2^-8 = 3.9e-3 a rounding) and
# the rounding is repeated over the 11 levels
PROD_BF16_RTOL = 1e-2


def exchange_bytes(shards: int, n_pad: int, cols: int, wire_bytes: int) -> int:
    """Bytes a level exchanges between S blocks (computed): the all-gather
    hands each block the S - 1 others, the ring passes each block S - 1
    times, so both move (S - 1) x [n_pad, C] in the wire dtype.  On one
    card the all-gather is one torch.cat and a ring pass a list rotation."""
    return (shards - 1) * n_pad * cols * wire_bytes


def local_estimates(g, walks, queries: int, walk_chunk: int, sqrt_c: float,
                    cols: int = 128):
    """The plain local check of a step's estimates: ``probe_walks_telescoped``
    over the COO ``Graph`` on the same walks, ``cols`` walk columns at a time
    (its COO push gathers [m, cols] messages), each query's columns summed
    and divided by ``walk_chunk``.  Returns est [n, Q] fp32."""
    import torch

    from repro_torch.core.probe import probe_walks_telescoped

    n = g.n
    walks = walks.clamp(max=n)  # the local probe's sentinel is n
    est = torch.zeros((n, queries), device=g.device)
    for a in range(0, walks.shape[0], cols):
        part = probe_walks_telescoped(g, walks[a : a + cols], sqrt_c=sqrt_c)
        q = a // walk_chunk
        est[:, q] += part.sum(dim=1)
        del part
    return est / walk_chunk


def production_cell(name, bundle, g, queries, uniforms, seed, *, cols,
                    exch: int, bound: float) -> tuple:
    """One bundle's step: the checked call on ``uniforms`` (it also warms),
    then PROD_REPS synchronized steps on the bundle's own draws (seeds);
    logs ms per step, steps/s, queries/s, MODEL_FLOPS/s, the peak, the
    computed exchange and the step's byte bound (``bound`` ms).  Returns
    the checked call's (idx, vals) and ms."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    idx, vals = bundle.step(g, dict(queries=queries, seed=seed),
                            uniforms=uniforms)
    torch.cuda.synchronize()
    times = []
    for r in range(PROD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bundle.step(g, dict(queries=queries, seed=seed + 1 + r))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        require(out[0].shape == idx.shape and bool(torch.isfinite(out[1]).all()),
                f"{name}: step {r} output")
        del out
    peak = torch.cuda.max_memory_allocated() - base
    ms = sum(times) / len(times)
    q = queries.numel()
    log(f"  {name}: {ms:.2f} ms/step (reps {', '.join(f'{t:.2f}' for t in times)}), "
        f"{1e3 / ms:.3f} steps/s, {q * 1e3 / ms:.2f} queries/s, "
        f"{bundle.model_flops() / (ms / 1e3) / 1e12:.4f} TFLOP/s of model_flops "
        f"({bundle.model_flops():.4g} a step), peak {peak / 1e9:.2f} GB above "
        f"the graphs, exchange {exch / 1e9:.2f} GB/level computed, "
        f"{cols} columns; byte bound {bound:.2f} ms ({ms / bound:.1f}x)")
    require(peak < PROD_PEAK_LIMIT, f"{name}: peak {peak / 1e9:.1f} GB")
    require(idx.shape == (q, 50) and bool(torch.isfinite(vals).all()),
            f"{name}: top-k {tuple(idx.shape)}")
    return idx.cpu(), vals.cpu(), ms


def untied_count(vals, tol: float) -> int:
    """How many top-k places ``topk_agree`` compares ids at: those whose
    score is further than ``2 * tol`` from both neighbours in its row."""
    import numpy as np

    v = np.asarray(vals, np.float64)
    gaps = np.abs(np.diff(v, axis=1)) > 2 * tol
    untied = np.ones(v.shape, bool)
    untied[:, :-1] &= gaps
    untied[:, 1:] &= gaps
    return int(untied.sum())


def production_phase(dev) -> dict:
    """The paper's production serve step (``arch.build_with_cfg("probesim",
    ...)``) on a Twitter-shaped graph (the probesim CONFIG cut by
    PROD_CUT): serve_batch and serve_online, the all-gather step at 1 and
    PROD_S blocks and the ring step at PROD_S blocks in fp32 and bf16, all
    on the card.  Walks bitwise equal to the sampler on the CPU; relative
    to each query's largest score, estimates within 1e-5 of the plain local probe
    on the same walks, 4 blocks within 1e-5 of 1, the ring within 1e-5
    (bf16 PROD_BF16_RTOL) of the all-gather step, ids equal where untied;
    one profiled serve_batch step; the smoke bundles.  The step launches
    none of the four kernels; returns their (zero) launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import arch
    from repro_torch.configs.base import get_config, shapes_for
    from repro_torch.core.distributed import (
        build_sharded_graph,
        csr_uniforms,
        walks_from_uniforms_csr,
    )
    from repro_torch.core.params import make_params
    from repro_torch.core.ring import build_ring_graph
    from repro_torch.core.walks import make_generator
    from repro_torch.graph import graph_from_edges, powerlaw_graph
    from repro_torch.launch.mesh import ShardMesh

    t_phase = time.perf_counter()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    src, dst, n = powerlaw_graph(PROD_N, PROD_M, seed=0)
    gen_s = time.perf_counter() - t0
    deg = np.bincount(dst, minlength=n)
    hub = int(deg.argmax())
    log(f"production graph (probesim CONFIG / {PROD_CUT}): n={n} m={len(src)} "
        f"(asked {PROD_M}), largest in-degree {int(deg[hub])} at node {hub}; "
        f"generated in {gen_s:.1f} s on the host")
    cfg = dataclasses.replace(get_config("probesim"), name="probesim-twitter/32",
                              n=n, m=len(src))
    params = make_params(n, c=cfg.c, eps_a=cfg.eps_a, delta=cfg.delta)
    require(params.max_len == 12, f"max_len {params.max_len}")
    sqrt_c = params.sqrt_c
    meshes = {1: ShardMesh([dev]), PROD_S: ShardMesh([dev] * PROD_S)}
    graphs = {}
    for key, build in (
            ("auto1", lambda: build_sharded_graph(src, dst, n, mesh=meshes[1],
                                                  pad_nodes=128, pad_edges=4096)),
            ("auto4", lambda: build_sharded_graph(src, dst, n, mesh=meshes[PROD_S],
                                                  pad_nodes=128, pad_edges=4096)),
            ("ring4", lambda: build_ring_graph(src, dst, n, mesh=meshes[PROD_S],
                                               csr=True))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphs[key] = build()
        torch.cuda.synchronize()
        log(f"  graph {key}: built on the card in {time.perf_counter() - t0:.2f} s")
    n_pad = graphs["auto1"].n_pad
    require(n_pad == graphs["ring4"].n_pad == n == PROD_N, f"n_pad {n_pad}")
    cpu_sg = build_sharded_graph(src, dst, n, mesh=ShardMesh(["cpu"]),
                                 pad_nodes=128, pad_edges=4096)
    coo = graph_from_edges(src, dst, n, device=dev)
    cand = np.flatnonzero(deg >= 1)
    picked = np.random.default_rng(0).choice(cand, 8, replace=False)
    variants = {"auto1": (cfg, 1), "auto4": (cfg, PROD_S),
                "ring4 fp32": (dataclasses.replace(cfg, push_mode="ring"), PROD_S),
                "ring4 bf16": (dataclasses.replace(cfg, push_mode="ring",
                                                   frontier_dtype="bfloat16"),
                               PROD_S)}
    rows = {}
    for si, shape in enumerate(shapes_for("probesim")):
        q, b = shape.dims["queries"], shape.dims["walk_chunk"]
        queries = torch.tensor(picked[:q], dtype=torch.int32, device=dev)
        cont, pick = csr_uniforms(make_generator(100 + si, dev), walks=q * b,
                                  max_len=params.max_len, sqrt_c=sqrt_c,
                                  device=dev)
        walks = walks_from_uniforms_csr(graphs["auto1"], queries, cont, pick)
        ref_walks = walks_from_uniforms_csr(cpu_sg, queries.cpu(), cont.cpu(),
                                            pick.cpu())
        require(torch.equal(walks.cpu(), ref_walks),
                f"{shape.name}: card walks differ from the CPU's")
        for key in ("auto4", "ring4"):
            require(torch.equal(walks_from_uniforms_csr(graphs[key], queries,
                                                        cont, pick), walks),
                    f"{shape.name}: {key} walks differ")
        sample_ms = {}
        for key in ("auto1", "auto4"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            walks_from_uniforms_csr(graphs[key], queries, cont, pick)
            torch.cuda.synchronize()
            sample_ms[key] = (time.perf_counter() - t0) * 1e3
        live = int((walks[:, 1:] < n).sum())
        log(f"{shape.name} (Q {q} x {b} walks, {params.max_len - 1} levels): "
            f"walks equal to the CPU sampler's bit for bit ({live} live steps); "
            f"the CSR sampler {sample_ms['auto1']:.2f} ms at 1 block, "
            f"{sample_ms['auto4']:.2f} ms at {PROD_S} (warm, synchronized)")
        out = {}
        for name, (vcfg, s) in variants.items():
            bundle = arch.build_with_cfg("probesim", vcfg, shape, mesh=meshes[s])
            g = graphs["ring4" if name.startswith("ring") else
                       ("auto4" if s > 1 else "auto1")]
            wire = 2 if vcfg.frontier_dtype == "bfloat16" else 4
            # least bytes a step moves: each level reads the frontier and
            # writes the next once, and reads the edges (src, dst) once
            level = 2 * n_pad * q * b * wire + len(src) * 8
            old_bound = byte_bound_ms((params.max_len - 1) * level)
            out[name] = production_cell(
                f"{shape.name} {name}", bundle, g, queries, (cont, pick),
                1000 * si, cols=q * b,
                exch=exchange_bytes(s, n_pad, q * b, wire), bound=old_bound)
            count_cut(f"production {shape.name} {name}", bundle, g, queries,
                      (cont, pick), out[name][2], old_bound)
            if name == "auto1" and si == 0:
                profile("serve_batch step (auto, 1 block)",
                        lambda: bundle.step(g, dict(queries=queries, seed=7)))
            del bundle
        # the plain local check on the same walks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = local_estimates(coo, walks, q, b, sqrt_c)
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        idx1, vals1, _ = out["auto1"]
        # the estimates are small on this graph (the hub takes most walks)
        # and differ by orders of magnitude between queries, so every limit
        # is relative to the query's largest score: fp32 at FP32_RTOL of
        # it, bf16 at PROD_BF16_RTOL of it; the ids are then compared
        # wherever two scores are further apart than twice the limit
        scale = vals1.abs().amax(dim=1).double()  # [Q]
        require(bool((scale > 0).all()), f"{shape.name}: a query scored 0")
        got = est.cpu()[idx1.long(), torch.arange(q)[:, None]]
        lerr = float(((got - vals1).abs().amax(dim=1) / scale).max())
        require(lerr <= FP32_RTOL, f"{shape.name}: step vs local probe {lerr} "
                f"of the query's largest score")
        est[queries.long(), torch.arange(q, device=dev)] = float("-inf")
        lvals, lidx = torch.topk(est.T, 50)

        def rel_agree(idx, vals, ref_idx, ref_vals, rtol):
            """Largest top-k difference over the queries, relative to each
            query's largest score (``topk_agree`` at rtol of it)."""
            return max(topk_agree(_TopK(idx[j].numpy(), vals[j].numpy()),
                                  _TopK(ref_idx[j].numpy(), ref_vals[j].numpy()),
                                  rtol * float(scale[j])) / float(scale[j])
                       for j in range(q))

        lagree = rel_agree(idx1, vals1, lidx.cpu(), lvals.cpu(), FP32_RTOL)
        errs = {}
        for name, rtol in (("auto4", FP32_RTOL), ("ring4 fp32", FP32_RTOL),
                           ("ring4 bf16", PROD_BF16_RTOL)):
            idx, vals, _ = out[name]
            errs[name] = rel_agree(idx, vals, idx1, vals1, rtol)
        untied = {k: sum(untied_count(vals1[j : j + 1], r * float(scale[j]))
                         for j in range(q))
                  for k, r in (("fp32", FP32_RTOL), ("bf16", PROD_BF16_RTOL))}
        log(f"  {shape.name}, relative to each query's largest score "
            f"({float(scale.min()):.4e} to {float(scale.max()):.4e}): step vs "
            f"plain local probe (probe_walks_telescoped over the COO graph, "
            f"{check_s:.2f} s) {lerr:.3e} at the top-k, top-k {lagree:.3e}; "
            f"ids compared at {untied['fp32']} (fp32) and {untied['bf16']} "
            f"(bf16) of {vals1.numel()} places; against auto1: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; top-1 of query 0: node {int(idx1[0, 0])} "
            f"{float(vals1[0, 0]):.4e}")
        rows[shape.name] = {k: v[2] for k, v in out.items()}
        del est, walks, out
        torch.cuda.empty_cache()
    # the smoke bundles through build(), init and step on the card
    for shape in ("serve_batch", "serve_online"):
        bundle = arch.build("probesim", shape, smoke=True, device="cuda")
        (g,) = bundle.init()
        idx, vals = bundle.step(g, dict(queries=torch.tensor([1, 2]), seed=0))
        require(idx.device.type == dev.type and idx.shape == (2, 50)
                and bool(torch.isfinite(vals).all()), f"smoke {shape}")
    launches = {k: fn.launches for k, fn in counters.items()}
    require(not any(launches.values()),
            f"the production step launched a kernel: {launches}")
    del graphs, coo, cpu_sg
    torch.cuda.empty_cache()
    log(f"production phase: {time.perf_counter() - t_phase:.1f} s "
        f"(ms/step {rows}); launches {launches}; card: {card()}")
    return launches


STREAM_N = 34_546
STREAM_RATE = 20_000 * STREAM_N // 2_000
STREAM_HORIZON = 1.0
STREAM_HANDLE = dict(capacity=1 << 19, k_max=256)
STREAM_DRIVER = dict(tick_s=0.05, update_burst=512, k=10, budget_walks=512)
STREAM_UPDATE_BATCH = 512
STREAM_SLO_P99_S = 0.5  # the bench's full-config SLO (printed, not gated)


def changing_batches(backend) -> list:
    """Count, on ``backend``, the update batches that changed the graph
    (any op applied), whichever path applies them: the expected version."""
    count = [0]
    for name in ("apply_ops", "epoch_batch"):
        real = getattr(type(backend), name)
        ref = weakref.ref(backend)

        def wrapped(*a, _real=real, _name=name, **kw):
            out = _real(ref(), *a, **kw)
            applied = out if _name == "apply_ops" else out[0]
            count[0] += bool(applied.any())
            return out

        setattr(backend, name, wrapped)
    return count


def live_window(stream, ttl: float, now: float):
    """The live edges (arrival order) of ``stream`` at virtual time ``now``
    under ``ttl``: an expirer replayed independently of the driver's."""
    from repro_torch.streams import SlidingWindowExpirer

    ex = SlidingWindowExpirer(ttl)
    j = int(stream.t.searchsorted(now, side="right"))
    ex.ingest(stream.t[:j], stream.src[:j], stream.dst[:j])
    ex.expire_until(now)
    return ex.live_edges()


def stream_checks(what, rep, h, batches, stream, ttl, tick_s, final, dev):
    """The gates of one run: every op applied, no sticky overflow, and the
    mirrors bitwise equal to a rebuild of the live window."""
    require(rep.updates_applied == rep.arrivals + rep.expired,
            f"{what}: applied {rep.updates_applied} != arrivals "
            f"{rep.arrivals} + expired {rep.expired}")
    require(not rep.sticky_overflow, f"{what}: sticky overflow")
    n_ticks = rep.ticks
    now = n_ticks * tick_s + (ttl if final else 0.0)
    src, dst = live_window(stream, ttl, now)
    require(len(src) == rep.final_live_edges == h.num_edges,
            f"{what}: live {len(src)}, report {rep.final_live_edges}, "
            f"handle {h.num_edges}")
    host = HostEdges(src, dst, h.n, h.capacity, h.k_max)
    host.batches = batches[0]
    mirrors_equal_rebuild(h, host, dev)


def stream_log(what, rep, sess_stats=None) -> None:
    log(f"  {what}: {rep.ticks} ticks, {rep.arrivals} arrivals, "
        f"{rep.expired} expired, {rep.updates_applied} applied in "
        f"{rep.update_steps} update steps, {rep.queries} queries in "
        f"{rep.duration_s:.2f} s ({rep.qps:.1f} queries/s); staleness p50 "
        f"{rep.staleness_p50_s * 1e3:.1f} ms, p99 {rep.staleness_p99_s * 1e3:.1f}"
        f" ms (SLO {STREAM_SLO_P99_S * 1e3:.0f} ms met: {rep.slo_met}); version"
        f" lag p50 {rep.version_lag_p50:.0f}, p99 {rep.version_lag_p99:.0f} "
        f"ops; 429s {rep.rejected_429}; live at the end {rep.final_live_edges}"
        + ("" if sess_stats is None else
           f"; epochs {sess_stats.epochs}, regrows {sess_stats.regrows}"))


def sharded_stream_leg(n, rate, horizon, slo, empty, launches, dev) -> None:
    """bench_stream's sharded leg: the steady scenario at half the rate for
    half the horizon, through drains, over 4 row blocks of ``dev``; every
    op applied and the live edges equal to the window's."""
    import numpy as np
    import torch

    from repro_torch.api import SimRankSession
    from repro_torch.launch.mesh import ShardMesh
    from repro_torch.streams import (
        SessionTransport,
        StreamDriver,
        poisson_edge_stream,
    )

    stream = poisson_edge_stream(n, rate=rate // 2, horizon=horizon / 2,
                                 seed=0)
    sess = SimRankSession(empty(), c=0.6, top_k=10, batch_q=4, seed=0,
                          update_batch=STREAM_UPDATE_BATCH, backend="sharded",
                          mesh=ShardMesh([dev] * SHARD_S))
    drv = StreamDriver(SessionTransport(sess, mode="drain"), stream, ttl=0.5,
                       queries_per_tick=1, slo=slo, seed=0, **STREAM_DRIVER)
    rep = counted(drv.run, launches)
    torch.cuda.synchronize()
    require(rep.updates_applied == rep.arrivals + rep.expired
            and not rep.sticky_overflow and rep.queries > 0,
            f"sharded stream: {rep.updates_applied} applied, {rep.arrivals} "
            f"arrivals, {rep.expired} expired")
    src, dst = live_window(stream, 0.5, rep.ticks * STREAM_DRIVER["tick_s"])
    hs, hd = sess.backend.to_host_edges()
    require(np.array_equal(np.sort(src.astype(np.int64) * n + dst),
                           np.sort(hs.astype(np.int64) * n + hd)),
            "sharded stream: live edges differ from the window's")
    stream_log(f"steady over {SHARD_S} blocks (TTL 0.5 s, drain, half rate "
               f"and horizon: {len(stream)} arrivals)", rep, sess.stats)
    del sess, drv
    torch.cuda.empty_cache()


def stream_phase(dev) -> dict:
    """``StreamDriver`` on the card at HepPh's node count, the four scenarios
    of benchmarks/bench_stream.py: steady (TTL 0.5 s) and turnover (TTL of
    two ticks, retired with ``final_expire``) through
    ``SessionTransport(mode="epoch")``, bursty (on/off at twice the rate,
    TTL 0.3 s) through ``ServiceTransport``, and pooled (TTL 0.5 s,
    ``mode="drain"``, three checkpoints), and the bench's sharded leg
    (steady at half the rate and horizon, drains, 4 row blocks); each run's
    mirrors held against a rebuild of its live window (the sharded leg's
    live edges against the window).  Returns each kernel's launches in the
    runs."""
    import numpy as np
    import torch

    from repro_torch.api import GraphHandle, SimRankSession
    from repro_torch.serving import ServiceConfig, SimRankService
    from repro_torch.streams import (
        FreshnessSLO,
        ServiceTransport,
        SessionTransport,
        StreamDriver,
        bursty_edge_stream,
        poisson_edge_stream,
    )

    launches = dict.fromkeys(kernel_counters(), 0)
    t_phase = time.perf_counter()
    n, rate, horizon = STREAM_N, STREAM_RATE, STREAM_HORIZON
    tick_s, budget = STREAM_DRIVER["tick_s"], STREAM_DRIVER["budget_walks"]
    slo = FreshnessSLO(staleness_p99_s=STREAM_SLO_P99_S)
    e = np.empty(0, np.int32)

    def empty():
        return GraphHandle.from_edges(e, e, n, device=dev, **STREAM_HANDLE)

    def session():
        return SimRankSession(empty(), c=0.6, top_k=10, batch_q=4, seed=0,
                              update_batch=STREAM_UPDATE_BATCH)

    stream = poisson_edge_stream(n, rate=rate, horizon=horizon, seed=0)
    log(f"stream phase (bench_stream full config, n {n}, rate {rate} edges/s, "
        f"horizon {horizon} s, {STREAM_HANDLE}, update_batch "
        f"{STREAM_UPDATE_BATCH}): {len(stream)} arrivals; {STREAM_DRIVER}")
    n_ticks = int(np.ceil(horizon / tick_s))
    runs = (  # name, mode, ttl, final_expire, driver extras
        ("steady", "epoch", 0.5, False, dict(queries_per_tick=2)),
        ("turnover", "epoch", 2 * tick_s, True, dict(queries_per_tick=2)),
        ("pooled", "drain", 0.5, False, dict(
            queries_per_tick=1, checkpoint_every=max(1, n_ticks // 3),
            checkpoint_queries=4, expert_r=20_000, fresh_budget=8_192,
            budget_walks=max(budget, 1_024))),
    )
    for what, mode, ttl, final, extra in runs:
        sess = session()
        batches = changing_batches(sess.backend)
        drv = StreamDriver(SessionTransport(sess, mode=mode), stream, ttl=ttl,
                           slo=slo, seed=0, **dict(STREAM_DRIVER, **extra))
        rep = counted(lambda: drv.run(final_expire=final), launches)
        torch.cuda.synchronize()
        stream_checks(what, rep, sess.handle, batches, stream, ttl, tick_s,
                      final, dev)
        stream_log(f"{what} (TTL {ttl} s, {mode})", rep, sess.stats)
        for cp in rep.checkpoints:
            log(f"    checkpoint t={cp.t:.2f} s: {cp.live_edges} live edges, "
                f"{cp.queries} queries, pool {cp.pool_size:.1f}, precision@10 "
                f"{cp.precision_at_k:.4f}, NDCG@10 {cp.ndcg_at_k:.4f}")
        del sess, drv
    bstream = bursty_edge_stream(n, rate_on=2 * rate, mean_on=0.15,
                                 mean_off=0.3, horizon=horizon, seed=1)
    with SimRankService(
        empty(),
        config=ServiceConfig(batch_window_ms=2.0, max_batch_q=4,
                             default_budget_walks=budget),
        session_kwargs=dict(c=0.6, top_k=10,
                            update_batch=STREAM_UPDATE_BATCH),
    ) as svc:
        sess = svc.session("stream")
        # updates apply through the default tenant's session, on the
        # handle every tenant shares
        batches = changing_batches(svc.session().backend)
        drv = StreamDriver(ServiceTransport(svc, tenant="stream"), bstream,
                           ttl=0.3, queries_per_tick=2, slo=slo, seed=0,
                           **STREAM_DRIVER)
        rep = counted(drv.run, launches)
        torch.cuda.synchronize()
        require(svc.stats.errors_5xx == 0 and svc.stats.served >= rep.queries,
                f"bursty service counters {svc.stats}")
        stream_checks("bursty", rep, sess.handle, batches, bstream, 0.3,
                      tick_s, False, dev)
        stream_log(f"bursty via the service (TTL 0.3 s, {len(bstream)} "
                   f"arrivals, on at {2 * rate} edges/s)", rep, sess.stats)
    torch.cuda.empty_cache()
    sharded_stream_leg(n, rate, horizon, slo, empty, launches, dev)
    require(launches["lane_probe"] > 0,
            f"the stream runs launched no lane_probe: {launches}")
    log(f"stream phase: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{launches}; card: {card()}")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: the LM path at full width
# ---------------------------------------------------------------------------


def logits_agree(out, ref, what: str) -> tuple[float, float]:
    """bf16-compute logits: max |out - ref| <= LM_TOL * max(1, max |ref|).
    Returns that difference and the share of rows whose argmax agrees."""
    o, r = out.float(), ref.float()
    scale = max(1.0, float(r.abs().max()))
    err = float((o - r).abs().max())
    require(err <= LM_TOL * scale, f"{what}: logits differ by {err} (scale {scale})")
    return err, float((o.argmax(dim=-1) == r.argmax(dim=-1)).float().mean())


def cut(shape, **dims):
    from repro_torch.configs import ShapeSpec

    return ShapeSpec(shape.name, shape.kind, {**shape.dims, **dims})


def lm_phase(dev) -> int:
    """Llama-3.2-1B at full width through ``repro_torch.arch``; returns the
    flash launches of the LM path's window (one prefill + 16 decode steps)."""
    import torch

    from repro_torch import arch
    from repro_torch.configs import get_config, shapes_for
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.lane_probe.ops import lane_probe_level
    from repro_torch.kernels.probe_push.ops import probe_push
    from repro_torch.kernels.spmm_ell.ops import spmm_ell_padded
    from repro_torch.models.transformer import model as M

    cfg = get_config("llama3.2-1b")
    shapes = {s.name: s for s in shapes_for("llama3.2-1b")}
    pre = arch.build_with_cfg("llama3.2-1b", cfg,
                              cut(shapes["prefill_32k"], global_batch=1), device=dev)
    pre_off = arch.build_with_cfg("llama3.2-1b", cfg, pre.shape, use_kernel=False,
                                  device=dev)
    dec = arch.build_with_cfg("llama3.2-1b", cfg,
                              cut(shapes["decode_32k"], global_batch=8), device=dev)
    S = pre.shape.dims["seq_len"]
    Bd, Sd = dec.shape.dims["global_batch"], dec.shape.dims["seq_len"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    model, caches = dec.init(gen)
    cache_gb = sum(c["k"].numel() + c["v"].numel() for c in caches) * 2 / 1e9
    n_params = sum(p.numel() for p in model.parameters())
    n_norms = (2 * cfg.n_layers + 1) * cfg.d_model  # not in params_dense
    require(n_params == cfg.params_dense + n_norms,
            f"{n_params} params, config says {cfg.params_dense} + {n_norms} norms")
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=dev,
                           dtype=torch.int32)
    first = torch.randint(0, cfg.vocab, (Bd,), generator=gen, device=dev,
                          dtype=torch.int32)
    log(f"llama3.2-1b: {n_params} params (bf16), decode cache {Bd} x {Sd} x "
        f"{cfg.n_layers} layers = {cache_gb:.2f} GB; prefill 1 x {S} tokens")
    with torch.inference_mode():
        pre.step(model, dict(tokens=tokens[:, :1024]))  # warm the libraries
        torch.cuda.synchronize()

        # --- the LM path, with every launch counter read around it --------
        for fn in (flash_attention, lane_probe_level, spmm_ell_padded, probe_push):
            fn.launches = 0
        flash_attention.tc_launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = pre.step(model, dict(tokens=tokens))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = flash_attention.launches
        prefill_tc = flash_attention.tc_launches
        prefill_peak = torch.cuda.max_memory_allocated() / 1e9
        tok = first
        step_s = []
        for t in range(16):
            pos = torch.full((Bd,), t, dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            caches, dlog = dec.step(model, caches, dict(tokens=tok, positions=pos))
            tok = dlog.argmax(dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            require(bool(torch.isfinite(dlog).all()), f"decode step {t} logits")
        launches = {"flash_attention": flash_attention.launches,
                    "lane_probe": lane_probe_level.launches,
                    "spmm_ell": spmm_ell_padded.launches,
                    "probe_push": probe_push.launches}
        decode_peak = torch.cuda.max_memory_allocated() / 1e9
        # -------------------------------------------------------------------

        require(logits.shape == (1, cfg.vocab) and logits.dtype == torch.float32,
                f"prefill logits {tuple(logits.shape)} {logits.dtype}")
        require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
        require(prefill_launches == cfg.n_layers,
                f"prefill launched flash {prefill_launches} times, "
                f"want one per layer ({cfg.n_layers})")
        require(prefill_tc == cfg.n_layers,
                f"{prefill_tc} of the prefill's {prefill_launches} flash launches "
                "ran on the tensor cores, want all")
        require(launches["flash_attention"] == cfg.n_layers,
                f"decode launched the flash kernel: {launches}")
        require(caches[0]["k"][:, :, 16:].abs().max() == 0
                and caches[0]["k"][:, :, :16].abs().amax(dim=(1, 3, 4)).min() > 0,
                "decode wrote the cache outside positions 0..15")
        dec_ms = sum(step_s[1:]) / len(step_s[1:]) * 1e3
        log(f"LM path: prefill {S} tokens in {prefill_s:.3f} s "
            f"({S / prefill_s:.1f} tokens/s), peak {prefill_peak:.2f} GB; "
            f"decode B={Bd} over the {Sd} cache: {dec_ms:.2f} ms per step "
            f"(steps 2-16; step 1 {step_s[0] * 1e3:.2f} ms), "
            f"{Bd / dec_ms * 1e3:.1f} tokens/s, peak {decode_peak:.2f} GB; "
            f"launches {launches}")

        # the same prefill again, outside the window: the first one above
        # also grows the allocator's pool and warms the GEMMs' 32k shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre.step(model, dict(tokens=tokens))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        log(f"LM path: second prefill of {S} tokens in {warm_s:.3f} s "
            f"({S / warm_s:.1f} tokens/s)")
        count_on_card(f"llama3.2-1b prefill of {S} tokens",
                      lambda: pre.step(model, dict(tokens=tokens)), warm_s * 1e3,
                      model_flops=pre.model_flops())

        # where the time goes: one prefill and one decode step (position 16)
        profile(f"prefill of {S} tokens", lambda: pre.step(model, dict(tokens=tokens)))
        pos = torch.full((Bd,), 16, dtype=torch.int32, device=dev)
        profile("decode step", lambda: dec.step(model, caches, dict(tokens=tok,
                                                                     positions=pos)))

        # --- kernel off: the plain chunked sdpa on the same tokens ---------
        p_ms, off = plain_ms(lambda: pre_off.step(model, dict(tokens=tokens)))
        err, _ = logits_agree(logits, off, "prefill kernel-on vs kernel-off")
        require(int(logits.argmax()) == int(off.argmax()),
                "prefill kernel-on and kernel-off pick different next tokens")
        log(f"prefill kernel-off (chunked sdpa) {p_ms / 1e3:.3f} s; on vs off: "
            f"max |diff| {err:.3e} (max |logit| {float(off.abs().max()):.3f}), "
            f"argmax {int(logits.argmax())} vs {int(off.argmax())}")
        del off, caches
        torch.cuda.empty_cache()

        # --- 64 teacher-forced decode steps against the kernel-on forward ---
        B2, T2 = 2, 64
        toks = torch.randint(0, cfg.vocab, (B2, T2), generator=gen, device=dev,
                             dtype=torch.int32)
        small = M.init_cache(cfg, B2, T2, dev)
        steps = []
        for t in range(T2):
            pos = torch.full((B2,), t, dtype=torch.int32, device=dev)
            small, lg = M.lm_decode_step(model, small, toks[:, t], pos, cfg)
            steps.append(lg)
        before = flash_attention.launches
        fwd, _ = M.lm_forward(model, toks, cfg, use_kernel=True)
        require(flash_attention.launches == before + cfg.n_layers,
                "forward did not run the flash kernel")
        err, same = logits_agree(torch.stack(steps, dim=1), fwd, "decode vs forward")
        log(f"decode vs forward ({B2} x {T2} teacher-forced steps): max |diff| "
            f"{err:.3e} (max |logit| {float(fwd.abs().max()):.3f}), argmax "
            f"equal at {same:.1%} of positions")
    del model, small
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 6b: MoE and MLA serving at full width
# ---------------------------------------------------------------------------

# the two MoE configs, Qwen first (its prefill runs the flash kernel)
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
MOE_DECODE_MAX_B = 8  # the decode batch cut (Llama's): 128 -> at most 8
MOE_MEM_SHARE = 0.85  # weights + decode cache + its transients under this share
# teacher-forced decode steps against the forward.  In bf16 the forward and
# the decode round the hidden states differently, and a top-k routing
# decision that flips moves the logits past LM_TOL: the reference's own
# SMOKE DeepSeek in bf16 with headroom gives 0.356 at max |logit| 4.66 (7.6 %)
# on the CPU, 0.070 with its MoE layers made dense.  So the check runs in
# fp32 compute over the bf16 weights, and the bf16 gap is printed.
MOE_TF_STEPS = 32


def decode_batch(cfg, s_max: int, weight_bytes: int) -> tuple[int, str]:
    """The largest decode batch up to ``MOE_DECODE_MAX_B`` whose cache, and
    the plain attention's fp32 copies of one layer's cache, fit beside the
    weights in ``MOE_MEM_SHARE`` of the card; and the reckoning."""
    import torch

    L = cfg.n_layers
    if cfg.attention == "mla":
        width = cfg.kv_lora_rank + cfg.qk_rope_head_dim  # c_kv + k_rope
        per_seq = L * s_max * width * 2
        transient = s_max * width * 4 + 2 * cfg.n_heads * s_max * 4
    else:
        width = 2 * cfg.n_kv_heads * cfg.d_head  # k + v
        per_seq = L * s_max * width * 2
        transient = s_max * width * 4
    total = torch.cuda.mem_get_info()[1]
    room = MOE_MEM_SHARE * total - weight_bytes
    b = int(min(MOE_DECODE_MAX_B, room // (per_seq + transient)))
    require(b >= 1, f"{cfg.name}: no decode batch fits ({room / 1e9:.1f} GB room)")
    why = (f"cache {per_seq / 1e9:.3f} GB + transient {transient / 1e9:.3f} GB a "
           f"sequence, {room / 1e9:.1f} GB beside {weight_bytes / 1e9:.1f} GB of "
           f"weights in {MOE_MEM_SHARE:.0%} of {total / 1e9:.1f} GB")
    return b, why


def moe_flash_shape(gen, dev, cfg, S: int) -> None:
    """flash_attention at the Qwen prefill's shape (B 1, S = T, H = Hkv, dh
    128, bf16, causal) against its plain version, timed beside the library."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention, route
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.roofline.analysis import flash_work

    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = flash_inputs(gen, dev, 1, S, S, H, Hkv, dh, torch.bfloat16)
    require(route(q.dtype, dh) == "tensor_core", "the Qwen shape left the tensor cores")
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), 3)
    out = flash_attention(q, k, v, causal=True)
    p_ms, ref = plain_ms(lambda: attention_ref(q, k, v, causal=True,
                                               probs_dtype=torch.bfloat16))
    err, widened = tc_close(out, ref, attention_ref(q, k, v.abs(), causal=True))
    del ref

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2)

    lib_ms = time_ms(library, 3)
    bound, by = bound_ms(flash_work(q.shape, k.shape, causal=True, dtype=q.dtype))
    log(f"flash_attention at {cfg.name}'s prefill shape B=1 S=T={S} H={H} Hkv={Hkv} "
        f"dh={dh} bf16 causal (tensor cores): max |diff| vs plain bf16-p {err:.3e}"
        f"{' (tc_close widened)' if widened else ' (bf16_close)'}; kernel {ms:.3f} ms, "
        f"plain {p_ms:.1f} ms, scaled_dot_product_attention {lib_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({by})")
    del q, k, v, out
    torch.cuda.empty_cache()


def teacher_forced(model, cfg, toks, use_kernel: bool, dev):
    """``toks.shape[1]`` teacher-forced decode steps against ``lm_forward``
    on the same tokens: (max |diff|, max(1, max |logit|), argmax agreement,
    the forward's aux loss).  The forward runs the flash kernel when
    ``use_kernel`` (one launch a layer, checked)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.transformer import model as M

    B, T = toks.shape
    small = M.init_cache(cfg, B, T, dev)
    steps = []
    for t in range(T):
        pos = torch.full((B,), t, dtype=torch.int32, device=dev)
        small, lg = M.lm_decode_step(model, small, toks[:, t], pos, cfg)
        steps.append(lg)
    before = flash_attention.launches
    fwd, aux = M.lm_forward(model, toks, cfg, use_kernel=use_kernel)
    require(flash_attention.launches == before + (cfg.n_layers if use_kernel else 0),
            f"{cfg.name}: the forward's flash launches")
    dec = torch.stack(steps, dim=1)
    err = float((dec - fwd).abs().max())
    same = float((dec.argmax(dim=-1) == fwd.argmax(dim=-1)).float().mean())
    return err, max(1.0, float(fwd.abs().max())), same, aux


def kernel_on_off(arch_id, cfg, shape, model, tokens, logits, dev) -> None:
    """The prefill with the flash kernel against the plain chunked ``sdpa``.
    In bf16 the two round the hidden states differently, a top-k routing
    decision that flips moves the last token's logits past LM_TOL, and at
    the published capacity a flip also moves which assignments are dropped
    (see MOE_TF_STEPS): so the check runs in fp32 compute over the same
    bf16 weights (the kernel's CUDA-core route, one launch a layer), and
    the bf16 gap (the tensor-core route's ``logits``) is printed."""
    import dataclasses

    import torch

    from repro_torch import arch
    from repro_torch.kernels.flash_attention.ops import flash_attention

    exact = dataclasses.replace(cfg, compute_dtype="float32")

    def prefill(c, use_kernel):
        bundle = arch.build_with_cfg(arch_id, c, shape, use_kernel=use_kernel, device=dev)
        return bundle.step(model, dict(tokens=tokens))

    before, tc = flash_attention.launches, flash_attention.tc_launches
    on32 = prefill(exact, True)
    require(flash_attention.launches == before + cfg.n_layers
            and flash_attention.tc_launches == tc,
            f"{arch_id}: the fp32 prefill's flash launches")
    p_ms, off32 = plain_ms(lambda: prefill(exact, False))
    err, _ = logits_agree(on32, off32, f"{arch_id} prefill kernel-on vs off (fp32 compute)")
    require(int(on32.argmax()) == int(off32.argmax()),
            f"{arch_id}: kernel on and off pick different next tokens (fp32 compute)")
    log(f"  prefill kernel on vs off in fp32 compute over the bf16 weights: max |diff| "
        f"{err:.3e} (max |logit| {float(off32.abs().max()):.3f}), argmax "
        f"{int(on32.argmax())} vs {int(off32.argmax())}; kernel-off {p_ms / 1e3:.3f} s")
    del on32, off32
    p_ms, off = plain_ms(lambda: prefill(cfg, False))
    err = float((logits - off).abs().max())
    log(f"  the same in bf16 compute, the tensor-core route against the plain path "
        f"(printed, not checked): max |diff| {err:.3e} ({err / float(off.abs().max()):.2%} "
        f"of max |logit|), argmax {int(logits.argmax())} vs {int(off.argmax())}; "
        f"kernel-off {p_ms / 1e3:.3f} s")


def moe_cell(arch_id: str, dev, gen) -> dict:
    """One MoE config at full width and depth through ``arch.build_with_cfg``:
    the prefill window and the decode window (counters read around each),
    the checks, and the timings.  Returns the kernels' launches of its
    windows."""
    import dataclasses
    import math

    import torch

    from repro_torch import arch
    from repro_torch.configs import get_config, shapes_for
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.lane_probe.ops import lane_probe_level
    from repro_torch.kernels.probe_push.ops import probe_push
    from repro_torch.kernels.spmm_ell.ops import spmm_ell_padded
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer import moe as moe_mod

    counters = (flash_attention, lane_probe_level, spmm_ell_padded, probe_push)
    names = ("flash_attention", "lane_probe", "spmm_ell", "probe_push")

    def zero():
        for fn in counters:
            fn.launches = 0
        flash_attention.tc_launches = 0

    def read():
        return dict(zip(names, (fn.launches for fn in counters)))

    cfg = get_config(arch_id)
    mla = cfg.attention == "mla"
    m = cfg.moe
    shapes = {s.name: s for s in shapes_for(arch_id)}
    pre = arch.build_with_cfg(arch_id, cfg, cut(shapes["prefill_32k"], global_batch=1),
                              use_kernel=not mla, device=dev)
    S = pre.shape.dims["seq_len"]
    torch.cuda.reset_peak_memory_stats()
    (model,) = pre.init(gen)
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_norms = (2 * cfg.n_layers + 1) * cfg.d_model  # not in params_dense
    require(n_params == cfg.params_dense + n_norms,
            f"{arch_id}: {n_params} params, config says {cfg.params_dense} + "
            f"{n_norms} norms")
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=dev,
                           dtype=torch.int32)
    log(f"{arch_id}: {n_params} params ({weight_bytes / 1e9:.2f} GB), "
        f"{cfg.attention} attention, {m.n_routed} experts top-{m.top_k} "
        f"(d_ff {m.d_ff_expert}, shared {m.d_ff_shared or m.n_shared * m.d_ff_expert}, "
        f"{m.first_dense_layers} dense layers first), capacity factor "
        f"{m.capacity_factor}; prefill 1 x {S} tokens "
        + ("with use_kernel=False: the flash kernel takes one head width and MLA's "
           f"q / k are {cfg.qk_nope_head_dim + cfg.qk_rope_head_dim} wide, v "
           f"{cfg.v_head_dim} (the reference's wrapper raises there too)"
           if mla else "with the flash kernel"))
    launches = dict.fromkeys(names, 0)
    with torch.inference_mode():
        pre.step(model, dict(tokens=tokens[:, :1024]))  # warm the libraries
        if mla:
            on = arch.build_with_cfg(arch_id, cfg, pre.shape, use_kernel=True, device=dev)
            try:
                on.step(model, dict(tokens=tokens[:, :1024]))
            except ValueError as e:
                log(f"  use_kernel=True refused on the card: {e}")
            else:
                require(False, f"{arch_id}: use_kernel=True ran MLA's prefill")
        torch.cuda.synchronize()

        # --- the prefill window -------------------------------------------
        zero()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = pre.step(model, dict(tokens=tokens))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        got = read()
        tc = flash_attention.tc_launches
        prefill_peak = torch.cuda.max_memory_allocated() / 1e9
        # ---------------------------------------------------------------------
        for k, v in got.items():
            launches[k] += v
        require(logits.shape == (1, cfg.vocab) and logits.dtype == torch.float32,
                f"{arch_id} prefill logits {tuple(logits.shape)} {logits.dtype}")
        require(bool(torch.isfinite(logits).all()), f"{arch_id} prefill logits not finite")
        want = 0 if mla else cfg.n_layers
        require(got["flash_attention"] == want and tc == want,
                f"{arch_id} prefill launched flash {got['flash_attention']} times "
                f"({tc} on the tensor cores), want {want}")
        require(sum(got.values()) == got["flash_attention"],
                f"{arch_id} prefill launched another kernel: {got}")

        # the same prefill again under the profiler: bitwise equal (the
        # combine has no atomics), with each MoE layer's dropped assignments
        # read off its dispatch
        drops, again = [], []
        dispatch = moe_mod.dispatch

        def counting(top_i, top_p, E, C):
            out = dispatch(top_i, top_p, E, C)
            drops.append((out[2] == E * C).sum())
            return out

        moe_mod.dispatch = counting
        try:
            profile(f"{arch_id} prefill of {S} tokens",
                    lambda: again.append(pre.step(model, dict(tokens=tokens))))
        finally:
            moe_mod.dispatch = dispatch
        require(torch.equal(logits, again[0]),
                f"{arch_id}: two prefills differ by "
                f"{float((logits - again[0]).abs().max())}")
        moe_layers = cfg.n_layers - m.first_dense_layers
        require(len(drops) == moe_layers, f"{len(drops)} MoE dispatches, want {moe_layers}")
        per_layer = torch.stack(drops).float() / (S * m.top_k)
        log(f"  prefill {S} tokens in {prefill_s:.3f} s ({S / prefill_s:.1f} tokens/s), "
            f"peak {prefill_peak:.2f} GB; launches {got} ({tc} on the tensor cores); "
            f"the profiled prefill bitwise equal; dropped at capacity factor "
            f"{m.capacity_factor} (C {moe_mod._capacity(S, cfg)}): "
            f"{float(per_layer.mean()):.4%} of the assignments (layers "
            f"{float(per_layer.min()):.4%} to {float(per_layer.max()):.4%})")
        count_on_card(f"{arch_id} prefill of {S} tokens",
                      lambda: pre.step(model, dict(tokens=tokens)), prefill_s * 1e3,
                      model_flops=pre.model_flops())
        if not mla:
            kernel_on_off(arch_id, cfg, pre.shape, model, tokens, logits, dev)
        del logits, again
        torch.cuda.empty_cache()

        # --- the decode window --------------------------------------------
        Sd = shapes["decode_32k"].dims["seq_len"]
        Bd, why = decode_batch(cfg, Sd, weight_bytes)
        dec = arch.build_with_cfg(arch_id, cfg, cut(shapes["decode_32k"], global_batch=Bd),
                                  device=dev)
        caches = M.init_cache(cfg, Bd, Sd, dev)
        cache_gb = sum(t.numel() * t.element_size() for c in caches
                       for t in c.values()) / 1e9
        log(f"  decode batch {Bd} (of {shapes['decode_32k'].dims['global_batch']}): "
            f"{why}; cache {cache_gb:.2f} GB")
        tok = torch.randint(0, cfg.vocab, (Bd,), generator=gen, device=dev,
                            dtype=torch.int32)
        zero()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for t in range(16):
            pos = torch.full((Bd,), t, dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            caches, dlog = dec.step(model, caches, dict(tokens=tok, positions=pos))
            tok = dlog.argmax(dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            require(bool(torch.isfinite(dlog).all()), f"{arch_id} decode step {t} logits")
        got = read()
        decode_peak = torch.cuda.max_memory_allocated() / 1e9
        # ---------------------------------------------------------------------
        for k, v in got.items():
            launches[k] += v
        require(sum(got.values()) == 0, f"{arch_id} decode launched a kernel: {got}")
        for layer in next(iter(caches[0].values())):  # [B, S, ...] each
            rest = tuple(range(2, layer.dim()))
            require(not bool(layer[:, 16:].any())
                    and layer[:, :16].abs().amax(dim=rest).min() > 0,
                    f"{arch_id} decode wrote the cache outside positions 0..15")
        dec_ms = sum(step_s[1:]) / len(step_s[1:]) * 1e3
        log(f"  decode B={Bd} over the {Sd} cache: {dec_ms:.2f} ms per step (steps "
            f"2-16; step 1 {step_s[0] * 1e3:.2f} ms), {Bd / dec_ms * 1e3:.1f} tokens/s, "
            f"peak {decode_peak:.2f} GB")
        pos = torch.full((Bd,), 16, dtype=torch.int32, device=dev)
        profile(f"{arch_id} decode step", lambda: dec.step(
            model, caches, dict(tokens=tok, positions=pos)))
        del caches
        torch.cuda.empty_cache()

        # --- teacher-forced decode against the forward, with headroom -------
        # at the published capacity the forward (T = 128) and a decode step
        # (T = 2) drop different assignments; at E / K none is dropped.  In
        # bf16 the two paths round h differently and some top-k routing
        # decisions flip (the reference does the same: see MOE_TF_STEPS), so
        # the check runs in fp32 compute over the same bf16 weights, and the
        # bf16 gap is printed
        head = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=float(math.ceil(m.n_routed / m.top_k))))
        toks = torch.randint(0, cfg.vocab, (2, MOE_TF_STEPS), generator=gen,
                             device=dev, dtype=torch.int32)
        exact = dataclasses.replace(head, compute_dtype="float32")
        err, scale, same, aux = teacher_forced(model, exact, toks, not mla, dev)
        require(err <= LM_TOL * scale,
                f"{arch_id} decode vs forward (fp32 compute): logits differ by {err} "
                f"(scale {scale})")
        require(bool(torch.isfinite(aux)) and float(aux) > 0,
                f"{arch_id}: aux loss {float(aux)}")
        log(f"  decode vs forward (2 x {MOE_TF_STEPS} teacher-forced steps, capacity "
            f"factor {head.moe.capacity_factor}, fp32 compute over the bf16 weights): "
            f"max |diff| {err:.3e} (max |logit| {scale:.3f}), argmax equal at "
            f"{same:.1%}; aux loss {float(aux):.6f}")
        err, scale, same, _ = teacher_forced(model, head, toks, not mla, dev)
        log(f"  the same in bf16 compute (printed, not checked): max |diff| {err:.3e} "
            f"({err / scale:.2%} of max |logit| {scale:.3f}), argmax equal at {same:.1%}")
    del model
    torch.cuda.empty_cache()
    return launches


def moe_phase(dev) -> dict:
    """Qwen1.5-MoE-A2.7B and DeepSeek-V2-Lite at full width and depth (random
    bf16 weights from a seeded generator); returns the launches of their
    prefill and decode windows."""
    import torch

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    moe_flash_shape(gen, dev, get_config(MOE_ARCHS[0]), 32768)
    launches = {}
    for arch_id in MOE_ARCHS:
        for k, v in moe_cell(arch_id, dev, gen).items():
            launches[k] = launches.get(k, 0) + v
    log(f"moe phase: {time.perf_counter() - t_phase:.1f} s; launches {launches}; "
        f"card: {card()}")
    return launches


# ---------------------------------------------------------------------------
# The roofline: the dry-run on the host, the op counter on the card
# ---------------------------------------------------------------------------

# a counted run's least time over its measured time above this means the
# counter counts work the card did not do
ROOFLINE_SHARE_LIMIT = 1.05
COUNTED: list = []  # one dict per counted run on the card
# the dry-run's records (``repro_torch.launch.dryrun``), one process each,
# counted on meta on the host while the card runs the other phases; the
# ring at 512 blocks (4 x its 256-block time) is left to the CLI
DRYRUN_CELLS = (
    ("probesim", "serve_batch", "single", ()),
    ("probesim", "serve_batch", "multi", ()),
    ("probesim", "serve_online", "both", ()),
    ("probesim", "serve_batch", "single", ("--set", "push_mode=ring", "--tag", "ring")),
    ("probesim", "serve_online", "single", ("--set", "push_mode=ring", "--tag", "ring")),
) + tuple((a, s, "both", ()) for a in ("llama3.2-1b", "yi-34b", "llama3-405b",
                                         "qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
          for s in ("prefill_32k", "decode_32k"))
DRYRUN_TIMEOUT_S = 900


def start_dryrun(out_dir: str) -> list:
    """Start every DRYRUN_CELLS cell as a niced CLI process on the host (meta
    tensors, no card); returns the processes, their commands and starts."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, mesh, extra in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", mesh, "--out", out_dir, *extra]
        procs.append((subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True,
                                       preexec_fn=lambda: os.nice(10)),
                      cmd, time.perf_counter()))
    return procs


def stop_dryrun(procs) -> None:
    for p, _, _ in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def record_count(name, ms, rep, counter, old_bound_ms=None) -> None:
    """Log one counted run beside its measured time and keep it for the
    share check."""
    h = hw()
    share = rep.roofline_s * 1e3 / ms
    top = counter.top_ops(h, 3)
    extra = (f"; the step's byte bound before the counter {old_bound_ms:.2f} ms "
             f"against its memory term {rep.memory_s * 1e3:.2f} ms"
             if old_bound_ms is not None else "")
    log(f"  roofline {name}: measured {ms:.3f} ms, least {rep.roofline_s * 1e3:.3f} "
        f"ms ({rep.bottleneck}; compute {rep.compute_s * 1e3:.3f}, memory "
        f"{rep.memory_s * 1e3:.3f}, collective {rep.collective_s * 1e3:.3f} ms), "
        f"share {share:.1%}; {counter.flops:.4g} FLOPs ({counter.tc_flops:.4g} "
        f"on tensor cores), {counter.bytes:.4g} B, collectives "
        f"{ {k: v for k, v in counter.collective_bytes.items() if v} }; most: "
        + ", ".join(f"{n} x{c} {t * 1e3:.3f} ms" for n, c, t in top) + extra)
    COUNTED.append(dict(name=name, ms=ms, share=share, top=top[0][0] if top else ""))


def count_on_card(name, fn, ms, *, model_flops=0.0):
    """Run ``fn`` once under the op counter on the card (one card: chips 1)
    and record it against ``ms``, its measured time without the counter."""
    import torch

    from repro_torch.roofline.analysis import OpCounter, analyze

    counter = OpCounter()
    torch.cuda.synchronize()
    with counter:
        fn()
    torch.cuda.synchronize()
    rep = analyze(arch=name, shape="", mesh_name="card", chips=1, counter=counter,
                  model_flops=model_flops, hw=hw())
    record_count(name, ms, rep, counter)


def count_cut(name, bundle, g, queries, uniforms, ms, old_bound_ms) -> None:
    """The production step of the cut under the counter, on the card and on
    ``meta`` (the same graph's shapes, blocks standing for cards): the two
    must count the same FLOPs, bytes and collective bytes."""
    import torch

    from repro_torch import arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ShardMesh

    inputs = dict(batch=dict(queries=queries, seed=0), uniforms=uniforms)
    torch.cuda.synchronize()
    rep, counter = dryrun.count_step(bundle, (g,), inputs, mesh_name="card",
                                     chips=1)
    torch.cuda.synchronize()
    meta = arch.build_with_cfg("probesim", bundle.cfg, bundle.shape,
                               mesh=ShardMesh(["meta"] * g.mesh.shards))
    t0 = time.perf_counter()
    _, mc = dryrun.count_step(meta, (dryrun.meta_like(g),), dryrun.meta_like(inputs),
                              mesh_name="meta", chips=1)
    require(mc.totals() == counter.totals(),
            f"{name}: meta counts {mc.totals()} != card counts {counter.totals()}")
    log(f"  {name}: the meta count equals the card's ({time.perf_counter() - t0:.1f} s "
        f"on meta); the counter's live peak {counter.peak_bytes / 1e9:.2f} GB")
    record_count(name, ms, rep, counter, old_bound_ms)


def count_hepph(h, params, nodes) -> None:
    """One drained batch of 8 (lane_probe) and one tree single_source
    (spmm_ell) on the HepPh handle: timed, then counted on the same seeds."""
    import torch

    from repro_torch.api import SimRankSession
    from repro_torch.core import single_source

    def drain():
        sess = SimRankSession(h, walk_chunk=256, batch_q=8, seed=2, own_graph=False)
        for u in nodes[:8]:
            sess.submit(u)
        return sess.drain()

    def tree():
        return single_source(7, h.eg, h.eg, nodes[0], params, variant="tree",
                             walk_chunk=256)

    for name, fn in (("hepph drain of 8 queries", drain),
                     ("hepph tree single_source", tree)):
        fn()  # warm (chunk plans)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        count_on_card(name, fn, (time.perf_counter() - t0) * 1e3)


def roofline_phase(procs, out_dir: str, rows: dict) -> None:
    """The dry-run's records (each ported cell's three terms, bottleneck and
    memory per block), the kernel bounds against their known values, and every
    counted card run's share of its measured time."""
    import os

    t_phase = time.perf_counter()
    for p, cmd, t0 in procs:
        try:
            text, _ = p.communicate(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                                - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            require(False, f"dry-run {' '.join(cmd[3:])} ran past {DRYRUN_TIMEOUT_S} s")
        require(p.returncode == 0, f"dry-run {' '.join(cmd[3:])} failed:\n{text[-3000:]}")
    want = []
    for arch, shape, mesh, extra in DRYRUN_CELLS:
        tag = "__ring" if extra else ""
        want += [f"{arch}__{shape}__{m}{tag}.json"
                 for m in (("single", "multi") if mesh == "both" else (mesh,))]
    have = sorted(os.listdir(out_dir))
    require(set(want) <= set(have) and not any("FAILED" in n for n in have),
            f"dry-run records: missing {sorted(set(want) - set(have))}, have {have}")
    log(f"dry-run on the host (meta, {len(want)} records; H100 peaks, "
        f"{hw()['hbm_bw'] / 1e12:.2f} TB/s, {hw()['ici_bw'] / 1e9:.0f} GB/s NVLink):")
    for name in want:
        with open(os.path.join(out_dir, name)) as f:
            r = json.load(f)
        mem = r["memory_per_device"]
        log(f"  {name[:-5]}: chips {r['chips']}, compute {r['compute_s'] * 1e3:.3f} ms, "
            f"memory {r['memory_s'] * 1e3:.3f} ms, collective "
            f"{r['collective_s'] * 1e3:.3f} ms, bottleneck {r['bottleneck']}, "
            f"useful/counted {r['useful_flops_ratio']:.3f}; per block "
            f"{mem['argument_gb']:.2f} GB state + {mem['temp_gb']:.2f} GB live "
            f"({'fits' if r['fits_hbm'] else 'does not fit'} 80 GB); counted in "
            f"{r['count_s']:.1f} s")
    lane_mb, spmm_mb = rows["lane_probe"]["bound_mb"], rows["spmm_ell"]["bound_mb"]
    require(f"{lane_mb:.1f}" == "142.4" and f"{spmm_mb:.2f}" == "18.56",
            f"kernel bounds moved: lane_probe {lane_mb} MB, spmm_ell {spmm_mb} MB")
    log(f"kernel bounds from repro_torch.roofline: lane_probe {lane_mb:.1f} MB, "
        f"spmm_ell {spmm_mb:.2f} MB (their known values)")
    worst = max(COUNTED, key=lambda c: c["share"])
    for c in COUNTED:
        require(c["share"] <= ROOFLINE_SHARE_LIMIT,
                f"{c['name']}: least time {c['share']:.1%} of the measured; "
                f"the op that counts the most: {c['top']}")
    log(f"roofline phase: {len(COUNTED)} counted card runs, shares "
        f"{min(c['share'] for c in COUNTED):.1%} to {worst['share']:.1%} "
        f"({worst['name']}); {time.perf_counter() - t_phase:.1f} s waiting and "
        f"checking; card: {card()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    pkg = ROOT / "src" / "repro_torch"
    require(pkg.is_dir(), f"no port package at {pkg}")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    require(Path(repro_torch.__file__).resolve().parent == pkg,
            f"imported {repro_torch.__file__}, not the checkout's package")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = start_dryrun(out_dir)
        try:
            return run(procs, out_dir)
        finally:
            stop_dryrun(procs)


def run(procs, out_dir: str) -> int:
    """Every phase on the card, then the roofline phase; prints the result."""
    import torch

    from repro_torch.api import GraphHandle
    from repro_torch.core import make_params
    from repro_torch.graph import paper_dataset
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(str(_build.library_path(k).name) for k in _build.KERNELS)})")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    small_lane_cases(gen, dev)
    small_spmm_cases(gen, dev)
    small_probe_push_cases(gen, dev)
    widened = small_flash_cases(gen, dev)
    torch.cuda.synchronize()
    log("small kernel cases: ok (lane_probe fp32/bf16, spmm_ell fp32/fp16/bf16, "
        "probe_push fp32/fp16/bf16, flash_attention fp32/bf16 on both routes; "
        f"tensor-core cases needing tc_close's widening: {widened})")
    rows = {"flash_attention": flash_phase(gen, dev)}

    t0 = time.perf_counter()
    src, dst, n = paper_dataset("hepph", 1.0)
    h = GraphHandle.from_edges(src, dst, n, device=dev)
    torch.cuda.synchronize()
    log(f"hepph stand-in: n={n} m={len(src)}; handle built on {dev} in "
        f"{time.perf_counter() - t0:.2f} s")
    params = make_params(n)  # the session's defaults: c = 0.6, eps_a = 0.1
    require((params.n_r, params.max_len) == (10840, 12), f"params {params}")
    rows.update(kernel_phase(h, params, gen))
    rows["probe_push"] = probe_push_phase(h, params, gen)
    launches, nodes = main_path(h, params)
    profile_batch(h, nodes)
    count_hepph(h, params, nodes)
    toy_accuracy(dev)
    acc_launches = accuracy_phase(h)
    svc_launches = service_phase(h)
    shard_launches = shard_phase(h, params, nodes, rows["lane_probe"]["ms"])
    del h
    torch.cuda.empty_cache()
    prod_launches = production_phase(dev)
    dyn_launches = dynamic_phase(dev)
    for k, v in dynamic_traffic(dev).items():
        dyn_launches[k] += v
    stream_launches = stream_phase(dev)
    lm_launches = lm_phase(dev)
    moe_launches = moe_phase(dev)
    roofline_phase(procs, out_dir, rows)

    # each kernel's launches in the windows of the paths that run it; probe_push
    # is on no path (the reference calls it only from its tests)
    for name, row in rows.items():
        row["launches"] = (launches[name] + acc_launches[name]
                           + svc_launches[name] + shard_launches[name]
                           + prod_launches[name] + dyn_launches[name]
                           + stream_launches[name] + lm_launches[name]
                           + moe_launches[name])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
