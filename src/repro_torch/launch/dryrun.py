"""Dry-run (port of ``repro.launch.dryrun``): count every (architecture x
input shape) cell on the production mesh, print its memory and roofline
terms, and write the records ``roofline.report`` renders.

A cell's bundle is built on ``meta`` (``arch.build(..., device="meta")``,
the ProbeSim family over ``launch.mesh.make_production_mesh``: 256 blocks,
or 512 with ``--mesh multi``), its state is made from shapes
(``abstract_state``), and its step runs once under a
``roofline.analysis.OpCounter``.  Nothing is allocated: the counter sees
every op of the full-depth, full-width step.  The port's LM, GNN and
recsys steps are one program with no sharding specs (the reference's are
jax ``PartitionSpec``s: Wide & Deep's shard the tables' rows and induce an
all-to-all): their records divide the step's counts evenly over the
mesh's chips and count no collective.

Unlike the reference there is no depth-delta extrapolation (XLA's
``cost_analysis`` counts a ``scan`` body once; the counter sees every
layer) and no compile, so ``--skip-full-compile`` has no counterpart.

An LM cell counts the flash kernel where its prefill runs it; MLA's
prefill runs the plain ``sdpa`` (the kernel refuses its head widths), so
its bundle is built with ``use_kernel=False``, as is every ``train_4k``
bundle (the kernel has no backward).  A train cell counts the whole step
with autograd on: the forward, the backward with each block recomputed
(``cfg.remat``), and the AdamW update.

A GNN cell is a train step (``full_graph``, ``minibatch`` and
``batched_graphs`` shapes), counted with autograd on like ``train_4k``, and
so is ``wide-deep``'s ``train_batch``; its ``serve_p99``, ``serve_bulk``
and ``retrieval_cand`` steps are counted in inference mode.  An
inapplicable cell (``arch.is_applicable``) writes
``{arch}__{shape}__skip.json`` unless ``--include-skipped``.  A cell that
fails writes ``{arch}__{shape}__{mesh}.FAILED.json`` and the run exits
non-zero.

Usage (``--arch`` without ``--shape``: every shape of the arch, in one
process):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape prefill_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gcn-cora --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch probesim --shape serve_batch --mesh single --set push_mode=ring --tag ring
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import arch as arch_mod
from repro_torch.configs.base import ARCH_IDS, get_config, shapes_for
from repro_torch.launch.mesh import HW, ShardMesh, make_production_mesh
from repro_torch.roofline import analysis as ra

META = torch.device("meta")


def abstract_state(bundle) -> tuple:
    """The bundle's state as ``meta`` tensors, made from shapes (a
    ``torch.Generator`` cannot draw on ``meta``)."""
    return bundle.init()


def meta_like(x):
    """``x`` with every tensor replaced by a ``meta`` tensor of its shape
    and dtype: lists, tuples, dicts and dataclasses are walked, a
    ``ShardMesh`` becomes one of as many ``meta`` blocks, host values are
    kept (a real state's shapes, for the dry-run of a cut)."""
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device=META)
    if isinstance(x, ShardMesh):
        return ShardMesh([META] * x.shards)
    if isinstance(x, (list, tuple)):
        return type(x)(meta_like(v) for v in x)
    if isinstance(x, dict):
        return {k: meta_like(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: meta_like(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def abstract_inputs(bundle, device=META) -> dict:
    """The step's keyword inputs on ``device`` (zeros, or ``meta``):
    ``batch`` from ``input_specs()``; for the ProbeSim family the walk draws
    ``uniforms = (cont, pick)``, each ``[max_len - 1, Q * walk_chunk]``
    (no generator draws on ``meta``), and ``seed`` 0."""
    specs = bundle.input_specs()["batch"]
    batch = {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for k, s in specs.items()}
    if bundle.cfg.family != "probesim":
        return dict(batch=batch)
    from repro_torch.core.params import make_params

    batch["seed"] = 0
    c = bundle.cfg
    length = make_params(c.n, c=c.c, eps_a=c.eps_a, delta=c.delta).max_len
    d = bundle.shape.dims
    shape = (length - 1, d["queries"] * d["walk_chunk"])
    return dict(batch=batch, uniforms=(
        torch.zeros(shape, dtype=torch.bool, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device)))


def storages(x) -> dict:
    """Every distinct tensor storage in a state (parameters of a module
    included): ``{key: bytes}``."""
    found = {}

    def walk(v):
        if isinstance(v, torch.nn.Module):
            for p in v.parameters():
                walk(p)
        elif isinstance(v, torch.Tensor):
            st = v.untyped_storage()
            found[st._cdata] = st.nbytes()
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))

    walk(x)
    return found


def state_bytes(x) -> int:
    """Bytes of every distinct tensor storage in a state."""
    return sum(storages(x).values())


def count_step(bundle, state, inputs, *, mesh_name: str,
               chips: int) -> tuple[ra.RooflineReport, ra.OpCounter]:
    """Run ``bundle.step(*state, **inputs)`` once under an ``OpCounter``
    and return the finalized report (per device: every count over
    ``chips``) and the counter.  A train step runs with autograd on (its
    backward and update are counted), any other in inference mode."""
    batch = inputs["batch"]
    extra = {k: v for k, v in inputs.items() if k != "batch"}
    counter = ra.OpCounter()
    mode = (torch.enable_grad() if bundle.shape.kind in arch_mod.TRAIN_KINDS
            else torch.inference_mode())
    with mode, counter:
        out = bundle.step(*state, batch, **extra)
        args = storages((state, inputs))
        # an output written in place into the state (decode's caches) is
        # an argument, not an output
        out_bytes = sum(b for k, b in storages(out).items() if k not in args)
        del out
    per = 1e-9 / chips
    memory = dict(
        argument_gb=sum(args.values()) * per,
        output_gb=out_bytes * per,
        temp_gb=counter.peak_bytes * per,
    )
    rep = ra.analyze(arch=bundle.arch, shape=bundle.shape.name,
                     mesh_name=mesh_name, chips=chips, counter=counter,
                     model_flops=bundle.model_flops(), hw=HW, memory=memory)
    return rep, counter


def _with_overrides(cfg, overrides: dict | None):
    if not overrides:
        return cfg
    top = {k: v for k, v in overrides.items() if "." not in k}
    moe_over = {k.split(".", 1)[1]: v for k, v in overrides.items()
                if k.startswith("moe.")}
    cfg = dataclasses.replace(cfg, **top)
    if moe_over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    return cfg


def run_cell(arch_id: str, shape_name: str, mesh_name: str, *,
             overrides: dict | None = None, mesh: ShardMesh | None = None) -> dict:
    """One cell's record, its step counted once over ``abstract_state``.
    By default on ``meta`` over the production mesh (``mesh_name``
    "single": 256 blocks, "multi": 512); ``mesh`` places the ProbeSim
    blocks elsewhere (a real ``ShardMesh``: a graph up to
    ``arch.REAL_GRAPH_MAX_N`` nodes is then built on it), and ``chips`` is
    the mesh's (``ShardMesh.chips``)."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    applicable, why = arch_mod.is_applicable(arch_id, shape_name)
    record: dict = dict(arch=arch_id, shape=shape_name, mesh=mesh_name,
                        chips=mesh.chips, applicable=applicable)
    if not applicable:
        record["skip_reason"] = why  # still counted: a bonus cell
    cfg = _with_overrides(get_config(arch_id), overrides)
    if overrides:
        record["overrides"] = {k: str(v) for k, v in overrides.items()}
    shape = next(s for s in shapes_for(arch_id) if s.name == shape_name)
    device = mesh.home if cfg.family == "probesim" else META
    use_kernel = not (cfg.family == "lm"
                      and (cfg.attention == "mla" or shape.kind == "train"))
    bundle = arch_mod.build_with_cfg(arch_id, cfg, shape, device=device,
                                     mesh=mesh, use_kernel=use_kernel)
    state = abstract_state(bundle)
    t0 = time.perf_counter()
    rep, counter = count_step(bundle, state, abstract_inputs(bundle, device),
                              mesh_name=mesh_name, chips=mesh.chips)
    record.update(rep.to_dict())
    record["count_s"] = time.perf_counter() - t0
    record["roofline_s"] = rep.roofline_s
    mem = rep.memory_per_device
    record["per_device_gb"] = mem["argument_gb"] + mem["temp_gb"]
    record["fits_hbm"] = record["per_device_gb"] * 1e9 <= HW["hbm_bytes"]
    record["top_ops"] = [list(r) for r in counter.top_ops(HW)]
    return record


def _parse_overrides(pairs) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        elif v.isdigit():
            v = int(v)
        else:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v
    return overrides


def _dump(path: str, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=float)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--include-skipped", action="store_true",
                    help="also count inapplicable cells as bonus cells")
    ap.add_argument("--set", nargs="*", default=[], metavar="K=V",
                    help="config overrides, e.g. push_mode=ring")
    ap.add_argument("--tag", default="",
                    help="suffix for output filenames (perf iterations)")
    args = ap.parse_args(argv)

    overrides = _parse_overrides(args.set)
    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in shapes_for(a)]
    else:
        assert args.arch, "--arch [--shape] or --all"
        shapes = [args.shape] if args.shape else [s.name for s in shapes_for(args.arch)]
        cells = [(args.arch, s) for s in shapes]

    def skip(a, s, why):
        print(f"SKIP {a} x {s}: {why}")
        _dump(os.path.join(args.out, f"{a}__{s}__skip.json"),
              dict(arch=a, shape=s, applicable=False, skip_reason=why))

    failures = 0
    for a, s in cells:
        applicable, why = arch_mod.is_applicable(a, s)
        if not applicable and not args.include_skipped:
            skip(a, s, why)
            continue
        for m in meshes:
            tag = f"{a}__{s}__{m}" + (f"__{args.tag}" if args.tag else "")
            t0 = time.time()
            try:
                rec = run_cell(a, s, m, overrides=overrides or None)
            except Exception as e:
                failures += 1
                print(f"FAIL {tag}: {e}")
                traceback.print_exc()
                _dump(os.path.join(args.out, f"{tag}.FAILED.json"),
                      dict(arch=a, shape=s, mesh=m, error=str(e)))
                continue
            rec["wall_s"] = time.time() - t0
            _dump(os.path.join(args.out, f"{tag}.json"), rec)
            mem = rec["memory_per_device"]
            print(
                f"OK   {tag}: flops/dev={rec['hlo_flops']:.3e} "
                f"bytes/dev={rec['hlo_bytes']:.3e} "
                f"coll/dev={rec['collective_bytes']:.3e}B "
                f"mem/dev={mem['argument_gb']:.2f}+{mem['temp_gb']:.2f} GB "
                f"bottleneck={rec['bottleneck']} ({rec['wall_s']:.0f}s)",
                flush=True,
            )
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")
    print("dry-run complete")


if __name__ == "__main__":
    main()
