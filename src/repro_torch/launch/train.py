"""Training launcher (port of ``repro.launch.train``): real runs on one
device with the full fault-tolerance loop: checkpoint / restart, async
saves, deterministic data, failure injection for testing.

The LM family trains (``arch.build(..., use_kernel=False)``: the flash
kernel has no backward), and so do the GNN and recsys families.  Runs on
the card unless ``device`` says otherwise.  Checkpoints hold
``state_tree(model, opt_state)``: the reference's ``(params, opt_state)``
pytree (the LM's stage leaves stacked; a GNN's or Wide & Deep's tree is
the reference's already), so the two packages restore each other's
checkpoints.

Usage:
  python -m repro_torch.launch.train --arch llama3.2-1b --smoke --steps 50 \\
      --ckpt-dir /tmp/ckpt --ckpt-every 10 [--fail-at 30] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import arch as arch_mod
from repro_torch.checkpoint.checkpointer import AsyncCheckpointer
from repro_torch.data import synthetic
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.graph.structs import resolve_device
from repro_torch.models.transformer import model as M
from repro_torch.training.tree import leaves, tree_map


def _fit_specs(b: dict, specs: dict) -> dict:
    """Each array of ``b`` named in ``specs`` zero-padded, then cut, to its
    spec's shape (the reference's pad-to-spec)."""
    out = {}
    for k, sds in specs.items():
        arr = b[k]
        pad = [(0, sds.shape[i] - arr.shape[i]) for i in range(arr.ndim)]
        out[k] = np.pad(arr, pad)[tuple(slice(0, n) for n in sds.shape)]
    return out


def _gnn_batch_fn(bundle, seed: int):
    """The reference's GNN batches: a ``molecule_batch`` a step, or one
    ``gnn_full_graph_batch`` for every step (it depends on the seed alone:
    the reference rebuilds the same graph each step, the port builds it
    here, once, and hands every step the same arrays, which callers must
    not write), with NequIP's positions and energy drawn a step."""
    cfg, d = bundle.cfg, bundle.shape.dims
    specs = bundle.input_specs()["batch"]
    nequip = cfg.conv == "nequip"
    if bundle.shape.kind == "batched_graphs":
        def fn(step):
            return _fit_specs(synthetic.molecule_batch(
                seed, step, d["batch"], d["n_nodes"], d["n_edges"], d["d_feat"],
                with_pos=nequip), specs)

        return fn

    n, e = specs["feats"].shape[0], specs["src"].shape[0]
    b = synthetic.gnn_full_graph_batch(seed, n, e, d["d_feat"], cfg.n_classes)
    graph = _fit_specs(b, {k: v for k, v in specs.items() if k in b})
    if not nequip:
        return lambda step: dict(graph)

    def fn(step):
        rng = np.random.default_rng((seed, step))
        per_step = dict(pos=rng.normal(size=(n, 3)).astype(np.float32) * 2,
                        energy=rng.normal(size=(1,)).astype(np.float32))
        return dict(graph, **_fit_specs(per_step, {k: specs[k] for k in per_step}))

    return fn


def make_batch_fn(bundle, seed: int):
    """step -> the step's host batch (numpy), (seed, step) deterministic."""
    cfg = bundle.cfg
    shape = bundle.shape
    if cfg.family == "recsys":
        def fn(step):
            return synthetic.recsys_batch(seed, step, shape.dims["batch"], cfg.n_sparse,
                                          cfg.vocab_per_field, cfg.n_dense)

        return fn
    if cfg.family == "gnn":
        return _gnn_batch_fn(bundle, seed)
    if cfg.family != "lm":
        raise ValueError(f"no training loop for family {cfg.family}")
    B = shape.dims["global_batch"]
    S = shape.dims["seq_len"]

    def fn(step):
        return synthetic.lm_batch(seed, step, B, S, cfg.vocab)

    return fn


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True)


def state_tree(model, opt_state) -> tuple:
    """``(params, opt_state)`` in the reference's layout as host copies:
    ``params`` its ``init_lm`` tree (stage leaves stacked; a GNN's or Wide
    & Deep's tree as it is), ``opt_state`` ``dict(count=, mu=, nu=)`` with the moments laid
    out alike."""
    if isinstance(model, torch.nn.Module):
        params = dict(model.named_parameters())

        def host(named):
            return M.stack_layers({k: _host(v) for k, v in named.items()})
    else:
        params = model

        def host(tree):
            return tree_map(_host, tree)

    return host(params), dict(count=_host(opt_state["count"]),
                              mu=host(opt_state["mu"]), nu=host(opt_state["nu"]))


def load_state_tree(model, opt_state, tree) -> None:
    """Write a reference-layout ``(params, opt_state)`` tree into ``model``
    and ``opt_state`` in place (the inverse of ``state_tree``)."""
    params, opt = tree
    if isinstance(model, torch.nn.Module):
        M.unstack_layers(params, dict(model.named_parameters()))
        M.unstack_layers(opt["mu"], opt_state["mu"])
        M.unstack_layers(opt["nu"], opt_state["nu"])
    else:
        with torch.no_grad():
            for dst, src in zip(leaves((model, opt_state["mu"], opt_state["nu"])),
                                leaves((params, opt["mu"], opt["nu"]))):
                dst.copy_(torch.from_numpy(np.array(src)))
    count = opt["count"]
    if not isinstance(count, torch.Tensor):
        count = torch.from_numpy(np.array(count))
    opt_state["count"].copy_(count)


def train(arch_id: str, shape_name: str, *, smoke: bool, steps: int,
          ckpt_dir: str | None, ckpt_every: int, seed: int = 0,
          fail_at: int | None = None, device="cuda") -> dict:
    dev = resolve_device(device)
    bundle = arch_mod.build(arch_id, shape_name, smoke=smoke, use_kernel=False,
                            device=dev)
    if bundle.shape.kind not in arch_mod.TRAIN_KINDS:
        raise ValueError(f"{shape_name} is not a training shape")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model, opt_state = bundle.init(gen)
    start = 0

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt is not None:
        restored = ckpt.restore_latest(state_tree(model, opt_state))
        if restored is not None:
            tree, manifest = restored
            load_state_tree(model, opt_state, tree)
            start = manifest["step"] + 1
            print(f"restored checkpoint at step {manifest['step']}")

    pipe = PrefetchPipeline(make_batch_fn(bundle, seed), start_step=start, device=dev)
    losses = []
    t0 = time.time()
    try:
        for step, batch in pipe:
            if step >= steps:
                break
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            model, opt_state, metrics = bundle.step(model, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % max(1, steps // 10) == 0:
                print(f"step {step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f}")
            if ckpt is not None and step % ckpt_every == 0 and step > start:
                ckpt.save(state_tree(model, opt_state), step=step)
    finally:
        pipe.close()
        if ckpt is not None:
            ckpt.wait()
    dt = time.time() - t0
    return dict(
        steps=len(losses), first_loss=losses[0] if losses else None,
        last_loss=losses[-1] if losses else None, seconds=dt,
        state=(model, opt_state),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (FT testing)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shape = args.shape or {
        "lm": "train_4k", "gnn": "full_graph_sm", "recsys": "train_batch",
    }[arch_mod.family_of(args.arch)]
    out = train(
        args.arch, shape, smoke=args.smoke, steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        fail_at=args.fail_at, device=args.device,
    )
    print(f"trained {out['steps']} steps in {out['seconds']:.1f}s: "
          f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}")


if __name__ == "__main__":
    main()
