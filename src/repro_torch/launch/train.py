"""Training launcher (port of ``repro.launch.train``): real runs on one
device with the full fault-tolerance loop: checkpoint / restart, async
saves, deterministic data, failure injection for testing.

The LM family trains (``arch.build(..., use_kernel=False)``: the flash
kernel has no backward); the GNN and recsys families wait for their
slices (ROADMAP queue 1 item 14).  Runs on the card unless ``device`` says
otherwise.  Checkpoints hold ``state_tree(model, opt_state)``: the
reference's ``(params, opt_state)`` pytree, stage leaves stacked, so the
two packages restore each other's checkpoints.

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

def make_batch_fn(bundle, seed: int):
    """step -> the step's host batch (numpy), (seed, step) deterministic."""
    cfg = bundle.cfg
    shape = bundle.shape
    if cfg.family in ("gnn", "recsys"):
        raise NotImplementedError(
            f"training family {cfg.family!r} is not ported ({arch_mod.NOT_PORTED})")
    if cfg.family != "lm":
        raise ValueError(f"no training loop for family {cfg.family}")
    B = shape.dims["global_batch"]
    S = shape.dims["seq_len"]

    def fn(step):
        return synthetic.lm_batch(seed, step, B, S, cfg.vocab)

    return fn


def state_tree(model, opt_state) -> tuple:
    """``(params, opt_state)`` in the reference's layout as host copies:
    ``params`` its ``init_lm`` tree (stage leaves stacked), ``opt_state``
    ``dict(count=, mu=, nu=)`` with the moments stacked alike."""
    def host(named):
        return M.stack_layers({k: v.detach().to("cpu", copy=True)
                               for k, v in named.items()})

    params = host(dict(model.named_parameters()))
    return params, dict(count=opt_state["count"].detach().to("cpu", copy=True),
                        mu=host(opt_state["mu"]), nu=host(opt_state["nu"]))


def load_state_tree(model, opt_state, tree) -> None:
    """Write a reference-layout ``(params, opt_state)`` tree into ``model``
    and ``opt_state`` in place (the inverse of ``state_tree``)."""
    params, opt = tree
    M.unstack_layers(params, dict(model.named_parameters()))
    M.unstack_layers(opt["mu"], opt_state["mu"])
    M.unstack_layers(opt["nu"], opt_state["nu"])
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
    if bundle.shape.kind != "train":
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
