"""repro_torch's data, checkpoint and training launcher held against repro
on the CPU: the pinned copy of ``data/synthetic.py``, ``PrefetchPipeline``'s
order and cursor, checkpoints (round trip, garbage collection, a
checkpoint written by repro restored by the port and the reverse), the
launcher's fail -> restart equal to a clean run, and the example in a
subprocess.

Checkpoint leaves must come back exactly (bf16 through its fp32 upcast);
a restart on the CPU ends bitwise equal to the clean run (every op is
deterministic there; see chip_smoke's train phase for the card).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.arch as JA
from repro.checkpoint import checkpointer as JCK
from repro.data import synthetic as j_syn

import repro_torch.arch as TA
from repro_torch.checkpoint import checkpointer as TCK
from repro_torch.data import synthetic as t_syn
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.launch import train as TL
from torch_port_helpers import (  # noqa: F401  (one_thread: a fixture)
    CPU, bf16_params, needs_cuda, one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")

SRC = Path(__file__).resolve().parent.parent / "src"


# ---------------------------------------------------------------------------
# synthetic data and the pipeline
# ---------------------------------------------------------------------------


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17)])
def test_synthetic_copy_pinned_to_repro(seed, step):
    _equal(t_syn.lm_batch(seed, step, 3, 9, 512), j_syn.lm_batch(seed, step, 3, 9, 512))
    _equal(t_syn.gnn_full_graph_batch(seed, 60, 300, 5, 4),
           j_syn.gnn_full_graph_batch(seed, 60, 300, 5, 4))
    for pos in (True, False):
        _equal(t_syn.molecule_batch(seed, step, 3, 6, 10, 4, with_pos=pos),
               j_syn.molecule_batch(seed, step, 3, 6, 10, 4, with_pos=pos))
    _equal(t_syn.recsys_batch(seed, step, 8, 5, 100, 3),
           j_syn.recsys_batch(seed, step, 8, 5, 100, 3))


def _make(step):
    return t_syn.lm_batch(1, step, 2, 4, 50)


@pytest.mark.parametrize("device", [None, CPU])
def test_pipeline_order_cursor_and_close(device):
    """Steps come in order from ``start_step``, each batch the maker's for
    its step (numpy without a device, tensors on ``device`` with one), and
    ``close`` stops the worker."""
    pipe = PrefetchPipeline(_make, start_step=5, prefetch=2, device=device)
    got = []
    try:
        for step, batch in pipe:
            got.append((step, batch))
            if len(got) == 4:
                break
    finally:
        pipe.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for step, batch in got:
        want = _make(step)
        if device is None:
            _equal(batch, want)
        else:
            assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                       for t in batch.values())
            _equal({k: t.numpy() for k, t in batch.items()}, want)
    assert not pipe._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state():
    rng = np.random.default_rng(0)
    return dict(
        w=torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
        h=torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)).to(torch.bfloat16),
        inner=[torch.tensor(7, dtype=torch.int32), torch.arange(4, dtype=torch.int64)],
    )


def test_checkpoint_round_trip_and_manifest(tmp_path):
    state = _state()
    path = str(tmp_path / "ckpt_3")
    TCK.save(path, state, step=3, extra=dict(note="x"))
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    assert not os.path.exists(path + ".tmp")
    man = json.loads(Path(path, "manifest.json").read_text())
    assert man["step"] == 3 and man["n_leaves"] == 4 and man["extra"] == {"note": "x"}
    # jax's leaf order: h, inner[0], inner[1], w; bf16 kept in the manifest
    assert [m["dtype"] for m in man["leaves"]] == ["bfloat16", "int32", "int64", "float32"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert z["leaf_0"].dtype == np.float32  # the bf16 leaf upcast
    like = jax.tree_util.tree_map(torch.zeros_like, state)
    back, man2 = TCK.restore(path, like)
    assert man2["step"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        TCK.restore(path, dict(w=state["w"]))


def test_async_checkpointer_gc_latest_and_snapshot(tmp_path):
    """``keep`` newest kept; a ``.tmp`` or a directory without a manifest is
    never the latest; the host snapshot is taken before ``save`` returns
    (an in-place write after it does not reach the file)."""
    root = str(tmp_path)
    ck = TCK.AsyncCheckpointer(root, keep=2)
    state = _state()
    for step in (10, 20, 30):
        ck.save(state, step=step)
        state["w"].add_(1.0)  # the step's in-place update, right after save
    ck.wait()
    assert sorted(os.listdir(root)) == ["ckpt_20", "ckpt_30"]
    os.makedirs(os.path.join(root, "ckpt_99.tmp"))
    os.makedirs(os.path.join(root, "ckpt_50"))  # partial: no manifest
    assert TCK.latest_step(root) == 30 == JCK.latest_step(root)
    back, man = ck.restore_latest(_state())
    assert man["step"] == 30
    assert torch.equal(back["w"], _state()["w"] + 2.0)
    assert TCK.AsyncCheckpointer(str(tmp_path / "empty")).restore_latest(_state()) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, dtype):
    """repro's train state of the Llama SMOKE bundle (fp32, or bf16 with
    bf16 moments) saved by repro restores into the port's bundle state leaf
    for leaf, and the port's saved state restores into repro's."""
    jb = JA.build("llama3.2-1b", "train_4k", smoke=True)
    params, opt = jb.init(jax.random.key(0))
    if dtype == "bfloat16":
        params = bf16_params(params)
        opt = dict(opt, mu=bf16_params(opt["mu"]), nu=bf16_params(opt["nu"]))
        opt["mu"] = jax.tree_util.tree_map(lambda a: a + jnp.asarray(0.5, a.dtype), opt["mu"])
    JCK.save(str(tmp_path / "j"), (params, opt), step=4)
    tb = TA.build("llama3.2-1b", "train_4k", smoke=True, device=CPU, use_kernel=False)
    model, topt = tb.init(torch.Generator().manual_seed(1))
    if dtype == "bfloat16":
        model.to(torch.bfloat16)
        topt = dict(count=topt["count"],
                    mu={k: v.to(torch.bfloat16) for k, v in topt["mu"].items()},
                    nu={k: v.to(torch.bfloat16) for k, v in topt["nu"].items()})
    tree, man = TCK.restore(str(tmp_path / "j"), TL.state_tree(model, topt))
    assert man["step"] == 4
    TL.load_state_tree(model, topt, tree)
    got = TL.state_tree(model, topt)
    jl = jax.tree_util.tree_leaves((params, opt))
    tl = jax.tree_util.tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        want = np.asarray(b, np.float32)
        assert a.dtype == (torch.int32 if want.ndim == 0 else getattr(torch, dtype))
        np.testing.assert_array_equal(a.float().numpy(), want)
    # and back: the port writes, repro reads
    TCK.save(str(tmp_path / "t"), got, step=5)
    jback, jman = JCK.restore(str(tmp_path / "t"), (params, opt))
    assert jman["step"] == 5
    for a, b in zip(jax.tree_util.tree_leaves(jback), jl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------


def test_make_batch_fn_and_refusals():
    tb = TA.build("llama3.2-1b", "train_4k", smoke=True, device=CPU, use_kernel=False)
    fn = TL.make_batch_fn(tb, seed=3)
    _equal(fn(7), j_syn.lm_batch(3, 7, 2, 64, tb.cfg.vocab))

    # the recsys family trains too: the reference's recsys_batch
    rb = TA.build("wide-deep", "train_batch", smoke=True, device=CPU)
    c = rb.cfg
    _equal(TL.make_batch_fn(rb, seed=3)(7),
           j_syn.recsys_batch(3, 7, 32, c.n_sparse, c.vocab_per_field, c.n_dense))
    out = TL.train("wide-deep", "train_batch", smoke=True, steps=1, ckpt_dir=None,
                   ckpt_every=1, device=CPU)
    assert out["steps"] == 1 and np.isfinite(out["first_loss"])

    class Fake:
        cfg = type("C", (), {"family": "probesim"})()
        shape = None

    with pytest.raises(ValueError, match="no training loop for family probesim"):
        TL.make_batch_fn(Fake, seed=0)
    with pytest.raises(ValueError, match="not a training shape"):
        TL.train("llama3.2-1b", "prefill_32k", smoke=True, steps=1, ckpt_dir=None,
                 ckpt_every=1, device=CPU)


def test_fail_then_restart_equals_a_clean_run(tmp_path):
    """A run that fails at step 9 (checkpoints every 4 steps: 4 and 8), then
    restarts from step 8's checkpoint, ends with the clean run's model and
    optimizer state, bitwise."""
    kw = dict(smoke=True, steps=12, ckpt_every=4, device=CPU)
    with pytest.raises(RuntimeError, match="injected failure at step 9"):
        TL.train("llama3.2-1b", "train_4k", ckpt_dir=str(tmp_path), fail_at=9, **kw)
    assert TCK.latest_step(str(tmp_path)) == 8
    resumed = TL.train("llama3.2-1b", "train_4k", ckpt_dir=str(tmp_path), **kw)
    clean = TL.train("llama3.2-1b", "train_4k", ckpt_dir=None, **kw)
    assert resumed["steps"] == 3 and clean["steps"] == 12
    assert resumed["last_loss"] == clean["last_loss"]
    a, b = TL.state_tree(*resumed["state"]), TL.state_tree(*clean["state"])
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)
    assert int(a[1]["count"]) == 12


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=env, timeout=timeout)


def test_train_lm_smoke_example_runs():
    t0 = time.perf_counter()
    r = _run(["repro_torch.examples.train_lm_smoke", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "injected failure at step 30" in out
    assert "restored checkpoint at step 20" in out
    assert "resumed and finished" in out
    assert time.perf_counter() - t0 < 120


def test_train_cli_runs(tmp_path):
    r = _run(["repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke",
              "--steps", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "trained 6 steps" in r.stdout
    assert TCK.latest_step(str(tmp_path)) == 4


@pytest.mark.cuda
def test_pipeline_and_restart_on_the_card(tmp_path):
    """Batches land on the card through pinned memory; a fail -> restart run
    on the card ends bitwise equal to a clean one (the default mode: the
    Llama path's backward has no atomics)."""
    needs_cuda()
    pipe = PrefetchPipeline(_make, start_step=0, device="cuda")
    try:
        step, batch = next(iter(pipe))
    finally:
        pipe.close()
    assert step == 0 and all(t.is_cuda for t in batch.values())
    _equal({k: t.cpu().numpy() for k, t in batch.items()}, _make(0))
    kw = dict(smoke=True, steps=12, ckpt_every=4, device="cuda")
    with pytest.raises(RuntimeError, match="injected failure"):
        TL.train("llama3.2-1b", "train_4k", ckpt_dir=str(tmp_path), fail_at=9, **kw)
    resumed = TL.train("llama3.2-1b", "train_4k", ckpt_dir=str(tmp_path), **kw)
    clean = TL.train("llama3.2-1b", "train_4k", ckpt_dir=None, **kw)
    a, b = TL.state_tree(*resumed["state"]), TL.state_tree(*clean["state"])
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)
