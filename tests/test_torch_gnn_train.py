"""repro_torch's GNN family held against repro on the CPU: the five
configs (pinned copies), the parameter trees (``init_gnn``'s layout,
``gnn_from_params`` / ``gnn_to_params``), ``gnn_loss`` and its gradients
for each SMOKE config against ``jax.value_and_grad``, the launcher's GNN
batches for every shape kind, a GNN ``train`` that fails and restarts
(bitwise equal to a clean run on the CPU), GNN checkpoints across the two
packages, and the dry-run's GNN records (meta counts equal to the CPU's).

Losses are held at 1e-5 and gradients at 1e-4 of each tensor's largest
magnitude; batches, checkpoints and the trees' layouts exactly.  One
``cuda`` case: two steps from one state bitwise equal on the card under
``torch.use_deterministic_algorithms(True)`` (its ``index_add_`` sums in
an undefined order otherwise).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.arch as JA
from repro.checkpoint import checkpointer as JCK
from repro.configs import base as JCB
from repro.launch import train as JLT
from repro.models.gnn import model as JG

import repro_torch.arch as TA
from repro_torch.checkpoint import checkpointer as TCK
from repro_torch.configs import base as TCB
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as TLT
from repro_torch.models.gnn import model as TG
from repro_torch.training.tree import leaves, tree_map
from torch_port_helpers import (  # noqa: F401  (one_thread: a fixture)
    CPU, gnn_params, needs_cuda, one_thread, rel_close)

pytestmark = pytest.mark.usefixtures("one_thread")

GNN_ARCHS = ("gcn-cora", "gin-tu", "gatedgcn", "nequip", "gat-bonus")
# each config's own shape: the one its users run
HOME = {"gcn-cora": "full_graph_sm", "gin-tu": "molecule", "gatedgcn": "minibatch_lg",
        "nequip": "molecule", "gat-bonus": "full_graph_sm"}


@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
def test_gnn_configs_pinned_to_repro(arch, smoke):
    j, t = JCB.get_config(arch, smoke=smoke), TCB.get_config(arch, smoke=smoke)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert TCB.family_of(arch) == "gnn" and arch in TCB._MODULE_OF
    assert [(s.name, s.kind, s.dims) for s in TCB.shapes_for(arch)] == \
        [(s.name, s.kind, s.dims) for s in JCB.shapes_for(arch)]
    # the tree's layout: keys, order, shapes and dtypes of repro's init_gnn
    df = 24
    want = jax.eval_shape(lambda k: JG.init_gnn(k, j, df), jax.random.key(0))
    got = TG.init_gnn(None, t, df)
    wl, gl = jax.tree_util.tree_flatten_with_path(want)[0], leaves(got)
    assert len(wl) == len(gl)
    for (path, w), g in zip(wl, gl):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype), path
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
        tree_map(lambda x: 0, got))


def test_wide_deep_still_raises():
    """wide-deep, the last config the port took, is ported: its config is
    the reference's and its train bundle trains like a GNN's (a parameter
    tree under ``make_train_step``); an unknown arch still raises."""
    assert dataclasses.asdict(TCB.get_config("wide-deep")) == dataclasses.asdict(
        JCB.get_config("wide-deep"))
    tb = TA.build("wide-deep", "train_batch", smoke=True, device=CPU)
    params, opt = tb.init(torch.Generator().manual_seed(0))
    assert set(params) == {"bias", "embed", "head", "mlp", "wide", "wide_dense"}
    batch = {k: torch.from_numpy(v) for k, v in TLT.make_batch_fn(tb, 0)(0).items()}
    params, opt, m = tb.step(params, opt, batch)
    assert int(opt["count"]) == 1 and bool(torch.isfinite(m["loss"]))
    with pytest.raises(KeyError):
        TCB.get_config("wide-deep-xl")
    with pytest.raises(ValueError, match="recsys shape kind"):
        TA.build_with_cfg("wide-deep", TCB.get_config("wide-deep", smoke=True),
                          TCB.ShapeSpec("x", "decode", {}), device=CPU)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_loss_and_gradients_equal_repro(arch):
    """``gnn_loss`` and every gradient on the config's own shape (smoke
    size, the launcher's batch of step 2), from repro's init carried over;
    then ``gnn_to_params`` gives repro's tree back exactly."""
    jb = JA.build(arch, HOME[arch], smoke=True)
    cfg, tcfg = jb.cfg, TCB.get_config(arch, smoke=True)
    n_graphs = TA._gnn_batch_shapes(tcfg, jb.shape)["G"]
    batch = JLT.make_batch_fn(jb, 0)(2)
    params = JG.init_gnn(jax.random.key(1), cfg, jb.input_specs()["batch"]["feats"].shape[1])

    def loss(p, b):
        return JG.gnn_loss(p, b, cfg, n_graphs=n_graphs)[0]

    jl, jg = jax.jit(jax.value_and_grad(loss))(params, batch)
    tp = gnn_params(params, tcfg)
    tl, metrics = TG.gnn_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                              n_graphs=n_graphs)
    assert set(metrics) == {"mse" if arch == "nequip" else "nll"}
    tg = torch.autograd.grad(tl, leaves(tp), allow_unused=True, materialize_grads=True)
    rel_close(tl, jl, 1e-5, "loss")
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for path, a, w in zip(paths, tg, jax.tree_util.tree_leaves(jg), strict=True):
        if float(np.abs(np.asarray(w)).max()) == 0.0:  # reaches no output
            assert float(a.abs().max()) == 0.0, path
        else:
            rel_close(a, np.asarray(w), 1e-4, path)
    back = TG.gnn_to_params(tp)
    for a, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params),
                    strict=True):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(w))


# ---------------------------------------------------------------------------
# the launcher, checkpoints and the dry-run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [
    ("gcn-cora", "full_graph_sm"), ("gat-bonus", "ogb_products"),
    ("gatedgcn", "minibatch_lg"), ("gin-tu", "molecule"), ("nequip", "molecule"),
    ("nequip", "full_graph_sm"), ("nequip", "minibatch_lg")])
def test_make_batch_fn_equals_repro(arch, shape):
    """Every shape kind, with and without NequIP's positions: each step's
    batch equals the reference's (which rebuilds the full graph each
    step); the port's full-graph steps share the graph's arrays."""
    jb = JA.build(arch, shape, smoke=True)
    tb = TA.build(arch, shape, smoke=True, device=CPU)
    jf, tf = JLT.make_batch_fn(jb, 5), TLT.make_batch_fn(tb, 5)
    got = {step: tf(step) for step in (0, 3)}
    for step, b in got.items():
        want = jf(step)
        assert list(b) == list(want)
        for k in want:
            assert b[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(b[k], want[k], err_msg=k)
    if shape != "molecule":
        assert got[0]["src"] is got[3]["src"] and got[0]["feats"] is got[3]["feats"]
        if arch == "nequip":
            assert not np.array_equal(got[0]["pos"], got[3]["pos"])


def test_gnn_fail_then_restart_equals_a_clean_run(tmp_path):
    """gin-tu at ``molecule`` (a new batch each step): fail at step 9,
    restart from step 8's checkpoint, end bitwise equal to a clean run."""
    kw = dict(smoke=True, steps=12, ckpt_every=4, device=CPU)
    with pytest.raises(RuntimeError, match="injected failure at step 9"):
        TLT.train("gin-tu", "molecule", ckpt_dir=str(tmp_path), fail_at=9, **kw)
    assert TCK.latest_step(str(tmp_path)) == 8
    resumed = TLT.train("gin-tu", "molecule", ckpt_dir=str(tmp_path), **kw)
    clean = TLT.train("gin-tu", "molecule", ckpt_dir=None, **kw)
    assert resumed["steps"] == 3 and clean["steps"] == 12
    assert resumed["last_loss"] == clean["last_loss"]
    a, b = TLT.state_tree(*resumed["state"]), TLT.state_tree(*clean["state"])
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert torch.equal(x, y)
    assert int(a[1]["count"]) == 12
    with pytest.raises(ValueError, match="not a training shape"):
        TLT.train("llama3.2-1b", "prefill_32k", smoke=True, steps=1, ckpt_dir=None,
                  ckpt_every=1, device=CPU)


@pytest.mark.parametrize("arch", ["gatedgcn", "nequip"])
def test_gnn_checkpoints_cross_between_packages(tmp_path, arch):
    """repro's GNN train state (nonzero moments, count 4) restores into the
    port's bundle state leaf for leaf, and the port's into repro's."""
    shape = HOME[arch]
    jb = JA.build(arch, shape, smoke=True)
    params, opt = jb.init(jax.random.key(0))
    opt = dict(opt, count=jnp.int32(4),
               mu=jax.tree_util.tree_map(lambda a: a + 0.5, opt["mu"]),
               nu=jax.tree_util.tree_map(lambda a: a + 0.25, opt["nu"]))
    JCK.save(str(tmp_path / "j"), (params, opt), step=4)
    tb = TA.build(arch, shape, smoke=True, device=CPU)
    tparams, topt = tb.init(torch.Generator().manual_seed(1))
    tree, man = TCK.restore(str(tmp_path / "j"), TLT.state_tree(tparams, topt))
    assert man["step"] == 4
    TLT.load_state_tree(tparams, topt, tree)
    got = TLT.state_tree(tparams, topt)
    jl = jax.tree_util.tree_leaves((params, opt))
    tl = leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert all(t.requires_grad for t in leaves(tparams))
    TCK.save(str(tmp_path / "t"), got, step=5)
    jback, jman = JCK.restore(str(tmp_path / "t"), (params, opt))
    assert jman["step"] == 5
    for a, b in zip(jax.tree_util.tree_leaves(jback), jl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dry_run_writes_gnn_records(tmp_path):
    """Every GNN cell writes a record (no skip) on meta at full size (one
    call an arch: ``--arch`` without ``--shape`` runs its four shapes): the
    three terms, the memory per block, repro's model FLOPs."""
    out = str(tmp_path)
    cells = [(a, s.name) for a in GNN_ARCHS for s in TCB.shapes_for(a)]
    for a in GNN_ARCHS:
        D.main(["--arch", a, "--out", out])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"{a}__{s}__single.json" for a, s in cells)
    for a, s in cells:
        r = json.loads((tmp_path / f"{a}__{s}__single.json").read_text())
        assert r["chips"] == 256 and r["applicable"]
        assert r["model_flops"] == JA.build(a, s).model_flops()
        assert min(r["compute_s"], r["memory_s"]) > 0 and r["collective_s"] == 0
        assert r["memory_per_device"]["temp_gb"] > 0 and r["per_device_gb"] > 0
        assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0


@pytest.mark.parametrize("arch,shape", [("gat-bonus", "full_graph_sm"),
                                        ("nequip", "molecule")])
def test_meta_counts_equal_cpu_counts(arch, shape):
    """A smoke train step counted on the CPU and on meta: equal FLOPs and
    bytes (the counter's scatter rule on both)."""
    counts = {}
    for dev in (CPU, "meta"):
        b = TA.build(arch, shape, smoke=True, device=dev)
        if dev == CPU:
            state = b.init(torch.Generator().manual_seed(0))
            inputs = dict(batch={k: torch.from_numpy(v)
                                 for k, v in TLT.make_batch_fn(b, 0)(0).items()})
        else:
            state, inputs = D.abstract_state(b), D.abstract_inputs(b)
        _, counts[dev] = D.count_step(b, state, inputs, mesh_name="x", chips=1)
    assert counts["meta"].totals() == counts[CPU].totals()
    ops = set(counts[CPU].by_op)
    # gathers through index_select, whose backward is an index_add_ (not a
    # sorted index_put_)
    assert {"index_add_", "index_select"} <= ops
    assert not ops & {"index", "index_put", "index_put_", "_index_put_impl_"}
    if arch == "gat-bonus":
        assert "scatter_reduce_" in ops


@pytest.mark.cuda
def test_deterministic_steps_bitwise_on_the_card():
    """Two train steps from one state on the card, under
    ``torch.use_deterministic_algorithms(True)``: bitwise equal (GAT:
    ``index_add_``, the gathers' backward and the segment max)."""
    needs_cuda()
    tb = TA.build("gat-bonus", "full_graph_sm", smoke=True, device="cuda")
    params, opt = tb.init(torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in TLT.make_batch_fn(tb, 0)(0).items()}
    outs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for _ in range(2):
            p, o = tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad),
                            (params, opt))
            p, o, m = tb.step(p, o, batch)
            outs.append([t.detach().cpu() for t in leaves((p, o))] + [m["loss"].cpu()])
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(*outs, strict=True):
        assert torch.equal(a, b)
