"""repro_torch's recsys family held against repro on the CPU: the
``wide-deep`` config and shapes (pinned copies), ``embedding_bag``,
``deep_tower``, ``widedeep_forward`` and ``widedeep_loss`` with their
gradients (ids below 0 and above V - 1 included), ``retrieval_scores`` and
the retrieval bundle's top-100, three train-bundle steps (parameters and
both moments), the two serve bundles, the parameter trees both ways, the
launcher's batches, checkpoints across the two packages, a fail ->
restart, the dry-run's eight records and the counter's rules for the
step's ops.

Inputs come from numpy seeds and weights from repro's ``init_widedeep``,
carried over by ``widedeep_from_params``.  fp32 throughout: logits and
losses within 1e-5 of their largest magnitude, gradients, parameters and
moments within 1e-5 of each tensor's largest (a table's gradient sums a
row's duplicates in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.arch as JA
from repro.checkpoint import checkpointer as JCK
from repro.configs import base as JCB
from repro.launch import train as JLT
from repro.models.recsys import widedeep as JW

import repro_torch.arch as TA
from repro_torch.checkpoint import checkpointer as TCK
from repro_torch.configs import base as TCB
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as TLT
from repro_torch.models.recsys import widedeep as TW
from repro_torch.roofline.analysis import OpCounter
from repro_torch.training.tree import leaves, tree_map
from torch_port_helpers import CPU, one_thread, rel_close  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "wide-deep"
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


def _smoke():
    return JCB.get_config(ARCH, smoke=True), TCB.get_config(ARCH, smoke=True)


def _params(cfg, seed=1):
    """repro's init (numpy) and the port's copy on the CPU, every leaf
    requiring grad."""
    jp = JW.init_widedeep(jax.random.key(seed), cfg)
    tp = TW.widedeep_from_params(jax.tree_util.tree_map(np.asarray, jp), CPU)
    return jp, tree_map(lambda t: t.requires_grad_(True), tp)


def _batch(cfg, B, seed, *, out_of_range):
    """A numpy batch; with ``out_of_range`` some ids below 0 and above V - 1
    (wrapping into range, and still out of range after the wrap)."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_per_field
    ids = rng.integers(0, V, (B, cfg.n_sparse))
    if out_of_range:
        bad = np.array([-1, -V, -V - 3, V, V + 5, -2 * V, 3 * V, -7])
        pos = rng.choice(ids.size, len(bad) * 3, replace=False)
        ids.flat[pos] = np.tile(bad, 3)
    return dict(sparse_ids=ids.astype(np.int32),
                dense=rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
                labels=rng.integers(0, 2, B).astype(np.int32))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads_close(tg, jg, what):
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for path, a, w in zip(paths, tg, jax.tree_util.tree_leaves(jg), strict=True):
        w = np.asarray(w)
        if float(np.abs(w).max()) == 0.0:
            assert float(a.abs().max()) == 0.0, (what, path)
        else:
            rel_close(a, w, 1e-5, f"{what} {path}")


# ---------------------------------------------------------------------------
# config, shapes, parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
def test_recsys_config_pinned_to_repro(smoke):
    j, t = JCB.get_config(ARCH, smoke=smoke), TCB.get_config(ARCH, smoke=smoke)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(TCB.RecsysConfig)] == \
        [f.name for f in dataclasses.fields(JCB.RecsysConfig)]
    assert TCB.family_of(ARCH) == j.family == "recsys"
    assert [(s.name, s.kind, s.dims) for s in TCB.shapes_for(ARCH)] == \
        [(s.name, s.kind, s.dims) for s in JCB.shapes_for(ARCH)]
    if not smoke:
        assert (t.n_sparse, t.embed_dim, t.mlp, t.vocab_per_field, t.n_dense) == \
            (40, 32, (1024, 512, 256), 1_000_000, 13)


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
def test_init_tree_matches_repro_and_carries_both_ways(smoke):
    """The port's init (``meta`` at full size) has repro's tree, shapes and
    dtypes; repro's draws cross into the port and back exactly."""
    j, t = JCB.get_config(ARCH, smoke=smoke), TCB.get_config(ARCH, smoke=smoke)
    want = jax.eval_shape(lambda k: JW.init_widedeep(k, j), jax.random.key(0))
    got = TW.init_widedeep(None, t)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
        tree_map(lambda x: 0, got))
    for w, g in zip(jax.tree_util.tree_leaves(want), leaves(got), strict=True):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
        assert g.device.type == "meta"
    if smoke:
        jp, tp = _params(j)
        for a, w in zip(leaves(TW.widedeep_to_params(tp)), jax.tree_util.tree_leaves(jp),
                        strict=True):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(w))
        drawn = TW.init_widedeep(torch.Generator().manual_seed(0), t)
        assert float(drawn["embed"].std()) == pytest.approx(0.01, rel=0.05)
        assert float(drawn["bias"]) == 0.0 and not drawn["mlp"][0]["b"].any()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_embedding_bag_equals_repro(mode, weighted):
    """Ids below 0 and above V - 1 clip; segments outside [0, num_bags)
    drop; the table's gradient (a random cotangent) as jax's."""
    rng = np.random.default_rng(4)
    V, D, T, nb = 40, 6, 64, 7
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(-5, V + 5, T).astype(np.int32)
    seg = rng.integers(-2, nb + 2, T).astype(np.int32)
    w = rng.uniform(0.5, 1.5, T).astype(np.float32) if weighted else None
    cot = rng.normal(size=(nb, D)).astype(np.float32)

    def jf(tab):
        return JW.embedding_bag(tab, jnp.asarray(ids), jnp.asarray(seg), nb, mode=mode,
                                weights=None if w is None else jnp.asarray(w))

    jout = jf(jnp.asarray(table))
    jg = jax.grad(lambda t: jnp.sum(jf(t) * cot))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    out = TW.embedding_bag(tt, torch.from_numpy(ids), torch.from_numpy(seg), nb, mode=mode,
                           weights=None if w is None else torch.from_numpy(w))
    (g,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), tt)
    rel_close(out, np.asarray(jout), 1e-5, "bags")
    rel_close(g, np.asarray(jg), 1e-5, "table gradient")
    empty = np.setdiff1d(np.arange(nb), seg)
    assert len(empty) == 0 or not bool(out[torch.from_numpy(empty)].any())


def test_field_gather_reads_and_drops_like_jax_indexing():
    """V = 5: ids 7, -1, -6 read rows 4, 4, 0 (a negative id wraps once,
    then clamps); only the wrapped in-range id passes a gradient."""
    table = torch.arange(15.0).reshape(1, 5, 3).requires_grad_(True)
    ids = torch.tensor([[7], [-1], [-6], [2]], dtype=torch.int32)
    out = TW.field_gather(table, ids)
    assert out[:, 0, 0].tolist() == [12.0, 12.0, 0.0, 6.0]
    (g,) = torch.autograd.grad(out.sum(), table)
    jt = jnp.arange(15.0).reshape(1, 5, 3)
    jids = jnp.asarray(ids.numpy())
    jg = jax.grad(lambda t: t[jnp.arange(1)[None, :], jids].sum())(jt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert g[0, :, 0].tolist() == [0.0, 0.0, 1.0, 0.0, 1.0]


@pytest.mark.parametrize("out_of_range", [False, True], ids=["in_range", "out_of_range"])
def test_forward_loss_and_gradients_equal_repro(out_of_range):
    cfg, tcfg = _smoke()
    jp, tp = _params(cfg)
    b = _batch(cfg, 48, 7, out_of_range=out_of_range)
    jb, tb = {k: jnp.asarray(v) for k, v in b.items()}, _t(b)
    rel_close(TW.deep_tower(tp, tb["sparse_ids"], tb["dense"], tcfg),
              np.asarray(JW.deep_tower(jp, jb["sparse_ids"], jb["dense"], cfg)), 1e-5,
              "deep tower")
    rel_close(TW.widedeep_forward(tp, tb, tcfg),
              np.asarray(JW.widedeep_forward(jp, jb, cfg)), 1e-5, "logits")
    jl, jg = jax.value_and_grad(lambda p: JW.widedeep_loss(p, jb, cfg)[0])(jp)
    tl, metrics = TW.widedeep_loss(tp, tb, tcfg)
    assert set(metrics) == {"bce"}
    rel_close(tl, np.asarray(jl), 1e-5, "loss")
    tg = torch.autograd.grad(tl, leaves(tp))
    _grads_close(tg, jg, "loss gradient")
    # the tower's and the logits' gradients too (random cotangents)
    cot = np.random.default_rng(8).normal(size=(48,)).astype(np.float32)
    jgf = jax.grad(lambda p: jnp.sum(JW.widedeep_forward(p, jb, cfg) * cot))(jp)
    tgf = torch.autograd.grad((TW.widedeep_forward(tp, tb, tcfg) * torch.from_numpy(cot)
                               ).sum(), leaves(tp))
    _grads_close(tgf, jgf, "logit gradient")


def test_retrieval_scores_and_top100_equal_repro():
    """The retrieval bundle at smoke size (512 candidates, some out of
    range and some repeated): the scores at 1e-5, the top-100 values at
    1e-5 and the ids equal where the scores are untied."""
    cfg, tcfg = _smoke()
    jp, tp = _params(cfg, seed=2)
    jbund = JA.build(ARCH, "retrieval_cand", smoke=True)
    tbund = TA.build(ARCH, "retrieval_cand", smoke=True, device=CPU)
    nc = tbund.input_specs()["batch"]["cand_ids"].shape[0]
    assert nc == jbund.input_specs()["batch"]["cand_ids"].shape[0] == 512
    rng = np.random.default_rng(3)
    b = _batch(cfg, 1, 9, out_of_range=False)
    del b["labels"]
    cand = rng.integers(-20, cfg.vocab_per_field + 20, nc).astype(np.int32)
    cand[:8] = cand[8:16]  # repeated candidates tie
    b["cand_ids"] = cand
    jb, tb = {k: jnp.asarray(v) for k, v in b.items()}, _t(b)
    rel_close(TW.retrieval_scores(tp, tb, tcfg),
              np.asarray(JW.retrieval_scores(jp, jb, cfg)), 1e-5, "scores")
    jv, ji = jax.jit(jbund.step)(jp, jb)
    with torch.no_grad():
        tv, ti = tbund.step(tp, tb)
    assert tv.shape == ti.shape == (100,)
    rel_close(tv, np.asarray(jv), 1e-5, "top-100 values")
    v = np.asarray(jv, np.float64)
    tol = 1e-5 * float(np.abs(v).max())
    gaps = np.abs(np.diff(v)) > 2 * tol
    untied = np.ones(100, bool)
    untied[:-1] &= gaps
    untied[1:] &= gaps
    assert untied.sum() > 50
    np.testing.assert_array_equal(ti.numpy()[untied], np.asarray(ji)[untied])
    # tied places hold candidates of equal score
    scores = TW.retrieval_scores(tp, tb, tcfg).detach()
    np.testing.assert_array_equal(scores[ti].numpy(), tv.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_bundle_specs_flops_and_shrink_equal_repro(shape):
    """Full size and smoke: the batch specs (retrieval's candidates padded
    to 8,192: 1,000,000 -> 1,007,616), model FLOPs and the shrunk shape."""
    for smoke in (False, True):
        jb = JA.build(ARCH, shape, smoke=smoke)
        tb = TA.build(ARCH, shape, smoke=smoke, device="meta")
        assert (tb.shape.name, tb.shape.kind, tb.shape.dims) == \
            (jb.shape.name, jb.shape.kind, jb.shape.dims)
        js, ts = jb.input_specs()["batch"], tb.input_specs()["batch"]
        assert list(ts) == list(js)
        for k, s in ts.items():
            assert s.shape == js[k].shape, k
            assert str(s.dtype).removeprefix("torch.") == str(js[k].dtype), k
        assert tb.model_flops() == jb.model_flops()
    if shape == "retrieval_cand":
        full = TA.build(ARCH, shape, device="meta").input_specs()["batch"]["cand_ids"]
        assert full.shape == (1_007_616,)


def test_train_bundle_three_steps_equal_repro():
    """Three AdamW steps at smoke size from repro's init state on the
    launcher's batches of both packages (equal arrays): losses, gradient
    norms, parameters and both moments."""
    jb = JA.build(ARCH, "train_batch", smoke=True)
    tb = TA.build(ARCH, "train_batch", smoke=True, device=CPU)
    params, opt = jb.init(jax.random.key(0))
    tparams, topt = tb.init(torch.Generator().manual_seed(0))
    TLT.load_state_tree(tparams, topt, jax.tree_util.tree_map(np.asarray, (params, opt)))
    jmake, tmake = JLT.make_batch_fn(jb, 0), TLT.make_batch_fn(tb, 0)
    jstep = jax.jit(jb.step)
    for i in range(3):
        jbatch, tbatch = jmake(i), tmake(i)
        for k in jbatch:
            np.testing.assert_array_equal(tbatch[k], jbatch[k])
        params, opt, jm = jstep(params, opt, jbatch)
        tparams, topt, tm = tb.step(tparams, topt, _t(tbatch))
        rel_close(tm["loss"], jm["loss"], 1e-5, f"step {i} loss")
        rel_close(tm["bce"], jm["bce"], 1e-5, f"step {i} bce")
        rel_close(tm["grad_norm"], jm["grad_norm"], 1e-5, f"step {i} grad norm")
    assert int(topt["count"]) == int(opt["count"]) == 3
    for what, t, j in (("params", tparams, params), ("mu", topt["mu"], opt["mu"]),
                       ("nu", topt["nu"], opt["nu"])):
        paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(j)[0]]
        for path, a, w in zip(paths, leaves(t), jax.tree_util.tree_leaves(j), strict=True):
            rel_close(a, np.asarray(w), 1e-5, f"{what} {path}")


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
def test_serve_bundles_equal_repro(shape):
    jb = JA.build(ARCH, shape, smoke=True)
    tb = TA.build(ARCH, shape, smoke=True, device=CPU)
    (params,) = jb.init(jax.random.key(5))
    (tparams,) = tb.init(torch.Generator().manual_seed(5))
    assert not any(t.requires_grad for t in leaves(tparams))
    tparams = TW.widedeep_from_params(jax.tree_util.tree_map(np.asarray, params), CPU)
    cfg = jb.cfg
    b = _batch(cfg, jb.shape.dims["batch"], 11, out_of_range=True)
    del b["labels"]
    want = jax.jit(jb.step)(params, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.inference_mode():
        got = tb.step(tparams, _t(b))
    assert got.shape == (jb.shape.dims["batch"],)
    rel_close(got, np.asarray(want), 1e-5, f"{shape} logits")


# ---------------------------------------------------------------------------
# the launcher, checkpoints, the dry-run, the counter
# ---------------------------------------------------------------------------


def test_make_batch_fn_equals_repro():
    jb = JA.build(ARCH, "train_batch", smoke=True)
    tb = TA.build(ARCH, "train_batch", smoke=True, device=CPU)
    jf, tf = JLT.make_batch_fn(jb, 5), TLT.make_batch_fn(tb, 5)
    for step in (0, 3):
        got, want = tf(step), jf(step)
        assert list(got) == list(want) == ["sparse_ids", "dense", "labels"]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    full = TA.build(ARCH, "train_batch", device="meta")
    b = TLT.make_batch_fn(full, 0)(0)
    assert b["sparse_ids"].shape == (65_536, 40) and b["sparse_ids"].max() < 1_000_000


def test_checkpoints_cross_between_packages(tmp_path):
    """repro's Wide & Deep train state (nonzero moments, count 4) restores
    into the port's bundle state leaf for leaf, and the port's into
    repro's."""
    jb = JA.build(ARCH, "train_batch", smoke=True)
    params, opt = jb.init(jax.random.key(0))
    opt = dict(opt, count=jnp.int32(4),
               mu=jax.tree_util.tree_map(lambda a: a + 0.5, opt["mu"]),
               nu=jax.tree_util.tree_map(lambda a: a + 0.25, opt["nu"]))
    JCK.save(str(tmp_path / "j"), (params, opt), step=4)
    tb = TA.build(ARCH, "train_batch", smoke=True, device=CPU)
    tparams, topt = tb.init(torch.Generator().manual_seed(1))
    tree, man = TCK.restore(str(tmp_path / "j"), TLT.state_tree(tparams, topt))
    assert man["step"] == 4
    TLT.load_state_tree(tparams, topt, tree)
    got = TLT.state_tree(tparams, topt)
    jl, tl = jax.tree_util.tree_leaves((params, opt)), leaves(got)
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


def test_recsys_fail_then_restart_equals_a_clean_run(tmp_path):
    kw = dict(smoke=True, steps=10, ckpt_every=3, device=CPU)
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        TLT.train(ARCH, "train_batch", ckpt_dir=str(tmp_path), fail_at=7, **kw)
    assert TCK.latest_step(str(tmp_path)) == 6
    resumed = TLT.train(ARCH, "train_batch", ckpt_dir=str(tmp_path), **kw)
    clean = TLT.train(ARCH, "train_batch", ckpt_dir=None, **kw)
    assert resumed["steps"] == 3 and clean["steps"] == 10
    a, b = TLT.state_tree(*resumed["state"]), TLT.state_tree(*clean["state"])
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert torch.equal(x, y)
    assert clean["last_loss"] < clean["first_loss"]
    with pytest.raises(ValueError, match="not a training shape"):
        TLT.train(ARCH, "serve_p99", smoke=True, steps=1, ckpt_dir=None, ckpt_every=1,
                  device=CPU)


def test_dry_run_writes_recsys_records(tmp_path):
    """The four cells on meta at full size on both meshes: no skip, no
    FAILED record; repro's model FLOPs; the train step counted with its
    backward and AdamW, the serve and retrieval steps without."""
    D.main(["--arch", ARCH, "--mesh", "both", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"{ARCH}__{s}__{m}.json" for s in SHAPES
                           for m in ("single", "multi"))
    import json

    for s in SHAPES:
        r = {m: json.loads((tmp_path / f"{ARCH}__{s}__{m}.json").read_text())
             for m in ("single", "multi")}
        assert (r["single"]["chips"], r["multi"]["chips"]) == (256, 512)
        assert r["single"]["model_flops"] == JA.build(ARCH, s).model_flops()
        assert r["single"]["hlo_flops"] == pytest.approx(2 * r["multi"]["hlo_flops"],
                                                         rel=1e-12)
        assert r["single"]["fits_hbm"] and r["single"]["collective_bytes"] == 0
        ops = {o[0] for o in r["single"]["top_ops"]}
        assert ops
    train = json.loads((tmp_path / f"{ARCH}__train_batch__single.json").read_text())
    bulk = json.loads((tmp_path / f"{ARCH}__serve_bulk__single.json").read_text())
    assert train["bottleneck"] == "memory"  # AdamW over 1.32e9 fp32 parameters
    assert bulk["bottleneck"] == "compute"  # fp32 GEMMs at batch 262,144
    # the train step's state: params and two moments of 1,321,981,454 fp32
    # values (tables 1.28e9 + 4e7, MLP and head 1,981,453, bias), and the batch
    n_params = 40 * 1_000_000 * 33 + 13 + 1 + 1293 * 1024 + 1024 * 512 + 512 * 256 \
        + 256 + 1024 + 512 + 256
    assert n_params == 1_321_981_454
    assert train["memory_per_device"]["argument_gb"] * 256 == pytest.approx(
        (3 * 4 * n_params + 65_536 * (40 + 13 + 1) * 4) * 1e-9, rel=1e-6)


def test_counter_rules_for_the_recsys_ops():
    """The lookups' backward (``index_add_`` into the zeroed tables): one
    add per gathered element, indices and rows read, the addressed rows
    read and written; ``topk``: one operation per candidate; the loss's
    ops counted elementwise."""
    cfg, tcfg = _smoke()
    _, tp = _params(cfg)
    b = _t(_batch(cfg, 32, 2, out_of_range=False))
    c = OpCounter()
    with c:
        loss, _ = TW.widedeep_loss(tp, b, tcfg)
        torch.autograd.grad(loss, leaves(tp))
    # index_select's backward: zeros, then index_add (the counter sees the
    # functional form; the index_add_ rule counts both)
    (n, w), = [c.by_op[k] for k in ("index_add", "index_add_") if k in c.by_op]
    F_, Dm = cfg.n_sparse, cfg.embed_dim
    assert n == 2  # the embed and wide tables
    assert w.flops == 32 * F_ * (Dm + 1)
    assert w.bytes == (2 * 32 * F_ * 8  # int64 rows of both gathers
                       + 3 * 32 * F_ * (Dm + 1) * 4)  # rows read, table rows r/w
    assert c.by_op["index_select"][0] == 2  # the two tables
    for op in ("log1p", "exp", "abs", "maximum", "mean"):
        assert op in c.by_op, op
    tb = TA.build(ARCH, "retrieval_cand", smoke=True, device=CPU)
    (params,) = tb.init(torch.Generator().manual_seed(0))
    inputs = D.abstract_inputs(tb, CPU)
    rep, counter = D.count_step(tb, (params,), inputs, mesh_name="cpu", chips=1)
    n, w = counter.by_op["topk"]
    assert n == 1 and w.flops == 512
    assert w.bytes == 512 * 4 + 100 * 4 + 100 * 8
