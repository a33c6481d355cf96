"""repro_torch's training substrate (``training/``) held against
``repro.training`` on the CPU: the schedules, AdamW (updates, the global-
norm clip, fp32 and bf16 state), ``make_train_step`` at 1 and 2
microbatches and with a ``grad_transform``, and both compressions.

Inputs are numpy draws from a seed, fed to both packages.  Tolerances:
schedules and learning rates 1e-6 relative (XLA's and torch's cos may
differ in the last bit); the gradient norm 1e-6 relative (the leaves are
summed in another order); parameters after the steps 1e-6 + 4 x lr
absolute (Adam turns a near-zero gradient into a step of +-lr, so a last-
bit difference in one can flip that element's step); moments 1e-6 of
each tensor's largest value; int8 and top-k compression exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.training import compression as JC
from repro.training import optimizer as JO
from repro.training import step as JS
from repro_torch.training import compression as TC
from repro_torch.training import optimizer as TO
from repro_torch.training import step as TS
from repro_torch.training import tree as TT
from torch_port_helpers import needs_cuda, one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}, "e": (7,)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def draw(rng, scale=1.0, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: draw(rng, scale, v) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def pair(tree, dtype="float32"):
    """One numpy tree as (repro's jnp tree, the port's tensor tree), both
    rounded to ``dtype`` once."""
    jdt, tdt = DTYPES[dtype]
    j = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), tree)
    t = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt), j)  # a copy
    return j, t


def as_np(tree):
    return [np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
                       np.float32)
            for x in jax.tree_util.tree_leaves(tree)]


def assert_trees(got, want, *, atol=0.0, rel=0.0):
    g, w = as_np(got), as_np(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=atol + rel * max(1e-30, float(np.abs(b).max())))


# ---------------------------------------------------------------------------
# Schedules and AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(3e-4, 100, 10_000, 0.0), (1e-3, 0, 50, 1e-5),
                                  (2e-4, 7, 7, 1e-6)], ids=["arch", "no_warmup", "flat"])
def test_schedules_match_repro(args):
    steps = np.array([0, 1, 3, 6, 7, 8, 50, 99, 100, 101, 5_000, 9_999, 10_000,
                      20_000], np.int32)
    j = JO.warmup_cosine_schedule(*args)(jnp.asarray(steps))
    t = TO.warmup_cosine_schedule(*args)(torch.from_numpy(steps))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=0)
    c = TO.constant_schedule(args[0])(torch.tensor(5, dtype=torch.int32))
    assert c.dtype == torch.float32 and c.shape == ()
    assert float(c) == float(JO.constant_schedule(args[0])(jnp.int32(5)))


def test_tree_leaves_follow_jax_order():
    tree = {"z": np.zeros(1), "a": {"y": np.ones(2), "b": [np.full(3, 2.0), np.full(1, 3.0)]}}
    jl = jax.tree_util.tree_leaves(tree)
    tl = TT.leaves(tree)
    assert [a.tolist() for a in tl] == [np.asarray(a).tolist() for a in jl]
    back = TT.unflatten(tree, [x * 2 for x in tl])
    assert list(back) == ["z", "a"] and back["a"]["b"][1].tolist() == [6.0]
    with pytest.raises(ValueError, match="fewer"):
        TT.unflatten(tree, tl[:-1])
    with pytest.raises(ValueError, match="more"):
        TT.unflatten(tree, tl + tl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("sched", ["warmup_cosine", "constant"])
def test_adamw_matches_repro(dtype, clip, sched):
    """Four updates (gradient scales 0.5, 2, 1e-6, 3: the clip acts on the
    large ones at clip 1) from the same parameters; bf16 parameters keep
    bf16 moments, as the arch bundles' rule gives."""
    rng = np.random.default_rng(0)
    jp, tp = pair(draw(rng), dtype)
    jdt, tdt = DTYPES[dtype]
    js_ = (JO.warmup_cosine_schedule(3e-4, 2, 10) if sched == "warmup_cosine"
           else JO.constant_schedule(1e-3))
    ts_ = (TO.warmup_cosine_schedule(3e-4, 2, 10) if sched == "warmup_cosine"
           else TO.constant_schedule(1e-3))
    jo = JO.AdamW(js_, clip_norm=clip, state_dtype=jdt)
    to = TO.AdamW(ts_, clip_norm=clip, state_dtype=tdt)
    jstate, tstate = jo.init(jp), to.init(tp)
    assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == 0
    assert all(m.dtype == tdt for m in TT.leaves(tstate["mu"]))
    update = jax.jit(jo.update)
    lr_max = 0.0
    for scale in (0.5, 2.0, 1e-6, 3.0):
        jg, tg = pair(draw(rng, scale), dtype)
        jp, jstate, jm = update(jg, jstate, jp)
        out = to.update(tg, tstate, tp)
        assert out[0] is tp and out[1] is tstate  # written in place
        tm = out[2]
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        lr_max = max(lr_max, float(jm["lr"]))
    assert int(tstate["count"]) == int(jstate["count"]) == 4
    assert all(p.dtype == tdt for p in TT.leaves(tp))
    assert_trees(tp, jp, atol=1e-6 + 4 * lr_max)
    for k in ("mu", "nu"):
        assert_trees(tstate[k], jstate[k], rel=1e-6)


def test_adamw_over_a_module_uses_its_named_parameters():
    """An ``nn.Module`` stands for the dict of its named parameters: the
    moments are keyed alike and the update writes the module's leaves."""
    mod = torch.nn.Linear(3, 2)
    opt = TO.AdamW(TO.constant_schedule(0.1))
    state = opt.init(mod)
    assert sorted(state["mu"]) == ["bias", "weight"]
    before = mod.weight.detach().clone()
    grads = {n: torch.ones_like(p) for n, p in mod.named_parameters()}
    opt.update(grads, state, mod)
    assert not torch.equal(before, mod.weight.detach())
    assert int(state["count"]) == 1


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

D_IN, D_H, D_OUT, B = 6, 8, 3, 8


def j_loss(p, batch):
    h = jnp.tanh(batch["x"] @ p["w1"])
    err = h @ p["w2"] + p["b"] - batch["y"]
    mse = jnp.mean(err * err)
    return mse + 0.01 * jnp.sum(p["w1"] ** 2), dict(mse=mse, h=jnp.mean(h))


def t_loss(p, batch):
    h = torch.tanh(batch["x"] @ p["w1"])
    err = h @ p["w2"] + p["b"] - batch["y"]
    mse = torch.mean(err * err)
    return mse + 0.01 * torch.sum(p["w1"] ** 2), dict(mse=mse, h=torch.mean(h))


@pytest.mark.parametrize("transform", [None, "int8", "topk"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_repro(microbatches, transform):
    """Three steps of a two-layer regression: loss, metrics, grad norm, lr
    and the parameters against repro's jitted step; 2 microbatches split
    the batch of 8 into two contiguous halves (the parts' gradients summed
    in fp32, then halved)."""
    rng = np.random.default_rng(1)
    params = dict(w1=rng.normal(size=(D_IN, D_H)).astype(np.float32),
                  w2=rng.normal(size=(D_H, D_OUT)).astype(np.float32),
                  b=np.zeros(D_OUT, np.float32))
    jp, tp = pair(params)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    jo = JO.AdamW(JO.warmup_cosine_schedule(1e-2, 1, 10))
    to = TO.AdamW(TO.warmup_cosine_schedule(1e-2, 1, 10))
    jgt = tgt = None
    if transform == "int8":
        jgt, tgt = JC.int8_compress, TC.int8_compress
    jstep = jax.jit(JS.make_train_step(j_loss, jo, microbatches=microbatches,
                                       grad_transform=jgt))
    tstep = TS.make_train_step(t_loss, to, microbatches=microbatches,
                               grad_transform=tgt)
    if transform == "topk":
        # the stateful transform rides outside the step, as the reference's
        # docstring has it: residuals carried by the caller
        jef, tef = JC.TopKErrorFeedback(0.3), TC.TopKErrorFeedback(0.3)
        jres, tres = jef.init(jp), tef.init(tp)
        box = {}

        def jgt(g):
            out, box["j"] = jef(g, box["jres"])
            return out

        def tgt(g):
            out, box["t"] = tef(g, box["tres"])
            return out

        jstep = JS.make_train_step(j_loss, jo, microbatches=microbatches,
                                   grad_transform=jgt)
        tstep = TS.make_train_step(t_loss, to, microbatches=microbatches,
                                   grad_transform=tgt)
    jstate, tstate = jo.init(jp), to.init(tp)
    lr_max = 0.0
    for _ in range(3):
        x = rng.normal(size=(B, D_IN)).astype(np.float32)
        y = rng.normal(size=(B, D_OUT)).astype(np.float32)
        if transform == "topk":
            box["jres"], box["tres"] = jres, tres
        jp, jstate, jm = jstep(jp, jstate, dict(x=jnp.asarray(x), y=jnp.asarray(y)))
        tp, tstate, tm = tstep(tp, tstate, dict(x=torch.from_numpy(x),
                                                y=torch.from_numpy(y)))
        if transform == "topk":
            jres, tres = box["j"], box["t"]
            assert_trees(tres, jres, rel=1e-6)
        assert sorted(tm) == sorted(jm) == ["grad_norm", "h", "loss", "lr", "mse"]
        for k in ("loss", "mse", "h", "grad_norm", "lr"):
            assert not tm[k].requires_grad
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        lr_max = max(lr_max, float(jm["lr"]))
    assert_trees(tp, jp, atol=1e-6 + 4 * lr_max)
    for k in ("mu", "nu"):
        assert_trees(tstate[k], jstate[k], rel=1e-5)


def test_train_step_refuses_frozen_parameters():
    p = {"w": torch.ones(2)}
    step = TS.make_train_step(lambda p, b: ((p["w"] * b["x"]).sum(), {}),
                              TO.AdamW(TO.constant_schedule(0.1)))
    with pytest.raises(RuntimeError, match="does not require grad"):
        step(p, TO.AdamW(TO.constant_schedule(0.1)).init(p), {"x": torch.ones(2)})


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def _grad_tree(rng):
    return dict(a=(rng.normal(size=(4, 5)) * 3).astype(np.float32),
                b=rng.normal(size=(33,)).astype(np.float32),
                z=np.zeros((3,), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compress_matches_repro(dtype):
    rng = np.random.default_rng(2)
    g = _grad_tree(rng)
    g["a"][0, 0] = 127.5 / 127.0 * np.abs(g["a"]).max()  # a tie at .5 after scaling
    jg, tg = pair(g, dtype)
    jg["n"], tg["n"] = jnp.arange(4, dtype=jnp.int32), torch.arange(4, dtype=torch.int32)
    jout, tout = JC.int8_compress(jg), TC.int8_compress(tg)
    for k in jout:
        assert tout[k].dtype == tg[k].dtype
        np.testing.assert_array_equal(np.asarray(tout[k].float() if tout[k].is_floating_point()
                                                 else tout[k]),
                                      np.asarray(jout[k], np.float32 if k != "n" else np.int32))
    # round half to even, as jnp.round
    assert torch.equal(torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])),
                       torch.tensor([0.0, 2.0, 2.0, -0.0]))


@pytest.mark.parametrize("fraction", [0.01, 0.25, 1.0])
def test_topk_error_feedback_matches_repro(fraction):
    """Two rounds with the residual carried: what is sent and what is kept
    back equal repro's exactly (k = the fraction of each tensor's entries,
    at least 1; the threshold is the k-th largest |g + r|)."""
    rng = np.random.default_rng(3)
    jef, tef = JC.TopKErrorFeedback(fraction), TC.TopKErrorFeedback(fraction)
    jg, tg = pair(_grad_tree(rng))
    jr, tr = jef.init(jg), tef.init(tg)
    for _ in range(2):
        jsent, jr = jef(jg, jr)
        tsent, tr = tef(tg, tr)
        assert_trees(tsent, jsent)
        assert_trees(tr, jr)
        jg, tg = pair(_grad_tree(rng))
    k = max(1, int(33 * fraction))
    assert int((tsent["b"] != 0).sum()) == k


@pytest.mark.cuda
def test_adamw_on_the_card_equals_the_cpu():
    """The update on CUDA tensors against the same update on the CPU (fp32
    state: 1e-6 of each tensor's largest value; the card's division by a
    Python number multiplies by its reciprocal)."""
    needs_cuda()
    rng = np.random.default_rng(4)
    p = {k: torch.from_numpy(v) for k, v in draw(rng).items() if k != "b"}
    g = {k: torch.from_numpy(v) for k, v in draw(rng, 2.0).items() if k != "b"}
    opt = TO.AdamW(TO.warmup_cosine_schedule(3e-4, 2, 10))
    cp = {k: v.clone() for k, v in p.items()}
    dp = {k: v.cuda() for k, v in p.items()}
    cs, ds = opt.init(cp), opt.init(dp)
    for _ in range(3):
        _, _, cm = opt.update(g, cs, cp)
        _, _, dm = opt.update({k: v.cuda() for k, v in g.items()}, ds, dp)
        np.testing.assert_allclose(float(dm["grad_norm"]), float(cm["grad_norm"]), rtol=1e-6)
    for k in cp:
        torch.testing.assert_close(dp[k].cpu(), cp[k], rtol=0, atol=1e-6)
