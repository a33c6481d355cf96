"""repro_torch's LM training path held against repro's on the CPU:
``lm_loss`` and its gradients for the Llama, Qwen-MoE and DeepSeek-MLA
SMOKE configs through carried parameters (repro's ``init_lm`` draws copied
by ``lm_from_params`` and back by ``lm_to_params``), three steps of the
``train_4k`` bundle against repro's on the same carried ``(params,
opt_state)`` and ``synthetic.lm_batch``, gradients through ``sdpa``'s
chunked in-place writes and masks, remat on against off, and the refusal
of the flash kernel under grad.

Tolerances (fp32): the loss and its parts 1e-5 relative; each gradient
tensor 1e-4 of its largest value; after the steps the parameters 1e-6 + 4
x the largest lr absolute (Adam turns a near-zero gradient into a step of
+-lr, so fp32 noise can flip one element's step), the moments 1e-4 of
each tensor's largest value, loss / grad_norm / lr 1e-5 relative.  Remat
on and off are bitwise equal.  MoE routing runs at capacity factor 4
(SMOKE), so no assignment is dropped, and in fp32 no top-k choice is near
enough to a tie to flip between the packages.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.arch as JA
from repro.configs import deepseek_v2_lite_16b as j_ds
from repro.configs import llama3_2_1b as j_llama
from repro.configs import qwen2_moe_a2_7b as j_qw
from repro.data import synthetic as j_syn
from repro.models.transformer import attention as JATT
from repro.models.transformer import model as JM

import repro_torch.arch as TA
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.train import load_state_tree, state_tree
from repro_torch.models.transformer import attention as TATT
from repro_torch.models.transformer import model as TM
from torch_port_helpers import (  # noqa: F401  (one_thread: a fixture)
    CPU, bf16_params, int_tokens, lm_pair, needs_cuda, one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")

SMOKES = {"llama": j_llama.SMOKE, "qwen": j_qw.SMOKE, "deepseek": j_ds.SMOKE}
GRAD_TOL = 1e-4


def paths(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_scaled(got: dict, want: dict, tol: float, atol: float = 0.0):
    """Same leaves; each within ``tol`` of its largest |value| (+ ``atol``)."""
    g, w = paths(got), paths(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        scale = float(np.abs(w[k]).max())
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol + tol * scale,
                                   err_msg=k)


def batches(jcfg, form: str, seed: int = 0):
    toks = int_tokens(seed, (2, 33), jcfg.vocab)
    b = (dict(tokens=toks[:, :-1], targets=toks[:, 1:]) if form == "targets"
         else dict(tokens=toks))
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def carried(jcfg):
    """A fresh trainable port model carrying repro's draws for ``jcfg``."""
    params, _, tcfg = lm_pair(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, TM.lm_from_params(tree, tcfg, device=CPU).requires_grad_(True), tcfg


def port_grads(model, loss) -> dict:
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return TM.to_numpy(TM.stack_layers(dict(zip(names, grads))))


@pytest.mark.parametrize("form", ["targets", "shifted"])
@pytest.mark.parametrize("name", ["llama", "qwen", "deepseek"])
def test_lm_loss_and_grads_match_repro(name, form):
    jcfg = SMOKES[name]
    params, model, tcfg = carried(jcfg)
    jb, tb = batches(jcfg, form)
    vg = jax.jit(jax.value_and_grad(partial(JM.lm_loss, cfg=jcfg), has_aux=True))
    (jl, jm), jg = vg(params, jb)
    tl, tm = TM.lm_loss(model, tb, tcfg)
    assert tl.dtype == torch.float32 and tl.shape == ()
    for got, want in ((tl, jl), (tm["nll"], jm["nll"]), (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                                   atol=1e-9)
    assert (float(tm["aux"]) > 0) == (jcfg.moe is not None)
    assert_scaled(port_grads(model, tl), jax.tree_util.tree_map(np.asarray, jg), GRAD_TOL)


@pytest.mark.parametrize("name", ["llama", "qwen", "deepseek"])
def test_lm_to_params_inverts_lm_from_params(name):
    """The stacked layout comes back leaf for leaf, in fp32 and (upcast,
    lossless) from bf16 leaves; ``unstack_layers`` writes it back."""
    params, model, tcfg = carried(SMOKES[name])
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = TM.lm_to_params(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for k, v in paths(tree).items():
        np.testing.assert_array_equal(paths(back)[k], v)
    bf = jax.tree_util.tree_map(np.asarray, bf16_params(params))
    bcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    bmodel = TM.lm_from_params(bf, bcfg, device=CPU)
    for k, v in paths(TM.lm_to_params(bmodel)).items():
        np.testing.assert_array_equal(v, paths(bf)[k])
    fresh = TM.init_lm(torch.Generator().manual_seed(5), tcfg)
    TM.unstack_layers(back, dict(fresh.named_parameters()))
    mine = dict(fresh.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(mine[n], p), n


@pytest.mark.parametrize("name", ["llama", "qwen", "deepseek"])
def test_train_bundle_steps_match_repro(name):
    """Three steps of the SMOKE ``train_4k`` bundles (batch 2, seq 64) from
    repro's ``init`` state carried into the port, on repro's
    ``synthetic.lm_batch``: loss, grad_norm and lr each step; parameters
    and moments after the third."""
    jcfg = SMOKES[name]
    arch = jcfg.name.removesuffix("-smoke")
    jb = JA.build(arch, "train_4k", smoke=True)
    tb = TA.build(arch, "train_4k", smoke=True, device=CPU, use_kernel=False)
    assert tb.model_flops() == jb.model_flops()
    assert {k: (s.shape, str(s.dtype).removeprefix("torch."))
            for k, s in tb.input_specs()["batch"].items()} == {
        k: (s.shape, str(s.dtype)) for k, s in jb.input_specs()["batch"].items()}
    params, opt_state = jb.init(jax.random.key(0))
    model, topt = tb.init(torch.Generator().manual_seed(0))
    assert all(p.requires_grad for p in model.parameters())
    load_state_tree(model, topt, jax.tree_util.tree_map(np.asarray, (params, opt_state)))
    B, S = tb.shape.dims["global_batch"], tb.shape.dims["seq_len"]
    jstep = jax.jit(jb.step)
    lr_max = 0.0
    for step in range(3):
        b = j_syn.lm_batch(0, step, B, S, jcfg.vocab)
        params, opt_state, jm = jstep(params, opt_state,
                                      {k: jnp.asarray(v) for k, v in b.items()})
        out = tb.step(model, topt, {k: torch.from_numpy(v) for k, v in b.items()})
        assert out[0] is model and out[1] is topt
        tm = out[2]
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-9, err_msg=f"step {step} {k}")
        lr_max = max(lr_max, float(jm["lr"]))
    tparams, topt_tree = state_tree(model, topt)
    assert int(topt_tree["count"]) == int(opt_state["count"]) == 3
    assert_scaled(TM.to_numpy(tparams), jax.tree_util.tree_map(np.asarray, params),
                  0.0, atol=1e-6 + 4 * lr_max)
    for k in ("mu", "nu"):
        assert_scaled(TM.to_numpy(topt_tree[k]),
                      jax.tree_util.tree_map(np.asarray, opt_state[k]), 1e-4)


def test_train_bundle_state_layout_and_bf16_rule():
    """The full Llama config's train state on ``meta``: bf16 parameters
    requiring grad, bf16 moments (the reference's rule), an int32 count;
    the SMOKE config's fp32 moments; ``model_flops`` = 6 N_active B S."""
    tb = TA.build("llama3.2-1b", "train_4k", device="meta", use_kernel=False)
    model, opt = tb.init()
    assert all(p.is_meta and p.dtype == torch.bfloat16 and p.requires_grad
               for p in model.parameters())
    assert all(m.dtype == torch.bfloat16 for m in opt["mu"].values())
    assert opt["count"].dtype == torch.int32
    assert sorted(opt["nu"]) == sorted(n for n, _ in model.named_parameters())
    cfg = tb.cfg
    assert tb.model_flops() == 6.0 * cfg.params_active * 256 * 4096
    smoke = TA.build("llama3.2-1b", "train_4k", smoke=True, device=CPU, use_kernel=False)
    _, sopt = smoke.init(torch.Generator().manual_seed(0))
    assert all(m.dtype == torch.float32 for m in sopt["mu"].values())


def test_remat_on_equals_off_and_recomputes():
    """``cfg.remat`` checkpoints each block: the loss and every gradient are
    bitwise those without it, and each block's forward runs twice (once
    more in the backward pass)."""
    jcfg = SMOKES["llama"]
    _, model, tcfg = carried(jcfg)
    _, tb = batches(jcfg, "targets")
    calls = []
    real = TM._block_forward

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        calls.clear()
        TM._block_forward = counting
        try:
            loss, _ = TM.lm_loss(model, tb, cfg)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        finally:
            TM._block_forward = real
        results.append((loss, grads, len(calls)))
    (l0, g0, n0), (l1, g1, n1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert (n0, n1) == (tcfg.n_layers, 2 * tcfg.n_layers)
    with torch.no_grad():  # no grad, no checkpoint: one forward a block
        calls.clear()
        TM._block_forward = counting
        try:
            TM.lm_loss(model, tb, dataclasses.replace(tcfg, remat=True))
        finally:
            TM._block_forward = real
        assert len(calls) == tcfg.n_layers


@pytest.mark.parametrize("chunk_q", [4, 64], ids=["chunked", "one_block"])
def test_sdpa_gradients_through_chunks_and_masks_match_repro(chunk_q):
    """Gradients of the plain ``sdpa`` (causal GQA, S 16) with the query
    chunks written in place into its output and the masks filled in place,
    against ``jax.grad`` of repro's ``sdpa`` at the same chunking; the
    kv_len mask too (decode's, S 1)."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    w = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)

    def jf(q, k, v):
        return jnp.sum(JATT.sdpa(q, k, v, chunk_q=chunk_q) * w)

    jg = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = TATT.sdpa(tq, tk, tv, chunk_q=chunk_q)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for got, want in zip(tg, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    kv_len = np.array([5, 16], np.int32)
    jg = jax.grad(lambda k: jnp.sum(JATT.sdpa(q[:, :1], k, v, causal_offset=None,
                                              kv_len=jnp.asarray(kv_len))))(k)
    out = TATT.sdpa(tq[:, :1].detach(), tk, tv, causal_offset=None,
                    kv_len=torch.from_numpy(kv_len))
    (gk,) = torch.autograd.grad(out.sum(), (tk,))
    assert float(gk[0, 5:].abs().max()) == 0.0  # masked keys get no gradient
    np.testing.assert_allclose(gk.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jg)).max()))


def _qkv(device, grad=True):
    q = torch.zeros((1, 8, 4, 16), device=device, requires_grad=grad)
    k = torch.zeros((1, 8, 2, 16), device=device, requires_grad=grad)
    v = torch.zeros((1, 8, 2, 16), device=device, requires_grad=grad)
    return q, k, v


def test_flash_under_grad_is_refused_on_meta():
    """The kernel has no backward: on ``meta`` (as on CUDA) a call with
    grad enabled and q / k / v requiring grad raises, directly and through
    ``sdpa(use_kernel=True)``; without grad it takes its meta route; the
    CPU route stays the differentiable plain version; the train bundle
    refuses ``use_kernel=True`` before any step."""
    q, k, v = _qkv("meta")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        TATT.sdpa(q, k, v, use_kernel=True)
    with torch.no_grad():
        assert flash_attention(q, k, v).is_meta
    assert flash_attention(*_qkv("meta", grad=False)).is_meta
    cq, ck, cv = (torch.randn(x.shape, generator=torch.Generator().manual_seed(i))
                  .requires_grad_(True) for i, x in enumerate(_qkv("meta")))
    g_flash = torch.autograd.grad(flash_attention(cq, ck, cv).sum(), (cq, ck, cv))
    g_plain = torch.autograd.grad(TATT.sdpa(cq, ck, cv).sum(), (cq, ck, cv))
    for a, b in zip(g_flash, g_plain):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for dev in (CPU, "meta"):
        with pytest.raises(ValueError, match="no backward"):
            TA.build("llama3.2-1b", "train_4k", smoke=True, device=dev)
        with pytest.raises(ValueError, match="use_kernel=False"):
            TA.build("qwen2-moe-a2.7b", "train_4k", smoke=True, device=dev,
                     use_kernel=True)


@pytest.mark.cuda
def test_flash_under_grad_is_refused_on_the_card():
    needs_cuda()
    q, k, v = (x.to(torch.bfloat16) for x in _qkv("cuda", grad=False))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape


@pytest.mark.cuda
def test_train_bundle_on_the_card_equals_the_cpu():
    """Three SMOKE train steps on the card from the CPU's state: losses and
    parameters within fp32 noise (1e-5 relative; 1e-6 + 4 x lr)."""
    needs_cuda()
    from repro_torch.data import synthetic

    cpu = TA.build("llama3.2-1b", "train_4k", smoke=True, device=CPU, use_kernel=False)
    gpu = TA.build("llama3.2-1b", "train_4k", smoke=True, device="cuda", use_kernel=False)
    cm, co = cpu.init(torch.Generator().manual_seed(0))
    gm, go = gpu.init(torch.Generator(device="cuda").manual_seed(0))
    load_state_tree(gm, go, state_tree(cm, co))
    B, S = cpu.shape.dims["global_batch"], cpu.shape.dims["seq_len"]
    for step in range(3):
        b = synthetic.lm_batch(0, step, B, S, cpu.cfg.vocab)
        _, _, c = cpu.step(cm, co, {k: torch.from_numpy(v) for k, v in b.items()})
        _, _, g = gpu.step(gm, go, {k: torch.from_numpy(v).cuda() for k, v in b.items()})
        np.testing.assert_allclose(float(g["loss"]), float(c["loss"]), rtol=1e-5)
    mine = dict(cm.named_parameters())
    for n, p in gm.named_parameters():
        torch.testing.assert_close(p.detach().cpu(), mine[n].detach(), rtol=0,
                                   atol=1e-6 + 4 * float(c["lr"]), msg=n)
