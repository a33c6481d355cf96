"""repro_torch's LM serving path held against repro's.

The weights are repro's ``init_lm`` draws, turned into the port's module by
``lm_from_params``; tokens come from numpy with a seed.  fp32 compute
agrees to 1e-4 (reductions in another order, rope angles from another pow),
the tolerance of tests/test_models.py's decode-vs-forward check.  The
bf16-compute case rounds every activation to bf16 in both packages at
slightly different places, and its logits are themselves bf16 products:
it is held at 2e-2 of the logits' scale, about two and a half bf16 steps
at magnitude 1 (0.0078 measured on the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import arch as j_arch
from repro.configs import llama3_2_1b as j_llama
from repro.configs.base import TransformerConfig as JConfig
from repro.models.transformer import model as JM
from repro_torch import arch as t_arch
from repro_torch.configs import base as t_base
from repro_torch.configs import llama3_2_1b as t_llama
from repro_torch.models.transformer import model as TM
from torch_port_helpers import close_scaled, int_tokens, lm_pair, port_lm_cfg

CPU = "cpu"
FP32_TOL = 1e-4
BF16_TOL = 2e-2

TINY_GQA = JConfig(
    name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, param_dtype="float32", compute_dtype="float32",
    remat=False,
)
CONFIGS = {"tiny_gqa": TINY_GQA, "llama_smoke": j_llama.SMOKE}


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# ---------------------------------------------------------------------------
# configs and conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_llama_configs_pinned_to_repro(which):
    j, t = getattr(j_llama, which), getattr(t_llama, which)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.params_dense, t.params_active) == (j.params_dense, j.params_active)
    assert t_base.get_config("llama3.2-1b", smoke=which == "SMOKE") == t
    shapes = [(s.name, s.kind, s.dims) for s in t_base.shapes_for("llama3.2-1b")]
    assert shapes == [(s.name, s.kind, s.dims) for s in j_arch.shapes_for("llama3.2-1b")]


def test_unported_configs_and_kinds_raise():
    # every config of the reference is ported (wide-deep last); an arch the
    # reference does not have raises, as there
    assert t_base.get_config("wide-deep").family == "recsys"
    assert all(a in t_base._MODULE_OF for a in t_base.ARCH_IDS)
    with pytest.raises(KeyError):
        t_base.get_config("llama3.2-2b")
    # the train kind is ported; it refuses the flash kernel (no backward)
    with pytest.raises(ValueError, match="no backward"):
        t_arch.build("llama3.2-1b", "train_4k", smoke=True, device=CPU)
    with pytest.raises(ValueError, match="no backward"):
        t_arch.build("qwen2-moe-a2.7b", "train_4k", smoke=True, device=CPU)
    # any attention kind but MLA runs as GQA, as in the reference (no kind is
    # left unported to refuse)
    other = dataclasses.replace(TINY_GQA, attention="linear")
    got = TM.init_cache(port_lm_cfg(other), 1, 4, CPU)
    want = JM.init_cache(other, 1, 4)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in got] == \
        [{k: v.shape for k, v in c.items()} for c in want]


def stacked(model, tcfg) -> dict:
    """The port's parameters in the reference's pytree layout (numpy fp32)."""
    def merge(trees):
        if isinstance(trees[0], dict):
            return {k: merge([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees).float().numpy()

    tree = model.tree()
    out = {k: v.float().numpy() for k, v in tree.items() if not k.startswith("stage")}
    for si, _ in enumerate(TM.stages_of(tcfg)):
        out[f"stage{si}"] = merge([b.tree() for b in model.stage(si)])
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_lm_layout_matches_repro(name):
    """The converter copies the reference's pytree exactly, and the port's
    own init draws leaves of the same shapes and distributions."""
    jcfg = CONFIGS[name]
    params, model, tcfg = lm_pair(jcfg)
    ref = numpy_tree(params)
    conv = stacked(model, tcfg)
    mine = stacked(TM.init_lm(torch.Generator().manual_seed(0), tcfg), tcfg)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    ref_leaves = flat(ref)
    assert [p for p, _ in flat(conv)] == [p for p, _ in ref_leaves]
    assert [p for p, _ in flat(mine)] == [p for p, _ in ref_leaves]
    for (_, r), (_, c), (_, m) in zip(ref_leaves, flat(conv), flat(mine)):
        np.testing.assert_array_equal(c, r.astype(np.float32))
        assert m.shape == r.shape
    assert 0.015 < float(mine["embed"].std()) < 0.025  # N(0, 0.02^2)


# ---------------------------------------------------------------------------
# forward and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_lm_forward_matches_repro(name, use_kernel):
    jcfg = CONFIGS[name]
    params, model, tcfg = lm_pair(jcfg, seed=1)
    toks = int_tokens(2, (2, 24), jcfg.vocab)
    want, _ = JM.lm_forward(params, jnp.asarray(toks), jcfg)
    got, aux = TM.lm_forward(model, torch.from_numpy(toks), tcfg, use_kernel=use_kernel)
    assert got.dtype == torch.float32 and got.shape == (2, 24, jcfg.vocab)
    assert float(aux) == 0.0
    close_scaled(got, want, FP32_TOL)
    last, _ = TM.lm_forward(model, torch.from_numpy(toks), tcfg,
                            use_kernel=use_kernel, last_only=True)
    close_scaled(last, np.asarray(want)[:, -1:], FP32_TOL)


def test_lm_forward_kernel_on_matches_repro_pallas():
    """At S = 128 repro's use_kernel=True runs its Pallas flash kernel
    (interpret mode); the port's kernel switch matches it."""
    jcfg = CONFIGS["llama_smoke"]
    params, model, tcfg = lm_pair(jcfg, seed=3)
    toks = int_tokens(4, (1, 128), jcfg.vocab)
    want, _ = JM.lm_forward(params, jnp.asarray(toks), jcfg, use_kernel=True)
    got, _ = TM.lm_forward(model, torch.from_numpy(toks), tcfg, use_kernel=True)
    close_scaled(got, want, FP32_TOL)


def test_lm_forward_bf16_compute_matches_repro():
    jcfg = dataclasses.replace(j_llama.SMOKE, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    params, model, tcfg = lm_pair(jcfg, seed=5)
    assert model.embed.dtype == torch.bfloat16
    toks = int_tokens(6, (2, 32), jcfg.vocab)
    want, _ = JM.lm_forward(params, jnp.asarray(toks), jcfg)
    for use_kernel in (False, True):
        got, _ = TM.lm_forward(model, torch.from_numpy(toks), tcfg,
                               use_kernel=use_kernel)
        assert got.dtype == torch.float32
        close_scaled(got, want, BF16_TOL)


def test_lm_forward_param_cast_to_compute_matches_repro():
    """bf16 params with fp32 compute: blocks are cast per layer (cast_tree)."""
    jcfg = dataclasses.replace(TINY_GQA, param_dtype="bfloat16")
    params, model, tcfg = lm_pair(jcfg, seed=7)
    toks = int_tokens(8, (1, 16), jcfg.vocab)
    want, _ = JM.lm_forward(params, jnp.asarray(toks), jcfg)
    got, _ = TM.lm_forward(model, torch.from_numpy(toks), tcfg)
    close_scaled(got, want, FP32_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_decode_steps_match_repro(name):
    jcfg = CONFIGS[name]
    params, model, tcfg = lm_pair(jcfg, seed=9)
    B, steps = 2, 8
    toks = int_tokens(10, (B, steps), jcfg.vocab)
    j_step = jax.jit(JM.lm_decode_step, static_argnames="cfg")
    j_caches = JM.init_cache(jcfg, B, steps + 4)
    t_caches = TM.init_cache(tcfg, B, steps + 4, CPU)
    outs = []
    for t in range(steps):
        pos = np.full((B,), t, np.int32)
        j_caches, j_lg = j_step(params, j_caches, jnp.asarray(toks[:, t]),
                                jnp.asarray(pos), cfg=jcfg)
        t_caches, t_lg = TM.lm_decode_step(model, t_caches, torch.from_numpy(toks[:, t]),
                                           torch.from_numpy(pos), tcfg)
        assert t_lg.shape == (B, jcfg.vocab) and t_lg.dtype == torch.float32
        close_scaled(t_lg, j_lg, FP32_TOL)
        outs.append(t_lg)
    for key in ("k", "v"):
        close_scaled(t_caches[0][key], j_caches[0][key], FP32_TOL)
    # teacher-forced decode equals the port's own forward pass
    fwd, _ = TM.lm_forward(model, torch.from_numpy(toks), tcfg, use_kernel=True)
    torch.testing.assert_close(torch.stack(outs, dim=1), fwd, atol=FP32_TOL, rtol=0)


# ---------------------------------------------------------------------------
# arch bundles
# ---------------------------------------------------------------------------


def test_arch_prefill_bundle_matches_repro():
    jb = j_arch.build("llama3.2-1b", "prefill_32k", smoke=True)
    tb = t_arch.build("llama3.2-1b", "prefill_32k", smoke=True, device=CPU)
    assert (tb.shape.name, tb.shape.kind, tb.shape.dims) == (
        jb.shape.name, jb.shape.kind, jb.shape.dims)
    assert tb.cfg == port_lm_cfg(jb.cfg)
    assert tb.model_flops() == jb.model_flops()
    spec = tb.input_specs()["batch"]["tokens"]
    assert spec.shape == jb.input_specs()["batch"]["tokens"].shape == (2, 64)
    (params,) = jb.init(jax.random.key(11))
    model = TM.lm_from_params(numpy_tree(params), tb.cfg, device=CPU)
    toks = int_tokens(12, spec.shape, tb.cfg.vocab)
    want = jb.step(params, dict(tokens=jnp.asarray(toks)))
    got = tb.step(model, dict(tokens=torch.from_numpy(toks)))
    assert got.shape == (2, tb.cfg.vocab)
    close_scaled(got, want, FP32_TOL)
    (own,) = tb.init(torch.Generator().manual_seed(0))  # the port's own draws
    assert torch.isfinite(tb.step(own, dict(tokens=torch.from_numpy(toks)))).all()


def test_arch_decode_bundle_matches_repro():
    jb = j_arch.build("llama3.2-1b", "decode_32k", smoke=True)
    tb = t_arch.build("llama3.2-1b", "decode_32k", smoke=True, device=CPU)
    assert tb.model_flops() == jb.model_flops()
    params, j_caches = jb.init(jax.random.key(13))
    own, t_caches = tb.init(torch.Generator().manual_seed(0))
    assert [tuple(c["k"].shape) for c in t_caches] == [c["k"].shape for c in j_caches]
    model = TM.lm_from_params(numpy_tree(params), tb.cfg, device=CPU)
    B = tb.shape.dims["global_batch"]
    toks = int_tokens(14, (B, 3), tb.cfg.vocab)
    for t in range(3):
        pos = np.full((B,), t, np.int32)
        j_caches, want = jb.step(params, j_caches, dict(
            tokens=jnp.asarray(toks[:, t]), positions=jnp.asarray(pos)))
        t_caches, got = tb.step(model, t_caches, dict(
            tokens=torch.from_numpy(toks[:, t]), positions=torch.from_numpy(pos)))
        close_scaled(got, want, FP32_TOL)


def test_arch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_arch.build("llama3.2-1b", "prefill_32k", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(port_lm_cfg(TINY_GQA), 1, 4)
