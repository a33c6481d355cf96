"""repro_torch's LM with MoE stages (``models/transformer/model.py`` with
``moe.py``; the Qwen1.5-MoE and DeepSeek-V2-Lite SMOKE configs and
tests/test_models.py's tiny MoE config) held against repro's: the init
layout, ``lm_forward`` with its aux loss (kernel off, and on through the
CPU's plain route), bf16 compute, and teacher-forced ``lm_decode_step``.

Weights are repro's ``init_lm`` draws copied by ``lm_from_params``; tokens
come from numpy with a seed.  fp32 agrees to 1e-4 of the logits' scale (as
tests/test_torch_lm.py), the aux loss to 1e-6 relative; bf16 compute to
2e-2, with routing that bf16 rounding cannot flip (``_separated_routing``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import deepseek_v2_lite_16b as j_ds
from repro.configs import qwen2_moe_a2_7b as j_qw
from repro.configs.base import MoEConfig as JMoE
from repro.configs.base import TransformerConfig as JConfig
from repro.models.transformer import model as JM
from repro_torch.models.transformer import model as TM
from torch_port_helpers import (
    CPU, bf16_params, close_scaled, int_tokens, lm_pair, one_thread, port_lm_cfg)

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")

FP32_TOL = 1e-4
BF16_TOL = 2e-2

TINY_MOE = JConfig(  # tests/test_models.py's
    name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=256,
    moe=JMoE(n_routed=4, top_k=2, d_ff_expert=32, n_shared=1, capacity_factor=8.0),
    param_dtype="float32", compute_dtype="float32", remat=False,
)
SMOKES = {"qwen": j_qw.SMOKE, "deepseek": j_ds.SMOKE}
j_forward = jax.jit(JM.lm_forward, static_argnames="cfg")


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("name", ["qwen", "deepseek", "tiny", "deepseek_bf16"])
def test_init_layout_matches_repro(name):
    """Every leaf of the port's own init (and of its meta tree) has the
    shape and dtype of repro's ``init_lm`` (the router fp32 whatever the
    parameters are), and the converter copies repro's leaves exactly
    (experts ``[L, E, d, f]``, MLA, shared experts)."""
    bf16 = name.endswith("_bf16")
    base = TINY_MOE if name == "tiny" else SMOKES[name.removesuffix("_bf16")]
    jcfg = dataclasses.replace(base, param_dtype="bfloat16",
                               compute_dtype="bfloat16") if bf16 else base
    tcfg = port_lm_cfg(jcfg)
    params = lm_pair(base)[0]
    if bf16:
        params = bf16_params(params)
    model = TM.lm_from_params(jax.tree_util.tree_map(np.asarray, params), tcfg,
                              device=CPU)
    mine = TM.init_lm(torch.Generator().manual_seed(0), tcfg)
    meta = TM.init_lm(None, tcfg)

    def stacked(m):
        def merge(trees):
            if isinstance(trees[0], dict):
                return {k: merge([t[k] for t in trees]) for k in trees[0]}
            return torch.stack(trees)

        out = {k: v for k, v in m.tree().items() if not k.startswith("stage")}
        for si, _ in enumerate(TM.stages_of(tcfg)):
            out[f"stage{si}"] = merge([b.tree() for b in m.stage(si)])
        return out

    layout = _leaves(jax.eval_shape(lambda k: JM.init_lm(k, jcfg), jax.random.key(0)))
    for tree in (stacked(model), stacked(mine), stacked(meta)):
        got = _leaves(tree)
        assert [p for p, _ in got] == [p for p, _ in layout]
        for (path, g), (_, r) in zip(got, layout):
            assert tuple(g.shape) == r.shape, path
            assert str(g.dtype).removeprefix("torch.") == str(r.dtype), path
    for (_, g), (_, r) in zip(_leaves(stacked(model)), _leaves(params)):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))
    if tcfg.moe.first_dense_layers:  # the dense layers take d_ff_dense
        assert model.stage(0)[0].ffn.w_gate.shape == (tcfg.d_model, tcfg.moe.d_ff_dense)



# ---------------------------------------------------------------------------
# the LM with MoE stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,use_kernel", [("qwen", False), ("qwen", True),
                                             ("deepseek", False), ("tiny", True)])
def test_lm_forward_matches_repro(name, use_kernel):
    jcfg = TINY_MOE if name == "tiny" else SMOKES[name]
    params, model, tcfg = lm_pair(jcfg)
    toks = int_tokens(8, (2, 24), jcfg.vocab)
    want, want_aux = j_forward(params, jnp.asarray(toks), cfg=jcfg)
    got, aux = TM.lm_forward(model, torch.from_numpy(toks), tcfg, use_kernel=use_kernel)
    assert got.dtype == torch.float32 and got.shape == (2, 24, jcfg.vocab)
    close_scaled(got, want, FP32_TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)



def _separated_routing(params, jcfg, sign):
    """repro's params with routing that bf16 rounding cannot flip: every
    router reads feature 0 alone, with one weight per expert, and every
    token's embedding has feature 0 at +-4 (``sign``), far from zero after
    the norms.  Otherwise, in bf16 the two packages round the hidden states
    in different places, and a top-k choice between near-equal probabilities
    can go either way and move a token's logits by far more than bf16's
    step."""
    E = jcfg.moe.n_routed
    embed = np.array(params["embed"], np.float32)
    embed[:, 0] = 4.0 * sign
    params = dict(params, embed=jnp.asarray(embed, params["embed"].dtype))
    for si, (depth, kind) in enumerate(JM.stages_of(jcfg)):
        if kind == "moe":
            router = np.zeros((depth, jcfg.d_model, E), np.float32)
            router[:, 0] = np.linspace(-1.0, 1.0, E)
            stage = dict(params[f"stage{si}"])
            stage["ffn"] = dict(stage["ffn"], router=jnp.asarray(router))
            params[f"stage{si}"] = stage
    return params


@pytest.mark.parametrize("name", ["qwen", "deepseek"])
def test_lm_forward_bf16_compute_matches_repro(name):
    jcfg = dataclasses.replace(SMOKES[name], param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tcfg = port_lm_cfg(jcfg)
    params = bf16_params(lm_pair(SMOKES[name])[0])
    vocab = jcfg.vocab
    params = _separated_routing(params, jcfg, np.where(np.arange(vocab) % 3, 1.0, -1.0))
    model = TM.lm_from_params(jax.tree_util.tree_map(np.asarray, params), tcfg, device=CPU)
    assert model.embed.dtype == torch.bfloat16
    toks = int_tokens(10, (2, 32), vocab)
    want, want_aux = j_forward(params, jnp.asarray(toks), cfg=jcfg)
    got, aux = TM.lm_forward(model, torch.from_numpy(toks), tcfg,
                             use_kernel=jcfg.attention != "mla")
    assert got.dtype == torch.float32
    close_scaled(got, want, BF16_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-3)


@pytest.mark.parametrize("name", ["qwen", "deepseek"])
def test_lm_decode_steps_match_repro(name):
    jcfg = SMOKES[name]
    params, model, tcfg = lm_pair(jcfg)
    B, steps = 2, 6
    toks = int_tokens(12, (B, steps), jcfg.vocab)
    j_step = jax.jit(JM.lm_decode_step, static_argnames="cfg")
    j_caches = JM.init_cache(jcfg, B, steps + 2)
    t_caches = TM.init_cache(tcfg, B, steps + 2, CPU)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in t_caches] == \
        [{k: v.shape for k, v in c.items()} for c in j_caches]
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
    for tc, jc in zip(t_caches, j_caches):
        for key in jc:
            close_scaled(tc[key], jc[key], FP32_TOL)
    # teacher-forced decode equals the port's own forward (SMOKE's capacity
    # factor 4 drops nothing at these T)
    fwd, _ = TM.lm_forward(model, torch.from_numpy(toks), tcfg)
    torch.testing.assert_close(torch.stack(outs, dim=1), fwd, atol=FP32_TOL, rtol=0)
