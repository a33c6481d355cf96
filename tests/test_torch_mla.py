"""repro_torch's MLA half of ``models/transformer/attention.py`` (DeepSeek-V2's
multi-head latent attention: ``init_mla``, ``_mla_q``, ``mla_forward``,
``mla_init_cache``, the absorbed-form ``mla_decode``) held against repro's,
and the flash kernel refused at MLA's head widths in both packages.

Weights are repro's draws copied into the port; inputs come from numpy with
a seed.  fp32 agrees to 1e-4 of the output's scale (tests/test_torch_lm.py's
tolerance); bf16 compute to 2e-2, on an MLA config without MoE layers:
tests/test_torch_moe.py holds those in bf16 with routing that rounding
cannot flip.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import deepseek_v2_lite_16b as j_ds
from repro.configs.base import TransformerConfig as JConfig
from repro.models.transformer import attention as JA
from repro.models.transformer import model as JM
from repro_torch.models.transformer import attention as TA
from repro_torch.models.transformer import model as TM
from torch_port_helpers import (
    CPU, bf16_params, close_scaled, int_tokens, lm_pair, needs_cuda, one_thread,
    port_lm_cfg)

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")

FP32_TOL = 1e-4
BF16_TOL = 2e-2

TINY_MLA = JConfig(  # tests/test_models.py's, with a q LoRA
    name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=256, attention="mla", kv_lora_rank=32, q_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
CONFIGS = {"tiny_q_lora": TINY_MLA, "deepseek_smoke": j_ds.SMOKE}

j_mla_forward = jax.jit(JA.mla_forward, static_argnames=("cfg", "use_kernel"))
j_mla_decode = jax.jit(JA.mla_decode, static_argnames="cfg")
j_forward = jax.jit(JM.lm_forward, static_argnames="cfg")


j_init_mla = jax.jit(JA.init_mla, static_argnums=(1, 2))


def _attn_pair(jcfg, seed=0):
    p = j_init_mla(jax.random.key(seed), jcfg, jnp.float32)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_mla_layout_matches_repro(name):
    jcfg = CONFIGS[name]
    tcfg = port_lm_cfg(jcfg)
    p, _ = _attn_pair(jcfg)
    for gen in (torch.Generator().manual_seed(0), None):
        mine = TA.init_mla(gen, tcfg, torch.float32)
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: v.shape for k, v in p.items()}
        assert all(v.dtype == torch.float32 for v in mine.values())
    assert ("w_uq" in p) == bool(jcfg.q_lora_rank) == ("wq" not in p)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mla_q_matches_repro(name):
    jcfg = CONFIGS[name]
    p, tp = _attn_pair(jcfg, 1)
    x = _x(2, 2, 12, jcfg.d_model)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    jn, jr = JA._mla_q(p, jnp.asarray(x), jnp.asarray(pos), jcfg)
    tn, tr = TA._mla_q(tp, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       port_lm_cfg(jcfg))
    close_scaled(tn, jn, FP32_TOL)
    close_scaled(tr, jr, FP32_TOL)


@pytest.mark.parametrize("S", [24, 130])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_mla_forward_matches_repro(name, S):
    jcfg = CONFIGS[name]
    p, tp = _attn_pair(jcfg, 3)
    x = _x(4, 2, S, jcfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want = j_mla_forward(p, jnp.asarray(x), jnp.asarray(pos), cfg=jcfg)
    got = TA.mla_forward(tp, torch.from_numpy(x), torch.from_numpy(pos), port_lm_cfg(jcfg))
    assert got.shape == (2, S, jcfg.d_model)
    close_scaled(got, want, FP32_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mla_decode_matches_repro(name):
    """Absorbed decode, step by step, against repro's: outputs and both
    caches; the port writes its cache in place and returns it."""
    jcfg = CONFIGS[name]
    tcfg = port_lm_cfg(jcfg)
    p, tp = _attn_pair(jcfg, 5)
    B, steps, s_max = 2, 6, 10
    xs = _x(6, B, steps, jcfg.d_model)
    j_cache = JA.mla_init_cache(jcfg, B, s_max, jnp.float32)
    t_cache = TA.mla_init_cache(tcfg, B, s_max, torch.float32, CPU)
    assert {k: tuple(v.shape) for k, v in t_cache.items()} == \
        {k: v.shape for k, v in j_cache.items()}
    for t in range(steps):
        # the two sequences at different positions
        pos = np.array([t, t + 2], np.int32)
        x = xs[:, t : t + 1]
        j_cache, want = j_mla_decode(p, j_cache, jnp.asarray(x), jnp.asarray(pos), cfg=jcfg)
        out_cache, got = TA.mla_decode(tp, t_cache, torch.from_numpy(x),
                                       torch.from_numpy(pos), tcfg)
        assert out_cache is t_cache
        assert got.shape == (B, 1, jcfg.d_model)
        close_scaled(got, want, FP32_TOL)
    for k in ("c_kv", "k_rope"):
        close_scaled(t_cache[k], j_cache[k], FP32_TOL)


def test_mla_decode_equals_forward():
    """The absorbed decode over the latent cache equals the expanded prefill
    at every position (the port's own two paths)."""
    tcfg = port_lm_cfg(TINY_MLA)
    _, tp = _attn_pair(TINY_MLA, 7)
    B, S = 2, 9
    x = torch.from_numpy(_x(8, B, S, TINY_MLA.d_model))
    pos = torch.arange(S)[None].expand(B, S)
    fwd = TA.mla_forward(tp, x, pos, tcfg)
    cache = TA.mla_init_cache(tcfg, B, S, torch.float32, CPU)
    steps = [TA.mla_decode(tp, cache, x[:, t : t + 1], torch.full((B,), t), tcfg)[1]
             for t in range(S)]
    torch.testing.assert_close(torch.cat(steps, dim=1), fwd, atol=FP32_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the kernel refused at MLA's widths
# ---------------------------------------------------------------------------


def test_mla_with_the_kernel_is_refused_by_both_packages():
    """q / k of width dn + dr = 24 and v of 16: repro's flash wrapper raises
    (it reshapes v with q's width), and the port's ``sdpa`` raises
    ``ValueError`` before choosing a route, on the CPU too, naming the
    widths and the ROADMAP item."""
    jcfg = TINY_MLA
    p, tp = _attn_pair(jcfg, 9)
    x = _x(10, 1, 128, jcfg.d_model)
    pos = np.arange(128, dtype=np.int32)[None]
    with pytest.raises(TypeError):
        JA.mla_forward(p, jnp.asarray(x), jnp.asarray(pos), jcfg, use_kernel=True)
    with pytest.raises(ValueError, match=r"q / k 24 and v 16.*queue 1 item 14"):
        TA.mla_forward(tp, torch.from_numpy(x), torch.from_numpy(pos), port_lm_cfg(jcfg),
                       use_kernel=True)


@pytest.mark.parametrize("dh,dv", [(24, 16), (16, 24), (192, 192)])
def test_sdpa_refuses_the_kernel_at_widths_it_does_not_take(dh, dv):
    q = torch.randn(1, 8, 2, dh)
    k = torch.randn(1, 8, 2, dh)
    v = torch.randn(1, 8, 2, dv)
    with pytest.raises(ValueError, match="one head width up to 128"):
        TA.sdpa(q, k, v, causal_offset=0, use_kernel=True)
    # the plain path takes v's width apart from q's
    assert TA.sdpa(q, k, v, causal_offset=0).shape == (1, 8, 2, dv)


# ---------------------------------------------------------------------------
# the LM with MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_forward_and_decode_match_repro(name):
    jcfg = CONFIGS[name]
    params, model, tcfg = lm_pair(jcfg)
    toks = int_tokens(11, (2, 8), jcfg.vocab)
    want, want_aux = j_forward(params, jnp.asarray(toks), cfg=jcfg)
    got, aux = TM.lm_forward(model, torch.from_numpy(toks), tcfg)
    close_scaled(got, want, FP32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    caches = TM.init_cache(tcfg, 2, 8, CPU)
    assert all(set(c) == {"c_kv", "k_rope"} for c in caches)
    steps = []
    for t in range(8):
        pos = torch.full((2,), t, dtype=torch.int32)
        caches, lg = TM.lm_decode_step(model, caches, torch.from_numpy(toks[:, t]), pos,
                                       tcfg)
        steps.append(lg)
    close_scaled(torch.stack(steps, dim=1), want, FP32_TOL)


def test_lm_forward_bf16_compute_matches_repro():
    jcfg = dataclasses.replace(TINY_MLA, param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = port_lm_cfg(jcfg)
    params = bf16_params(lm_pair(TINY_MLA)[0])
    model = TM.lm_from_params(params, tcfg, device=CPU)
    assert model.stage(0)[0].attn.w_dkv.dtype == torch.bfloat16
    toks = int_tokens(12, (2, 32), jcfg.vocab)
    want, _ = j_forward(params, jnp.asarray(toks), cfg=jcfg)
    got, _ = TM.lm_forward(model, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32
    close_scaled(got, want, BF16_TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_mla_on_card_equals_cpu():
    """mla_forward, mla_decode and the kernel's refusal on CUDA tensors."""
    needs_cuda()
    tcfg = port_lm_cfg(j_ds.SMOKE)
    _, tp = _attn_pair(j_ds.SMOKE, 13)
    cp = {k: v.cuda() for k, v in tp.items()}
    x = torch.from_numpy(_x(14, 2, 40, tcfg.d_model))
    pos = torch.arange(40)[None].expand(2, 40)
    torch.testing.assert_close(TA.mla_forward(cp, x.cuda(), pos.cuda(), tcfg).cpu(),
                               TA.mla_forward(tp, x, pos, tcfg), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="one head width"):
        TA.mla_forward(cp, x.cuda(), pos.cuda(), tcfg, use_kernel=True)
    c_cpu = TA.mla_init_cache(tcfg, 2, 8, torch.float32, CPU)
    c_gpu = TA.mla_init_cache(tcfg, 2, 8, torch.float32, "cuda")
    for t in range(4):
        p = torch.full((2,), t)
        _, want = TA.mla_decode(tp, c_cpu, x[:, t : t + 1], p, tcfg)
        _, got = TA.mla_decode(cp, c_gpu, x[:, t : t + 1].cuda(), p.cuda(), tcfg)
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(c_gpu["c_kv"].cpu(), c_cpu["c_kv"], atol=1e-5, rtol=1e-5)
