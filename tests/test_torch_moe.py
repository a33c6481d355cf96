"""repro_torch's MoE block (``models/transformer/moe.py``: ``init_moe``,
``_capacity``, the sort-based ``dispatch``, ``moe_forward``), the two MoE
configs and their dry-run, held against repro's.

Weights are repro's draws (``init_moe``) copied into the port; inputs come
from numpy with a seed.  fp32 agrees to 1e-4 of the output's scale, as in
tests/test_torch_lm.py; the aux loss to 1e-6 relative; bf16 to 2e-2.  The
dispatch cases pin repro's result on the CPU where an expert overflows: the
dropped assignments' clipped writes land on the slot of the token kept at
rank C - 1 and the last write (the sentinel) wins, so the expert keeps
C - 1 tokens while its gate buffer keeps that token's gate.  The LM with
MoE stages is in tests/test_torch_moe_lm.py, its bundles in
tests/test_torch_moe_arch.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import arch as j_arch
from repro.configs import deepseek_v2_lite_16b as j_ds
from repro.configs import qwen2_moe_a2_7b as j_qw
from repro.configs.base import MoEConfig as JMoE
from repro.configs.base import TransformerConfig as JConfig
from repro.models.transformer import moe as JMOE
from repro_torch import arch as t_arch
from repro_torch.configs import base as t_base
from repro_torch.configs import deepseek_v2_lite_16b as t_ds
from repro_torch.configs import qwen2_moe_a2_7b as t_qw
from repro_torch.launch import dryrun as D
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer import moe as TMOE
from torch_port_helpers import CPU, close_scaled, needs_cuda, one_thread, port_lm_cfg

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")

FP32_TOL = 1e-4
BF16_TOL = 2e-2

TINY_MOE = JConfig(
    name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=256,
    moe=JMoE(n_routed=4, top_k=2, d_ff_expert=32, n_shared=1, capacity_factor=8.0),
    param_dtype="float32", compute_dtype="float32", remat=False,
)
SMOKES = {"qwen": j_qw.SMOKE, "deepseek": j_ds.SMOKE}
ARCH = {"qwen": "qwen2-moe-a2.7b", "deepseek": "deepseek-v2-lite-16b"}
j_moe = jax.jit(JMOE.moe_forward, static_argnames="cfg")


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: TM._tensor(np.asarray(a), CPU), tree)


# ---------------------------------------------------------------------------
# configs and layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("pair", [(j_qw, t_qw), (j_ds, t_ds)], ids=["qwen", "deepseek"])
def test_moe_configs_pinned_to_repro(pair, which):
    j, t = (getattr(m, which) for m in pair)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.params_dense, t.params_active) == (j.params_dense, j.params_active)
    arch = pair[0].CONFIG.name
    assert arch in t_base._MODULE_OF  # registered: every config is ported
    assert t_base.get_config(arch, smoke=which == "SMOKE") == t == port_lm_cfg(j)
    shapes = [(s.name, s.kind, s.dims) for s in t_base.shapes_for(arch)]
    assert shapes == [(s.name, s.kind, s.dims) for s in j_arch.shapes_for(arch)]



# ---------------------------------------------------------------------------
# moe_forward and its dispatch
# ---------------------------------------------------------------------------


j_init_moe = jax.jit(JMOE.init_moe, static_argnums=(1, 2))


def _moe_pair(cfg, seed, dtype=jnp.float32):
    p = j_init_moe(jax.random.key(seed), cfg, dtype)
    return p, _torch_tree(p)


def _check_moe(cfg, p, tp, x):
    want, want_aux = j_moe(p, jnp.asarray(x), cfg=cfg)
    got, aux = TMOE.moe_forward(tp, torch.from_numpy(x), port_lm_cfg(cfg))
    assert got.shape == x.shape and got.dtype == torch.float32
    close_scaled(got, want, FP32_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    return got


@pytest.mark.parametrize("case", ["headroom", "overflow"])
@pytest.mark.parametrize("name", ["qwen", "deepseek"])
def test_moe_forward_matches_repro(name, case):
    """``headroom``: nothing dropped; ``overflow`` (capacity factor 0.5):
    most experts overflow, and repro's C - 1 rule holds."""
    cfg = SMOKES[name]
    if case == "overflow":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    p, tp = _moe_pair(cfg, 1)
    x = np.random.default_rng(2).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    _check_moe(cfg, p, tp, x)
    T, m = 80, cfg.moe
    C = TMOE._capacity(T, port_lm_cfg(cfg))
    assert C == JMOE._capacity(T, cfg)
    probs = torch.softmax(torch.from_numpy(x).reshape(T, -1) @ tp["router"], -1)
    top_p, top_i = torch.topk(probs, m.top_k)
    _, _, slot, count = TMOE.dispatch(top_i, top_p, m.n_routed, C)
    assert bool((count > C).any()) == (case == "overflow")
    dropped = int((slot == m.n_routed * C).sum())
    # past rank C, plus slot C - 1 of every overflowing expert
    assert dropped == int((count - C).clamp(min=0).sum() + (count > C).sum())


def _routed(split: int, T: int = 16):
    """One-expert-per-token routing (K = 1 of 2 experts): tokens 0..split-1
    to expert 0, the rest to expert 1 (the router reads feature 0's sign)."""
    cfg = dataclasses.replace(TINY_MOE, moe=JMoE(
        n_routed=2, top_k=1, d_ff_expert=32, n_shared=0, capacity_factor=1.0,
        norm_topk_prob=False))
    p, tp = _moe_pair(cfg, 3)
    router = np.zeros((cfg.d_model, 2), np.float32)
    router[0] = [4.0, -4.0]
    p = dict(p, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.random.default_rng(4).standard_normal((1, T, cfg.d_model)).astype(np.float32)
    x[0, :, 0] = np.where(np.arange(T) < split, 1.0, -1.0)
    return cfg, p, tp, x


@pytest.mark.parametrize("split", [8, 9, 12])
def test_moe_capacity_edge_matches_repro(split):
    """C = 8 of 16 tokens: expert 0 takes exactly C (split 8, nothing
    dropped), one past C (9: the token at rank C - 1 = 7 loses its row to
    the sentinel and token 8 is dropped; the gate buffer keeps token 7's
    gate), or four past C."""
    cfg, p, tp, x = _routed(split)
    got = _check_moe(cfg, p, tp, x)
    tcfg = port_lm_cfg(cfg)
    C = TMOE._capacity(16, tcfg)
    assert C == 8
    probs = torch.softmax(torch.from_numpy(x[0]) @ tp["router"], -1)
    top_p, top_i = torch.topk(probs, 1)
    buf, gate_buf, slot, count = TMOE.dispatch(top_i, top_p, 2, C)
    assert count.tolist() == [split, 16 - split]
    kept0 = list(range(min(split, C)))
    if split > C:
        kept0[C - 1] = 16  # the sentinel T
    assert buf[0].tolist() == kept0
    np.testing.assert_array_equal(gate_buf[0].numpy(), top_p[:min(split, C), 0].numpy())
    reach = [t < C - 1 or (t == C - 1 and split <= C) for t in range(split)]
    assert (slot[:split, 0] < 2 * C).tolist() == reach
    zero_rows = [t for t in range(split) if not reach[t]]
    assert torch.equal(got[0, zero_rows], torch.zeros_like(got[0, zero_rows]))


def test_moe_combine_is_a_gather_in_k_order():
    """The combine gathers each token's K rows and adds them in k order: an
    fp32 sum in that order, bitwise, and no duplicate slot among kept pairs."""
    cfg = SMOKES["deepseek"]
    tcfg = port_lm_cfg(cfg)
    _, tp = _moe_pair(cfg, 5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 48, cfg.d_model)).astype(np.float32))
    probs = torch.softmax(x[0] @ tp["router"], -1)
    top_p, top_i = torch.topk(probs, cfg.moe.top_k)
    E, C = cfg.moe.n_routed, TMOE._capacity(48, tcfg)
    _, _, slot, _ = TMOE.dispatch(top_i, top_p, E, C)
    kept = slot[slot < E * C]
    assert kept.unique().numel() == kept.numel()
    out1, _ = TMOE.moe_forward(tp, x, tcfg)
    out2, _ = TMOE.moe_forward(tp, x, tcfg)
    assert torch.equal(out1, out2)



@pytest.mark.parametrize("name", ["qwen", "deepseek"])
def test_moe_forward_bf16_matches_repro(name):
    """bf16 experts and input (the router stays fp32, so both packages route
    the same input alike): within 2e-2 of the output's scale."""
    cfg = dataclasses.replace(SMOKES[name], param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    p, tp = _moe_pair(cfg, 19, jnp.bfloat16)
    assert tp["router"].dtype == torch.float32 and tp["w_up"].dtype == torch.bfloat16
    x = np.random.default_rng(20).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want, want_aux = j_moe(p, jnp.asarray(x, jnp.bfloat16), cfg=cfg)
    got, aux = TMOE.moe_forward(tp, torch.from_numpy(x).to(torch.bfloat16),
                                port_lm_cfg(cfg))
    assert got.dtype == torch.bfloat16
    close_scaled(got, want, BF16_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)



# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", ["qwen", "deepseek"])
def test_dry_run_counts_equal_the_cpu_step(name, shape):
    """The step on ``meta`` (static shapes all the way through the dispatch)
    counts what it counts on CPU tensors, sort and searchsorted included."""
    arch = ARCH[name]
    use_kernel = name == "qwen"
    real = t_arch.build(arch, shape, smoke=True, device=CPU, use_kernel=use_kernel)
    meta = t_arch.build(arch, shape, smoke=True, device="meta", use_kernel=use_kernel)
    state = real.init(torch.Generator().manual_seed(0))
    rep, c = D.count_step(real, state, D.abstract_inputs(real, device=CPU),
                          mesh_name="cpu", chips=1)
    mrep, mc = D.count_step(meta, D.abstract_state(meta), D.abstract_inputs(meta),
                            mesh_name="meta", chips=1)
    assert mc.totals() == c.totals()
    for op in ("sort", "searchsorted", "topk", "bmm"):
        assert c.by_op[op][0] > 0, op
    n_moe = sum(d for d, kind in TM.stages_of(real.cfg) if kind == "moe")
    assert c.by_op["sort"][0] == n_moe
    assert ("flash_attention" in c.by_op) == (use_kernel and shape == "prefill_32k")
    assert mrep.memory_per_device["argument_gb"] == pytest.approx(
        (D.state_bytes(state) + D.state_bytes(D.abstract_inputs(real, device=CPU)))
        * 1e-9, rel=1e-12)


def test_dry_run_cli_writes_the_moe_records(tmp_path):
    for arch in ARCH.values():
        D.main(["--arch", arch, "--shape", "decode_32k", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["deepseek-v2-lite-16b__decode_32k__single.json",
                     "qwen2-moe-a2.7b__decode_32k__single.json"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["headroom", "overflow"])
def test_moe_forward_on_card_equals_cpu(case):
    """The dispatch and combine on a CUDA tensor: the CPU's result in fp32,
    and two runs bitwise equal (no atomics)."""
    needs_cuda()
    cfg = SMOKES["deepseek"]
    if case == "overflow":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    tcfg = port_lm_cfg(cfg)
    _, tp = _moe_pair(cfg, 16)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (4, 64, cfg.d_model)).astype(np.float32))
    want, want_aux = TMOE.moe_forward(tp, x, tcfg)
    cp = jax.tree_util.tree_map(lambda t: t.cuda(), tp)
    got, aux = TMOE.moe_forward(cp, x.cuda(), tcfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-7, rtol=1e-5)
    assert torch.equal(got, TMOE.moe_forward(cp, x.cuda(), tcfg)[0])
