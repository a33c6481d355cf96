"""repro_torch's prefill and decode bundles (``arch.build``) of the two MoE
configs at SMOKE size, held against repro's bundles on repro's weights at
fp32 1e-4 of the logits' scale; the train bundle still raises.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import arch as j_arch
from repro.models.transformer import model as JM
from repro_torch import arch as t_arch
from torch_port_helpers import (
    CPU, close_scaled, int_tokens, lm_pair, needs_cuda, one_thread, port_lm_cfg)

# a file of many small CPU ops: one intra-op thread beside the other workers
pytestmark = pytest.mark.usefixtures("one_thread")

FP32_TOL = 1e-4
ARCH = {"qwen": "qwen2-moe-a2.7b", "deepseek": "deepseek-v2-lite-16b"}


# ---------------------------------------------------------------------------
# the prefill and decode bundles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen", "deepseek"])
def test_arch_bundles_match_repro(name):
    arch = ARCH[name]
    use_kernel = name == "qwen"
    jb = j_arch.build(arch, "prefill_32k", smoke=True)
    tb = t_arch.build(arch, "prefill_32k", smoke=True, device=CPU, use_kernel=use_kernel)
    assert (tb.shape.name, tb.shape.kind, tb.shape.dims) == (
        jb.shape.name, jb.shape.kind, jb.shape.dims)
    assert tb.cfg == port_lm_cfg(jb.cfg)
    assert tb.model_flops() == jb.model_flops()
    params, model, _ = lm_pair(jb.cfg)  # repro's init_lm draws for the bundle's config
    toks = int_tokens(14, tb.input_specs()["batch"]["tokens"].shape, tb.cfg.vocab)
    close_scaled(tb.step(model, dict(tokens=torch.from_numpy(toks))),
                 jb.step(params, dict(tokens=jnp.asarray(toks))), FP32_TOL)
    (own,) = tb.init(torch.Generator().manual_seed(0))  # the port's own draws
    assert torch.isfinite(tb.step(own, dict(tokens=torch.from_numpy(toks)))).all()

    jd = j_arch.build(arch, "decode_32k", smoke=True)
    td = t_arch.build(arch, "decode_32k", smoke=True, device=CPU)
    assert td.model_flops() == jd.model_flops()
    B, S = td.shape.dims["global_batch"], td.shape.dims["seq_len"]
    j_caches = JM.init_cache(jd.cfg, B, S)
    _, t_caches = td.init(torch.Generator().manual_seed(0))
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in t_caches] == \
        [{k: v.shape for k, v in c.items()} for c in j_caches]
    toks = int_tokens(15, (B, 3), td.cfg.vocab)
    for t in range(3):
        pos = np.full((B,), t, np.int32)
        j_caches, want = jd.step(params, j_caches, dict(
            tokens=jnp.asarray(toks[:, t]), positions=jnp.asarray(pos)))
        t_caches, got = td.step(model, t_caches, dict(
            tokens=torch.from_numpy(toks[:, t]), positions=torch.from_numpy(pos)))
        close_scaled(got, want, FP32_TOL)
    # the train kind is ported (tests/test_torch_train_lm.py); it refuses
    # the flash kernel, which has no backward
    with pytest.raises(ValueError, match="no backward"):
        t_arch.build(arch, "train_4k", smoke=True, device=CPU)
    tt = t_arch.build(arch, "train_4k", smoke=True, device=CPU, use_kernel=False)
    assert tt.model_flops() == j_arch.build(arch, "train_4k", smoke=True).model_flops()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_qwen_smoke_prefill_on_card_launches_flash():
    needs_cuda()
    from repro_torch.kernels.flash_attention.ops import flash_attention

    tb = t_arch.build("qwen2-moe-a2.7b", "prefill_32k", smoke=True, device="cuda")
    (model,) = tb.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.from_numpy(int_tokens(18, (2, 64), tb.cfg.vocab)).cuda()
    before = flash_attention.launches
    got = tb.step(model, dict(tokens=toks))
    assert flash_attention.launches == before + tb.cfg.n_layers
    off = t_arch.build("qwen2-moe-a2.7b", "prefill_32k", smoke=True, device="cuda",
                       use_kernel=False)
    torch.testing.assert_close(got, off.step(model, dict(tokens=toks)), atol=1e-4,
                               rtol=0)
