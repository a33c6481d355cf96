"""repro_torch flash attention and sdpa held against repro's.

On the CPU the port's op runs its plain version (chunked fp32 softmax
attention); repro's op runs its Pallas kernel in interpret mode, as
tests/test_kernels.py does, or its plain reference.  Inputs come from
numpy with a seed.  Tolerances are tests/test_kernels.py's: fp32 2e-5
(summation order), bf16 3e-2 (one bf16 rounding of outputs of order 1).
The CUDA kernels are held against the plain version on the card only:
the tensor-core route against ``attention_ref(probs_dtype=torch.bfloat16)``
(it rounds p to bf16 before p v), the CUDA-core route against the fp32
plain version.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models.transformer.attention import sdpa as j_sdpa
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention.ops import MAX_HEAD_DIM
from repro_torch.kernels.flash_attention.ops import flash_attention as t_flash
from repro_torch.kernels.flash_attention.ref import attention_ref as t_ref
from repro_torch.models.transformer.attention import sdpa as t_sdpa
from torch_port_helpers import needs_cuda

SHAPES = [
    (1, 128, 2, 2, 16),  # MHA
    (2, 256, 4, 2, 32),  # GQA group 2
    (1, 128, 8, 1, 64),  # MQA
]
TOL = {np.float32: 2e-5, "bfloat16": 3e-2}


def _qkv(seed, B, S, H, Hkv, dh, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.normal(size=(B, S, H, dh)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, dh)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, dh)).astype(np.float32))


def _both(arrays, bf16):
    j = [jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    if bf16:
        t = [x.to(torch.bfloat16) for x in t]
    return j, t


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,Hkv,dh", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_matches_repro_kernel_and_ref(B, S, H, Hkv, dh, bf16):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, B, S, H, Hkv, dh), bf16)
    out = t_flash(tq, tk, tv, causal=True)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = TOL["bfloat16" if bf16 else np.float32]
    _close(out, j_flash(jq, jk, jv, causal=True, block_q=64, block_k=64), tol)
    _close(out, j_ref(jq, jk, jv, causal=True), tol)


def test_flash_non_causal_matches_repro():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 1, 128, 2, 2, 16), False)
    out = t_flash(tq, tk, tv, causal=False)
    _close(out, j_flash(jq, jk, jv, causal=False, block_q=64, block_k=64), 2e-5)


@pytest.mark.parametrize("causal,S,T", [(True, 100, 100), (False, 37, 90)])
def test_flash_off_tile_shapes_match_repro_ref(causal, S, T):
    """S and T off the reference's tile grid (its wrapper falls back to its
    ref there; the port's kernel takes them as they are)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 2, S, 4, 2, 24, T=T), False)
    scale = 0.3
    out = t_flash(tq, tk, tv, causal=causal, scale=scale)
    _close(out, j_ref(jq, jk, jv, causal=causal, scale=scale), 2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_chunks_equal_one_pass(causal):
    _, (tq, tk, tv) = _both(_qkv(4, 1, 200, 4, 1, 16), False)
    full = t_ref(tq, tk, tv, causal=causal, chunk_q=1024)
    chunked = t_ref(tq, tk, tv, causal=causal, chunk_q=64)
    torch.testing.assert_close(full, chunked, atol=2e-6, rtol=0)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    def qkv(S=8, T=8, H=4, Hkv=2, dh=16, dtype=torch.float32):
        return (torch.zeros(1, S, H, dh, dtype=dtype),
                torch.zeros(1, T, Hkv, dh, dtype=dtype),
                torch.zeros(1, T, Hkv, dh, dtype=dtype))

    t_ops._check(*qkv(), causal=True)
    t_ops._check(*qkv(S=3, T=9), causal=False)
    t_ops._check(*qkv(dh=MAX_HEAD_DIM), causal=True)
    with pytest.raises(ValueError, match="S == T"):
        t_ops._check(*qkv(S=3, T=9), causal=True)
    with pytest.raises(ValueError, match="head width"):
        t_ops._check(*qkv(dh=MAX_HEAD_DIM + 8), causal=True)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        t_ops._check(*qkv(H=3), causal=True)
    with pytest.raises(TypeError):
        t_ops._check(*qkv(dtype=torch.float16), causal=True)
    q, k, v = qkv()
    with pytest.raises(ValueError, match="contiguous"):
        t_ops._check(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, causal=True)
    # meta tensors take the meta route (a dry-run's step): the output's
    # shape and dtype, nothing computed and nothing launched
    before = t_flash.launches
    out = t_flash(q.to("meta"), k.to("meta"), v.to("meta"))
    assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape, q.dtype)
    assert t_flash.launches == before
    with pytest.raises(ValueError, match="S == T"):
        t_flash(*(x.to("meta") for x in qkv(S=3, T=9)))


# ---------------------------------------------------------------------------
# sdpa: chunked against unchunked, and against repro's
# ---------------------------------------------------------------------------


def test_sdpa_chunked_equals_unchunked_and_repro():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 2, 256, 4, 2, 16), False)
    full = t_sdpa(tq, tk, tv, causal_offset=0, chunk_q=256)
    chunked = t_sdpa(tq, tk, tv, causal_offset=0, chunk_q=64)
    torch.testing.assert_close(full, chunked, atol=2e-5, rtol=0)
    _close(chunked, j_sdpa(jq, jk, jv, causal_offset=0, chunk_q=64), 2e-5)
    kernel = t_sdpa(tq, tk, tv, causal_offset=0, use_kernel=True)
    _close(kernel, j_sdpa(jq, jk, jv, causal_offset=0, use_kernel=True), 2e-5)


def test_sdpa_decode_kv_len_matches_repro():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(6, 3, 1, 4, 2, 16, T=40), False)
    kv_len = np.array([1, 17, 40], np.int32)
    out = t_sdpa(tq, tk, tv, causal_offset=None, kv_len=torch.from_numpy(kv_len))
    _close(out, j_sdpa(jq, jk, jv, causal_offset=None, kv_len=jnp.asarray(kv_len)), 2e-5)


@pytest.mark.parametrize("causal,S,T,H,Hkv,dh", [
    (True, 64, 64, 4, 2, 16),
    (True, 100, 100, 4, 1, 64),
    (False, 37, 90, 2, 2, 24),
])
def test_flash_ref_bf16_probs_match_repro_sdpa(causal, S, T, H, Hkv, dh):
    """attention_ref(probs_dtype=bf16), the tensor-core kernel's plain
    version, rounds p and v as repro's sdpa(probs_dtype=bf16) does."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(9, 2, S, H, Hkv, dh, T=T), True)
    out = t_ref(tq, tk, tv, causal=causal, probs_dtype=torch.bfloat16, chunk_q=32)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    ref = j_sdpa(jq, jk, jv, causal_offset=0 if causal else None,
                 probs_dtype=jnp.bfloat16)
    _close(out, ref, 3e-2)


def test_flash_ref_probs_dtype_defaults_to_fp32():
    _, (tq, tk, tv) = _both(_qkv(10, 1, 48, 2, 1, 16), False)
    torch.testing.assert_close(
        t_ref(tq, tk, tv), t_ref(tq, tk, tv, probs_dtype=torch.float32),
        atol=0, rtol=0)


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 8, "tensor_core"),
    (torch.bfloat16, 16, "tensor_core"),
    (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 72, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 100, "simt"),
    (torch.bfloat16, 20, "simt"),
    (torch.bfloat16, 1, "simt"),
    (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"),
])
def test_flash_route(dtype, dh, want):
    assert t_ops.route(dtype, dh) == want


def test_sdpa_bf16_probs_match_repro():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7, 1, 64, 4, 2, 16), True)
    out = t_sdpa(tq, tk, tv, causal_offset=0, probs_dtype=torch.bfloat16)
    _close(out, j_sdpa(jq, jk, jv, causal_offset=0, probs_dtype=jnp.bfloat16), 3e-2)


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain version (card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,Hkv,dh,causal", [
    (1, 128, 128, 2, 2, 16, True),
    (2, 200, 200, 8, 2, 64, True),
    (1, 70, 70, 4, 1, 128, True),
    (2, 33, 150, 4, 4, 100, False),
    (2, 300, 300, 4, 4, 72, True),     # tensor cores: dh 72 pads to 128
    (1, 130, 257, 8, 1, 64, False),    # S != T, MQA, both off the tile
    (1, 1, 1, 4, 2, 64, True),         # one token
    (2, 384, 384, 8, 2, 128, True),    # three full tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_card(B, S, T, H, Hkv, dh, causal, dtype):
    needs_cuda()
    q, k, v = (torch.from_numpy(a).cuda().to(dtype)
               for a in _qkv(8, B, S, H, Hkv, dh, T=T))
    tensor_core = t_ops.route(dtype, dh) == "tensor_core"
    before, tc_before = t_flash.launches, t_flash.tc_launches
    out = t_flash(q, k, v, causal=causal)
    assert t_flash.launches == before + 1
    assert t_flash.tc_launches == tc_before + int(tensor_core)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    probs = torch.bfloat16 if tensor_core else torch.float32
    ref = t_ref(q, k, v, causal=causal, probs_dtype=probs)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_tensor_core_kernel_repeats_bit_for_bit(dh):
    needs_cuda()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in _qkv(11, 2, 520, 8, 2, dh))
    first = t_flash(q, k, v, causal=True)
    assert torch.equal(first, t_flash(q, k, v, causal=True))
