"""The port's flash attention (repro_torch/kernels/flash_attention.py)
against the JAX package's Pallas flash kernel in interpret mode
(``repro.kernels.ops.mha(..., impl="interpret")``).

On the CPU the wrapper runs its plain version (the kernel's online-softmax
recurrence over 32-key blocks). The grid is tests/parity.py's ATTN_CASES —
prefill, GQA with a ragged length, decode against a long partially filled
cache, masked position −1 rows, a chunked-prefill offset, non-causal
ragged keys — in fp32 and bf16 within its ATTN_TOLS, plus the
bottom-right default positions, a soft-cap, masked rows that are exactly
zero, and the head dims the kernel is built for (64, and 80 for
ViT-huge). The CUDA kernel is held against the plain version on the card
by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import ATTN_CASES, ATTN_TOLS, make_attention_operands

from repro.kernels.ops import mha as jmha
from repro_torch.convert import to_tensor
from repro_torch.core import api
from repro_torch.core.plan import FUSED, PAGED, UNFUSED
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import mha_ref


def _to_port(*xs):
    return [None if x is None else to_tensor(np.asarray(x)) for x in xs]


def _check(got, want, dtype, qpos=None, causal=True):
    atol, rtol = ATTN_TOLS[dtype]
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    if qpos is not None and causal:
        masked = np.asarray(qpos) < 0
        assert not masked.any() or np.abs(got[masked]).max() == 0.0


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: c.name)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(case, dtype):
    q, k, v, qpos, kvl = make_attention_operands(case, dtype)
    want = np.asarray(jmha(q, k, v, causal=case.causal, q_positions=qpos,
                           kv_valid_len=kvl, impl="interpret")
                      .astype(jnp.float32))
    before = FA.flash_attention.launches
    got = FA.flash_attention(*_to_port(q, k, v, qpos, kvl),
                             causal=case.causal)
    assert FA.flash_attention.launches == before          # CPU: no launch
    assert got.dtype == to_tensor(np.asarray(q)).dtype
    _check(got, want, dtype, qpos, case.causal)


def _operands(B, Sq, Sk, H, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed + Sq * 7 + Sk)
    dt = jnp.dtype(dtype)
    return [jnp.asarray(rng.standard_normal(s, np.float32)).astype(dt)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_bottom_right_default_positions(dtype, causal):
    """No q_positions and no kv_valid_len: query i sits at
    i + (Sk − Sq), the TPU wrapper's default (the paged kernel's default is
    plain arange; the two wrappers keep their own)."""
    q, k, v = _operands(2, 5, 40, 4, 2, 16, dtype)
    want = np.asarray(jmha(q, k, v, causal=causal, impl="interpret")
                      .astype(jnp.float32))
    got = FA.flash_attention(*_to_port(q, k, v), causal=causal)
    _check(got, want, dtype)
    # the bottom-right rows see more keys than arange-positioned ones would
    qa, ka, va = _to_port(q, k, v)
    top_left = FA.flash_attention(qa, ka, va, torch.arange(5).expand(2, 5),
                                  causal=causal)
    assert causal == (not torch.equal(top_left, got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_soft_cap(dtype):
    q, k, v = _operands(2, 9, 33, 4, 4, 16, dtype, seed=1)
    q = q * 4                                  # logits well past the cap
    kvl = jnp.asarray([33, 20], jnp.int32)
    want = np.asarray(jmha(q, k, v, causal=False, soft_cap=5.0,
                           kv_valid_len=kvl, impl="interpret")
                      .astype(jnp.float32))
    got = FA.flash_attention(*_to_port(q, k, v, None, kvl), causal=False,
                             soft_cap=5.0)
    _check(got, want, dtype)
    uncapped = FA.flash_attention(*_to_port(q, k, v, None, kvl),
                                  causal=False)
    assert not torch.allclose(uncapped.float(), got.float(), atol=1e-2)


def test_masked_rows_exactly_zero():
    """Rows at position −1, and rows of a batch row with no valid key, are
    exactly 0 in the output — never NaN — as in the reference."""
    q, k, v = _operands(3, 4, 64, 6, 3, 16, "float32", seed=2)
    qpos = jnp.asarray([[10, 11, -1, -1], [-1, -1, -1, -1], [0, 1, 2, 3]],
                       jnp.int32)
    kvl = jnp.asarray([12, 30, 0], jnp.int32)
    want = np.asarray(jmha(q, k, v, q_positions=qpos, kv_valid_len=kvl,
                           impl="interpret"))
    got = FA.flash_attention(*_to_port(q, k, v, qpos, kvl)).numpy()
    np.testing.assert_allclose(got, want, *ATTN_TOLS["float32"])
    assert np.isfinite(got).all()
    assert not got[0, 2:].any() and not got[1].any() and not got[2].any()
    assert np.abs(got[0, :2]).min(axis=-1).max() > 0


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_built_head_dims(D, dtype):
    """The kernel's head dims at an encoder's shape (non-causal, MHA;
    ViT-huge has 1280 / 16 = 80) and a GQA rep-3 decode (smollm)."""
    q, k, v = _operands(2, 23, 23, 4, 4, D, dtype, seed=3)
    want = np.asarray(jmha(q, k, v, causal=False, impl="interpret")
                      .astype(jnp.float32))
    _check(FA.flash_attention(*_to_port(q, k, v), causal=False), want, dtype)
    q, k, v = _operands(3, 1, 70, 9, 3, D, dtype, seed=4)
    qpos = jnp.asarray([[40], [-1], [69]], jnp.int32)
    kvl = jnp.asarray([41, 0, 70], jnp.int32)
    want = np.asarray(jmha(q, k, v, q_positions=qpos, kv_valid_len=kvl,
                           impl="interpret").astype(jnp.float32))
    _check(FA.flash_attention(*_to_port(q, k, v, qpos, kvl)), want, dtype,
           qpos)


def test_strided_views_and_backends():
    """K/V handed over as views of a larger cache (the contiguous serving
    cache sliced to max_len) give what the contiguous copies give; the
    fused backend, and the paged backend on dense operands, route to the
    same wrapper; unfused is mha_ref."""
    q, k, v = _to_port(*_operands(2, 3, 48, 4, 2, 16, "float32", seed=5))
    cache = torch.zeros((2, 49, 2, 16))
    cache[:, :48] = k
    qpos = torch.tensor([[20, 21, 22], [45, 46, 47]], dtype=torch.int32)
    kvl = torch.tensor([23, 48], dtype=torch.int32)
    want = FA.flash_attention(q, k, v, qpos, kvl)
    got = FA.flash_attention(q, cache[:, :48], v, qpos, kvl)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    for pol in (FUSED, PAGED):
        out = api.attention(q, k, v, q_positions=qpos, kv_valid_len=kvl,
                            policy=pol)
        torch.testing.assert_close(out, want, atol=0, rtol=0)
    ref = api.attention(q, k, v, q_positions=qpos, kv_valid_len=kvl,
                        policy=UNFUSED)
    torch.testing.assert_close(ref, mha_ref(q, k, v, q_positions=qpos,
                                            kv_valid_len=kvl),
                               atol=0, rtol=0)
    torch.testing.assert_close(ref, want, atol=3e-5, rtol=3e-5)


def test_fused_rejects_block_tables_and_bad_devices():
    q = torch.randn(1, 4, 2, 16)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="paged KV cache"):
        api.attention(q, q, q, q_positions=pos, kv_valid_len=torch.tensor([4]),
                      block_tables=torch.zeros((1, 1), dtype=torch.int32),
                      policy=FUSED)
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention(torch.randn(1, 4, 3, 16), q, q)
    with pytest.raises(ValueError, match="no flash attention kernel"):
        FA.flash_attention(*(x.to("meta") for x in (q, q, q)))
    empty = FA.flash_attention(q, q[:, :0], q[:, :0])
    assert empty.shape == q.shape and not empty.any()
