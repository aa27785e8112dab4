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
by tests/test_torch_cuda.py; here the pure functions of shapes that pick
its routes on the card (``route_for``, ``split_count``) and the build's
hash of its shared header are checked.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
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
    # meta is the dry run's device: a meta result at a head dim the card
    # takes; q on meta beside CPU keys raises
    qm = torch.empty((1, 4, 2, 64), dtype=torch.bfloat16, device="meta")
    out = FA.flash_attention(qm, qm, qm)
    assert out.device.type == "meta" and out.shape == qm.shape
    kc = torch.randn((1, 4, 2, 64)).bfloat16()
    with pytest.raises(ValueError, match="is on"):
        FA.flash_attention(qm, kc, kc)
    empty = FA.flash_attention(q, q[:, :0], q[:, :0])
    assert empty.shape == q.shape and not empty.any()


# dtype, Sq, rep, the route the kernels take on the card: bf16 rows of one
# CTA (Sq x rep) that fit one m16 tile split their keys (decode, short
# chunks); more rows take the rows route (encoders, prefill buckets); fp32
# stays on the CUDA cores (TF32 off).
_ROUTE_CASES = [
    ("bfloat16", 128, 1, "rows"),        # bert-base
    ("bfloat16", 197, 1, "rows"),        # vit-base
    ("bfloat16", 64, 3, "rows"),         # smollm's prefill bucket
    ("bfloat16", 17, 1, "rows"),
    ("bfloat16", 6, 3, "rows"),          # 18 rows
    ("bfloat16", 1, 3, "split"),         # smollm decode
    ("bfloat16", 1, 1, "split"),         # zamba2 decode
    ("bfloat16", 1, 16, "split"),
    ("bfloat16", 5, 3, "split"),         # 15 rows
    ("bfloat16", 8, 2, "split"),         # 16 rows
    ("float32", 1, 3, "cuda_cores"),
    ("float32", 128, 1, "cuda_cores"),
]


@pytest.mark.parametrize("case", _ROUTE_CASES, ids=str)
def test_route_for(case):
    dtype, Sq, rep, route = case
    assert FA.route_for(getattr(torch, dtype), Sq, rep) == route
    assert route in FA.ROUTES


# B, Hkv, keys in memory, the split count: the B x Hkv pairs brought near
# SPLIT_TARGET_CTAS CTAs, at most MAX_SPLITS, none once the pairs fill the
# SMs, and at least MIN_SPLIT_KEYS (256) keys a CTA.
_SPLIT_CASES = [
    (8, 3, 256, 1),          # smollm decode: a merge costs more than it saves
    (8, 3, 512, 2),
    (8, 3, 1024, 4),
    (8, 3, 2048, 8),         # 24 pairs x 8 = 192 CTAs of 256 keys
    (2, 12, 4096, 8),
    (4, 12, 4096, 4),        # 48 pairs
    (8, 12, 2048, 2),        # 96 pairs
    (16, 8, 1024, 2),        # 128 pairs, just short of the SMs
    (8, 32, 512, 1),         # zamba2 decode: 256 pairs fill the SMs
    (3, 2, 88, 1),
]


@pytest.mark.parametrize("case", _SPLIT_CASES, ids=str)
def test_split_count(case):
    """kernels/flash_attention.py::split_count, a pure function of shapes
    (never of kv_valid_len): a count csrc/attn_mma.cuh takes (1..8 CTAs of
    a cluster), each with a non-empty even share of the 16-key tiles."""
    B, Hkv, n_keys, splits = case
    got = FA.split_count(B, Hkv, n_keys)
    assert got == splits
    assert 1 <= got <= FA.MAX_SPLITS
    assert got <= -(-n_keys // 16)           # every share holds a tile
    assert got == 1 or B * Hkv < FA.SMS


def test_cpu_call_counts_no_route():
    """On CPU tensors the wrapper runs the plain version: no route counts."""
    before = dict(FA.flash_attention.launches_by_route)
    q, k, v = _to_port(*_operands(2, 1, 40, 6, 2, 64, "bfloat16", seed=6))
    FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches_by_route == before
    assert set(before) == set(FA.ROUTES)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """kernels/_build.py: a kernel's library name hashes its source and
    every csrc header it includes (through other headers too), so an
    edited header rebuilds instead of reusing a stale library."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    # the port's attention sources include their shared warp tile
    monkeypatch.undo()
    for name in ("flash_attention", "paged_attention"):
        assert "attn_mma.cuh" in [p.name for p in _build.sources(name)]
