"""The attention kernels' plain versions at the shapes the rest of the dense
family brings — head_dim 128 (qwen2, qwen3, granite) and GQA groups above
16 (granite-20b: 48 query heads on one kv head) — against the JAX
package's Pallas kernels in interpret mode, within tests/parity.py's
ATTN_TOLS: K3 over dense K/V, K4 over fp pools and K5 over int8 pools
(fp32 and bf16 q), under shuffled block tables, at decode, a bucketed
prefill and a chunk at an offset, with masked rows exactly zero.

``reduced()`` gives granite a group of 4, so the group-48 cases build
their own shapes (narrow heads keep them fast; one case is 48 x 128).
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py; here the routes those shapes take there (a pure
function of shapes) are checked.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import ATTN_TOLS, make_paged_operands

from repro.core import quant as JQ
from repro.kernels.ops import mha as jmha
from repro.kernels.paged_attention import paged_attention as jpaged
from repro_torch.convert import to_tensor
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA

# name, B, Sq, H, Hkv, D, page size, kv lengths, first query position per
# row (-1: the row is masked whole)
CASES = [
    ("d128_group6_decode", 3, 1, 12, 2, 128, 16, (80, 33, 1), (79, 32, 0)),
    ("d128_group4_chunk", 2, 12, 8, 2, 128, 16, (12, 40), (0, 28)),
    ("group48_decode", 3, 1, 48, 1, 16, 16, (70, 17, 40), (69, 16, -1)),
    ("group48_prefill", 2, 9, 48, 1, 16, 8, (9, 45), (0, 36)),
    ("group64_decode", 2, 1, 64, 1, 16, 32, (50, 3), (49, 2)),
    ("d128_group48_decode", 2, 1, 48, 1, 128, 16, (37, 20), (36, 19)),
]


def _port(*xs):
    return [None if x is None else to_tensor(np.asarray(x)) for x in xs]


def _operands(case, seed=0):
    name, B, Sq, H, Hkv, D, ps, lens, starts = case
    T = max(lens)
    rng = np.random.default_rng(seed + H * 10 + D)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    qpos = np.full((B, Sq), -1, np.int32)
    for b, s0 in enumerate(starts):
        if s0 >= 0:
            qpos[b] = s0 + np.arange(Sq)
    return (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(qpos), jnp.asarray(np.asarray(lens, np.int32)))


def _check(got, want, dtype, qpos):
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               *ATTN_TOLS[dtype])
    masked = np.asarray(qpos) < 0
    assert not masked.any() or np.abs(got[masked]).max() == 0.0


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(case, dtype):
    q, k, v, qpos, kvl = _operands(case)
    dt = jnp.dtype(dtype)
    q, k, v = q.astype(dt), k.astype(dt), v.astype(dt)
    want = jmha(q, k, v, causal=True, q_positions=qpos, kv_valid_len=kvl,
                impl="interpret").astype(jnp.float32)
    got = FA.flash_attention(*_port(q, k, v, qpos, kvl), causal=True)
    _check(got, want, dtype, qpos)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax(case, dtype):
    q, k, v, qpos, kvl = _operands(case, seed=1)
    kp, vp, bt = make_paged_operands(k, v, page_size=case[6], seed=2)
    dt = jnp.dtype(dtype)
    q, kp, vp = q.astype(dt), kp.astype(dt), vp.astype(dt)
    want = jpaged(q, kp, vp, bt, qpos, kvl, causal=True, block_q=8,
                  interpret=True).astype(jnp.float32)
    got = PA.paged_attention(*_port(q, kp, vp, bt, qpos, kvl), causal=True)
    _check(got, want, dtype, qpos)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_int8_plain_matches_jax(case, q_dtype):
    q, k, v, qpos, kvl = _operands(case, seed=3)
    kp, vp, bt = make_paged_operands(k, v, page_size=case[6], seed=4)
    qk, ks = JQ.quantize_kv_pages(kp)
    qv, vs = JQ.quantize_kv_pages(vp)
    q = q.astype(jnp.dtype(q_dtype))
    want = jpaged(q, qk, qv, bt, qpos, kvl, kv_scales=(ks, vs), causal=True,
                  block_q=8, interpret=True).astype(jnp.float32)
    tq, tqk, tqv, tks, tvs, tbt, tqpos, tkvl = _port(q, qk, qv, ks, vs, bt,
                                                     qpos, kvl)
    got = PA.paged_attention(tq, tqk, tqv, tbt, tqpos, tkvl,
                             kv_scales=(tks, tvs), causal=True)
    _check(got, want, q_dtype, qpos)


# Sq, rep, the route bf16 takes on the card: a decode row of any group is
# split (granite's 48 rows are three m16 tiles of one kv head); more rows
# than one tile take rows.
_ROUTES = [(1, 48, "split"), (1, 64, "split"), (1, 6, "split"),
           (2, 48, "rows"), (64, 48, "rows"), (64, 6, "rows"),
           (5, 3, "split")]


@pytest.mark.parametrize("case", _ROUTES, ids=str)
def test_routes_of_large_groups(case):
    Sq, rep, route = case
    assert FA.route_for(torch.bfloat16, Sq, rep) == route
    assert PA.route_for(torch.float32, Sq, rep) == "cuda_cores"


def test_head_dim_128_is_built():
    """K3 is built for head_dim 128 and K4/K5's tensor-core geometry takes
    it at the serving page size; the wrappers no longer cap the group."""
    assert 128 in FA.HEAD_DIMS
    PA.check_tc_geometry("split", 16, 128, 128, 32)
    assert not hasattr(FA, "MAX_ROWS") and not hasattr(PA, "MAX_ROWS")
