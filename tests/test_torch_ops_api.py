"""The port's kernel facade (repro_torch/kernels/ops.py) and the rest of
core's API (plan's registries and cache, api's resolved backends and
deprecated shims) against the JAX package's, on the CPU.

``ops.gemm``, ``gemm_preformatted``, ``mha`` and ``ssd`` run their
kernels' wrappers, which take the plain versions for CPU tensors; they
are held against ``repro.kernels.ops`` with ``impl="interpret"`` (the
Pallas kernels in interpret mode) at tests/parity.py's shapes, within its
TOLS / ATTN_TOLS (int8 exact). The API's register / unregister / cache
sequences are those of tests/test_plan.py and tests/test_api.py, run on
both packages.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
from repro.core import api as japi
from repro.core import layout as JL
from repro.core import plan as JP
from repro.kernels import ops as JO
from repro_torch.convert import to_tensor
from repro_torch.core import api
from repro_torch.core import layout as L
from repro_torch.core import plan as P
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import matrixflow_gemm as MF
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as K6


def check(got: torch.Tensor, want, dtype: str, tols=parity.TOLS):
    want = np.asarray(jnp.asarray(want, jnp.float32)
                      if dtype != "int8" else want)
    if dtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      want.astype(np.int64))
        return
    atol, rtol = tols[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)


# Each parity shape against the Pallas kernel in interpret mode, the
# dtypes taken in turn (tests/test_torch_gemm.py holds K1's plain version
# to it over the whole grid); the whole grid against parity's numpy
# reference below.
INTERPRET_CELLS = tuple(zip(parity.SHAPES, parity.DTYPES * 2))


@pytest.mark.parametrize("shape,dtype", INTERPRET_CELLS, ids=str)
def test_gemm_matches_reference_interpret(shape, dtype):
    M, K, N = shape
    a, b = parity.make_operands(dtype, M, K, N)
    want = JO.gemm(a, b, impl="interpret")
    before = MF.matrixflow_gemm_block_major.launches
    check(ops.gemm(to_tensor(a), to_tensor(b)), want, dtype)
    assert MF.matrixflow_gemm_block_major.launches == before   # plain: CPU


@pytest.mark.parametrize("shape", parity.SHAPES, ids=str)
@pytest.mark.parametrize("dtype", parity.DTYPES)
def test_gemm_parity_grid(shape, dtype):
    M, K, N = shape
    a, b = parity.make_operands(dtype, M, K, N)
    want = parity.reference(a, b)
    check(ops.gemm(to_tensor(a), to_tensor(b)), want, dtype)
    check(ops.gemm(to_tensor(a), to_tensor(b), mode="dc"), want, dtype)
    check(ops.gemm(to_tensor(a), to_tensor(b), impl="ref"), want, dtype)


@pytest.mark.parametrize("dtype", ["int8"])
def test_gemm_preformatted_matches_reference_interpret(dtype):
    M, K, N = 33, 17, 65
    a, b = parity.make_operands(dtype, M, K, N)
    jblk = JL.choose_layout(M, N, K, a.dtype)
    a_bm = JL.to_block_major_a(a, jblk.bm, jblk.bk)
    b_bm = JL.to_block_major_b(b, jblk.bk, jblk.bn)
    want = JO.gemm_preformatted(a_bm, b_bm, blk=jblk, impl="interpret")
    blk = L.BlockLayout(jblk.bm, jblk.bn, jblk.bk)
    got = ops.gemm_preformatted(to_tensor(a_bm), to_tensor(b_bm), blk=blk)
    assert tuple(got.shape) == tuple(want.shape)
    check(got, want, dtype)
    check(ops.gemm_preformatted(to_tensor(a_bm), to_tensor(b_bm), blk=blk,
                                impl="ref"), want, dtype)
    with pytest.raises(ValueError, match="blocks match layout|do not match"):
        ops.gemm_preformatted(to_tensor(a_bm), to_tensor(b_bm),
                              blk=L.BlockLayout(blk.bm, blk.bn, blk.bk * 2))


@pytest.mark.parametrize("case", parity.ATTN_CASES, ids=lambda c: c.name)
def test_mha_matches_reference_interpret(case):
    dtype = "float32"
    q, k, v, qpos, kvl = parity.make_attention_operands(case, dtype)
    want = JO.mha(q, k, v, causal=case.causal, q_positions=qpos,
                  kv_valid_len=kvl, impl="interpret")
    tq, tk, tv, tqp, tkl = map(to_tensor, (q, k, v, qpos, kvl))
    got = ops.mha(tq, tk, tv, causal=case.causal, q_positions=tqp,
                  kv_valid_len=tkl, block_q=32, block_k=32)
    check(got, want, dtype, parity.ATTN_TOLS)
    check(ops.mha(tq, tk, tv, causal=case.causal, q_positions=tqp,
                  kv_valid_len=tkl, impl="ref"), want, dtype,
          parity.ATTN_TOLS)


def test_ssd_matches_reference_interpret():
    rng = np.random.default_rng(0)
    B, S, H, Pd, N = 2, 48, 2, 8, 8
    x = rng.standard_normal((B, S, H, Pd)).astype(np.float32)
    dt = (0.1 + 0.2 * rng.random((B, S, H))).astype(np.float32)
    A = -(0.5 + rng.random(H)).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    want = JO.ssd(*map(jnp.asarray, (x, dt, A, Bc, Cc)), chunk=16,
                  impl="interpret")
    args = [torch.from_numpy(t) for t in (x, dt, A, Bc, Cc)]
    before = K6.ssd_scan.launches
    check(ops.ssd(*args, chunk=16), want, "float32")
    check(ops.ssd(*args, impl="ref"), want, "float32")
    assert K6.ssd_scan.launches == before


@pytest.mark.parametrize("impl", ["pallas", "interpret", "cuda"])
def test_ops_refuses_the_tpu_impls(impl):
    a = torch.ones(4, 4)
    with pytest.raises(ValueError, match="port's choices"):
        ops.gemm(a, a, impl=impl)
    with pytest.raises(ValueError, match="port's choices"):
        ops.mha(a[None, :, None], a[None, :, None], a[None, :, None],
                impl=impl)


def test_ops_meta_takes_the_card_routes():
    """On meta tensors the facade runs the wrappers' card paths: the
    shapes the card would return, and no launch counted."""
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")
    before = (MF.matrixflow_gemm_block_major.launches, FA.flash_attention
              .launches)
    assert ops.gemm(m(8, 64), m(64, 96)).shape == (8, 96)
    assert ops.mha(m(1, 1, 4, 64), m(1, 32, 2, 64),
                   m(1, 32, 2, 64)).shape == (1, 1, 4, 64)
    assert (MF.matrixflow_gemm_block_major.launches,
            FA.flash_attention.launches) == before


# ---------------------------------------------------------------------------
# core's API against tests/test_plan.py's and tests/test_api.py's uses
# ---------------------------------------------------------------------------

def registry_sequence(P_, fn):
    """The register / unregister sequence of tests/test_plan.py; returns
    what each step saw."""
    seen = []
    P_.register_backend("fake", fn, overwrite=True)
    seen.append("fake" in P_.registered_backends())
    P_.unregister_backend("fake")
    seen.append("fake" in P_.registered_backends())
    P_.register_backend("dupe", fn, overwrite=True)
    try:
        with pytest.raises(ValueError, match="already registered"):
            P_.register_backend("dupe", fn)
    finally:
        P_.unregister_backend("dupe")
    seen.append("dupe" in P_.registered_backends())
    P_.register_attention_backend("fake_attn", fn)
    seen.append("fake_attn" in P_.registered_attention_backends())
    with pytest.raises(ValueError, match="already registered"):
        P_.register_attention_backend("fake_attn", fn)
    P_.unregister_attention_backend("fake_attn")
    seen.append("fake_attn" in P_.registered_attention_backends())
    return seen


def test_registry_sequence_matches_reference():
    fn = lambda *a, **k: None
    before, jbefore = P.registered_backends(), JP.registered_backends()
    assert registry_sequence(P, fn) == registry_sequence(JP, fn) == \
        [True, False, False, True, False]
    assert P.registered_backends() == before
    assert {"blockflow", "matrixflow", "torch"} <= set(before)
    assert JP.registered_backends() == jbefore
    assert {"fused", "paged", "unfused"} <= set(
        P.registered_attention_backends())


def cache_sequence(P_, dtype):
    """tests/test_plan.py's plan-cache sequence: a miss, a hit, another
    policy's miss."""
    P_.plan_cache_clear()
    out = []
    P_.plan(128, 256, 512, dtype, P_.GemmPolicy(backend="blockflow",
                                                mode="dm"))
    out.append(P_.plan_cache_info()[:2])
    P_.plan(128, 256, 512, dtype, P_.GemmPolicy(backend="blockflow",
                                                mode="dm"))
    out.append(P_.plan_cache_info()[:2])
    P_.plan(128, 256, 512, dtype, P_.GemmPolicy(backend="blockflow",
                                                mode="dc"))
    out.append(P_.plan_cache_info()[:2])
    return out


def test_plan_cache_info_matches_reference():
    assert cache_sequence(P, torch.float32) == \
        cache_sequence(JP, jnp.float32) == [(0, 1), (1, 1), (1, 2)]
    # the port's key also holds the device type
    P.plan(128, 256, 512, torch.float32,
           P.GemmPolicy(backend="blockflow", mode="dc"), "cuda")
    assert P.plan_cache_info()[:2] == (1, 3)


def test_resolved_backends_take_the_device():
    assert api.resolved_backend("cpu") == "blockflow"
    assert api.resolved_backend("cuda") == "matrixflow"
    with api.use_policy(P.GemmPolicy(backend="torch")):
        assert api.resolved_backend("cuda") == "torch"
    assert api.resolved_attention_backend("cpu") == "unfused"
    assert api.resolved_attention_backend("cuda") == "paged"
    assert api.resolved_attention_backend("cuda", pageable=False) == "fused"
    with api.use_attention_policy(P.FUSED):
        assert api.resolved_attention_backend("cpu") == "fused"
    assert japi.resolved_backend() == "xla"


def test_gemm_backend_shim_warns_and_pins():
    with pytest.deprecated_call():
        with api.gemm_backend("blockflow"):
            assert api.current_backend("cuda") == "blockflow"
    assert api.current_backend("cuda") == "matrixflow"
    with pytest.deprecated_call():
        with japi.gemm_backend("blockflow"):
            assert japi.current_backend() == "blockflow"
    assert japi.current_backend() == "xla"
