"""The port's W8A8 GEMM — the plain version of K2
(kernels/matrixflow_gemm.py::matrixflow_gemm_dequant) and ``api.linear``
under ``GemmPolicy(weight_dtype="int8")`` on each of the port's GEMM
backends — against the JAX package's dequant-fused Pallas kernel in
interpret mode and its ``pallas_interpret`` route.

The gate is tests/parity.py's ``check_quantized_cell`` tolerance (atol
1e-5, rtol 1e-6); every case is also bitwise equal, as it must be: the
int32 sums are exact and the two fp32 products of the dequant are taken
in the same order. Shapes are parity.SHAPES (K and N not multiples of the
blocks included) plus a decode-like row of K = 1536 sums past 2^24, where
the int32 → fp32 conversion rounds. The ``cuda``-marked twins live in
tests/test_torch_cuda.py.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import SHAPES, make_operands

from repro.core import api as japi
from repro.core import layout as JL
from repro.core import quant as JQ
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.core.plan import pack_weight as jpack_weight
from repro.kernels.matrixflow_gemm import matrixflow_gemm_block_major as jgemm
from repro_torch.convert import to_tensor
from repro_torch.core import api
from repro_torch.core import layout as L
from repro_torch.core.plan import GemmPolicy, pack_weight
from repro_torch.kernels import matrixflow_gemm as MF

ATOL, RTOL = 1e-5, 1e-6           # parity.check_quantized_cell
# every large-sum entry exceeds 2^24 in int32 (1536 · 127² ≈ 2.5e7)
LARGE = (8, 1536, 160)
CASES = SHAPES + (LARGE,)


def _operands(shape, dtype="float32"):
    M, K, N = shape
    if shape == LARGE:
        rng = np.random.default_rng(9)
        a = (1 + 0.01 * rng.standard_normal((M, K))).astype(np.float32)
        w = (1 + 0.01 * rng.standard_normal((K, N))).astype(np.float32)
        a, w = jnp.asarray(a), jnp.asarray(w)
    else:
        a, w = make_operands("float32", M, K, N, seed=1)
    return a.astype(dtype), w.astype(dtype)


def _check(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CASES, ids=str)
def test_dequant_plain_matches_jax_kernel(shape, out):
    """Block-major int8 in, the scales, C block-major out; the same blocks
    (the port's Hopper geometry) on both sides."""
    M, K, N = shape
    a, w = _operands(shape)
    aq, sa = JQ.quantize_activations(a)
    wq, sw = JQ.quantize_weight(w)
    blk = L.choose_layout(M, N, K, torch.int8)
    jblk = JL.BlockLayout(blk.bm, blk.bn, blk.bk, blk.mode)
    a_bm = JL.to_block_major_a(aq, blk.bm, blk.bk)
    b_bm = JL.to_block_major_b(wq, blk.bk, blk.bn)
    want = jgemm(a_bm, b_bm, blk=jblk, out_dtype=jnp.dtype(out),
                 interpret=True, acc_dtype=jnp.int32, scale_a=sa, scale_b=sw)
    before = MF.matrixflow_gemm_dequant.launches
    got = MF.matrixflow_gemm_dequant(
        to_tensor(np.asarray(a_bm)), to_tensor(np.asarray(b_bm)),
        to_tensor(np.asarray(sa)), to_tensor(np.asarray(sw)),
        out_dtype=getattr(torch, out))
    assert MF.matrixflow_gemm_dequant.launches == before   # CPU: no launch
    assert got.dtype == getattr(torch, out) and got.shape == want.shape
    _check(got, want)
    if shape == LARGE:
        acc = (np.asarray(aq, np.int64) @ np.asarray(wq, np.int64))
        assert np.abs(acc).min() > 2 ** 24


@pytest.mark.parametrize("backend", ["matrixflow", "blockflow", "torch"])
@pytest.mark.parametrize("shape", CASES, ids=str)
def test_linear_w8a8_matches_jax(shape, backend):
    """api.linear with a raw fp32 weight under weight_dtype="int8" (the
    weight quantized on the fly) against the JAX route through the Pallas
    kernel, and against parity's unfused dequant reference."""
    a, w = _operands(shape)
    want = japi.linear(a, w, policy=JGemmPolicy(backend="pallas_interpret",
                                                weight_dtype="int8"))
    aq, sa = JQ.quantize_activations(a)
    wq, sw = JQ.quantize_weight(w)
    c_int = np.asarray(aq, np.int64) @ np.asarray(wq, np.int64)
    ref = JQ.dequantize_gemm(jnp.asarray(c_int, jnp.int32), sa, sw)
    got = api.linear(to_tensor(np.asarray(a)), to_tensor(np.asarray(w)),
                     policy=GemmPolicy(backend=backend, weight_dtype="int8"))
    assert got.dtype == torch.float32
    _check(got, want)
    _check(got, ref)


@pytest.mark.parametrize("backend", ["matrixflow", "blockflow", "torch"])
@pytest.mark.parametrize("shape", [(1, 64, 128), (33, 17, 65), (130, 24, 56)],
                         ids=str)
def test_packed_bf16_w8a8_matches_jax(shape, backend):
    """bf16 activations against a resident QuantizedPackedWeight of a bf16
    weight: the route dequantizes to bf16 (promote(a, weight dtype)). The
    two packs have different block geometry, the result is the same."""
    a, w = _operands(shape, "bfloat16")
    jpw = jpack_weight(w, JGemmPolicy(), quantize="int8")
    want = japi.linear(a, jpw, policy=JGemmPolicy(backend="pallas_interpret"))
    pw = pack_weight(to_tensor(np.asarray(w)), quantize="int8")
    got = api.linear(to_tensor(np.asarray(a)), pw,
                     policy=GemmPolicy(backend=backend))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _check(got, want)
    # a 3-D activation keeps its leading dims
    got3 = api.linear(to_tensor(np.asarray(a))[None], pw,
                      policy=GemmPolicy(backend=backend))
    assert got3.shape == (1,) + tuple(got.shape)
    assert torch.equal(got3[0], got)


def test_dequant_wrapper_refuses_what_it_does_not_take():
    a_bm = torch.zeros((1, 1, 16, 32), dtype=torch.int8)
    b_bm = torch.zeros((1, 1, 32, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        MF.matrixflow_gemm_dequant(a_bm.float(), b_bm.float(), None, None)
    with pytest.raises(ValueError, match="scale_b"):
        MF.matrixflow_gemm_dequant(a_bm, b_bm, None, torch.ones(33))
    with pytest.raises(ValueError, match="K stream"):
        MF.matrixflow_gemm_dequant(a_bm, b_bm[:, :, :16], None, None)
    # absent scales are ones: the plain int32 product, in fp32
    a_bm = torch.randint(-127, 128, (2, 1, 16, 32), dtype=torch.int8)
    b_bm = torch.randint(-127, 128, (3, 1, 32, 32), dtype=torch.int8)
    got = MF.matrixflow_gemm_dequant(a_bm, b_bm, None, None)
    assert torch.equal(got, MF.matrixflow_gemm_block_major(a_bm, b_bm).float())


def test_dequant_route_by_row_tile():
    """K2 runs on the tensor cores at every row tile (s8 wgmma at bm 64,
    s8 mma.sync at 16 and 32); K1's int8 -> int32 instance stays on the
    CUDA cores."""
    for bm in L.BM_CHOICES:
        assert MF.route_for(torch.int8, bm, dequant=True) == \
            ("wgmma" if bm == 64 else "mma")
        assert MF.route_for(torch.int8, bm) == "cuda_core"


# (M, K, N) of the W8A8 GEMMs on the served paths: smollm-135m's decode
# and 64-column prefill projections and head, bert-base's forward, the
# SSM families' decode steps.
_W8A8_GEMMS = ((8, 576, 576), (8, 576, 192), (8, 576, 3072), (8, 1536, 576),
               (8, 576, 49152), (512, 576, 576), (512, 576, 3072),
               (512, 1536, 576), (1024, 768, 768), (1024, 3072, 768),
               (1024, 768, 30522), (8, 2048, 8192), (8, 2560, 10240),
               (40, 576, 8192))


@pytest.mark.parametrize("mkn", _W8A8_GEMMS, ids=str)
def test_dequant_tile_is_one_the_kernels_take(mkn):
    """The int8 block geometry the engine packs (choose_layout with int8:
    deeper K blocks than bf16's) gets a tile csrc/matrixflow_gemm.cu
    instantiates for K2: wgmma 1 x 64, 1 x 128, 2 x 128 or 2 x 256 whole
    C blocks a CTA at bm 64; one C block and 1-8 K splits at bm 16/32,
    each split with K to walk."""
    M, K, N = mkn
    blk = L.choose_layout(M, N, K, torch.int8)
    nbm, nbn, nbk = L.cdiv(M, blk.bm), L.cdiv(N, blk.bn), L.cdiv(K, blk.bk)
    assert blk.bk % L.K_SLICE == 0
    gm, tn, splits = MF.tc_tile(blk.bm, blk.bn, nbm, nbn, nbk, blk.bk)
    if blk.bm == 64:
        assert (gm, tn) in {(g, t) for g, t, _ in MF.WGMMA_TILES}
        assert tn % blk.bn == 0 and splits == 1
    else:
        assert (gm, tn) == (1, blk.bn) and 1 <= splits <= MF.MAX_SPLITS
        assert splits <= nbk * blk.bk // L.K_SLICE
        assert splits == 1 or nbm * nbn < MF.SMS


def test_dequant_cpu_call_counts_no_route():
    """On CPU tensors K2's wrapper runs the plain version: no route
    counts."""
    fn = MF.matrixflow_gemm_dequant
    before = (fn.launches, fn.wgmma_launches, fn.mma_launches)
    a_bm = torch.randint(-127, 128, (1, 1, 64, 32), dtype=torch.int8)
    b_bm = torch.randint(-127, 128, (1, 1, 32, 32), dtype=torch.int8)
    fn(a_bm, b_bm, torch.ones(64), torch.ones(32))
    assert (fn.launches, fn.wgmma_launches, fn.mma_launches) == before
