"""The port's MatrixFlow GEMM (repro_torch/kernels/matrixflow_gemm.py and
the core/api.py backends) against the JAX package's.

On the CPU the kernel wrapper runs its plain version (Algorithm 1 over
block-major operands); it is held against the Pallas kernel in interpret
mode over tests/parity.py's SHAPES × fp32/bf16/int8 with its TOLS (int8
exact). The ``cuda``-marked test holds the CUDA kernel against the plain
version and skips without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import DTYPES, SHAPES, TOLS, make_operands, reference

from repro.core import api as japi
from repro.core import layout as JL
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.core.plan import pack_weight as jpack_weight
from repro.kernels.matrixflow_gemm import matrixflow_gemm_block_major as jgemm
from repro_torch.convert import to_tensor
from repro_torch.core import api
from repro_torch.core import layout as L
from repro_torch.core.plan import GemmPolicy, pack_weight
from repro_torch.kernels import matrixflow_gemm as MF
from repro_torch.kernels.ref import matmul_ref


def _check(got: torch.Tensor, want: np.ndarray, dtype: str):
    if dtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      want.astype(np.int64))
        return
    atol, rtol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_gemm_matches_jax_kernel(shape, dtype):
    """Block-major in, block-major out, same blocks on both sides."""
    M, K, N = shape
    a, b = make_operands(dtype, M, K, N)
    blk = L.choose_layout(M, N, K, to_tensor(np.asarray(a)).dtype)
    jblk = JL.BlockLayout(blk.bm, blk.bn, blk.bk, blk.mode)
    a_bm = JL.to_block_major_a(a, blk.bm, blk.bk)
    b_bm = JL.to_block_major_b(b, blk.bk, blk.bn)
    want = np.asarray(jgemm(a_bm, b_bm, blk=jblk, interpret=True))
    before = MF.matrixflow_gemm_block_major.launches
    got = MF.matrixflow_gemm_block_major(to_tensor(np.asarray(a_bm)),
                                         to_tensor(np.asarray(b_bm)))
    assert MF.matrixflow_gemm_block_major.launches == before  # CPU: no launch
    assert got.shape == want.shape
    _check(got, want, dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", ["matrixflow", "blockflow", "torch"])
def test_api_matmul_matches_jax(shape, dtype, backend):
    """Row-major api.matmul on every port backend against JAX's api.matmul
    (xla), including the promoted output dtype (int8 → int32)."""
    M, K, N = shape
    a, b = make_operands(dtype, M, K, N)
    want = np.asarray(japi.matmul(a, b, policy=JGemmPolicy(backend="xla")))
    got = api.matmul(to_tensor(np.asarray(a)), to_tensor(np.asarray(b)),
                     policy=GemmPolicy(backend=backend))
    assert got.dtype == to_tensor(want).dtype
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dc", "dm"])
def test_linear_on_packed_weight_matches_jax(dtype, mode):
    """api.linear on a resident PackedWeight (3-D activations, bias) against
    JAX's api.linear on its own PackedWeight of the same weight."""
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, 5, 96)).astype(np.float32)
                    ).astype(dtype)
    w = jnp.asarray((rng.standard_normal((96, 200)) / 10).astype(np.float32)
                    ).astype(dtype)
    bias = jnp.asarray(rng.standard_normal(200).astype(np.float32)
                       ).astype(dtype)
    jpol = JGemmPolicy(backend="blockflow", mode=mode)
    want = np.asarray(japi.linear(x, jpack_weight(w, jpol), bias,
                                  policy=jpol).astype(jnp.float32))
    pw = pack_weight(to_tensor(np.asarray(w)), GemmPolicy(mode=mode))
    assert pw.data.shape[-2:] == (pw.bk, pw.bn)
    np.testing.assert_array_equal(
        pw.unpack().float().numpy(), np.asarray(w.astype(jnp.float32)))
    got = api.linear(to_tensor(np.asarray(x)), pw, to_tensor(np.asarray(bias)),
                     policy=GemmPolicy(backend="matrixflow", mode=mode))
    assert got.shape == (2, 5, 200)
    atol, rtol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_ref_matches_parity_reference(shape, dtype):
    """kernels/ref.py::matmul_ref, the row-major plain GEMM, against the
    harness's ground truth (int64-exact for int8, fp32 else)."""
    a, b = make_operands(dtype, *shape)
    got = matmul_ref(to_tensor(np.asarray(a)), to_tensor(np.asarray(b)))
    _check(got, reference(a, b), dtype)


def test_plan_resolves_backend_by_device():
    assert GemmPolicy().resolved_backend("cpu") == "blockflow"
    assert GemmPolicy().resolved_backend("cuda") == "matrixflow"
    p = api.plan(8, 576, 576, torch.bfloat16, GemmPolicy(mode="auto"), "cpu")
    assert p.backend == "blockflow" and p.mode in ("dc", "dm")
    assert p.layout == L.choose_layout(8, 576, 576, torch.bfloat16,
                                       mode=p.mode)


def test_wrapper_rejects_mismatched_k_stream():
    a = torch.zeros(1, 2, 16, 32)
    b = torch.zeros(1, 3, 32, 32)
    with pytest.raises(ValueError, match="K stream"):
        MF.matrixflow_gemm_block_major(a, b)



def test_route_by_dtype_and_row_tile():
    """bf16 takes the tensor cores (wgmma at bm 64, mma.sync at 16/32);
    fp32 (TF32 stays off) and int8 the CUDA-core routine."""
    for bm in L.BM_CHOICES:
        assert MF.route_for(torch.bfloat16, bm) == \
            ("wgmma" if bm == 64 else "mma")
        assert MF.route_for(torch.float32, bm) == "cuda_core"
        assert MF.route_for(torch.int8, bm) == "cuda_core"


# (M, K, N) of every projection of the served and encoded models, at the
# block geometry the engine packs them in (chip_smoke.py::gemm_cells).
_PATH_GEMMS = ((8, 576, 576), (8, 576, 192), (8, 1536, 576), (8, 576, 49152),
               (512, 576, 3072), (8, 2048, 4096), (8, 2048, 64),
               (8, 4096, 2048), (3072, 2048, 4096), (3072, 2048, 128),
               (8, 10240, 2560), (8, 2560, 20480), (1024, 768, 768),
               (1024, 3072, 768), (1576, 768, 30522), (20, 704, 1000),
               (33, 17, 65), (40, 576, 8192))


@pytest.mark.parametrize("mkn", _PATH_GEMMS, ids=str)
def test_tc_tile_is_one_the_kernels_take(mkn):
    """kernels/matrixflow_gemm.py::tc_tile: a tile csrc/matrixflow_gemm.cu
    instantiates (wgmma: 1 x 64, 1 x 128, 2 x 128, 2 x 256, whole C blocks
    per CTA; mma: one C block, 1-8 K splits, each split with K to walk),
    and split K only where the C blocks alone leave SMs idle."""
    M, K, N = mkn
    blk = L.choose_layout(M, N, K, torch.bfloat16)
    nbm, nbn, nbk = L.cdiv(M, blk.bm), L.cdiv(N, blk.bn), L.cdiv(K, blk.bk)
    gm, tn, splits = MF.tc_tile(blk.bm, blk.bn, nbm, nbn, nbk, blk.bk)
    if blk.bm == 64:
        assert (gm, tn) in {(g, t) for g, t, _ in MF.WGMMA_TILES}
        assert tn % blk.bn == 0 and splits == 1
    else:
        assert (gm, tn) == (1, blk.bn) and 1 <= splits <= MF.MAX_SPLITS
        assert splits <= nbk * blk.bk // L.K_SLICE
        assert splits == 1 or nbm * nbn < MF.SMS


def test_wrapper_counts_no_launch_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version: no route counts."""
    fn = MF.matrixflow_gemm_block_major
    before = (fn.launches, fn.wgmma_launches, fn.mma_launches,
              fn.cuda_core_launches)
    a = L.to_block_major_a(torch.ones(8, 64, dtype=torch.bfloat16), 16, 32)
    b = L.to_block_major_b(torch.ones(64, 32, dtype=torch.bfloat16), 32, 32)
    c = fn(a, b, out_dtype=torch.bfloat16)
    assert bool((L.from_block_major_c(c, 8, 32).float() == 64).all())
    assert (fn.launches, fn.wgmma_launches, fn.mma_launches,
            fn.cuda_core_launches) == before
