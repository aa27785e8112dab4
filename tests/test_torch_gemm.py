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

