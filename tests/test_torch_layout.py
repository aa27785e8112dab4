"""The port's block-major layouts (repro_torch/core/layout.py) against the
JAX package's (repro/core/layout.py): the transforms must be bitwise the
same for any block geometry, on the ragged shapes that exercise padding."""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as JL
from repro_torch.core import layout as L

# (rows, cols, b0, b1): aligned, ragged on one side, ragged on both, blocks
# larger than the matrix, and the sizes tests/test_layout.py draws from.
SHAPES = [
    (64, 96, 16, 32),
    (33, 17, 16, 32),
    (1, 1, 8, 8),
    (130, 24, 128, 8),
    (300, 257, 256, 128),
    (17, 300, 32, 256),
    (8, 8, 128, 128),
]


def _pair(rows, cols, seed=0):
    x = np.random.default_rng(seed).standard_normal((rows, cols)).astype(
        np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x.copy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_block_major_transforms_bitwise_equal_jax(shape):
    rows, cols, b0, b1 = shape
    x, xj, xt = _pair(rows, cols)
    for to_j, to_t, fr_j, fr_t in (
            (JL.to_block_major_a, L.to_block_major_a,
             JL.from_block_major_a, L.from_block_major_a),
            (JL.to_block_major_b, L.to_block_major_b,
             JL.from_block_major_b, L.from_block_major_b),
            (JL.to_block_major_c, L.to_block_major_c,
             JL.from_block_major_c, L.from_block_major_c)):
        bj, bt = np.asarray(to_j(xj, b0, b1)), to_t(xt, b0, b1).numpy()
        assert bj.shape == bt.shape
        np.testing.assert_array_equal(bt, bj)
        back = fr_t(torch.from_numpy(bt), rows, cols).numpy()
        np.testing.assert_array_equal(back, np.asarray(fr_j(jnp.asarray(bj),
                                                            rows, cols)))
        np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        L.pad_to_blocks(xt, b0, b1).numpy(),
        np.asarray(JL.pad_to_blocks(xj, b0, b1)))


def test_block_major_bf16_bits_preserved():
    """bf16 blocks keep their exact bit patterns (the transforms are moves)."""
    x = torch.randn(33, 70, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    back = L.from_block_major_b(L.to_block_major_b(x, 32, 64), 33, 70)
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))


@pytest.mark.parametrize("M,N,K", [(8, 576, 576), (8, 49152, 576),
                                   (512, 576, 1536), (512, 3072, 576),
                                   (1, 128, 64), (33, 65, 17),
                                   (4096, 4096, 8192)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("mode", ["dc", "dm"])
def test_hopper_chooser_fits_shared_memory(M, N, K, dtype, mode):
    """The Hopper chooser's blocks are kernel tiles (MMA-aligned, a 32-deep
    K slice), an A block of the tallest row tile plus a B block fit the
    shared-memory budget, and padding K costs less than one slice per
    block."""
    blk = L.choose_layout(M, N, K, dtype, mode=mode)
    assert blk.bm in L.BM_CHOICES and blk.bn in L.BN_CHOICES
    assert blk.bk % L.K_SLICE == 0
    assert blk.bm == L.bm_for(M) and blk.bm >= min(M, L.BM_CHOICES[-1])
    assert (L.BM_CHOICES[-1] + blk.bn) * blk.bk * dtype.itemsize \
        <= L.SMEM_BUDGET
    nbk = L.cdiv(K, blk.bk)
    assert nbk * blk.bk - K < L.K_SLICE * nbk
    if mode == "dc":
        assert blk.bk <= L.DC_MAX_BK
