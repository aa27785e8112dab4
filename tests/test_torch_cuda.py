"""Card tests of the port: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors (K1's tensor-core routes at every tile and
K split their chooser emits, within the fp32 dot-product bound, bitwise
repeatable; K3's and K4's bf16 tensor-core routes at every split count,
page size, head dim and GQA group they take, within ATTN_TOLS, bitwise
repeatable, through block tables whose dead entries are out of range; the
W8A8 GEMM, K2, bitwise on both tensor-core routes at every tile and split;
the int8 paged kernel, K5, within ATTN_TOLS on both tensor-core routes at
every head dim, page size, GQA group and split count, with p carried
unrounded into P·V; the SSD scan, K6, on its tensor-core routes (walk,
chunks) and the CUDA cores, the fp32 state within 1e-4 either way, a
row's bits independent of the batch), and the
serving engine (paged, int8, contiguous, and the SSM
families) and the BERT/ViT encoders on the card against the same code on
the CPU (where the wrappers run the plain versions).

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine
with the card and without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The GEMM shapes are tests/parity.py's SHAPES (copied: importing parity
would import JAX) plus two full-width smollm-135m projections; the
attention tolerances are its ATTN_TOLS. The flash attention shapes are the
full-width encoders' (bert-base S 128, vit-base S 197, vit-huge S 257 at
head_dim 80), smollm-135m's contiguous decode and prefill, and MLA's q/k
head dim 192 with v head dim 128 (``-k mla``). Training and mixed dtypes
(``-k "mixed or batch_grid or function_grads or on_card or bf16_cache"``):
K1's batch grid and its autograd Function at smollm-135m's training
shapes, K3's and K4's fp32-q over bf16-K/V instances (and bf16 q over
fp32 K/V), an fp32 model's engine over bf16 and int8 caches, and the
forward-only wrappers refusing a gradient. Tensor-parallel training and
the dry run (``-k "tp_k1 or meta_launch"``): K1's gradients on a rank's
column and row slices, and every wrapper's ``meta`` path counting the
launch a real call counts, kernel by kernel and route by route.
"""
import numpy as np
import pytest
import torch
from int8_flips import Recorder, check_tie_flip

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import api
from repro_torch.core import layout as L
from repro_torch.core import quant as Q
from repro_torch.core.plan import FUSED, AttentionPolicy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import matrixflow_gemm as MF
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ssd_scan as K6
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeConfig, ServingEngine

SHAPES = ((8, 8, 8), (64, 96, 48), (33, 17, 65), (1, 64, 128), (130, 24, 56),
          (8, 576, 49152), (512, 1536, 576))
ATTN_TOLS = {"float32": (3e-5, 3e-5), "bfloat16": (3e-2, 3e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out", [("float32", "float32"),
                                       ("bfloat16", "bfloat16"),
                                       ("bfloat16", "float32"),
                                       ("int8", "int32")])
def test_gemm_kernel_matches_plain(cuda, dtype, out):
    """int8: kernel and plain version equal (exact int32 accumulation).
    Floats: the kernel and the plain version each lie within the standard
    fp32 dot-product error bound of the float64 product,
    K·2⁻²⁴·(|A|·|B|) — each sums K products in fp32, in different orders —
    plus bf16's unit roundoff 2⁻⁸·|C| when the output is bf16. parity's TOLS
    were set for K <= 96 and are too tight for K = 1536 with unscaled
    N(0, 1) operands."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for M, K, N in SHAPES:
        if dtype == "int8":
            a = torch.randint(-127, 128, (M, K), generator=gen, device=cuda,
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (K, N), generator=gen, device=cuda,
                              dtype=torch.int8)
        else:
            a = torch.randn((M, K), generator=gen, device=cuda).to(
                getattr(torch, dtype))
            b = torch.randn((K, N), generator=gen, device=cuda).to(a.dtype)
        for mode in ("dc", "dm"):
            blk = L.choose_layout(M, N, K, a.dtype, mode=mode)
            a_bm = L.to_block_major_a(a, blk.bm, blk.bk)
            b_bm = L.to_block_major_b(b, blk.bk, blk.bn)
            odt = getattr(torch, out)
            before = MF.matrixflow_gemm_block_major.launches
            got = MF.matrixflow_gemm_block_major(a_bm, b_bm, out_dtype=odt)
            torch.cuda.synchronize()
            assert MF.matrixflow_gemm_block_major.launches == before + 1
            want = MF.plain(a_bm, b_bm, out_dtype=odt)
            if dtype == "int8":
                assert torch.equal(got, want), (M, K, N, mode)
                continue
            exact = torch.einsum("ikab,jkbc->ijac", a_bm.double(),
                                 b_bm.double())
            bound = K * 2.0 ** -24 * torch.einsum(
                "ikab,jkbc->ijac", a_bm.double().abs(), b_bm.double().abs())
            if odt == torch.bfloat16:      # round to nearest: u = 2⁻⁸
                bound += 2.0 ** -8 * (exact.abs() + bound)
            for name, c in (("kernel", got), ("plain", want)):
                err = (c.double() - exact).abs()
                assert bool((err <= bound + 1e-30).all()), \
                    (name, M, K, N, mode, float(err.max()))


# (M, K, N, bm, bn, bk, (gm, tn, splits) that kernels/matrixflow_gemm.py::
# tc_tile picks): every tile and route of the tensor-core instances of K1.
# bk 192, 352 and 704 are multiples of 32 and not of 64; nbk > 1 in all
# but the head; ragged groups at the grid's edge along N (N = 80, 300,
# 65) and M (nbm = 25 under 2-block groups).
TC_CASES = (
    (8, 576, 576, 16, 32, 192, (1, 32, 5)),        # smollm q/o decode
    (8, 2560, 5120, 16, 64, 256, (1, 64, 2)),      # zamba2 z/x decode
    (8, 576, 49152, 16, 128, 576, (1, 128, 1)),    # smollm head: no split
    (8, 2560, 32000, 16, 128, 512, (1, 128, 1)),   # zamba2 head
    (8, 2048, 64, 16, 32, 256, (1, 32, 8)),        # mamba2 dt: 8 splits
    (20, 1536, 576, 32, 32, 256, (1, 32, 8)),
    (32, 96, 200, 32, 64, 32, (1, 64, 1)),
    (17, 704, 1000, 32, 128, 352, (1, 128, 6)),
    (1024, 768, 768, 64, 32, 256, (1, 128, 1)),    # bert-base q/k/v/o
    (200, 704, 300, 64, 32, 352, (1, 64, 1)),
    (33, 17, 65, 64, 32, 32, (1, 64, 1)),
    (512, 576, 3072, 64, 64, 192, (1, 128, 1)),    # smollm mlp-in prefill
    (1600, 768, 2048, 64, 64, 256, (2, 128, 1)),
    (1024, 768, 30522, 64, 128, 384, (2, 256, 1)),  # bert-base head
)


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_gemm_tensor_core_routes_match_plain(cuda, case, out):
    """bf16 K1 on the tensor cores at each tile the chooser emits: within
    the fp32 dot-product bound of the float64 product (see
    test_gemm_kernel_matches_plain), counted on its route and not on the
    others, and two launches bitwise equal (every sum in a fixed order)."""
    M, K, N, bm, bn, bk, tile = case
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = torch.randn((M, K), generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn((K, N), generator=gen, device=cuda).to(torch.bfloat16)
    a_bm = L.to_block_major_a(a, bm, bk)
    b_bm = L.to_block_major_b(b, bk, bn)
    nbm, nbk, nbn = a_bm.shape[0], a_bm.shape[1], b_bm.shape[0]
    assert MF.tc_tile(bm, bn, nbm, nbn, nbk, bk) == tile
    route = MF.route_for(a.dtype, bm)
    assert route == ("wgmma" if bm == 64 else "mma")
    odt = getattr(torch, out)
    fn = MF.matrixflow_gemm_block_major
    before = {r: getattr(fn, f"{r}_launches")
              for r in ("wgmma", "mma", "cuda_core")}
    got = fn(a_bm, b_bm, out_dtype=odt)
    again = fn(a_bm, b_bm, out_dtype=odt)
    torch.cuda.synchronize()
    for r, n in before.items():
        assert getattr(fn, f"{r}_launches") == n + (2 if r == route else 0)
    assert got.dtype == odt and torch.equal(got, again)
    exact = torch.einsum("ikab,jkbc->ijac", a_bm.double(), b_bm.double())
    bound = K * 2.0 ** -24 * torch.einsum(
        "ikab,jkbc->ijac", a_bm.double().abs(), b_bm.double().abs())
    if odt == torch.bfloat16:
        bound += 2.0 ** -8 * (exact.abs() + bound)
    want = MF.plain(a_bm, b_bm, out_dtype=odt)
    for name, c in (("kernel", got), ("plain", want)):
        ratio = (c.double() - exact).abs() / (bound + 1e-30)
        assert float(ratio.max()) <= 1.0, (name, float(ratio.max()))


@pytest.mark.cuda
def test_gemm_tensor_core_route_rejects(cuda):
    """No fallback: a bf16 geometry the tensor-core kernels do not take
    raises, and never runs the CUDA-core routine."""
    a = torch.zeros((1, 1, 16, 48), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros((1, 1, 48, 32), dtype=torch.bfloat16, device=cuda)
    n = MF.matrixflow_gemm_block_major.cuda_core_launches
    with pytest.raises(ValueError, match="multiple of 32"):
        MF.matrixflow_gemm_block_major(a, b)
    assert MF.matrixflow_gemm_block_major.cuda_core_launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_dequant_gemm_kernel_matches_plain_bitwise(cuda, out):
    """K2 against its plain version on the card: bitwise, in fp32 and in
    bf16. The int32 sums are exact; the rounding of a sum past 2^24 to
    fp32 and the two scale products are the same operations in the same
    order on both sides. Includes the LM head (N = 49152, bn padding) and
    a large-sum case where every |acc| exceeds 2^24."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    odt = getattr(torch, out)
    for M, K, N in SHAPES + ((8, 1536, 160),):
        a = torch.randn((M, K), generator=gen, device=cuda)
        w = torch.randn((K, N), generator=gen, device=cuda)
        if K == 1536:
            a, w = 1 + 0.01 * a, 1 + 0.01 * w
        aq, sa = Q.quantize_activations(a)
        wq, sw = Q.quantize_weight(w)
        for mode in ("dc", "dm"):
            blk = L.choose_layout(M, N, K, torch.int8, mode=mode)
            a_bm = L.to_block_major_a(aq, blk.bm, blk.bk)
            b_bm = L.to_block_major_b(wq, blk.bk, blk.bn)
            before = MF.matrixflow_gemm_dequant.launches
            got = MF.matrixflow_gemm_dequant(a_bm, b_bm, sa, sw, out_dtype=odt)
            torch.cuda.synchronize()
            assert MF.matrixflow_gemm_dequant.launches == before + 1
            want = MF.plain(a_bm, b_bm, out_dtype=odt, scale_a=sa, scale_b=sw)
            assert got.dtype == odt and torch.equal(got, want), \
                (M, K, N, mode, float((got.float() - want.float()).abs().max()))


# (M, K, N, bm, bn, bk, (gm, tn, splits)): TC_CASES, whose tiles K2 shares
# with K1, and two whose every |int32 sum| exceeds 2^24 (K = 1536), on
# each route.
DQ_CASES = TC_CASES + ((8, 1536, 160, 16, 32, 256, (1, 32, 8)),
                       (128, 1536, 256, 64, 64, 256, (1, 64, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("scales", ["per_row_and_channel", "none"])
@pytest.mark.parametrize("case", DQ_CASES, ids=str)
def test_dequant_gemm_tensor_core_routes_bitwise(cuda, case, scales):
    """K2 at each tile and K split the chooser emits (wgmma at bm 64, mma
    at bm 16/32): bitwise equal to the plain version in fp32 and bf16, two
    launches bitwise equal, counted on its route only. M and N not
    multiples of the blocks leave padded rows and columns, which read a
    scale of 1 (``scale_a`` holds M rows, ``scale_b`` N channels); with no
    scales (n_sa = n_sb = 0) the flush is float(acc) itself."""
    M, K, N, bm, bn, bk, tile = case
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = torch.randn((M, K), generator=gen, device=cuda)
    w = torch.randn((K, N), generator=gen, device=cuda)
    if K == 1536:
        a, w = 1 + 0.01 * a, 1 + 0.01 * w
    aq, sa = Q.quantize_activations(a)
    wq, sw = Q.quantize_weight(w)
    if K == 1536:
        acc = aq.double() @ wq.double()            # exact: |acc| < 2^53
        assert float(acc.abs().min()) > 2 ** 24
    if scales == "none":
        sa = sw = None
    a_bm = L.to_block_major_a(aq, bm, bk)
    b_bm = L.to_block_major_b(wq, bk, bn)
    nbm, nbk, nbn = a_bm.shape[0], a_bm.shape[1], b_bm.shape[0]
    assert MF.tc_tile(bm, bn, nbm, nbn, nbk, bk) == tile
    route = MF.route_for(torch.int8, bm, dequant=True)
    assert route == ("wgmma" if bm == 64 else "mma")
    fn = MF.matrixflow_gemm_dequant
    for odt in (torch.float32, torch.bfloat16):
        before = {r: getattr(fn, f"{r}_launches") for r in ("wgmma", "mma")}
        got = fn(a_bm, b_bm, sa, sw, out_dtype=odt)
        again = fn(a_bm, b_bm, sa, sw, out_dtype=odt)
        torch.cuda.synchronize()
        for r, n in before.items():
            assert getattr(fn, f"{r}_launches") == n + 2 * (r == route)
        want = MF.plain(a_bm, b_bm, out_dtype=odt, scale_a=sa, scale_b=sw)
        assert got.dtype == odt and torch.equal(got, again)
        assert torch.equal(got, want), \
            float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
def test_dequant_gemm_rejects(cuda):
    """No fallback: an int8 geometry neither tensor-core route takes
    raises before anything launches."""
    fn = MF.matrixflow_gemm_dequant
    before = (fn.launches, fn.wgmma_launches, fn.mma_launches)
    a = torch.zeros((1, 1, 16, 48), dtype=torch.int8, device=cuda)
    b = torch.zeros((1, 1, 48, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        fn(a, b, None, None)
    a = torch.zeros((1, 1, 48, 32), dtype=torch.int8, device=cuda)
    b = torch.zeros((1, 1, 32, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="bm in"):
        fn(a, b, None, None)
    assert (fn.launches, fn.wgmma_launches, fn.mma_launches) == before


def _paged_inputs(cuda, dtype, B, Sq, H, Hkv, D, ps, lens, starts, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    nb = -(-max(lens) // ps) + 1
    P = B * nb + 3
    dt = getattr(torch, dtype)
    kp = (torch.randn((P, ps, Hkv, D), generator=gen, device=cuda) * 3).to(dt)
    vp = (torch.randn((P, ps, Hkv, D), generator=gen, device=cuda) * 3).to(dt)
    bt = torch.randperm(P, generator=gen, device=cuda)[:B * nb].reshape(
        B, nb).to(torch.int32)
    q = torch.randn((B, Sq, H, D), generator=gen, device=cuda).to(dt)
    qpos = np.full((B, Sq), -1, np.int32)
    for b in range(B):
        if starts[b] >= 0:
            n = min(Sq, lens[b] - starts[b])
            qpos[b, :n] = starts[b] + np.arange(n)
    return (q, kp, vp, bt, torch.from_numpy(qpos).to(cuda),
            torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    # B, Sq, H, Hkv, D, ps, lens, first query position per row (-1: masked)
    (8, 1, 9, 3, 64, 16, (17, 200, 64, 1, 33, 128, 255, 90),
     (16, 199, 63, 0, 32, 127, 254, 89)),
    (8, 64, 9, 3, 64, 16, (64, 16, 40, 1, 63, 0, 20, 64),
     (0, 0, 0, 0, 0, -1, 0, 0)),
    (3, 1, 4, 2, 16, 8, (6, 81, 0), (5, 80, -1)),
    (2, 8, 4, 4, 16, 8, (32, 48), (24, 40)),
    (2, 5, 4, 1, 128, 32, (70, 5), (65, 0)),
    (8, 1, 48, 1, 128, 16, (17, 200, 64, 1, 33, 128, 255, 90),
     (16, 199, 63, 0, 32, 127, 254, 89)),
    (2, 20, 48, 1, 128, 16, (20, 50), (0, 30)),
    (4, 1, 24, 1, 64, 16, (9, 100, 1, 64), (8, 99, -1, 63)),
], ids=["decode_full_width", "prefill_bucket_full_width", "decode_gqa2",
        "chunk_offset", "mqa_d128_page32", "granite_decode_rep48",
        "granite_prefill_rep48", "decode_rep24"])
def test_paged_attention_kernel_matches_plain(cuda, dtype, case):
    """K4 against its plain version: bf16 pools on the tensor-core route
    the chooser names (two launches bitwise equal), fp32 pools on the CUDA
    cores."""
    B, Sq, H, Hkv, D, ps, lens, starts = case
    q, kp, vp, bt, qpos, kvl = _paged_inputs(cuda, dtype, B, Sq, H, Hkv, D,
                                             ps, lens, starts)
    route = PA.route_for(q.dtype, Sq, H // Hkv)
    before = PA.paged_attention.launches
    by_route = dict(PA.paged_attention.launches_by_route)
    got = PA.paged_attention(q, kp, vp, bt, qpos, kvl)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    assert PA.paged_attention.launches_by_route == {
        r: n + (r == route) for r, n in by_route.items()}
    if route != "cuda_cores":
        assert torch.equal(got, PA.paged_attention(q, kp, vp, bt, qpos, kvl))
    want = PA.paged_attention_plain(q, kp, vp, bt, qpos, kvl, causal=True,
                                    scale=D ** -0.5, soft_cap=None)
    atol, rtol = ATTN_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    masked = qpos < 0
    assert not bool(masked.any()) or float(got[masked].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    (8, 1, 9, 3, 64, 16, (17, 200, 64, 1, 33, 128, 255, 90),
     (16, 199, 63, 0, 32, 127, 254, 89)),
    (8, 64, 9, 3, 64, 16, (64, 16, 40, 1, 63, 0, 20, 64),
     (0, 0, 0, 0, 0, -1, 0, 0)),
    (3, 1, 4, 2, 16, 8, (6, 81, 0), (5, 80, -1)),
    (2, 8, 4, 4, 16, 8, (32, 48), (24, 40)),
    (8, 1, 48, 1, 128, 16, (17, 200, 64, 1, 33, 128, 255, 90),
     (16, 199, 63, 0, 32, 127, 254, 89)),
    (2, 20, 48, 1, 128, 16, (20, 50), (0, 30)),
    (3, 1, 64, 1, 16, 32, (40, 3, 90), (39, -1, 89)),
], ids=["decode_full_width", "prefill_bucket_full_width", "decode_gqa2",
        "chunk_offset", "granite_decode_rep48", "granite_prefill_rep48",
        "decode_rep64"])
def test_paged_attention_int8_kernel_matches_plain(cuda, dtype, case):
    """K5: int8 pools with per-(page, kv head) scales, q in fp32 or bf16,
    against the plain version within ATTN_TOLS, on the route its chooser
    names (bf16 q on the tensor cores, fp32 q on the CUDA cores); masked
    rows exactly 0."""
    B, Sq, H, Hkv, D, ps, lens, starts = case
    q, kp, vp, bt, qpos, kvl = _paged_inputs(cuda, "float32", B, Sq, H, Hkv,
                                             D, ps, lens, starts, seed=2)
    (qk, ks), (qv, vs) = Q.quantize_kv_pages(kp), Q.quantize_kv_pages(vp)
    q = q.to(getattr(torch, dtype))
    route = PA.route_for(q.dtype, Sq, H // Hkv)
    assert (route == "cuda_cores") == (dtype == "float32")
    before = (PA.paged_attention.launches, PA.paged_attention.launches_int8)
    by_route = dict(PA.paged_attention.launches_int8_by_route)
    got = PA.paged_attention(q, qk, qv, bt, qpos, kvl, kv_scales=(ks, vs))
    torch.cuda.synchronize()
    assert (PA.paged_attention.launches,
            PA.paged_attention.launches_int8) == (before[0], before[1] + 1)
    assert PA.paged_attention.launches_int8_by_route == {
        r: n + (r == route) for r, n in by_route.items()}
    want = PA.paged_attention_plain(q, qk, qv, bt, qpos, kvl, causal=True,
                                    scale=D ** -0.5, soft_cap=None,
                                    kv_scales=(ks, vs))
    atol, rtol = ATTN_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    masked = qpos < 0
    assert not bool(masked.any()) or float(got[masked].abs().max()) == 0.0


@pytest.mark.cuda
def test_paged_attention_soft_cap_noncausal_defaults(cuda):
    q, kp, vp, bt, qpos, kvl = _paged_inputs(cuda, "float32", 2, 17, 2, 1,
                                             16, 16, (45, 29), (0, 0))
    nb = bt.shape[1]
    got = PA.paged_attention(q, kp, vp, bt, causal=False, soft_cap=5.0)
    want = PA.paged_attention_plain(
        q, kp, vp, bt, torch.arange(17, device=cuda).expand(2, 17).to(
            torch.int32), torch.full((2,), nb * 16, dtype=torch.int32,
                                     device=cuda),
        causal=False, scale=0.25, soft_cap=5.0)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_plain(cuda):
    """Submit/step with more requests than slots and a pool that preempts:
    fp32 greedy streams on the card (CUDA kernels) equal the CPU's (plain
    versions), and both kernels were launched."""
    cfg = get_smoke_config("smollm-135m", n_layers=2, vocab=64,
                           dtype="float32")
    params = T.init_model(cfg, seed=0, device="cpu")
    streams = []
    for device in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=2, max_len=16, cache_dtype="float32",
            pack_weights=True, cache_pages=2, device=device,
            attention=AttentionPolicy(backend="paged", page_size=8)))
        launches = (MF.matrixflow_gemm_block_major.launches,
                    PA.paged_attention.launches)
        pending, rids = [[1, 2, 3], [4, 5, 6], [7, 8]], []
        for _ in range(100):
            while pending and (rid := eng.submit(pending[0])) is not None:
                rids.append(rid)
                pending.pop(0)
            eng.step()
            if not pending and not eng.slot_live.any() and not eng.wait:
                break
        assert eng.n_preemptions > 0
        streams.append([eng.request_out[r] for r in rids])
        if device == "cuda":
            assert MF.matrixflow_gemm_block_major.launches > launches[0]
            assert PA.paged_attention.launches > launches[1]
    assert streams[0] == streams[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(kv_dtype="int8", weight_dtype="int8")],
                         ids=["int8_kv", "w8a8"])
def test_int8_engine_on_card_matches_cpu_plain(cuda, kw):
    """The int8 engine: submit/step with preemption under an int8 pool;
    fp32 greedy streams on the card (K5, and K2 under W8A8) against the
    CPU's, and the int8 kernels were launched. int8 KV alone: streams
    equal. W8A8: equal, or parting only where a value the card and the CPU
    computed an ulp apart crossed a .5 tie of the int8 grid
    (tests/int8_flips.py shows it from both runs' quantizations)."""
    cfg = get_smoke_config("smollm-135m", n_layers=2, vocab=64, d_head=64,
                           dtype="float32")
    params = T.init_model(cfg, seed=0, device="cpu")
    streams, records = [], []
    for device in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=2, max_len=16, cache_dtype="float32",
            cache_pages=2, device=device,
            attention=AttentionPolicy(backend="paged", page_size=8), **kw))
        before = (MF.matrixflow_gemm_dequant.launches,
                  PA.paged_attention.launches_int8)
        pending, rids = [[1, 2, 3], [4, 5, 6], [7, 8]], []
        with Recorder() as rec:
            for _ in range(100):
                while pending and (rid := eng.submit(pending[0])) is not None:
                    rids.append(rid)
                    pending.pop(0)
                eng.step()
                if not pending and not eng.slot_live.any() and not eng.wait:
                    break
        records.append(rec.calls)
        assert eng.n_preemptions > 0
        streams.append([eng.request_out[r] for r in rids])
        if device == "cuda":
            assert PA.paged_attention.launches_int8 > before[1]
            assert (MF.matrixflow_gemm_dequant.launches > before[0]) == \
                ("weight_dtype" in kw)
    if streams[0] != streams[1]:
        assert "weight_dtype" in kw, streams
        print("W8A8 card vs CPU:", check_tie_flip(*records))


_FEATURES = {
    "prefix_cow": ("paged", dict(prefix_cache=True)),
    "prefix_cow_int8_kv": ("paged", dict(prefix_cache=True,
                                         kv_dtype="int8")),
    "spec_paged": ("paged", dict(spec=4)),
    "spec_k8_paged": ("paged", dict(spec=8)),
    "spec_fused": ("fused", dict(spec=4)),
    "spec_int8_kv": ("paged", dict(spec=4, kv_dtype="int8")),
    "spec_prefix_obs": ("paged", dict(spec=4, prefix_cache=True, obs=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_FEATURES), ids=str)
def test_serving_features_on_card_match_cpu_plain(cuda, case):
    """The prefix cache (COW forks over shared 8-token pages), speculative
    decoding at k = 4 and 8 (verify at Sq 5 and 9) on paged and contiguous
    caches and int8 KV pages, and observability: fp32 greedy streams on
    the card equal the CPU's and the card's own with the feature off;
    pools end clean."""
    from repro_torch.obs import Observability
    from repro_torch.serving.spec_decode import NGramDrafter
    attn, kw = _FEATURES[case]
    cfg = get_smoke_config("smollm-135m", n_layers=2, vocab=64, d_head=64,
                           dtype="float32")
    params = T.init_model(cfg, seed=0, device="cpu")
    shared = [5, 9, 2, 7, 5, 9, 2, 7, 1, 3]
    prompts = [shared + [11 + i, 5, 9, 2] for i in range(3)] + \
        [shared[:6] + [40, 41], [1, 2, 3, 1, 2, 3, 1]]
    policy = FUSED if attn == "fused" else AttentionPolicy("paged", 8)

    def run(device, on):
        fkw = dict(kw) if on else {"kv_dtype": kw["kv_dtype"]} \
            if "kv_dtype" in kw else {}
        if "spec" in fkw:
            fkw["spec"] = NGramDrafter(k=fkw["spec"])
        if fkw.pop("obs", False):
            fkw["obs"] = Observability()
        eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=3, max_len=40, cache_dtype="float32",
            attention=policy, device=device, **fkw))
        pending, owner, streams = list(enumerate(prompts)), {}, {}
        for _ in range(400):
            while pending and (h := eng.submit(pending[0][1])) is not None:
                owner[h] = pending.pop(0)[0]
                streams[owner[h]] = []
            for h, t in eng.step().items():
                streams[owner[h]] += t if isinstance(t, list) else [t]
            if not pending and not eng.slot_live.any() and not eng.wait:
                break
        if eng.paged:
            if eng.prefix is not None:
                assert eng.prefix.stats()["prefix_hits"] > 0
                eng.prefix.clear()
            eng.pool.check()
            assert eng.pool.free_pages == eng.pool.n_pages
        if eng.spec is not None:
            assert eng.spec_accepted > 0
        return [streams[i] for i in range(len(prompts))]

    got = run("cuda", True)
    assert got == run("cpu", True)
    assert got == run("cuda", False)


# B, Sq, Sk, H, Hkv, D, causal, first query position per row (None: the
# bottom-right default; -1: masked row), valid keys per row (None: Sk)
FLASH_CASES = {
    "bert_base": (8, 128, 128, 12, 12, 64, False, None, None),
    "vit_base": (8, 197, 197, 12, 12, 64, False, None, None),
    "vit_huge_d80": (8, 257, 257, 16, 16, 80, False, None, None),
    "decode_rep3_ragged_masked": (8, 1, 256, 9, 3, 64, True,
                                  (16, 199, 63, -1, 32, 127, 255, 89),
                                  (17, 200, 64, 0, 33, 128, 256, 90)),
    "prefill_bucket_masked_rows": (4, 64, 256, 9, 3, 64, True,
                                   (0, -1, 0, 0), (40, 0, 64, 1)),
    "chunk_offset": (2, 8, 64, 9, 3, 64, True, (24, 40), (32, 48)),
    "bottom_right_default": (2, 5, 40, 12, 12, 80, True, None, None),
    "noncausal_ragged": (2, 17, 45, 16, 16, 80, False, None, (45, 29)),
    # head_dim 128 and the GQA groups of qwen2 (6), qwen3 (4), granite (48)
    "qwen2_decode_d128_rep6": (8, 1, 256, 12, 2, 128, True,
                               (16, 199, 63, -1, 32, 127, 255, 89),
                               (17, 200, 64, 0, 33, 128, 256, 90)),
    "qwen3_prefill_d128_rep4": (4, 64, 256, 32, 8, 128, True,
                                (0, -1, 0, 0), (40, 0, 64, 1)),
    "granite_decode_d128_rep48": (8, 1, 256, 48, 1, 128, True,
                                  (16, 199, 63, -1, 32, 127, 255, 89),
                                  (17, 200, 64, 0, 33, 128, 256, 90)),
    "granite_chunk_d128_rep48": (2, 20, 64, 48, 1, 128, True, (0, 30),
                                 (20, 50)),
    "noncausal_d128": (2, 17, 45, 8, 8, 128, False, None, (45, 29)),
}


def _flash_inputs(cuda, dtype, B, Sq, Sk, H, Hkv, D, starts, lens, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dt)
               for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    qpos = kvl = None
    if starts is not None:
        pos = np.full((B, Sq), -1, np.int32)
        for b in range(B):
            if starts[b] >= 0:
                pos[b] = starts[b] + np.arange(Sq)
                if lens is not None:         # bucket padding past the keys
                    pos[b, max(lens[b] - starts[b], 0):] = -1
        qpos = torch.from_numpy(pos).to(cuda)
    if lens is not None:
        kvl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, k, v, qpos, kvl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES), ids=str)
def test_flash_attention_kernel_matches_plain(cuda, dtype, case):
    """K3 against its plain version: bf16 on the tensor-core route the
    chooser names (two launches bitwise equal), fp32 on the CUDA cores."""
    B, Sq, Sk, H, Hkv, D, causal, starts, lens = FLASH_CASES[case]
    q, k, v, qpos, kvl = _flash_inputs(cuda, dtype, B, Sq, Sk, H, Hkv, D,
                                       starts, lens)
    route = FA.route_for(q.dtype, Sq, H // Hkv)
    before = FA.flash_attention.launches
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, qpos, kvl, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert FA.flash_attention.launches_by_route == {
        r: n + (r == route) for r, n in by_route.items()}
    if route != "cuda_cores":
        assert torch.equal(got, FA.flash_attention(q, k, v, qpos, kvl,
                                                   causal=causal))
    qpos_r = qpos if qpos is not None else (
        torch.arange(Sq, device=cuda) + (Sk - Sq)).expand(B, Sq).to(torch.int32)
    kvl_r = kvl if kvl is not None else torch.full(
        (B,), Sk, dtype=torch.int32, device=cuda)
    want = FA.flash_attention_plain(q, k, v, qpos_r, kvl_r, causal=causal,
                                    scale=D ** -0.5, soft_cap=None)
    atol, rtol = ATTN_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if causal:
        masked = qpos_r < 0
        assert not bool(masked.any()) or float(got[masked].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES), ids=str)
def test_flash_attention_lse_matches_plain(cuda, dtype, case, splits,
                                           monkeypatch):
    """K3 with ``return_lse=True`` on every route (the split route also
    over clusters of 3 and 8 CTAs): out and lse within ATTN_TOLS of the
    plain version, lse -inf exactly where a row sees no key, and the
    output bitwise the launch without lse."""
    B, Sq, Sk, H, Hkv, D, causal, starts, lens = FLASH_CASES[case]
    route = FA.route_for(getattr(torch, dtype), Sq, H // Hkv)
    if splits is not None:
        if route != "split":
            pytest.skip("a split count applies to the split route")
        monkeypatch.setattr(FA, "split_count", lambda *a: splits)
    q, k, v, qpos, kvl = _flash_inputs(cuda, dtype, B, Sq, Sk, H, Hkv, D,
                                       starts, lens)
    before = FA.flash_attention.lse_launches
    got, lse = FA.flash_attention(q, k, v, qpos, kvl, causal=causal,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert FA.flash_attention.lse_launches == before + 1
    assert torch.equal(got, FA.flash_attention(q, k, v, qpos, kvl,
                                               causal=causal))
    qpos_r = qpos if qpos is not None else (
        torch.arange(Sq, device=cuda) + (Sk - Sq)).expand(B, Sq).to(torch.int32)
    kvl_r = kvl if kvl is not None else torch.full(
        (B,), Sk, dtype=torch.int32, device=cuda)
    want, want_lse = FA.flash_attention_plain(
        q, k, v, qpos_r, kvl_r, causal=causal, scale=D ** -0.5,
        soft_cap=None, return_lse=True)
    atol, rtol = ATTN_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    dead = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    torch.testing.assert_close(lse[~dead], want_lse[~dead], atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_flash_attention_soft_cap_and_strided_cache(cuda):
    """A soft-cap, and K/V read as views of a (B, T + 1, Hkv, D) contiguous
    serving cache sliced to T (no copy): the same as contiguous operands."""
    q, k, v, qpos, kvl = _flash_inputs(cuda, "float32", 3, 1, 96, 9, 3, 64,
                                       (40, 95, 7), (41, 96, 8))
    kc = torch.zeros((3, 97, 3, 64), device=cuda)
    vc = torch.zeros_like(kc)
    kc[:, :96], vc[:, :96] = k, v
    got = FA.flash_attention(q * 8, kc[:, :96], vc[:, :96], qpos, kvl,
                             soft_cap=5.0)
    want = FA.flash_attention_plain(q * 8, k, v, qpos, kvl, causal=True,
                                    scale=0.125, soft_cap=5.0)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q[..., :32], k[..., :32], v[..., :32])


def _check_tc(got, want, again, qpos, causal=True):
    """A bf16 tensor-core result: within ATTN_TOLS of the plain version,
    bitwise equal to a second launch, rows at position -1 exactly 0."""
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOLS["bfloat16"][0],
                               rtol=ATTN_TOLS["bfloat16"][1])
    assert torch.equal(got, again)
    masked = qpos < 0
    if causal and bool(masked.any()):
        assert float(got[masked].abs().max()) == 0.0


# kernel, B, Sq, Sk (flash) or table entries x page (paged), H, Hkv, D, ps,
# valid keys per row (0: an all-masked slot), first query position per row
_SPLIT_FORCED = {
    "flash_decode": ("flash", 4, 1, 256, 9, 3, 64, 0, (0, 1, 128, 255),
                     (-1, 0, 127, 254)),
    "flash_chunk_d80": ("flash", 2, 4, 96, 4, 1, 80, 0, (96, 7), (92, 3)),
    "paged_decode": ("paged", 4, 1, 256, 9, 3, 64, 16, (0, 1, 128, 255),
                     (-1, 0, 127, 254)),
    "paged_chunk_ps8": ("paged", 2, 8, 96, 4, 2, 16, 8, (96, 41), (88, 33)),
    # granite-20b's MQA decode: 48 rows of one kv head, three m16 tiles,
    # each tile's keys split over the cluster
    "paged_decode_rep48_d128": ("paged", 4, 1, 512, 48, 1, 128, 16,
                                (0, 1, 128, 511), (-1, 0, 127, 510)),
    "flash_decode_rep48_d128": ("flash", 4, 1, 512, 48, 1, 128, 0,
                                (0, 1, 128, 511), (-1, 0, 127, 510)),
    "paged_decode_rep24": ("paged", 3, 1, 256, 24, 1, 64, 16,
                           (256, 17, 0), (255, 16, -1)),
}


def _tc_case(cuda, kind, B, Sq, Sk, H, Hkv, D, ps, lens, starts, seed=0,
             soft_cap=None, causal=True):
    """(wrapper call, plain call, q_positions) of one bf16 case; the paged
    tables are shuffled, with entries past each row's valid keys out of the
    pool's range (the kernel must not read them; the plain version, which
    gathers every entry, reads a valid copy)."""
    if kind == "flash":
        pos = np.full((B, Sq), -1, np.int32)
        for b in range(B):
            if starts[b] >= 0:
                n = min(Sq, lens[b] - starts[b])
                pos[b, :n] = starts[b] + np.arange(n)
        pos = torch.from_numpy(pos).to(cuda)
        q, k, v, _, _ = _flash_inputs(cuda, "bfloat16", B, Sq, Sk, H, Hkv, D,
                                      None, None, seed=seed)
        kvl = torch.tensor(lens, dtype=torch.int32, device=cuda)
        kw = dict(causal=causal, soft_cap=soft_cap)
        return (lambda: FA.flash_attention(q, k, v, pos, kvl, **kw),
                lambda: FA.flash_attention_plain(q, k, v, pos, kvl,
                                                 scale=D ** -0.5, **kw), pos)
    q, kp, vp, bt, pos, kvl = _paged_inputs(cuda, "bfloat16", B, Sq, H, Hkv,
                                            D, ps, lens, starts, seed=seed)
    nb = Sk // ps
    bt = torch.cat([bt, bt[:, :1].expand(B, nb - bt.shape[1])], 1) \
        if bt.shape[1] < nb else bt[:, :nb]
    dead = torch.arange(nb, device=cuda)[None] >= -(-kvl[:, None] // ps)
    poisoned = torch.where(dead, torch.full_like(bt, 1 << 30), bt)
    kw = dict(causal=causal, soft_cap=soft_cap)
    return (lambda: PA.paged_attention(q, kp, vp, poisoned, pos, kvl, **kw),
            lambda: PA.paged_attention_plain(q, kp, vp, bt, pos, kvl,
                                             scale=D ** -0.5, **kw), pos)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(_SPLIT_FORCED), ids=str)
def test_split_route_at_forced_split_counts(cuda, monkeypatch, case, splits):
    """The split route at 1, 2, 4 and 8 CTAs a cluster (forced through the
    chooser): every count gives the plain version's result within
    ATTN_TOLS, the same bits on a second launch, and exactly 0 for the
    all-masked slot; the slots at 1, 128 (a page boundary) and 255 keys
    leave some CTAs of the cluster empty."""
    kind, *shape = _SPLIT_FORCED[case]
    mod = FA if kind == "flash" else PA
    monkeypatch.setattr(mod, "split_count", lambda *a: splits)
    kernel, plain, pos = _tc_case(cuda, kind, *shape)
    fn = FA.flash_attention if kind == "flash" else PA.paged_attention
    before = fn.launches_by_route["split"]
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    assert fn.launches_by_route["split"] == before + 2
    _check_tc(got, plain(), again, pos)


# kernel, B, Sq, Sk, H, Hkv, D, ps, lens, starts: page sizes 8/16/32, head
# dims 16/64/80/128 where the route takes them, GQA groups 1/3/4/16, both
# routes, each with an all-masked slot.
_TC_GEOMETRIES = {
    "paged_ps8_d16_rep1_decode": ("paged", 3, 1, 64, 2, 2, 16, 8,
                                  (0, 17, 64), (-1, 16, 63)),
    "paged_ps32_d128_rep4_split": ("paged", 3, 4, 128, 8, 2, 128, 32,
                                   (70, 0, 128), (66, -1, 124)),
    "paged_ps16_d80_rep16_decode": ("paged", 3, 1, 96, 16, 1, 80, 16,
                                    (96, 0, 33), (95, -1, 32)),
    "paged_ps32_d128_rep1_rows": ("paged", 2, 40, 96, 2, 2, 128, 32,
                                  (96, 0), (56, -1)),
    "paged_ps8_d16_rep16_rows": ("paged", 2, 3, 48, 16, 1, 16, 8,
                                 (48, 0), (45, -1)),
    "paged_ps16_d64_rep3_rows": ("paged", 3, 64, 128, 9, 3, 64, 16,
                                 (64, 0, 100), (0, -1, 36)),
    "flash_d64_rep4_split": ("flash", 3, 4, 80, 8, 2, 64, 0,
                             (80, 0, 9), (76, -1, 5)),
    "flash_d80_rep16_decode": ("flash", 3, 1, 300, 16, 1, 80, 0,
                               (300, 0, 1), (299, -1, 0)),
    "flash_d80_rep3_rows": ("flash", 2, 70, 200, 6, 2, 80, 0,
                            (200, 0), (130, -1)),
    "flash_d64_rep16_rows": ("flash", 2, 9, 64, 16, 1, 64, 0, (64, 0),
                             (55, -1)),
    # speculative verify at smollm-135m's heads (9 / 3 x 64, page 16): Sq
    # = 1 + k, each row trimmed to its own draft count (rows past it at
    # position -1; one slot masked whole): k = 4 splits (15 rows a CTA),
    # k = 8 takes the rows route (27)
    "paged_verify_k4_split": ("paged", 4, 5, 256, 9, 3, 64, 16,
                              (101, 35, 0, 200), (96, 32, -1, 199)),
    "paged_verify_k8_rows": ("paged", 4, 9, 256, 9, 3, 64, 16,
                             (105, 37, 0, 250), (96, 32, -1, 249)),
    "flash_verify_k4_split": ("flash", 4, 5, 256, 9, 3, 64, 0,
                              (101, 35, 0, 200), (96, 32, -1, 199)),
    # a prefix-hit tail prefill: 11 rows of a 16-column bucket starting
    # mid-page (position 43 of page 2), one slot masked
    "paged_tail_prefill_midpage_rows": ("paged", 2, 16, 128, 9, 3, 64, 16,
                                        (54, 0), (43, -1)),
    # head_dim 128 (qwen2, qwen3, granite) and GQA groups 24, 48 and 64 on
    # both routes; a decode row of a group above 16 spans several tiles
    "flash_d128_rep6_split": ("flash", 3, 1, 200, 12, 2, 128, 0,
                              (200, 0, 77), (199, -1, 76)),
    "flash_d128_rep4_rows": ("flash", 2, 64, 256, 32, 8, 128, 0,
                             (256, 0), (192, -1)),
    "flash_d128_rep48_rows": ("flash", 2, 7, 96, 48, 1, 128, 0,
                              (96, 0), (89, -1)),
    "flash_d64_rep64_split": ("flash", 3, 1, 128, 64, 1, 64, 0,
                              (128, 0, 5), (127, -1, 4)),
    "paged_ps16_d128_rep48_split": ("paged", 3, 1, 128, 48, 1, 128, 16,
                                    (128, 0, 33), (127, -1, 32)),
    "paged_ps16_d128_rep48_rows": ("paged", 2, 9, 128, 48, 1, 128, 16,
                                   (128, 0), (119, -1)),
    "paged_ps8_d64_rep24_rows": ("paged", 2, 40, 64, 24, 1, 64, 8,
                                 (64, 0), (24, -1)),
    "paged_ps32_d16_rep64_split": ("paged", 3, 1, 96, 64, 1, 16, 32,
                                   (96, 0, 40), (95, -1, 39)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_TC_GEOMETRIES), ids=str)
def test_tensor_core_routes_at_each_geometry(cuda, case):
    kind, B, Sq, Sk, H, Hkv, D, ps, lens, starts = _TC_GEOMETRIES[case]
    fn = FA.flash_attention if kind == "flash" else PA.paged_attention
    route = FA.route_for(torch.bfloat16, Sq, H // Hkv)
    assert route == ("split" if Sq == 1 or Sq * H // Hkv <= 16 else "rows")
    kernel, plain, pos = _tc_case(cuda, kind, B, Sq, Sk, H, Hkv, D, ps,
                                  lens, starts, seed=1)
    before = dict(fn.launches_by_route)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    assert fn.launches_by_route == {r: n + 2 * (r == route)
                                    for r, n in before.items()}
    _check_tc(got, plain(), again, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,Sq", [("flash", 1), ("flash", 40),
                                     ("paged", 1), ("paged", 40)])
def test_tensor_core_routes_soft_cap_and_noncausal(cuda, kind, Sq):
    """A soft cap of 2 (the logits reach past it), causal and not, on both
    routes."""
    for causal in (True, False):
        kernel, plain, pos = _tc_case(
            cuda, kind, 3, Sq, 96, 6, 2, 64, 16, (96, 50, 0), (56, 10, -1),
            seed=2, soft_cap=2.0, causal=causal)
        got = kernel()
        _check_tc(got, plain(), kernel(), pos, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [5, 40])
def test_tensor_core_routes_default_positions_and_lengths(cuda, Sq):
    """No q_positions and no kv_valid_len: the tensor-core kernels compute
    the wrappers' defaults on the card (K3 bottom-right aligned, K4
    arange; every key in memory), and a kv_valid_len past the keys in
    memory is clamped by the kernel as the plain version's caller clamps
    it."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    bf = torch.bfloat16
    B, H, Hkv, D, ps, nb = 2, 6, 2, 64, 16, 6
    Sk = nb * ps
    q = torch.randn((B, Sq, H, D), generator=gen, device=cuda).to(bf)
    k, v = (torch.randn((B, Sk, Hkv, D), generator=gen, device=cuda).to(bf)
            for _ in range(2))
    full = torch.full((B,), Sk, dtype=torch.int32, device=cuda)
    huge = torch.full((B,), 10_000, dtype=torch.int32, device=cuda)
    pos = (torch.arange(Sq, device=cuda) + Sk - Sq).expand(B, Sq).to(
        torch.int32)
    want = FA.flash_attention_plain(q, k, v, pos, full, causal=True,
                                    scale=D ** -0.5, soft_cap=None)
    got = FA.flash_attention(q, k, v)
    _check_tc(got, want, FA.flash_attention(q, k, v, pos, huge), pos)
    kp, vp = (x.reshape(B * nb, ps, Hkv, D) for x in (k, v))
    bt = torch.arange(B * nb, dtype=torch.int32, device=cuda).reshape(B, nb)
    pos = torch.arange(Sq, device=cuda).expand(B, Sq).to(torch.int32)
    want = PA.paged_attention_plain(q, kp, vp, bt, pos, full, causal=True,
                                    scale=D ** -0.5, soft_cap=None)
    got = PA.paged_attention(q, kp, vp, bt)
    _check_tc(got, want, PA.paged_attention(q, kp, vp, bt, pos, huge), pos)


# MLA (deepseek-v2): q/k head dim 192 (128 nope + 64 rope), v head dim 128,
# one kv head a query head; v a strided view of the (..., 256) K/V
# up-projection, as mla_attention passes it. B, Sq, Sk, H, valid keys per
# row, first query position per row (-1: a masked row)
_MLA_CASES = {
    "decode": (8, 1, 256, 16, (0, 1, 64, 255, 17, 128, 200, 33),
               (-1, 0, 63, 254, 16, 127, 199, 32)),
    "prefill_bucket": (2, 64, 256, 4, (40, 0), (0, -1)),
    "decode_1024": (2, 1, 1024, 8, (1024, 600), (1023, 599)),
    "chunk_rows": (2, 20, 96, 2, (96, 50), (76, 30)),
}


def _mla_inputs(cuda, dtype, B, Sq, Sk, H, lens, starts, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, 192), generator=gen, device=cuda).to(dt)
    k = torch.randn((B, Sk, H, 192), generator=gen, device=cuda).to(dt)
    kv = torch.randn((B, Sk, H, 256), generator=gen, device=cuda).to(dt)
    pos = np.full((B, Sq), -1, np.int32)
    for b in range(B):
        if starts[b] >= 0:
            n = min(Sq, lens[b] - starts[b])
            pos[b, :n] = starts[b] + np.arange(n)
    pos = torch.from_numpy(pos).to(cuda)
    kvl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, k, kv[..., 128:], pos, kvl


def _mla_plain(q, k, v, pos, kvl):
    return FA.flash_attention_plain(q, k, v, pos, kvl, causal=True,
                                    scale=192 ** -0.5, soft_cap=None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_MLA_CASES), ids=str)
def test_mla_head_dims_match_plain(cuda, dtype, case):
    """K3 at (D 192, Dv 128) against its plain version on the route its
    chooser names (bf16: split at decode, rows at prefill, two launches
    bitwise equal; fp32: the CUDA cores), v read through its strides (no
    copy), the output (B, Sq, H, 128), masked rows exactly 0."""
    q, k, v, pos, kvl = _mla_inputs(cuda, dtype, *_MLA_CASES[case])
    assert v.stride(-2) == 256 and FA._aligned(v) is v
    route = FA.route_for(q.dtype, q.shape[1], 1)
    before = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, pos, kvl)
    again = FA.flash_attention(q, k, v, pos, kvl)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches_by_route == {
        r: n + 2 * (r == route) for r, n in before.items()}
    assert got.shape == (*q.shape[:3], 128)
    want = _mla_plain(q, k, v, pos, kvl)
    if route == "cuda_cores":
        torch.testing.assert_close(got, want, atol=ATTN_TOLS["float32"][0],
                                   rtol=ATTN_TOLS["float32"][1])
        assert not bool((pos < 0).any()) \
            or float(got[pos < 0].abs().max()) == 0.0
    else:
        _check_tc(got, want, again, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", list(range(1, 9)))
@pytest.mark.parametrize("case", ["decode", "decode_1024"])
def test_mla_split_route_at_forced_split_counts(cuda, monkeypatch, case,
                                                splits):
    """K3's split route at (192, 128) over 1..8 CTAs a cluster, at 256
    keys and at 1,024 (where the chooser itself splits): the plain
    version's result within ATTN_TOLS, the same bits on a second launch."""
    monkeypatch.setattr(FA, "split_count", lambda *a: splits)
    q, k, v, pos, kvl = _mla_inputs(cuda, "bfloat16", *_MLA_CASES[case],
                                    seed=splits)
    before = FA.flash_attention.launches_by_route["split"]
    got = FA.flash_attention(q, k, v, pos, kvl)
    again = FA.flash_attention(q, k, v, pos, kvl)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches_by_route["split"] == before + 2
    _check_tc(got, _mla_plain(q, k, v, pos, kvl), again, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_MLA_CASES), ids=str)
def test_mla_lse_matches_plain(cuda, monkeypatch, case, dtype, splits):
    """K3 with ``return_lse=True`` at (192, 128), as a rank of a latent cut
    over the sequence runs it, on every route (split also over clusters of
    2, 3 and 8 CTAs, where a row's lse is written by the rank whose share of
    the (16, 128) tile holds its first element): out and lse within
    ATTN_TOLS of the plain version, lse -inf exactly where a row sees no
    key, the output bitwise the launch without lse."""
    q, k, v, pos, kvl = _mla_inputs(cuda, dtype, *_MLA_CASES[case])
    if splits is not None:
        if FA.route_for(q.dtype, q.shape[1], 1) != "split":
            pytest.skip("a split count applies to the split route")
        monkeypatch.setattr(FA, "split_count", lambda *a: splits)
    before = FA.flash_attention.lse_launches
    got, lse = FA.flash_attention(q, k, v, pos, kvl, return_lse=True)
    torch.cuda.synchronize()
    assert FA.flash_attention.lse_launches == before + 1
    assert lse.shape == q.shape[:3]
    assert torch.equal(got, FA.flash_attention(q, k, v, pos, kvl))
    want, want_lse = FA.flash_attention_plain(
        q, k, v, pos, kvl, causal=True, scale=192 ** -0.5, soft_cap=None,
        return_lse=True)
    atol, rtol = ATTN_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    dead = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    torch.testing.assert_close(lse[~dead], want_lse[~dead], atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_mla_rows_and_split_routes_each_match_plain(cuda):
    """Each position of a 64-column MLA prefill (rows) and a decode step at
    that position over the same keys (split) both hold the plain
    version's result within ATTN_TOLS. (K3's rows route walks a stage's 64
    keys a warp, its split route 16 a warp, so the two sum a row in
    different orders; the bitwise agreement of caveat (iv) is K4's and
    K5's, whose rows route walks as split does.)"""
    q, k, v, pos, kvl = _mla_inputs(cuda, "bfloat16", 2, 64, 64, 4,
                                    (64, 64), (0, 0), seed=9)
    prefill = FA.flash_attention(q, k, v, pos, kvl)
    _check_tc(prefill, _mla_plain(q, k, v, pos, kvl),
              FA.flash_attention(q, k, v, pos, kvl), pos)
    for t in (0, 15, 16, 63):
        args = (q[:, t:t + 1], k, v, pos[:, t:t + 1],
                torch.full_like(kvl, t + 1))
        step = FA.flash_attention(*args)
        _check_tc(step, _mla_plain(*args), FA.flash_attention(*args),
                  args[3])


@pytest.mark.cuda
def test_tensor_core_routes_reject(cuda):
    """No fallback: a CUDA bf16 geometry the tensor-core kernels do not take
    raises before anything launches."""
    bf = torch.bfloat16
    flash, paged = dict(FA.flash_attention.launches_by_route), \
        dict(PA.paged_attention.launches_by_route)
    for D in (32, 96):                   # K3 takes head_dim 64, 80 and 128
        q = torch.zeros((1, 1, 4, D), dtype=bf, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            FA.flash_attention(q, q, q)
    # (192, 128) is MLA's pair; 192 with v at 192 is no instance
    q = torch.zeros((1, 1, 4, 192), dtype=bf, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q)
    # no cap on the GQA group: a group of 17 launches (and counts)
    q = torch.zeros((1, 1, 17, 64), dtype=bf, device=cuda)
    FA.flash_attention(q, q[:, :, :1], q[:, :, :1])
    flash["split"] += 1
    # the block-table entries a CTA copies into shared memory are bounded
    big = torch.zeros((1, PA.MAX_TABLE + 1), dtype=torch.int32, device=cuda)
    kp = torch.zeros((1, 16, 1, 64), dtype=bf, device=cuda)
    with pytest.raises(ValueError, match="entries"):
        PA.paged_attention(q, kp, kp, big)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    for P, ps, D, Dv in ((2, 4, 64, 64), (2, 16, 24, 24), (2, 16, 64, 32)):
        q = torch.zeros((1, 1, 2, D), dtype=bf, device=cuda)
        kp = torch.zeros((P, ps, 1, D), dtype=bf, device=cuda)
        vp = torch.zeros((P, ps, 1, Dv), dtype=bf, device=cuda)
        with pytest.raises(ValueError, match="bf16 kernels take"):
            PA.paged_attention(q, kp, vp, bt)
    assert FA.flash_attention.launches_by_route == flash
    assert PA.paged_attention.launches_by_route == paged


def _int8_case(cuda, B, Sq, Sk, H, Hkv, D, ps, lens, starts, seed=0,
               positive_v=False, **kw):
    """(wrapper call, plain call, q_positions, pools) of one bf16-q case
    over int8 pools. Page p's values are scaled by 1 + p % 5 before they
    are quantized, so neighbouring pages (the two of a ps-8 key tile) have
    scales up to 5x apart; the tables are shuffled and their entries past
    each row's valid keys are out of the pool's range (the kernels read
    neither those pages nor their scales)."""
    q, kp, vp, bt, pos, kvl = _paged_inputs(cuda, "float32", B, Sq, H, Hkv,
                                            D, ps, lens, starts, seed=seed)
    q = q.to(torch.bfloat16)
    nb = Sk // ps
    bt = torch.cat([bt, bt[:, :1].expand(B, nb - bt.shape[1])], 1) \
        if bt.shape[1] < nb else bt[:, :nb]
    spread = 1 + torch.arange(kp.shape[0], device=cuda)[:, None, None,
                                                        None] % 5
    if positive_v:
        vp = vp.abs() + 0.5
    (qk, ks), (qv, vs) = (Q.quantize_kv_pages(x * spread) for x in (kp, vp))
    dead = torch.arange(nb, device=cuda)[None] >= -(-kvl[:, None] // ps)
    poisoned = torch.where(dead, torch.full_like(bt, 1 << 30), bt)
    kw = dict(kw, kv_scales=(ks, vs))
    return (lambda: PA.paged_attention(q, qk, qv, poisoned, pos, kvl, **kw),
            lambda: PA.paged_attention_plain(
                q, qk, qv, bt, pos, kvl, scale=D ** -0.5,
                causal=kw.get("causal", True),
                soft_cap=kw.get("soft_cap"), kv_scales=(ks, vs)),
            pos, (q, qk, qv, ks, vs, bt, kvl))


def _int8_launch(kernel, route):
    """Two launches of a K5 case, counted on ``route`` only."""
    fn = PA.paged_attention
    before = dict(fn.launches_int8_by_route)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    assert fn.launches_int8_by_route == {r: n + 2 * (r == route)
                                         for r, n in before.items()}
    return got, again


# B, Sq, key slots (nb x ps), H, Hkv, D, ps, valid keys per row (0: an
# all-masked slot), first query position per row: every head dim of the
# tensor-core instances on both routes, page sizes 8/16/32 and GQA groups
# 1..16 among them.
_INT8_GEOMETRIES = {
    "split_d16_ps8_rep1": (3, 1, 96, 2, 2, 16, 8, (0, 41, 96), (-1, 40, 95)),
    "split_d32_ps16_rep4": (3, 4, 128, 8, 2, 32, 16, (77, 0, 128),
                            (73, -1, 124)),
    "split_d48_ps32_rep16": (2, 1, 160, 16, 1, 48, 32, (160, 0), (159, -1)),
    "split_d64_ps8_rep3": (3, 5, 256, 9, 3, 64, 8, (0, 100, 256),
                           (-1, 95, 251)),
    "split_d80_ps16_rep2": (2, 8, 96, 4, 2, 80, 16, (96, 9), (88, 1)),
    "split_d96_ps32_rep8": (3, 2, 128, 8, 1, 96, 32, (33, 128, 0),
                            (31, 126, -1)),
    "split_d112_ps8_rep5": (2, 3, 64, 10, 2, 112, 8, (64, 0), (61, -1)),
    "split_d128_ps16_rep1": (2, 16, 96, 2, 2, 128, 16, (96, 17), (80, 1)),
    "rows_d16_ps32_rep16": (2, 3, 96, 16, 1, 16, 32, (96, 0), (93, -1)),
    "rows_d32_ps8_rep1": (2, 40, 64, 2, 2, 32, 8, (64, 0), (24, -1)),
    "rows_d48_ps16_rep3": (3, 64, 128, 6, 2, 48, 16, (64, 0, 100),
                           (0, -1, 36)),
    "rows_d64_ps32_rep2": (2, 33, 128, 4, 2, 64, 32, (128, 40), (95, 7)),
    "rows_d80_ps8_rep4": (2, 20, 80, 8, 2, 80, 8, (80, 0), (60, -1)),
    "rows_d96_ps16_rep6": (2, 11, 96, 6, 1, 96, 16, (96, 11), (85, 0)),
    "rows_d112_ps32_rep8": (2, 9, 64, 8, 1, 112, 32, (64, 0), (55, -1)),
    "rows_d128_ps8_rep12": (2, 7, 48, 12, 1, 128, 8, (48, 30), (41, 23)),
    # speculative verify and a mid-page tail prefill at smollm-135m's heads
    # (as _TC_GEOMETRIES' verify cases)
    "split_verify_k4_d64_ps16_rep3": (4, 5, 256, 9, 3, 64, 16,
                                      (101, 35, 0, 200), (96, 32, -1, 199)),
    "rows_verify_k8_d64_ps16_rep3": (4, 9, 256, 9, 3, 64, 16,
                                     (105, 37, 0, 250), (96, 32, -1, 249)),
    "rows_tail_prefill_midpage_d64_ps16": (2, 16, 128, 9, 3, 64, 16,
                                           (54, 0), (43, -1)),
    # GQA groups 24, 48 (granite-20b's MQA at head_dim 128) and 64
    "split_d128_ps16_rep48": (3, 1, 128, 48, 1, 128, 16, (128, 0, 33),
                              (127, -1, 32)),
    "rows_d128_ps16_rep48": (2, 9, 128, 48, 1, 128, 16, (128, 0),
                             (119, -1)),
    "split_d64_ps8_rep24": (3, 1, 64, 24, 1, 64, 8, (64, 0, 9), (63, -1, 8)),
    "rows_d16_ps32_rep64": (2, 3, 96, 64, 1, 16, 32, (96, 0), (93, -1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_INT8_GEOMETRIES), ids=str)
def test_int8_tensor_core_routes_at_each_geometry(cuda, case):
    """K5 with bf16 q at each head dim of the tensor-core instances, on
    the route its chooser names: within ATTN_TOLS of the plain version,
    two launches bitwise equal, all-masked rows exactly 0."""
    B, Sq, Sk, H, Hkv, D, ps, lens, starts = _INT8_GEOMETRIES[case]
    route = PA.route_for(torch.bfloat16, Sq, H // Hkv)
    assert route == case.split("_")[0]
    kernel, plain, pos, _ = _int8_case(cuda, B, Sq, Sk, H, Hkv, D, ps, lens,
                                       starts, seed=5)
    got, again = _int8_launch(kernel, route)
    _check_tc(got, plain(), again, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", list(range(1, 9)))
@pytest.mark.parametrize("case", ["decode_ps8", "chunk_ps32"])
def test_int8_split_route_at_forced_split_counts(cuda, monkeypatch, case,
                                                 splits):
    """K5's split route at 1..8 CTAs a cluster (forced through the
    chooser): the plain version's result within ATTN_TOLS, the same bits
    on a second launch; slots at 0, 1, 128 and 255 keys leave some CTAs
    of the cluster empty."""
    monkeypatch.setattr(PA, "split_count", lambda *a: splits)
    shape = {"decode_ps8": (4, 1, 256, 9, 3, 64, 8, (0, 1, 128, 255),
                            (-1, 0, 127, 254)),
             "chunk_ps32": (2, 8, 256, 4, 2, 32, 32, (256, 41),
                            (248, 33))}[case]
    kernel, plain, pos, _ = _int8_case(cuda, *shape, seed=6)
    got, again = _int8_launch(kernel, "split")
    _check_tc(got, plain(), again, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 40])
def test_int8_tensor_core_routes_soft_cap_and_noncausal(cuda, Sq):
    """A soft cap of 2, causal and not, on both routes of K5."""
    route = PA.route_for(torch.bfloat16, Sq, 3)
    for causal in (True, False):
        kernel, plain, pos, _ = _int8_case(
            cuda, 3, Sq, 96, 6, 2, 64, 16, (96, 50, 0), (56, 10, -1),
            seed=7, soft_cap=2.0, causal=causal)
        got, again = _int8_launch(kernel, route)
        _check_tc(got, plain(), again, pos, causal)


def _off_midpoint(x: torch.Tensor) -> torch.Tensor:
    """fp32 values farther than 2^-16 relative from a bf16 rounding
    midpoint (their low 16 bits 0x8000): the values whose single rounding
    to bf16 an error below 2^-16 relative cannot change."""
    bits = x.contiguous().view(torch.int32)
    mid = ((bits & ~0xFFFF) | 0x8000).view(torch.float32)
    return (x.double() - mid.double()).abs() > 2.0 ** -16 * x.double().abs()


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 40])
def test_int8_tensor_core_routes_do_not_round_p(cuda, Sq):
    """The reference dequantizes int8 pages to fp32 before the block step,
    so p is not rounded to bf16 before P·V. With bf16 q, every output
    element of K5 equals the plain fp32 recurrence (on the same bf16 q
    values) rounded once to bf16, except where that fp32 value lies
    within 2^-16 relative of a bf16 rounding midpoint. V is positive, so
    an output is a weighted mean without cancellation and its relative
    error is that of p. The same attention with p rounded once to bf16
    (what K4's tile does for bf16 pools) misses the criterion: the test
    tells the two apart."""
    B, H, Hkv, D, ps = 8, 9, 3, 64, 16
    lens = (256, 17, 200, 64, 1, 128, 255, 90)
    starts = tuple(n - Sq if n >= Sq else 0 for n in lens)
    kernel, _, pos, (q, qk, qv, ks, vs, bt, kvl) = _int8_case(
        cuda, B, Sq, 256, H, Hkv, D, ps, lens, starts, seed=8,
        positive_v=True)
    route = PA.route_for(torch.bfloat16, Sq, H // Hkv)
    got, _ = _int8_launch(kernel, route)
    ref = PA.paged_attention_plain(q.float(), qk, qv, bt, pos, kvl,
                                   causal=True, scale=D ** -0.5,
                                   soft_cap=None, kv_scales=(ks, vs))
    live = (pos >= 0)[:, :, None, None].expand_as(ref)
    check = live & _off_midpoint(ref)
    assert int(check.sum()) > 0.9 * int(live.sum())
    assert torch.equal(got[check], ref.to(torch.bfloat16)[check])
    # p rounded once, on the same dequantized pages
    kd = PA.gather_pages(Q.dequantize_kv_pages(qk, ks, torch.float32), bt)
    vd = PA.gather_pages(Q.dequantize_kv_pages(qv, vs, torch.float32), bt)
    rep = H // Hkv
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     kd.repeat_interleave(rep, 2)) * D ** -0.5
    cols = torch.arange(kd.shape[1], device=cuda)
    vis = (cols[None, None, :] < kvl[:, None, None]) \
        & (cols[None, None, :] <= pos[:, :, None])
    s = torch.where(vis[:, None], s, torch.full_like(s, -1e30))
    p = torch.where(vis[:, None], torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    rounded = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(),
                           vd.repeat_interleave(rep, 2)) \
        / p.sum(-1).clamp(min=1e-30).permute(0, 2, 1)[..., None]
    assert not torch.equal(rounded.to(torch.bfloat16)[check],
                           ref.to(torch.bfloat16)[check])


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D,ps", [(9, 3, 64, 16), (2, 2, 128, 8),
                                        (8, 1, 32, 32)])
def test_int8_split_and_rows_routes_agree_bitwise(cuda, H, Hkv, D, ps):
    """A row's K5 result does not depend on the route: each position of a
    64-token prefill (rows route) equals, bit for bit, a decode step at
    that position over the same pool (split route, one CTA per (kv head,
    batch row)). A preempted int8 request is re-prefilled over tokens it
    decoded, and its stream equals its solo stream only so."""
    B, Sq = 2, 64
    lens, starts = (64, 64), (0, 0)
    kernel, _, pos, (q, qk, qv, ks, vs, bt, kvl) = _int8_case(
        cuda, B, Sq, 128, H, Hkv, D, ps, lens, starts, seed=9)
    assert PA.route_for(torch.bfloat16, Sq, H // Hkv) == "rows"
    assert PA.route_for(torch.bfloat16, 1, H // Hkv) == "split"
    assert PA.split_count(B, Hkv, bt.shape[1] * ps) == 1
    prefill, _ = _int8_launch(kernel, "rows")
    for t in (0, 1, 15, 16, 40, 63, ps - 1, ps):
        step = PA.paged_attention(q[:, t:t + 1], qk, qv, bt, pos[:, t:t + 1],
                                  torch.full_like(kvl, t + 1),
                                  kv_scales=(ks, vs))
        assert torch.equal(step[:, 0], prefill[:, t]), t


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("H,Hkv,D,ps", [(9, 3, 64, 16), (12, 2, 128, 16),
                                        (48, 1, 128, 16), (24, 1, 64, 8)])
def test_split_and_rows_routes_agree_bitwise(cuda, pool, H, Hkv, D, ps):
    """K4 over bf16 pools and K5 over int8 pools give a row the same bits
    on both routes: each position of a 64-token prefill (rows) equals a
    decode step at that position over the same pool (split, one CTA per
    tile), at qwen2's group 6, granite's 48 and 24 among them. A preempted
    request is re-prefilled over tokens it decoded, and a prefix-cache hit
    prefills its tail over keys another request wrote: their streams equal
    a solo run's only so."""
    B, Sq = 2, 64
    q, kp, vp, bt, pos, kvl = _paged_inputs(cuda, "float32", B, Sq, H, Hkv,
                                            D, ps, (64, 64), (0, 0), seed=9)
    q = q.to(torch.bfloat16)
    kw = {}
    if pool == "int8":
        (kp, ks), (vp, vs) = Q.quantize_kv_pages(kp), Q.quantize_kv_pages(vp)
        kw = dict(kv_scales=(ks, vs))
    else:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    assert PA.route_for(torch.bfloat16, Sq, H // Hkv) == "rows"
    assert PA.route_for(torch.bfloat16, 1, H // Hkv) == "split"
    assert PA.split_count(B, Hkv, bt.shape[1] * ps) == 1
    prefill = PA.paged_attention(q, kp, vp, bt, pos, kvl, **kw)
    for t in (0, 1, 15, 16, 40, 63, ps - 1, ps):
        step = PA.paged_attention(q[:, t:t + 1], kp, vp, bt, pos[:, t:t + 1],
                                  torch.full_like(kvl, t + 1), **kw)
        assert torch.equal(step[:, 0], prefill[:, t]), t


@pytest.mark.cuda
@pytest.mark.parametrize("d", [576, 1536, 5120, 8192])
def test_norm_row_bits_independent_of_m(cuda, d):
    """RMSNorm and LayerNorm give a bf16 row the same bits whether it shares
    the call with 0, 7 or 511 other rows (torch.mean's reduction order
    follows the row count; a decode step and a re-prefill must agree)."""
    from repro_torch.models import layers as ML
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((512, d), generator=gen, device=cuda).to(torch.bfloat16)
    p = {k: torch.randn((d,), generator=gen, device=cuda).to(torch.bfloat16)
         for k in ("scale", "bias")}
    for norm in (ML.rmsnorm, ML.layernorm):
        full = norm(p, x)
        for M in (1, 2, 8, 16, 96):
            assert torch.equal(norm(p, x[:M]), full[:M]), (norm, M)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(1536, 256), (1536, 8960), (4096, 1024),
                                 (6144, 128)])
def test_gemm_wgmma_row_bits_independent_of_m_and_tile(cuda, monkeypatch,
                                                       K, N):
    """bf16 K1 on the card runs every M on its wgmma route (bm 64, the
    plan's bm_for): a row's bits are the same at M = 8, 40 and 512 and on
    every CTA tile of WGMMA_TILES that takes the block width. So a
    preempted request's re-prefill rebuilds the K/V its decode steps
    wrote, whichever rows shared each call."""
    from repro_torch.core.plan import GemmPolicy, layout_for_packed, \
        pack_weight
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    a = torch.randn((512, K), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5).to(
        torch.bfloat16)
    pw = pack_weight(w, GemmPolicy())
    fn = MF.matrixflow_gemm_block_major

    def run(M):
        blk = layout_for_packed(M, pw)
        assert blk.bm == 64 and MF.route_for(a.dtype, blk.bm) == "wgmma"
        c = fn(L.to_block_major_a(a[:M], blk.bm, blk.bk), pw.data,
               out_dtype=torch.bfloat16)
        return L.from_block_major_c(c, M, N)

    full = run(512)
    for M in (8, 40):
        assert torch.equal(run(M), full[:M]), M
    chooser = MF.tc_tile
    for gm, tn, _ in MF.WGMMA_TILES:
        if tn % pw.bn:
            continue
        monkeypatch.setattr(MF, "tc_tile", lambda *a, t=(gm, tn, 1): t)
        for M in (8, 512):
            assert torch.equal(run(M), full[:M]), (gm, tn, M)
        monkeypatch.setattr(MF, "tc_tile", chooser)


@pytest.mark.cuda
def test_int8_tensor_core_routes_reject(cuda):
    """No fallback: an int8-pool geometry the tensor-core kernels do not
    take with bf16 q raises before anything launches."""
    bf = torch.bfloat16
    before = dict(PA.paged_attention.launches_int8_by_route)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    for P, ps, D, Dv in ((2, 4, 64, 64), (2, 16, 24, 24), (2, 16, 64, 32)):
        q = torch.zeros((1, 1, 2, D), dtype=bf, device=cuda)
        kp = torch.zeros((P, ps, 1, D), dtype=torch.int8, device=cuda)
        vp = torch.zeros((P, ps, 1, Dv), dtype=torch.int8, device=cuda)
        sc = torch.ones((P, 1), device=cuda)
        with pytest.raises(ValueError, match="bf16 kernels take"):
            PA.paged_attention(q, kp, vp, bt, kv_scales=(sc, sc))
    assert PA.paged_attention.launches_int8_by_route == before


def _encoder_logits(cfg, params, batch, device):
    batch = {k: v.to(device) for k, v in batch.items()}
    with torch.no_grad():
        return T.encoder_forward(api.pack_model_weights(
            {k: v for k, v in params.items()}), cfg, batch).float().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    ("bert-base", dict(n_heads=2, n_kv_heads=2, d_head=64)),
    ("vit-huge", dict(d_model=160, n_heads=2, n_kv_heads=2, d_head=80))],
    ids=["bert_d64", "vit_d80"])
def test_encoder_on_card_matches_cpu_plain(cuda, arch, kw):
    """fp32 encoder_forward under the default policies: the card's path
    (K1 and the paged policy's flash fallback, K3) against the CPU's plain
    versions, within 1e-4 (fp32 GEMMs summed in other orders)."""
    cfg = get_smoke_config(arch, dtype="float32", **kw)
    params = T.init_model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = ({"embeds": torch.randn((2, 37, cfg.d_model), generator=gen)}
             if cfg.family == "vit" else
             {"tokens": torch.randint(0, cfg.vocab, (2, 37), generator=gen)})
    before = (MF.matrixflow_gemm_block_major.launches,
              FA.flash_attention.launches)
    got = _encoder_logits(cfg, {k: _to(v, cuda) for k, v in params.items()},
                          batch, cuda)
    assert MF.matrixflow_gemm_block_major.launches > before[0]
    assert FA.flash_attention.launches == before[1] + cfg.n_layers
    want = _encoder_logits(cfg, params, batch, "cpu")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _to(node, device):
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node.to(device)


@pytest.mark.cuda
def test_contiguous_engine_on_card_matches_cpu_plain(cuda):
    """The fused (contiguous-cache) engine: submit/step with more requests
    than slots, then generate(); fp32 greedy streams on the card (K1, K3)
    equal the CPU's (plain versions)."""
    cfg = get_smoke_config("smollm-135m", n_layers=2, vocab=64, d_head=64,
                           dtype="float32")
    params = T.init_model(cfg, seed=0, device="cpu")
    results = []
    for device in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=2, max_len=24, cache_dtype="float32",
            pack_weights=True, device=device, attention=FUSED))
        before = FA.flash_attention.launches
        pending, owner, streams = [[1, 2, 3], [4, 5, 6, 7], [8, 9]], {}, []
        for _ in range(100):
            while pending and (h := eng.submit(pending[0])) is not None:
                owner[h] = len(streams)
                streams.append([])
                pending.pop(0)
            for h, t in eng.step().items():
                streams[owner[h]].append(t)
            if not pending and not eng.slot_live.any():
                break
        gen = eng.generate(np.array([[3, 1, 4], [1, 5, 9]]), 6)
        results.append((streams, gen.tolist()))
        if device == "cuda":
            assert FA.flash_attention.launches > before
    assert results[0] == results[1]


# (B, S, H, P, N, chunk): tests/test_flash_ssd_kernels.py's SSD_CASES
# (copied: importing it would import JAX), then Mamba-2's serving prefill
# (Q 64, one chunk; 8 of its 64 heads), a prime length (Q 1), Q 125 over 8
# chunks and Zamba-2's N 64 over two chunks of 100
SSD_CARD_CASES = ((1, 16, 1, 4, 8, 4), (2, 32, 3, 8, 16, 8),
                  (1, 64, 2, 16, 32, 16), (2, 48, 2, 8, 16, 16),
                  (1, 128, 4, 64, 128, 64), (2, 64, 8, 64, 128, 128),
                  (1, 131, 2, 64, 128, 128), (1, 1000, 2, 64, 128, 128),
                  (2, 200, 3, 64, 64, 128))
SSD_TOLS = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)}


def _ssd_inputs(cuda, dtype, B, S, H, P, N, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dt_ = getattr(torch, dtype)
    x = torch.randn((B, S, H, P), generator=gen, device=cuda).to(dt_)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=gen, device=cuda) * 0.5)
    Bc, Cc = ((torch.randn((B, S, N), generator=gen, device=cuda) * 0.5)
              .to(dt_) for _ in range(2))
    return x, dt, A, Bc, Cc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CARD_CASES,
                         ids=lambda c: "B{}S{}H{}P{}N{}q{}".format(*c))
def test_ssd_scan_kernel_matches_plain(cuda, dtype, case):
    """K6 against its plain version on the same CUDA tensors: y within
    tests/test_ssm.py's 1e-4 in fp32 (parity's TOLS in bf16, y rounded
    once), the fp32 final state within 1e-4 either way."""
    B, S, H, P, N, chunk = case
    x, dt, A, Bc, Cc = _ssd_inputs(cuda, dtype, B, S, H, P, N, seed=S)
    before = K6.ssd_scan.launches
    y, h = K6.ssd_scan(x, dt, A, Bc, Cc, chunk=chunk)
    torch.cuda.synchronize()
    assert K6.ssd_scan.launches == before + 1
    want_y, want_h = K6.ssd_scan_plain(x, dt, A, Bc, Cc, chunk=chunk)
    atol, rtol = SSD_TOLS[dtype]
    assert y.dtype == x.dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_ssd_scan_strided_views_decay_extremes_and_rejections(cuda):
    """x, B and C read as views of wider tensors (the model layout's
    slices) give the contiguous result; dt = 20 with A = −8 stays finite;
    final_state=False writes no state; what the kernel does not take
    raises."""
    x, dt, A, Bc, Cc = _ssd_inputs(cuda, "float32", 2, 96, 3, 16, 32)
    wide = torch.randn((2, 96, 3, 40), device=cuda)
    wide[..., :16] = x
    bc_wide = torch.randn((2, 96, 80), device=cuda)
    bc_wide[..., :32], bc_wide[..., 40:72] = Bc, Cc
    y, none = K6.ssd_scan(wide[..., :16], dt, A, bc_wide[..., :32],
                          bc_wide[..., 40:72], chunk=32, final_state=False)
    assert none is None
    want, _ = K6.ssd_scan_plain(x, dt, A, Bc, Cc, chunk=32)
    torch.testing.assert_close(y, want, atol=1e-4, rtol=1e-4)
    y, h = K6.ssd_scan(x, torch.full_like(dt, 20.0), torch.full_like(A, -8.0),
                       Bc, Cc, chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    with pytest.raises(ValueError, match="dtype"):
        K6.ssd_scan(x, dt, A, Bc.bfloat16(), Cc)
    x, dt, A, Bc, Cc = _ssd_inputs(cuda, "float32", 1, 192, 1, 4, 8)
    with pytest.raises(ValueError, match="exceeds"):
        K6.ssd_scan(x, dt, A, Bc, Cc, chunk=192)


def _ssd_launch(args, route, chunk=128):
    """One K6 call and a second on the same inputs, with the counters'
    growth checked against ``route``; returns both results."""
    before = dict(K6.ssd_scan.launches_by_route)
    n = K6.ssd_scan.launches
    got = K6.ssd_scan(*args, chunk=chunk)
    again = K6.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert K6.ssd_scan.launches == n + 2
    assert K6.ssd_scan.launches_by_route == {
        r: c + 2 * (r == route) for r, c in before.items()}
    return got, again


def _ssd_check(args, got, again, dtype, chunk=128):
    want_y, want_h = K6.ssd_scan_plain(*args, chunk=chunk)
    atol, rtol = SSD_TOLS[dtype]
    torch.testing.assert_close(got[0].float(), want_y.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(got[1], want_h, atol=1e-4, rtol=1e-4)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("seg_tiles", [K6.SEG_TILES, 2, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CARD_CASES,
                         ids=lambda c: "B{}S{}H{}P{}N{}q{}".format(*c))
def test_ssd_routes_match_plain(cuda, monkeypatch, case, dtype, seg_tiles):
    """Every route at every case: bf16 on the tensor cores — walk, or
    chunks with segments of 1, 2 or SEG_TILES tiles forced through the plan
    (so the 64-step tiles of Q 4 .. 128, and of S 131 and 1000, cross
    segment boundaries) — and fp32 on the CUDA cores, each within SSD_TOLS
    for y and (1e-4, 1e-4) for the fp32 state, the same bits on a second
    launch."""
    monkeypatch.setattr(K6, "SEG_TILES", seg_tiles)
    B, S, H, P, N, chunk = case
    args = _ssd_inputs(cuda, dtype, B, S, H, P, N, seed=S + seg_tiles)
    route = K6.route_for(args[0].dtype, S, P, N)
    if dtype == "float32":
        assert route == "cuda_cores"
    else:
        tiles = -(-S // K6.TILE)
        assert route == ("walk" if tiles <= seg_tiles else "chunks")
    got, again = _ssd_launch(args, route, chunk)
    _ssd_check(args, got, again, dtype, chunk)


# full width: mamba2-1.3b (H 64, P 64, N 128) at its served prefills and a
# 4096-step prompt, zamba2-2.7b (H 80, N 64) at its 8 x 64 prefill
SSD_FULL_WIDTH = {"mamba2_8x384": (8, 384, 64, 64, 128, "walk"),
                  "mamba2_1x4096": (1, 4096, 64, 64, 128, "chunks"),
                  "mamba2_2x1000": (2, 1000, 64, 64, 128, "chunks"),
                  "mamba2_1x131": (1, 131, 64, 64, 128, "walk"),
                  "zamba2_8x64": (8, 64, 80, 64, 64, "walk")}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SSD_FULL_WIDTH))
def test_ssd_tensor_core_routes_at_full_width(cuda, cell):
    B, S, H, P, N, route = SSD_FULL_WIDTH[cell]
    args = _ssd_inputs(cuda, "bfloat16", B, S, H, P, N, seed=B + S)
    assert K6.route_for(torch.bfloat16, S, P, N) == route
    got, again = _ssd_launch(args, route)
    _ssd_check(args, got, again, "bfloat16")


def _state_rounded_once(x, dt, A, Bc, Cc, Q):
    """The final state of the chunk recurrence with its fp32 operand,
    exp(cum_Q − cum) ∘ dt x, rounded once to bf16 before the product with
    (bf16, exact) B: the state a single-rounded tensor-core product gives."""
    Bsz, S, H, P = x.shape
    h = torch.zeros((Bsz, H, P, Bc.shape[-1]), device=x.device)
    for c0 in range(0, S, Q):
        dtc = dt[:, c0:c0 + Q]
        dtx = (x[:, c0:c0 + Q].float() * dtc[..., None]).transpose(1, 2)
        cum = torch.cumsum((dtc * A).transpose(1, 2).double(), dim=-1)
        w = dtx * torch.exp((cum[..., -1:] - cum).float())[..., None]
        h = h * torch.exp(cum[..., -1].float())[..., None, None] \
            + torch.matmul(w.bfloat16().float().transpose(-1, -2),
                           Bc[:, c0:c0 + Q].float()[:, None])
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(8, 384), (1, 1000)])
def test_ssd_state_needs_unrounded_operands(cuda, B, S):
    """The bf16 routes carry exp(cum_Q − cum) ∘ dt x into the state product
    as bf16 hi + lo: the kernel's state holds (1e-4, 1e-4) against the
    plain version, and the same recurrence with that operand rounded once
    to bf16 does not (the test tells the two apart)."""
    args = _ssd_inputs(cuda, "bfloat16", B, S, 64, 64, 128, seed=3)
    _, h = K6.ssd_scan(*args)
    _, want = K6.ssd_scan_plain(*args)
    torch.testing.assert_close(h, want, atol=1e-4, rtol=1e-4)
    once = _state_rounded_once(*args, K6.ssd_chunk_size(S, 128))
    assert not torch.allclose(once, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S,route", [(384, "walk"), (1000, "chunks"),
                                     (131, "walk")])
def test_ssd_row_does_not_depend_on_batch(cuda, S, route):
    """A row's y and state are the same bits alone (B 1) and inside a
    batch of 8, on either tensor-core route: the route and its segments
    depend on S, never on B, and no CTA sums another row's work."""
    args = _ssd_inputs(cuda, "bfloat16", 8, S, 64, 64, 128, seed=S)
    assert K6.route_for(torch.bfloat16, S, 64, 128) == route
    y, h = K6.ssd_scan(*args)
    for b in (0, 5):
        yb, hb = K6.ssd_scan(*(t[b:b + 1] if t.dim() > 1 else t
                               for t in args))
        assert torch.equal(yb[0], y[b]) and torch.equal(hb[0], h[b]), b


@pytest.mark.cuda
def test_ssd_tensor_core_strided_views_and_decay_extremes(cuda):
    """bf16 x, B and C read as unaligned views of wider tensors (no 16-byte
    loads) give the bits of contiguous copies, on both routes; dt = 20
    with A = −8 stays finite; final_state=False writes no state."""
    for S in (200, 1000):
        x, dt, A, Bc, Cc = _ssd_inputs(cuda, "bfloat16", 2, S, 3, 16, 32)
        wide = torch.zeros((2, S, 3, 21), device=cuda, dtype=torch.bfloat16)
        wide[..., 1:17] = x
        bc = torch.zeros((2, S, 67), device=cuda, dtype=torch.bfloat16)
        bc[..., 1:33], bc[..., 34:66] = Bc, Cc
        y, h = K6.ssd_scan(wide[..., 1:17], dt, A, bc[..., 1:33],
                           bc[..., 34:66])
        want_y, want_h = K6.ssd_scan(x, dt, A, Bc, Cc)
        assert torch.equal(y, want_y) and torch.equal(h, want_h)
        y2, none = K6.ssd_scan(x, dt, A, Bc, Cc, final_state=False)
        assert none is None and torch.equal(y2, want_y)
        y, h = K6.ssd_scan(x, torch.full_like(dt, 20.0),
                           torch.full_like(A, -8.0), Bc, Cc)
        assert bool(torch.isfinite(y.float()).all())
        assert bool(torch.isfinite(h).all())


@pytest.mark.cuda
def test_ssd_tensor_core_route_rejects(cuda):
    """No fallback: a bf16 geometry no tensor-core route takes (P above 64,
    N above 128) raises before anything launches; fp32 takes it on the
    CUDA cores."""
    before = dict(K6.ssd_scan.launches_by_route)
    for P, N in ((80, 64), (64, 256)):
        args = _ssd_inputs(cuda, "bfloat16", 1, 64, 2, P, N)
        with pytest.raises(ValueError, match="no tensor-core"):
            K6.ssd_scan(*args)
    assert K6.ssd_scan.launches_by_route == before
    args = _ssd_inputs(cuda, "float32", 1, 64, 2, 80, 64)
    got, again = _ssd_launch(args, "cuda_cores")
    _ssd_check(args, got, again, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [("mamba2-1.3b", {}),
                                     ("zamba2-2.7b", dict(d_head=64))])
def test_ssm_engine_on_card_matches_cpu_plain(cuda, arch, kw):
    """The SSM families under the fused policy, fp32: generate() and a
    single-slot submit/step stream on the card (K1, K6, and K3 for the
    hybrid's shared block) equal the CPU's (plain versions)."""
    cfg = get_smoke_config(arch, vocab=64, dtype="float32", **kw)
    params = T.init_model(cfg, seed=0, device="cpu")
    results = []
    for device in ("cuda", "cpu"):
        before = K6.ssd_scan.launches
        eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=2, max_len=48, cache_dtype="float32",
            pack_weights=True, device=device, attention=FUSED))
        gen = eng.generate(np.array([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]), 8)
        solo = ServingEngine(cfg, params, ServeConfig(
            batch_slots=1, max_len=48, cache_dtype="float32",
            pack_weights=True, device=device, attention=FUSED))
        h = solo.submit(list(range(1, 38)))          # Q 37: one chunk
        stream = [solo.step()[h] for _ in range(6)]
        results.append((gen.tolist(), stream))
        if device == "cuda":
            assert K6.ssd_scan.launches == before + 2 * cfg.n_layers
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# Mixed cache and model dtypes: fp32 q over bf16 K/V (K3, K4), and bf16 q
# over fp32 K/V (cast up to fp32, the output back to bf16)
# ---------------------------------------------------------------------------

MIXED_FLASH = ("decode_rep3_ragged_masked", "prefill_bucket_masked_rows",
               "chunk_offset", "qwen2_decode_d128_rep6")
MIXED_PAGED = (
    (8, 1, 9, 3, 64, 16, (17, 200, 64, 1, 33, 128, 255, 90),
     (16, 199, 63, 0, 32, 127, 254, 89)),
    (8, 64, 9, 3, 64, 16, (64, 16, 40, 1, 63, 0, 20, 64),
     (0, 0, 0, 0, 0, -1, 0, 0)),
)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [("float32", "bfloat16"),
                                              ("bfloat16", "float32")])
@pytest.mark.parametrize("case", MIXED_FLASH, ids=str)
def test_flash_attention_mixed_dtypes_match_plain(cuda, q_dtype, kv_dtype,
                                                  case):
    """K3 with a cache in another dtype than q, at decode and prefill:
    fp32 q over bf16 K/V on its own instance (``cuda_cores_bf16kv``), bf16
    q over fp32 K/V on the fp32 instance with q cast up; the output in q's
    dtype, within ATTN_TOLS of the plain version (:func:`_mixed_close`)."""
    B, Sq, Sk, H, Hkv, D, causal, starts, lens = FLASH_CASES[case]
    q, k, v, qpos, kvl = _flash_inputs(cuda, "float32", B, Sq, Sk, H, Hkv,
                                       D, starts, lens)
    q = q.to(getattr(torch, q_dtype))
    k, v = (t.to(getattr(torch, kv_dtype)) for t in (k, v))
    route = FA.route_for(q.dtype, Sq, H // Hkv, k.dtype)
    assert route == (FA.MIXED_ROUTE if q_dtype == "float32" else "cuda_cores")
    by_route = dict(FA.flash_attention.launches_by_route)
    got = FA.flash_attention(q, k, v, qpos, kvl, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches_by_route == {
        r: n + (r == route) for r, n in by_route.items()}
    assert got.dtype == q.dtype
    qpos_r = qpos if qpos is not None else (
        torch.arange(Sq, device=cuda) + (Sk - Sq)).expand(B, Sq).to(torch.int32)
    kvl_r = kvl if kvl is not None else torch.full(
        (B,), Sk, dtype=torch.int32, device=cuda)
    want = FA.flash_attention_plain(q, k, v, qpos_r, kvl_r, causal=causal,
                                    scale=D ** -0.5, soft_cap=None)
    _mixed_close(got, want)


def _mixed_close(got, want):
    """Kernel against plain version with q and K/V of two dtypes. Either
    way one operand of P·V is bf16 (p rounded to bf16 over bf16 V, as the
    reference's p.astype(v.dtype); or the output rounded to bf16), so
    ATTN_TOLS["bfloat16"]. Over bf16 V both sides round p from fp32 scores
    summed in other orders, and a p on a rounding boundary takes the other
    bf16 neighbour (an ulp, 2⁻⁷ relative, on rare elements: 93 of 147,456
    outputs past the fp32 tolerance in the prefill case on an H100): all
    but 1% of the elements must also hold the fp32 tolerance."""
    atol, rtol = ATTN_TOLS["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if got.dtype == torch.float32:
        atol, rtol = ATTN_TOLS["float32"]
        off = (got - want).abs() > atol + rtol * want.abs()
        assert float(off.float().mean()) <= 0.01, int(off.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [("float32", "bfloat16"),
                                              ("bfloat16", "float32")])
@pytest.mark.parametrize("case", MIXED_PAGED, ids=["decode", "prefill"])
def test_paged_attention_mixed_dtypes_match_plain(cuda, q_dtype, kv_dtype,
                                                  case):
    """K4 with pools in another dtype than q: fp32 q over bf16 pools on
    ``paged_attn_bf16_kernel`` (``cuda_cores_bf16kv``), bf16 q over fp32
    pools on the fp32 kernel with q cast up; within ATTN_TOLS of the plain
    version (:func:`_mixed_close`)."""
    B, Sq, H, Hkv, D, ps, lens, starts = case
    q, kp, vp, bt, qpos, kvl = _paged_inputs(cuda, kv_dtype, B, Sq, H, Hkv,
                                             D, ps, lens, starts)
    q = q.to(getattr(torch, q_dtype))
    route = PA.route_for(q.dtype, Sq, H // Hkv, kp.dtype)
    assert route == (FA.MIXED_ROUTE if q_dtype == "float32" else "cuda_cores")
    by_route = dict(PA.paged_attention.launches_by_route)
    got = PA.paged_attention(q, kp, vp, bt, qpos, kvl)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches_by_route == {
        r: n + (r == route) for r, n in by_route.items()}
    assert got.dtype == q.dtype
    want = PA.paged_attention_plain(q, kp, vp, bt, qpos, kvl, causal=True,
                                    scale=D ** -0.5, soft_cap=None)
    _mixed_close(got, want)
    masked = qpos < 0
    assert not bool(masked.any()) or float(got[masked].abs().max()) == 0.0


@pytest.mark.cuda
def test_mixed_dtype_pairs_no_kernel_takes_raise(cuda):
    q = torch.randn((1, 1, 2, 64), device=cuda)
    k = torch.randn((1, 8, 1, 64), device=cuda).half()
    with pytest.raises(ValueError, match="fp32 or bf16"):
        FA.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        FA.flash_attention(q, k.bfloat16(), k.float())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_fp32_model_bf16_cache_engine_matches_cpu(cuda, kv_dtype):
    """The paged engine of an fp32 model over a bf16 cache (and over int8
    pages) on the card: the new K4 instance (K5's fp32 q for int8) serves
    the streams the CPU's plain versions serve."""
    cfg = get_smoke_config("smollm-135m", vocab=64, dtype="float32",
                           d_head=64)
    params = T.init_model(cfg, seed=0, device="cpu")
    streams = []
    for device in ("cuda", "cpu"):
        by_route = dict(PA.paged_attention.launches_by_route)
        n8 = PA.paged_attention.launches_int8_by_route["cuda_cores"]
        eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=2, max_len=48, cache_dtype="bfloat16",
            kv_dtype=kv_dtype, device=device, pack_weights=True))
        streams.append(eng.generate(np.array([[3, 1, 4, 1, 5],
                                              [9, 2, 6, 5, 3]]), 8).tolist())
        if device == "cuda" and kv_dtype is None:
            assert PA.paged_attention.launches_by_route[FA.MIXED_ROUTE] > \
                by_route[FA.MIXED_ROUTE]
        if device == "cuda" and kv_dtype == "int8":
            assert PA.paged_attention.launches_int8_by_route[
                "cuda_cores"] > n8
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# K1 trains on itself: the batch grid and the backward
# ---------------------------------------------------------------------------

def _dot_bound_check(got, a, b, K, out_dtype, what):
    """``got`` within the fp32 dot-product bound of the float64 product of
    a (…, M, K) and b (…, K, N) (test_gemm_kernel_matches_plain)."""
    exact = torch.matmul(a.double(), b.double())
    bound = K * 2.0 ** -24 * torch.matmul(a.double().abs(), b.double().abs())
    if out_dtype == torch.bfloat16:
        bound += 2.0 ** -8 * (exact.abs() + bound)
    err = (got.double() - exact).abs()
    assert bool((err <= bound + 1e-30).all()), (what, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("G,M,K,N", [(72, 128, 64, 128), (72, 128, 128, 64),
                                     (5, 70, 96, 40)])
def test_gemm_batch_grid_matches_plain(cuda, dtype, G, M, K, N):
    """K1's batch grid (one launch for G problems: the unfused attention's
    score and value products at smollm-135m's B 8 x 9 heads, S 128) on
    ``wgmma`` (bf16, bm 64) and the CUDA cores (fp32): each problem bitwise
    the same kernel's 2-D launch, and within the fp32 dot-product bound,
    as the plain version is."""
    gen = torch.Generator(device=cuda).manual_seed(G + M)
    dt = getattr(torch, dtype)
    a = torch.randn((G, M, K), generator=gen, device=cuda).to(dt)
    b = torch.randn((G, K, N), generator=gen, device=cuda).to(dt)
    pol = api.GemmPolicy(backend="matrixflow")
    blk = api.plan(M, N, K, dt, pol, cuda).layout
    a_bm = L.to_block_major_a(a, blk.bm, blk.bk)
    b_bm = L.to_block_major_b(b, blk.bk, blk.bn)
    fn = MF.matrixflow_gemm_block_major
    route = MF.route_for(dt, blk.bm)
    assert route == ("wgmma" if dtype == "bfloat16" else "cuda_core")
    n, nb, nr = fn.launches, fn.batched_launches, getattr(fn, f"{route}_launches")
    got = fn(a_bm, b_bm, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (fn.launches, fn.batched_launches,
            getattr(fn, f"{route}_launches")) == (n + 1, nb + 1, nr + 1)
    for g in range(0, G, max(1, G // 6)):
        assert torch.equal(got[g], fn(a_bm[g], b_bm[g],
                                      out_dtype=torch.float32))
    c = L.from_block_major_c(got, M, N)
    _dot_bound_check(c, a, b, K, torch.float32, "kernel")
    want = L.from_block_major_c(MF.plain(a_bm, b_bm, out_dtype=torch.float32),
                                M, N)
    _dot_bound_check(want, a, b, K, torch.float32, "plain")
    # through the API, one launch a call
    n = fn.launches
    torch.testing.assert_close(api.matmul(a, b, policy=pol,
                                          out_dtype=torch.float32), c)
    assert fn.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,K,N", [(1024, 576, 576), (1024, 576, 192),
                                   (1024, 576, 3072), (1024, 1536, 576),
                                   (1024, 576, 49152), (200, 96, 40)])
def test_gemm_function_grads_match_plain(cuda, dtype, M, K, N):
    """The K1 autograd Function at smollm-135m's training shapes (B 8 x
    128 rows; q/o, k/v, mlp-in, mlp-out, the head) and a ragged one: C, dA
    = dC·Bᵀ and dB = Aᵀ·dC, each a K1 launch counted as a backward launch,
    within the fp32 dot-product bound of the float64 products over their
    own inner dims (K, N and M); the plain version's autograd (the
    ``blockflow`` backend on the same CUDA tensors) within the same
    bound."""
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    dt = getattr(torch, dtype)
    a0 = (torch.randn((M, K), generator=gen, device=cuda) * 0.5).to(dt)
    b0 = (torch.randn((K, N), generator=gen, device=cuda) * 0.05).to(dt)
    dc = torch.randn((M, N), generator=gen, device=cuda).to(dt)
    fn = MF.matrixflow_gemm_block_major
    for backend in ("matrixflow", "blockflow"):
        a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
        n, nb = fn.launches, fn.backward_launches
        c = api.matmul(a, b, policy=api.GemmPolicy(backend=backend))
        c.backward(dc)
        torch.cuda.synchronize()
        if backend == "matrixflow":
            assert (fn.launches, fn.backward_launches) == (n + 3, nb + 2)
        assert a.grad.dtype == b.grad.dtype == dt
        _dot_bound_check(c, a0, b0, K, dt, (backend, "C"))
        _dot_bound_check(a.grad, dc, b0.t(), N, dt, (backend, "dA"))
        _dot_bound_check(b.grad, a0.t(), dc, M, dt, (backend, "dB"))


@pytest.mark.cuda
def test_forward_only_wrappers_raise_under_grad_on_card(cuda):
    """K2–K6 refuse a gradient on CUDA tensors before anything launches."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=cuda).to(dtype).requires_grad_()

    q, k, v = t(1, 2, 2, 64), t(1, 16, 1, 64), t(1, 16, 1, 64)
    counts = (FA.flash_attention.launches, PA.paged_attention.launches,
              PA.paged_attention.launches_int8, K6.ssd_scan.launches,
              MF.matrixflow_gemm_dequant.launches)
    with pytest.raises(RuntimeError, match="forward-only"):
        FA.flash_attention(q, k, v)
    pools = t(3, 16, 1, 64), t(3, 16, 1, 64)
    bt = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        PA.paged_attention(q, *pools, bt)
    i8 = torch.zeros((3, 16, 1, 64), dtype=torch.int8, device=cuda)
    sc = (torch.ones((3, 1), device=cuda), torch.ones((3, 1), device=cuda))
    with pytest.raises(RuntimeError, match="forward-only"):
        PA.paged_attention(q, i8, i8, bt, kv_scales=sc)
    a8 = torch.zeros((1, 1, 64, 64), dtype=torch.int8, device=cuda)
    b8 = torch.zeros((1, 1, 64, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        MF.matrixflow_gemm_dequant(a8, b8, t(64, dtype=torch.float32), None)
    with pytest.raises(RuntimeError, match="SSD training"):
        K6.ssd_scan(t(1, 64, 2, 64), t(1, 64, 2, dtype=torch.float32),
                    -torch.ones(2, device=cuda), t(1, 64, 128),
                    t(1, 64, 128))
    torch.cuda.synchronize()
    assert counts == (FA.flash_attention.launches,
                      PA.paged_attention.launches,
                      PA.paged_attention.launches_int8, K6.ssd_scan.launches,
                      MF.matrixflow_gemm_dequant.launches)


# ---------------------------------------------------------------------------
# Tensor parallelism (distributed/tp.py): K1 on a rank's column and row
# slices, K4 and K5 at a rank's heads — qwen3-8b at TP=2, full width
# ---------------------------------------------------------------------------

# (M, K, N, blocks): the column-parallel projections q, k/v, SwiGLU's
# gate ‖ up (each half sliced alike) and the LM head (151,936 / 2 =
# 75,968 columns a rank), at decode and prefill rows
TP_COL_CASES = [(M, K, N, b) for M in (8, 512)
                for K, N, b in ((4096, 4096, 1), (4096, 1024, 1),
                                (4096, 24576, 2))] + [(8, 4096, 151936, 1)]
# (M, K, N): the row-parallel o and mlp-out projections
TP_ROW_CASES = [(M, K, N) for M in (8, 512)
                for K, N in ((4096, 4096), (12288, 4096))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", TP_COL_CASES,
                         ids=[f"M{m}_K{k}_N{n}" for m, k, n, _ in
                              TP_COL_CASES])
def test_tp_column_slice_bits_match_unsharded_columns(cuda, dtype, case):
    """K1 on a rank's column slice (rank 1 of 2: the far half, so the
    columns move in the grid) gives the same columns' bits as the
    unsharded call: a column's dot product does not depend on N."""
    from repro_torch.distributed.tp import shard_dim
    M, K, N, blocks = case
    gen = torch.Generator(device=cuda).manual_seed(M + N)
    dt = getattr(torch, dtype)
    x = torch.randn((M, K), generator=gen, device=cuda).to(dt)
    w = (torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5).to(dt)
    before = MF.matrixflow_gemm_block_major.launches
    part = api.matmul(x, shard_dim(w, 1, 1, 2, blocks))
    whole = shard_dim(api.matmul(x, w), -1, 1, 2, blocks)
    torch.cuda.synchronize()
    assert MF.matrixflow_gemm_block_major.launches == before + 2
    assert torch.equal(part, whole), float((part.float()
                                            - whole.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", TP_ROW_CASES,
                         ids=[f"M{m}_K{k}_N{n}" for m, k, n in TP_ROW_CASES])
def test_tp_row_partial_sums_match_one_call(cuda, dtype, case):
    """The row-parallel contraction: two K halves through K1 with fp32
    outputs, summed, against one fp32-output call over the whole K,
    within parity's TOLS["float32"] (weights at the models' 1/sqrt(K)
    scale)."""
    from repro_torch.distributed.tp import shard_dim
    M, K, N = case
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    dt = getattr(torch, dtype)
    x = torch.randn((M, K), generator=gen, device=cuda).to(dt)
    w = (torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5).to(dt)
    parts = [api.matmul(shard_dim(x, -1, r, 2), shard_dim(w, 0, r, 2),
                        out_dtype=torch.float32) for r in range(2)]
    one = api.matmul(x, w, out_dtype=torch.float32)
    assert parts[0].dtype == torch.float32
    torch.testing.assert_close(parts[0] + parts[1], one, atol=1e-4,
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["K4", "K5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    (8, 1, (17, 200, 64, 1, 33, 128, 255, 90),
     (16, 199, 63, 0, 32, 127, 254, 89)),
    (8, 64, (64, 16, 40, 1, 63, 0, 20, 64), (0, 0, 0, 0, 0, -1, 0, 0)),
], ids=["decode", "prefill_bucket"])
def test_paged_attention_at_tp2_rank_heads(cuda, int8, dtype, case):
    """K4 (fp pools) and K5 (int8 pools with their scales) at a rank's
    heads of qwen3-8b at TP=2 (16 query heads over 4 KV heads, head_dim
    128, pages of 16) against their plain versions within ATTN_TOLS."""
    B, Sq, lens, starts = case
    H, Hkv, D, ps = 16, 4, 128, 16
    q, kp, vp, bt, qpos, kvl = _paged_inputs(
        cuda, "float32" if int8 else dtype, B, Sq, H, Hkv, D, ps, lens,
        starts, seed=24)
    scales = None
    if int8:
        (kp, ks), (vp, vs) = Q.quantize_kv_pages(kp), Q.quantize_kv_pages(vp)
        q, scales = q.to(getattr(torch, dtype)), (ks, vs)
    counter = "launches_int8" if int8 else "launches"
    before = getattr(PA.paged_attention, counter)
    got = PA.paged_attention(q, kp, vp, bt, qpos, kvl, kv_scales=scales)
    torch.cuda.synchronize()
    assert getattr(PA.paged_attention, counter) == before + 1
    want = PA.paged_attention_plain(q, kp, vp, bt, qpos, kvl, causal=True,
                                    scale=D ** -0.5, soft_cap=None,
                                    kv_scales=scales)
    atol, rtol = ATTN_TOLS[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    masked = qpos < 0
    assert not bool(masked.any()) or float(got[masked].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# Tensor-parallel training: K1 under autograd on a rank's slices; the meta
# path of every wrapper (the dry run) against a real launch
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,K,N", [(512, 4096, 4096), (512, 4096, 12288)])
def test_tp_k1_grads_on_column_and_row_slices(cuda, dtype, M, K, N):
    """K1's autograd Function (its backward is K1: dA = dC·Bᵀ, dB = Aᵀ·dC)
    on a rank's column slice of W gives the unsharded call's dW columns,
    and on a rank's row slice of W (with x's matching columns) its dW rows
    and dx columns, bitwise: an output column or row of K1 does not
    depend on the rest of the problem. qwen3-8b's q and mlp-in at a
    1,024-token train batch cut to 512 rows."""
    from repro_torch.distributed.tp import shard_dim
    gen = torch.Generator(device=cuda).manual_seed(M + N)
    dt = getattr(torch, dtype)
    x = torch.randn((M, K), generator=gen, device=cuda).to(dt)
    w = (torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5).to(dt)
    g = torch.randn((M, N), generator=gen, device=cuda).to(dt)
    policy = api.GemmPolicy(backend="matrixflow")

    def grads(x_, w_, g_):
        x_ = x_.detach().requires_grad_(True)
        w_ = w_.detach().requires_grad_(True)
        (api.matmul(x_, w_, policy=policy).float() * g_.float()).sum() \
            .backward()
        return x_.grad, w_.grad

    before = MF.matrixflow_gemm_block_major.backward_launches
    dx, dw = grads(x, w, g)
    _, dw_col = grads(x, shard_dim(w, 1, 1, 2), shard_dim(g, 1, 1, 2))
    dx_row, dw_row = grads(shard_dim(x, 1, 1, 2), shard_dim(w, 0, 1, 2), g)
    torch.cuda.synchronize()
    assert MF.matrixflow_gemm_block_major.backward_launches == before + 6
    assert torch.equal(dw_col, shard_dim(dw, 1, 1, 2))
    assert torch.equal(dw_row, shard_dim(dw, 0, 1, 2))
    assert torch.equal(dx_row, shard_dim(dx, 1, 1, 2))


def _counts():
    """The wrappers' launch counters, under the names of
    ``dryrun.launch_counters``: ``kernel``, ``kernel_route``, and K1's
    ``_batched`` and ``_backward``."""
    k1, k2 = MF.matrixflow_gemm_block_major, MF.matrixflow_gemm_dequant
    fa, pa, k6 = FA.flash_attention, PA.paged_attention, K6.ssd_scan
    out = {}
    for name, fn, routes in (
            ("matrixflow_gemm", k1,
             ("wgmma", "mma", "cuda_core", "batched", "backward")),
            ("matrixflow_gemm_dequant", k2, ("wgmma", "mma"))):
        out[name] = fn.launches
        out.update({f"{name}_{r}": getattr(fn, f"{r}_launches")
                    for r in routes})
    for name, total, by_route in (
            ("flash_attention", fa.launches, fa.launches_by_route),
            ("paged_attention", pa.launches, pa.launches_by_route),
            ("paged_attention_int8", pa.launches_int8,
             pa.launches_int8_by_route),
            ("ssd_scan", k6.launches, k6.launches_by_route)):
        out[name] = total
        out.update({f"{name}_{r}": n for r, n in by_route.items()})
    return out


def _delta(fn):
    before = _counts()
    fn()
    after = _counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _meta(tree):
    if isinstance(tree, torch.Tensor):
        return tree.to("meta")
    if isinstance(tree, (tuple, list)):
        return type(tree)(_meta(t) for t in tree)
    return tree


def _launch_cases(cuda):
    """(name, kernel call, its arguments): every kernel on every route."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    cases = []
    for dt, bm in ((torch.bfloat16, 64), (torch.bfloat16, 16),
                   (torch.float32, 16)):
        a = torch.randn((2, 3, bm, 192), generator=gen, device=cuda).to(dt)
        b = torch.randn((4, 3, 192, 64), generator=gen, device=cuda).to(dt)
        cases.append((f"k1 {dt} bm{bm}",
                      lambda a, b: MF.matrixflow_gemm_block_major(
                          a, b, out_dtype=a.dtype), (a, b)))
    a = torch.randn((6, 2, 3, 64, 192), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    b = torch.randn((6, 4, 3, 192, 64), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    cases.append(("k1 batched backward",
                  lambda a, b: MF.matrixflow_gemm_block_major(
                      a, b, out_dtype=a.dtype, backward=True), (a, b)))
    for bm in (64, 16):
        a8 = torch.randint(-127, 128, (2, 3, bm, 192), generator=gen,
                           device=cuda, dtype=torch.int8)
        b8 = torch.randint(-127, 128, (4, 3, 192, 64), generator=gen,
                           device=cuda, dtype=torch.int8)
        sa = torch.rand(2 * bm, generator=gen, device=cuda)
        sb = torch.rand(256, generator=gen, device=cuda)
        cases.append((f"k2 bm{bm}",
                      lambda a, b, sa, sb: MF.matrixflow_gemm_dequant(
                          a, b, sa, sb, out_dtype=torch.bfloat16),
                      (a8, b8, sa, sb)))
    for dt, kv, Sq in ((torch.bfloat16, torch.bfloat16, 1),
                       (torch.bfloat16, torch.bfloat16, 64),
                       (torch.float32, torch.float32, 64),
                       (torch.float32, torch.bfloat16, 1)):
        q = torch.randn((2, Sq, 8, 64), generator=gen, device=cuda).to(dt)
        k = torch.randn((2, 128, 2, 64), generator=gen, device=cuda).to(kv)
        cases.append((f"k3 {dt} {kv} Sq{Sq}",
                      lambda q, k: FA.flash_attention(q, k, k), (q, k)))
    lens, starts = (40, 90), (39, 89)
    for int8 in (False, True):
        for dt, Sq in (("bfloat16", 1), ("bfloat16", 64), ("float32", 1)):
            q, kp, vp, bt, qpos, kvl = _paged_inputs(
                cuda, "float32" if int8 else dt, 2, Sq, 8, 2, 64, 16, lens,
                starts if Sq == 1 else (0, 0), seed=3)
            if int8:
                (kp, ks), (vp, vs) = Q.quantize_kv_pages(kp), \
                    Q.quantize_kv_pages(vp)
                q = q.to(getattr(torch, dt))
                cases.append((f"k5 {dt} Sq{Sq}",
                              lambda q, kp, vp, bt, qp, kl, ks, vs:
                              PA.paged_attention(q, kp, vp, bt, qp, kl,
                                                 kv_scales=(ks, vs)),
                              (q, kp, vp, bt, qpos, kvl, ks, vs)))
            else:
                cases.append((f"k4 {dt} Sq{Sq}",
                              lambda q, kp, vp, bt, qp, kl:
                              PA.paged_attention(q, kp, vp, bt, qp, kl),
                              (q, kp, vp, bt, qpos, kvl)))
    for dt, S in ((torch.bfloat16, 384), (torch.bfloat16, 1000),
                  (torch.float32, 200)):
        x = torch.randn((1, S, 4, 64), generator=gen, device=cuda).to(dt)
        dtv = torch.rand((1, S, 4), generator=gen, device=cuda) * 0.1
        A = -torch.rand(4, generator=gen, device=cuda)
        Bc = torch.randn((1, S, 128), generator=gen, device=cuda).to(dt)
        cases.append((f"k6 {dt} S{S}",
                      lambda x, d, A, Bc: K6.ssd_scan(x, d, A, Bc, Bc),
                      (x, dtv, A, Bc)))
    return cases


@pytest.mark.cuda
def test_meta_launch_counts_equal_real_calls(cuda):
    """Each wrapper on ``meta`` copies of the inputs records in an active
    cost ledger the launch, by kernel, route and mark, that the real call
    on the card counts; moves no launch counter (nothing launches); and
    returns a ``meta`` result of the real one's shape and dtype."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.roofline import analysis as RA
    routes = set()
    for name, fn, args in _launch_cases(cuda):
        out = []
        real = _delta(lambda: out.append(fn(*args)))
        torch.cuda.synchronize()
        ledger = RA.CostLedger()
        with RA.use_ledger(ledger):
            moved = _delta(lambda: out.append(fn(*_meta(args))))
        assert real and not moved, (name, real, moved)
        recorded = DR.launch_counters({"launches": ledger.launches,
                                       "launches_marked": ledger.marked})
        assert recorded == real, (name, real, recorded)
        want, got = (o[0] if isinstance(o, tuple) else o for o in out)
        assert got.device.type == "meta" and got.shape == want.shape \
            and got.dtype == want.dtype, name
        routes |= set(real)
    assert {f"matrixflow_gemm_{r}" for r in ("wgmma", "mma", "cuda_core",
                                             "batched", "backward")} \
        | {"matrixflow_gemm_dequant_wgmma", "matrixflow_gemm_dequant_mma"} \
        | {f"flash_attention_{r}" for r in ("rows", "split", "cuda_cores",
                                            "cuda_cores_bf16kv")} \
        | {f"{k}_{r}" for k in ("paged_attention", "paged_attention_int8")
           for r in ("rows", "split", "cuda_cores")} \
        | {f"ssd_scan_{r}" for r in ("walk", "chunks", "cuda_cores")} \
        <= routes


# ---------------------------------------------------------------------------
# The static-analysis gate on the card (chip_smoke.py phase 29): the
# coverage probe at the parity cells, the ops facade
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_analysis_probe_parity_cells(cuda):
    """Each contract of the card sweep's parity cells (K1/K2 of the
    matrixflow backend at the parity shapes, K3 at every head dim it is
    built for, K4 and K5 through the parity block tables) held to its
    ``.cu``: launched through the raw binding into outputs filled with a
    sentinel, every element the contract marks written was overwritten and
    agrees with the plain version."""
    from repro_torch.analysis import probe as PR
    from repro_torch.analysis import sweep as SW
    entries = SW.sweep_gemm(["matrixflow"], device="cuda") \
        + SW.sweep_attention(device="cuda")
    assert all(e.ok for e in entries)
    cells = PR.sweep_cells(entries)
    cells.append(("K1 mma split", "matrixflow_gemm",
                  PR.gemm_cell(8, 576, 1536, torch.bfloat16, bm=16)))
    out = PR.run_probe(cells)
    assert {"matrixflow_gemm/wgmma", "matrixflow_gemm/mma",
            "matrixflow_gemm/cuda_core", "flash_attention/rows",
            "flash_attention/split", "flash_attention/cuda_cores",
            "paged_attention/rows", "paged_attention/split",
            "paged_attention/cuda_cores"} <= set(out["cells"])


@pytest.mark.cuda
def test_analysis_ops_facade_matches_plain(cuda):
    """kernels/ops.py on CUDA tensors: each function launches its kernel
    once (its wrapper's counter moves by one, no other kernel's) and
    agrees with its plain reference (impl="ref")."""
    from repro_torch.analysis import probe as PR
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(0)
    bf = torch.bfloat16
    a = torch.randn((8, 576), generator=gen, device=cuda).to(bf)
    b = torch.randn((576, 1536), generator=gen, device=cuda).to(bf)
    blk = L.BlockLayout(64, 128, 576)
    a_bm, b_bm = (L.to_block_major_a(a, blk.bm, blk.bk),
                  L.to_block_major_b(b, blk.bk, blk.bn))
    q = torch.randn((8, 1, 9, 64), generator=gen, device=cuda).to(bf)
    kv = torch.randn((8, 256, 3, 64), generator=gen, device=cuda).to(bf)
    x = torch.randn((1, 384, 8, 64), generator=gen, device=cuda).to(bf)
    dt = 0.01 + 0.1 * torch.rand((1, 384, 8), generator=gen, device=cuda)
    A = -(0.5 + torch.rand(8, generator=gen, device=cuda))
    Bc = (torch.randn((1, 384, 128), generator=gen, device=cuda) / 8).to(bf)
    wrappers = {"gemm": (MF.matrixflow_gemm_block_major, PR.TOLS),
                "mha": (FA.flash_attention, PR.ATTN_TOLS),
                "ssd": (K6.ssd_scan, PR.SSD_TOLS)}
    for fn, args, kw, key in (
            (ops.gemm, (a, b), {}, "gemm"),
            (ops.gemm_preformatted, (a_bm, b_bm), dict(blk=blk), "gemm"),
            (ops.mha, (q, kv, kv), {}, "mha"),
            (ops.ssd, (x, dt, A, Bc, Bc), {}, "ssd")):
        counted = {n: w.launches for n, (w, _) in wrappers.items()}
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert {n: w.launches - counted[n] for n, (w, _) in wrappers.items()} \
            == {n: int(n == key) for n in wrappers}, fn.__name__
        atol, rtol = wrappers[key][1]["bfloat16"]
        want = fn(*args, **kw, impl="ref").float()
        assert bool((got.float() - want).abs().le(atol + rtol * want.abs())
                    .all()), fn.__name__
