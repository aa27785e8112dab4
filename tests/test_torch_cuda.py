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
head_dim 80) and smollm-135m's contiguous decode and prefill.
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
], ids=["decode_full_width", "prefill_bucket_full_width", "decode_gqa2",
        "chunk_offset", "mqa_d128_page32"])
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
], ids=["decode_full_width", "prefill_bucket_full_width", "decode_gqa2",
        "chunk_offset"])
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
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_TC_GEOMETRIES), ids=str)
def test_tensor_core_routes_at_each_geometry(cuda, case):
    kind, B, Sq, Sk, H, Hkv, D, ps, lens, starts = _TC_GEOMETRIES[case]
    fn = FA.flash_attention if kind == "flash" else PA.paged_attention
    route = FA.route_for(torch.bfloat16, Sq, H // Hkv)
    assert route == ("split" if Sq * H // Hkv <= 16 else "rows")
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


@pytest.mark.cuda
def test_tensor_core_routes_reject(cuda):
    """No fallback: a CUDA bf16 geometry the tensor-core kernels do not take
    raises before anything launches."""
    bf = torch.bfloat16
    flash, paged = dict(FA.flash_attention.launches_by_route), \
        dict(PA.paged_attention.launches_by_route)
    q = torch.zeros((1, 1, 4, 32), dtype=bf, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):     # D 32: K3 takes 64, 80
        FA.flash_attention(q, q, q)
    q = torch.zeros((1, 1, 17, 64), dtype=bf, device=cuda)
    with pytest.raises(ValueError, match="GQA group"):
        FA.flash_attention(q, q[:, :, :1], q[:, :, :1])
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
