"""Card tests of the port: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, and the serving engine on the card
against the same engine on the CPU (where the wrappers run the plain
versions).

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the JAX package, so it also runs on a machine
with the card and without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The GEMM shapes are tests/parity.py's SHAPES (copied: importing parity
would import JAX) plus two full-width smollm-135m projections; the
attention tolerances are its ATTN_TOLS.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import layout as L
from repro_torch.core.plan import AttentionPolicy
from repro_torch.kernels import matrixflow_gemm as MF
from repro_torch.kernels import paged_attention as PA
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
    B, Sq, H, Hkv, D, ps, lens, starts = case
    q, kp, vp, bt, qpos, kvl = _paged_inputs(cuda, dtype, B, Sq, H, Hkv, D,
                                             ps, lens, starts)
    before = PA.paged_attention.launches
    got = PA.paged_attention(q, kp, vp, bt, qpos, kvl)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    want = PA.paged_attention_plain(q, kp, vp, bt, qpos, kvl, causal=True,
                                    scale=D ** -0.5, soft_cap=None)
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
