"""The SSD scan's routes on the card (repro_torch/kernels/ssd_scan.py, the
wrapper of K6), in the parts that run without one: the route chooser and
its tile and segment plan at the served shapes, the checks the wrapper
makes before it launches, and the tensor-core routes' algorithm — 64-step
tiles whatever Q is, segments whose states are composed by a pass —
written out in PyTorch and held against the JAX package's chunked scan.

Served shapes: mamba2-1.3b (H 64, P 64, N 128) prefills of 8 x 384 (Q 128),
8 x 64 (Q 64), 1 x 200 (Q 100), 1 x 131 (Q 1), 2 x 1000 (Q 125) and
1 x 4096; zamba2-2.7b (H 80, N 64) at 8 x 64; the engine tests' Q 37.
The kernels themselves run on the card only (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JSSM
from repro_torch.kernels import ssd_scan as K6

CHUNKED_TOL = 1e-4      # tests/test_ssm.py, ssd_chunked

# (S, P, N, route, tiles, segments): the served shapes
SERVED = [(384, 64, 128, "walk", 6, 1), (64, 64, 128, "walk", 1, 1),
          (200, 64, 128, "walk", 4, 1), (131, 64, 128, "walk", 3, 1),
          (37, 64, 128, "walk", 1, 1), (1000, 64, 128, "chunks", 16, 2),
          (4096, 64, 128, "chunks", 64, 8), (64, 64, 64, "walk", 1, 1),
          (512, 64, 128, "walk", 8, 1), (513, 64, 128, "chunks", 9, 2)]


@pytest.mark.parametrize("S,P,N,route,tiles,segments", SERVED)
def test_route_and_plan_at_served_shapes(S, P, N, route, tiles, segments):
    assert K6.route_for(torch.bfloat16, S, P, N) == route
    assert K6.route_for(torch.float32, S, P, N) == "cuda_cores"
    plan = K6.tile_plan(S, P, N)
    assert (plan["tiles"], plan["segments"]) == (tiles, segments)
    assert plan["scratch_floats"] == (segments - 1) * (P * N + 1)
    # the last tile holds the rest; no tile is empty
    assert 0 < S - (tiles - 1) * K6.TILE <= K6.TILE


@pytest.mark.parametrize("S,Q", [(384, 128), (64, 64), (200, 100),
                                 (131, 1), (37, 37), (1000, 125)])
def test_plan_does_not_depend_on_q(S, Q):
    """The wrapper derives Q as the reference does (and bounds it), but the
    tensor-core routes tile by TILE steps whatever Q is: Q 1, 37, 100 and
    125 run as 64-step tiles, the last one short."""
    ops = _operands(B=1, S=S, H=2)
    assert K6.check_operands(*ops)[1] == Q
    plan = K6.tile_plan(S, 8, 16)
    assert plan["tiles"] == -(-S // K6.TILE)


@pytest.mark.parametrize("P,N", [(80, 64), (64, 256), (128, 128)])
def test_route_raises_where_no_tensor_core_route(P, N):
    with pytest.raises(ValueError, match="no tensor-core"):
        K6.route_for(torch.bfloat16, 384, P, N)
    assert K6.route_for(torch.float32, 384, P, N) == "cuda_cores"


def _operands(B=2, S=64, H=3, P=8, N=16, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((B, S, H, P), generator=g).to(dtype),
            torch.rand((B, S, H), generator=g),
            -torch.rand((H,), generator=g),
            torch.randn((B, S, N), generator=g).to(dtype),
            torch.randn((B, S, N), generator=g).to(dtype))


@pytest.mark.parametrize("dtype,S,route", [(torch.bfloat16, 64, "walk"),
                                           (torch.bfloat16, 600, "chunks"),
                                           (torch.float32, 600,
                                            "cuda_cores")])
def test_check_operands_routes(dtype, S, route):
    assert K6.check_operands(*_operands(S=S, dtype=dtype)) == (
        route, K6.ssd_chunk_size(S, 128))


@pytest.mark.parametrize("bad,match", [
    (lambda o: (o[0], o[1], o[2], o[3].float(), o[4]), "dtype"),
    (lambda o: (o[0].half(), o[1], o[2], o[3].half(), o[4].half()), "dtype"),
    (lambda o: (o[0], o[1].double(), o[2], o[3], o[4]), "dtype"),
    (lambda o: (o[0], o[1][:, :-1], o[2], o[3], o[4]), "disagree"),
    (lambda o: (o[0], o[1], o[2][:-1], o[3], o[4]), "disagree"),
    (lambda o: (o[0], o[1], o[2], o[3][..., :-1], o[4]), "disagree"),
    (lambda o: (o[0], o[1], o[2].to("meta"), o[3], o[4]), "meta"),
])
def test_check_operands_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        K6.check_operands(*bad(_operands()))


def test_check_operands_rejects_long_chunk_and_wide_bf16():
    with pytest.raises(ValueError, match="exceeds"):
        K6.check_operands(*_operands(S=192), chunk=192)
    with pytest.raises(ValueError, match="no tensor-core"):
        K6.check_operands(*_operands(P=80))
    assert K6.check_operands(*_operands(P=80, dtype=torch.float32))[0] \
        == "cuda_cores"


def test_cpu_wrapper_counts_no_route():
    before = dict(K6.ssd_scan.launches_by_route)
    y, h = K6.ssd_scan(*_operands())
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert K6.ssd_scan.launches_by_route == before
    with pytest.raises(ValueError, match="device"):
        K6.ssd_scan(*(t.to("meta") for t in _operands()))


def _tiled_scan(x, dt, A, Bc, Cc, seg_tiles):
    """The tensor-core routes' algorithm in float64: TILE-step tiles (the
    last one short), each tile's y = (L ∘ C Bᵀ) dtx + exp(cum) ∘ (C hᵀ)
    and state h ← exp(cum_T) h + (exp(cum_T − cum) ∘ dtx)ᵀ B; the tiles
    cut into segments of ``seg_tiles``, every segment's state from zero
    and its decay G, the pass h_k+1 = G_k h_k + S_k, then each segment
    walked from its starting state."""
    Bsz, S, H, P = x.shape
    N = Bc.shape[-1]
    T = K6.TILE
    x, dt, A, Bc, Cc = (t.double() for t in (x, dt, A, Bc, Cc))

    def tile(h, s0, want_y):
        s1 = min(S, s0 + T)
        a = (dt[:, s0:s1] * A).transpose(1, 2)                  # (B, H, R)
        cum = torch.cumsum(a, -1)
        dtx = (x[:, s0:s1] * dt[:, s0:s1, :, None]).transpose(1, 2)
        bq, cq = Bc[:, s0:s1], Cc[:, s0:s1]
        y = None
        if want_y:
            R = s1 - s0
            low = torch.tril(torch.ones(R, R, dtype=torch.bool))
            L = torch.exp(torch.where(low, cum[..., :, None]
                                      - cum[..., None, :], -torch.inf))
            y = torch.matmul(L * torch.matmul(cq, bq.transpose(1, 2))[:, None],
                             dtx) + torch.matmul(cq[:, None], h.transpose(
                                 -1, -2)) * torch.exp(cum)[..., None]
        w = dtx * torch.exp(cum[..., -1:] - cum)[..., None]
        h = h * torch.exp(cum[..., -1])[..., None, None] \
            + torch.matmul(w.transpose(-1, -2), bq[:, None])
        return h, y, torch.exp(cum[..., -1])

    tiles = -(-S // T)
    segs = -(-tiles // seg_tiles)
    zero = torch.zeros((Bsz, H, P, N), dtype=torch.float64)
    starts = [zero]
    for k in range(segs - 1):                   # segment states, then the pass
        s, g = zero, torch.ones((Bsz, H), dtype=torch.float64)
        for t in range(k * seg_tiles, (k + 1) * seg_tiles):
            s, _, gt = tile(s, t * T, False)
            g = g * gt
        starts.append(g[..., None, None] * starts[-1] + s)
    ys, h = [], None
    for k in range(segs):                       # each segment from its start
        h = starts[k]
        for t in range(k * seg_tiles, min(tiles, (k + 1) * seg_tiles)):
            h, y, _ = tile(h, t * T, True)
            ys.append(y)
    return torch.cat(ys, 2).transpose(1, 2), h


@pytest.mark.parametrize("S,chunk,seg_tiles", [
    (200, 128, 8), (200, 128, 1), (131, 128, 2), (300, 128, 2),
    (64, 16, 8), (37, 128, 1)])
def test_tiled_algorithm_matches_jax_chunked(S, chunk, seg_tiles):
    """The routes' algorithm, at the reference's Q or not, against the JAX
    package's ssd_chunked: y and the final state within tests/test_ssm.py's
    1e-4."""
    rng = np.random.default_rng(S + seg_tiles)
    B, H, P, N = 2, 3, 8, 16
    arrays = [rng.standard_normal((B, S, H, P)).astype(np.float32),
              np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(
                  np.float32),
              (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32),
              (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32),
              (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)]
    want_y, want_h = JSSM.ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    y, h = _tiled_scan(*map(torch.from_numpy, arrays), seg_tiles)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                               atol=CHUNKED_TOL, rtol=CHUNKED_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                               atol=CHUNKED_TOL, rtol=CHUNKED_TOL)
