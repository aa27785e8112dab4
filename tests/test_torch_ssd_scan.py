"""The port's SSD scan (repro_torch/kernels/ssd_scan.py, the wrapper of
K6, and its plain version kernels/ref.py::ssd_chunked_ref) against the
JAX package: its Pallas SSD kernel in interpret mode
(``repro.kernels.ops.ssd(..., impl="interpret")``) on
tests/test_flash_ssd_kernels.py's SSD_CASES at that file's tolerance
(5e-4), and the model's ``ssd_chunked`` — y and the final state — at
tests/test_ssm.py's (1e-4), over chunk counts of one, several, a chunk
that does not divide evenly into powers of two and a prime length (Q = 1).

Inputs are made with numpy from a seed and handed to both packages in
fp32. On the CPU the wrapper runs the plain version and launches nothing;
the CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_flash_ssd_kernels import SSD_CASES

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_size as jssd_chunk_size
from repro.models import ssm as JSSM
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as K6

SSD_TOL = 5e-4          # tests/test_flash_ssd_kernels.py, kernel vs oracle
CHUNKED_TOL = 1e-4      # tests/test_ssm.py, ssd_chunked


def _inputs(seed, B, S, H, P, N, dt_scale=1.0):
    """x, dt (softplus of a normal), A = −exp(0.5·normal), B/C — the JAX
    tests' distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bc = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cc = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    return x, dt * dt_scale, A, Bc, Cc


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=lambda c: "B{}S{}H{}P{}N{}q{}".format(*c))
def test_plain_matches_jax_ssd_kernel(case):
    B, S, H, P, N, chunk = case
    arrays = _inputs(sum(case), B, S, H, P, N)
    want = np.asarray(jops.ssd(*map(jnp.asarray, arrays), chunk=chunk,
                               impl="interpret"))
    before = K6.ssd_scan.launches
    y, state = K6.ssd_scan(*_port(*arrays), chunk=chunk)
    assert K6.ssd_scan.launches == before                  # CPU: no launch
    assert y.dtype == torch.float32 and state.shape == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), want, atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 32, 2, 8, 16, 8),        # test_ssd_kernel_matches_model_chunked
    (2, 48, 2, 8, 16, 16),       # S = 48 with chunk 16: three chunks
    (1, 200, 2, 8, 16, 128),     # Q = 100: the largest divisor <= 128
    (1, 37, 3, 4, 8, 16),        # prime S: Q = 1, 37 chunks
    (1, 24, 2, 8, 16, 128),      # one chunk: Q = S
])
def test_plain_matches_model_ssd_chunked(B, S, H, P, N, chunk):
    """y and the state after the last chunk (which the prefill with a
    cache stores) against the model's ssd_chunked."""
    arrays = _inputs(S * 7 + chunk, B, S, H, P, N)
    want_y, want_h = JSSM.ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    y, h = K6.ssd_scan(*_port(*arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                               atol=CHUNKED_TOL, rtol=CHUNKED_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                               atol=CHUNKED_TOL, rtol=CHUNKED_TOL)
    y2, none = K6.ssd_scan(*_port(*arrays), chunk=chunk, final_state=False)
    assert none is None and torch.equal(y2, y)


@pytest.mark.parametrize("S", [1, 16, 33])
def test_sequential_oracle_matches_jax_and_chunked(S):
    """The port's ssd_ref against the JAX one, and the chunked scan
    against the port's oracle."""
    arrays = _inputs(S, 2, S, 3, 4, 8)
    want = np.asarray(jref.ssd_ref(*map(jnp.asarray, arrays)))
    got = ref.ssd_ref(*_port(*arrays))
    np.testing.assert_allclose(got.numpy(), want, atol=CHUNKED_TOL,
                               rtol=CHUNKED_TOL)
    y, _ = K6.ssd_scan(*_port(*arrays), chunk=8)
    np.testing.assert_allclose(y.numpy(), got.numpy(), atol=CHUNKED_TOL,
                               rtol=CHUNKED_TOL)


def test_decay_extremes_finite():
    """dt = 20 with A = −8 (tests/test_flash_ssd_kernels.py): the masked
    decays above the diagonal would overflow if evaluated."""
    x, _, _, Bc, Cc = _inputs(9, 1, 16, 1, 4, 8)
    dt = np.full((1, 16, 1), 20.0, np.float32)
    A = np.asarray([-8.0], np.float32)
    y, h = K6.ssd_scan(*_port(x, dt, A, Bc, Cc), chunk=4)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    want = np.asarray(jops.ssd(*map(jnp.asarray, (x, dt, A, Bc, Cc)),
                               chunk=4, impl="interpret"))
    np.testing.assert_allclose(y.numpy(), want, atol=SSD_TOL, rtol=SSD_TOL)


def test_chunk_size_matches_jax():
    for S in (1, 2, 7, 37, 64, 100, 128, 131, 200, 384, 1000, 4096):
        for chunk in (1, 4, 16, 128):
            assert K6.ssd_chunk_size(S, chunk) == jssd_chunk_size(S, chunk)
    assert K6.ssd_chunk_size(1000, 128) == 125
    assert K6.ssd_chunk_size(131, 128) == 1


def test_bf16_output_and_rejections():
    """bf16 x, B, C give a bf16 y rounded once from the fp32 sum, the
    state staying fp32; mismatched shapes and devices the kernel has not
    raise."""
    x, dt, A, Bc, Cc = _port(*_inputs(3, 2, 32, 2, 8, 16))
    y32, h32 = K6.ssd_scan(x.bfloat16().float(), dt, A,
                           Bc.bfloat16().float(), Cc.bfloat16().float(),
                           chunk=8)
    y16, h16 = K6.ssd_scan(x.bfloat16(), dt, A, Bc.bfloat16(), Cc.bfloat16(),
                           chunk=8)
    assert y16.dtype == torch.bfloat16 and h16.dtype == torch.float32
    assert torch.equal(y16, y32.bfloat16()) and torch.equal(h16, h32)
    with pytest.raises(ValueError, match="disagree"):
        K6.ssd_scan(x, dt[:, :-1], A, Bc, Cc)
    with pytest.raises(ValueError, match="is on"):
        K6.ssd_scan(x.to("meta"), dt, A, Bc, Cc)
