"""Where two int8 runs of the port part, and why.

Every int8 value on the serving path is ``round(x / s)`` on a grid whose
.5 ties are real: a KV page's first row puts its largest value exactly on
one (amax / (amax · KV_HEADROOM / QMAX) = 63.5), and W8A8 activations land
near one now and then. Two runs whose fp32 values differ by an ulp (two
packages, or the card and the CPU, summing in other orders) can then
round one value differently; one int8 step changes a GEMM row or a key by
a whole quantization step, and greedy streams can part well away from a
logit near-tie.

:class:`Recorder` records each quantization of a run of the port — each
W8A8 GEMM input (``quantize_activations``) and each KV write
(``quantize_kv_rows``) — and :func:`check_tie_flip` holds two runs'
records to the claim that they agree to fp32 noise up to the first
differing int8 value, which differs by exactly one step on a tie.
Imports nothing of JAX (tests/test_torch_cuda.py runs without it).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import quant as Q


def row_scales(x: np.ndarray) -> np.ndarray:
    """quantize_activations' per-row scale, (…, 1)."""
    amax = np.abs(x).max(-1, keepdims=True)
    return np.where(amax > 0, amax / Q.QMAX, 1).astype(np.float32)


class Recorder:
    """Context manager: (fp32 values, scale, int8 payload) per call, in
    call order, as numpy arrays on the host."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.saved = (Q.quantize_activations, Q.quantize_kv_rows)
        qa, qkv = self.saved

        def act(x):
            out = qa(x)
            xf = x.float().cpu().numpy()
            self.calls.append((xf, row_scales(xf), out[0].cpu().numpy()))
            return out

        def kv(rows, scales):
            out = qkv(rows, scales)
            self.calls.append((rows.float().cpu().numpy(),
                               scales.float().cpu().numpy()[..., None],
                               out.cpu().numpy()))
            return out

        Q.quantize_activations, Q.quantize_kv_rows = act, kv
        return self

    def __exit__(self, *exc):
        Q.quantize_activations, Q.quantize_kv_rows = self.saved


def _aligned(a, b):
    """One call of both runs: the same rows when the shapes agree; else
    (an LM head run over every prefill column in one run and the last
    one in the other) each row of ``a`` beside the nearest row of ``b``."""
    (ax, as_, aq), (bx, bs, bq) = a, b
    if ax.shape == bx.shape:
        return ax, as_, aq, bx, bs, bq
    near = np.abs(ax[:, None] - bx[None]).max(-1).argmin(1)
    return ax, as_, aq, bx[near], bs[near], bq[near]


def check_tie_flip(calls_a, calls_b, **report) -> dict:
    """Assert that two runs' quantizations agree to fp32 noise (values and
    scales within 1e-5 relative) up to the first call whose int8 payloads
    differ, and that there every differing value differs by exactly one
    step and sits within 1e-3 of a .5 tie. Returns the report."""
    assert len(calls_a) == len(calls_b) > 0, (len(calls_a), len(calls_b))
    calls = [_aligned(a, b) for a, b in zip(calls_a, calls_b)]
    n_diff = [int((aq != bq).sum()) for _, _, aq, _, _, bq in calls]
    first = next((g for g, n in enumerate(n_diff) if n), None)
    report.update(first_flip_call=first, quantize_calls=len(calls),
                  int8_diffs_total=sum(n_diff),
                  int8_diffs_first=n_diff[first] if first is not None else 0)
    assert first is not None, report
    for ax, as_, _, bx, bs, _ in calls[:first + 1]:
        assert np.abs(ax - bx).max() <= 1e-5 * max(np.abs(bx).max(), 1), \
            report
        assert np.allclose(as_, bs, rtol=1e-5, atol=0), report
    _, _, aq, bx, bs, bq = calls[first]
    flips = aq != bq
    assert (np.abs(aq[flips].astype(int) - bq[flips]) == 1).all(), report
    scaled = np.broadcast_to(bx / bs, bx.shape)[flips]
    assert (np.abs(np.abs(scaled - np.trunc(scaled)) - 0.5) < 1e-3).all(), \
        report
    return report
