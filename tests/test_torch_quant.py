"""The port's int8 quantizers (repro_torch/core/quant.py) and quantized
packing (repro_torch/core/plan.py) against the JAX package's.

Payloads and scales must match bitwise: both round half to even, divide
in fp32 ``x / s`` and clip to [−127, 127]. The inputs include exact .5
ties on the grid, all-zero rows and channels (scale 1), and late KV rows
past ``KV_HEADROOM`` (clipped, not wrapped).
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layout as JL
from repro.core import quant as JQ
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.core.plan import pack_weight as jpack_weight
from repro_torch.convert import to_tensor
from repro_torch.core import api
from repro_torch.core import layout as L
from repro_torch.core import quant as Q
from repro_torch.core.plan import (AttentionPolicy, GemmPolicy, PackedWeight,
                                   QuantizedPackedWeight, pack_model_weights,
                                   pack_weight)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == to_tensor(want).dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _ties(shape, seed, reduce_axis):
    """A 2-D operand whose quotients by their scale land on exact .5 ties:
    the first entry of every slice along ``reduce_axis`` is 127, so each
    scale is exactly 1, and most other entries are k + 0.5. The first
    slice across it is all zeros (scale 1, payload 0)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-120, 120, shape)).astype(np.float32) + 0.5
    x.flat[::3] = rng.uniform(-120, 120, x.size)[::3]
    v = np.moveaxis(x, reduce_axis, 0)
    v[0] = 127.0
    v[:, 0] = 0.0
    return x


@pytest.mark.parametrize("shape", [(8, 8), (33, 65), (3, 64, 128)], ids=str)
def test_quantize_weight_bitwise(shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0                                    # an all-zero channel
    w[..., 0, 5] = 1e3                                 # one outlier
    q, s = Q.quantize_weight(torch.from_numpy(w))
    jq, js = JQ.quantize_weight(jnp.asarray(w))
    _same(q, jq)
    _same(s, js)
    assert float(s[..., 3].min()) == 1.0
    _same(Q.dequantize_weight(q, s), JQ.dequantize_weight(jq, js))


def test_quantize_ties_round_half_to_even():
    w = _ties((16, 24), 2, reduce_axis=0)             # per output channel
    x = _ties((24, 16), 3, reduce_axis=1)             # per row
    for got, want in ((Q.quantize_weight(torch.from_numpy(w)),
                       JQ.quantize_weight(jnp.asarray(w))),
                      (Q.quantize_activations(torch.from_numpy(x)),
                       JQ.quantize_activations(jnp.asarray(x)))):
        _same(got[0], want[0])
        _same(got[1], want[1])
    # the ties really are ties, and they went to even
    q, s = Q.quantize_weight(torch.from_numpy(w))
    half = np.abs(w - np.trunc(w)) == 0.5
    assert half.sum() > 100 and (s.numpy() == 1.0).all()
    assert (q.numpy()[half] % 2 == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_and_dequantize_gemm_bitwise(dtype):
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((37, 96)).astype(np.float32)
                    ).astype(dtype)
    x = x.at[5].set(0)                                 # an all-zero row
    q, s = Q.quantize_activations(to_tensor(np.asarray(x)))
    jq, js = JQ.quantize_activations(x)
    _same(q, jq)
    _same(s, js)
    # K = 1536-sized sums exceed 2^24: the int32 → fp32 rounding must agree
    c = rng.integers(-2.5e7, 2.5e7, (37, 40)).astype(np.int32)
    sb = np.abs(rng.standard_normal(40)).astype(np.float32) + 1e-3
    for out in ("float32", "bfloat16"):
        got = Q.dequantize_gemm(torch.from_numpy(c), s, torch.from_numpy(sb),
                                getattr(torch, out))
        want = JQ.dequantize_gemm(jnp.asarray(c), js, jnp.asarray(sb),
                                  jnp.dtype(out))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_kv_quantizers_bitwise():
    rng = np.random.default_rng(5)
    pages = rng.standard_normal((5, 8, 3, 16)).astype(np.float32)
    pages[2, :, 1] = 0.0                               # an all-zero head
    q, s = Q.quantize_kv_pages(torch.from_numpy(pages))
    jq, js = JQ.quantize_kv_pages(jnp.asarray(pages))
    _same(q, jq)
    _same(s, js)
    _same(Q.dequantize_kv_pages(q, s), JQ.dequantize_kv_pages(jq, js))
    first = pages[:, 0]                                # (P, Hkv, dh)
    ws = Q.kv_write_scale(torch.from_numpy(first))
    jws = JQ.kv_write_scale(jnp.asarray(first))
    _same(ws, jws)
    # later rows of each page, some far past the headroom: clipped at ±127
    late = pages[:, 1:] * np.asarray([0.5, 1, 4 * Q.KV_HEADROOM, 1, 1, 1, 1],
                                     np.float32)[None, :, None, None]
    got = Q.quantize_kv_rows(torch.from_numpy(late), ws[:, None])
    want = JQ.quantize_kv_rows(jnp.asarray(late), jws[:, None])
    _same(got, want)
    assert int(got.abs().max()) == Q.QMAX


@pytest.mark.parametrize("mode", ["dc", "dm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_pack_matches_jax(mode, dtype):
    """The port's QuantizedPackedWeight against JAX pack_weight(...,
    quantize="int8"): the row-major int8 payload and the scales bitwise,
    and the block-major data bitwise under one shared BlockLayout (the
    port's Hopper geometry)."""
    w = jnp.asarray(np.random.default_rng(6).standard_normal((200, 130))
                    .astype(np.float32)).astype(dtype)
    jpw = jpack_weight(w, JGemmPolicy(mode=mode), quantize="int8")
    pw = pack_weight(to_tensor(np.asarray(w)), GemmPolicy(mode=mode),
                     quantize="int8")
    assert isinstance(pw, QuantizedPackedWeight)
    assert (pw.k, pw.n, pw.mode, pw.dequant_dtype) == \
        (jpw.k, jpw.n, jpw.mode, jpw.dequant_dtype)
    assert pw.dtype == torch.int8
    _same(pw.unpack_quantized(), jpw.unpack_quantized())
    _same(pw.scales, jpw.scales)
    _same(pw.data, JL.to_block_major_b(jpw.unpack_quantized(), pw.bk, pw.bn))
    np.testing.assert_array_equal(pw.unpack().float().numpy(),
                                  np.asarray(jpw.unpack(), np.float32))
    # the geometry is the Hopper chooser's for the int8 itemsize
    blk = L.choose_layout(512, 130, 200, torch.int8, mode=mode)
    assert (pw.bk, pw.bn) == (blk.bk, blk.bn)


def test_pack_model_weights_quantizes_gemm_weights_only():
    params = {"embed": torch.randn(64, 16), "head": torch.randn(16, 64),
              "layers": [{"attn": {"wq": torch.randn(16, 16)},
                          "attn_norm": {"scale": torch.ones(16)}}]}
    for packed in (pack_model_weights(params, quantize="int8"),
                   pack_model_weights(params, GemmPolicy(weight_dtype="int8"))):
        assert isinstance(packed["head"], QuantizedPackedWeight)
        assert isinstance(packed["layers"][0]["attn"]["wq"],
                          QuantizedPackedWeight)
        assert packed["embed"] is params["embed"]
        assert packed["layers"][0]["attn_norm"]["scale"] is \
            params["layers"][0]["attn_norm"]["scale"]
    assert isinstance(pack_model_weights(params)["head"], PackedWeight)


def test_policy_rejects_unknown_weight_dtype():
    """tests/test_quant.py's refusals, on the port. The port's GemmPolicy
    has no acc_dtype knob, so that refusal has nothing to refuse."""
    with pytest.raises(ValueError, match="weight_dtype"):
        GemmPolicy(weight_dtype="int4")
    with pytest.raises(ValueError, match="quantize"):
        pack_weight(torch.ones((8, 8)), quantize="fp8")
    with pytest.raises(ValueError, match="weight_dtype"):
        JGemmPolicy(weight_dtype="int4")
    assert GemmPolicy(weight_dtype="int8").weight_dtype == "int8"
    assert api.GemmPolicy is GemmPolicy


def test_policy_rejects_unknown_kv_dtype():
    """tests/test_kv_quant.py's refusals, on the port."""
    with pytest.raises(ValueError, match="kv_dtype"):
        AttentionPolicy(kv_dtype="int4")
    with pytest.raises(ValueError, match="kv_dtype"):
        JAttentionPolicy(kv_dtype="int4")
    assert AttentionPolicy(kv_dtype="int8").kv_dtype == "int8"
