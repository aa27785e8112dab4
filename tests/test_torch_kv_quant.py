"""int8 KV pages in the port: the plain version of K5 (the int8 branch of
kernels/paged_attention.py) against the JAX package's paged kernel in
interpret mode, and the int8 write path of models/layers.py against the
JAX ``_paged_cache_update``.

* K5's plain version reads int8 pools with per-(page, kv head) fp32
  scales through shuffled block tables over garbage distractor pages, on
  tests/parity.py's attention cases (``check_quantized_attention_cell``'s
  grid), within ATTN_TOLS; masked rows are exactly zero.
* The write path freezes a page's scale at its first row; its payload and
  scales are bitwise JAX's, and bitwise the same whether a sequence is
  written token by token, in chunks or in bulk (the invariant
  preempt/resume rests on; tests/test_kv_quant.py proves it for JAX).
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import ATTN_CASES, ATTN_TOLS, make_attention_operands, \
    make_paged_operands

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import quant as JQ
from repro.kernels.paged_attention import gather_pages as jgather
from repro.kernels.paged_attention import paged_attention as jpaged
from repro.kernels.ref import mha_ref as jmha_ref
from repro.models import layers as JL
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import to_tensor
from repro_torch.core import api
from repro_torch.core.plan import FUSED, UNFUSED, AttentionPolicy
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as Lyr

PAGED_INT8 = AttentionPolicy(backend="paged", kv_dtype="int8")


def _port(*xs):
    return [None if x is None else to_tensor(np.asarray(x)) for x in xs]


def _int8_cell(case, q_dtype):
    q, k, v, qpos, kvl = make_attention_operands(case, "float32")
    kp, vp, bt = make_paged_operands(k, v)
    qk, ks = JQ.quantize_kv_pages(kp)
    qv, vs = JQ.quantize_kv_pages(vp)
    return q.astype(q_dtype), qk, qv, ks, vs, bt, qpos, kvl, k.shape[1]


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: c.name)
def test_int8_plain_matches_jax_kernel(case, q_dtype):
    """JAX's paged kernel with kv_scales (interpret mode) and the oracle of
    check_quantized_attention_cell (mha_ref over the dequantized pool)."""
    q, qk, qv, ks, vs, bt, qpos, kvl, T = _int8_cell(case, q_dtype)
    want = np.asarray(jpaged(q, qk, qv, bt, qpos, kvl, kv_scales=(ks, vs),
                             causal=case.causal, block_q=32,
                             interpret=True).astype(jnp.float32))
    before = (PA.paged_attention.launches, PA.paged_attention.launches_int8)
    tq, tqk, tqv, tks, tvs, tbt, tqpos, tkvl = _port(q, qk, qv, ks, vs, bt,
                                                     qpos, kvl)
    got = api.attention(tq, tqk, tqv, q_positions=tqpos, kv_valid_len=tkvl,
                        causal=case.causal, block_tables=tbt,
                        kv_scales=(tks, tvs), policy=PAGED_INT8)
    assert (PA.paged_attention.launches,
            PA.paged_attention.launches_int8) == before    # CPU: no launch
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    atol, rtol = ATTN_TOLS[q_dtype]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    oracle = np.asarray(jmha_ref(
        q.astype(jnp.float32),
        jgather(JQ.dequantize_kv_pages(qk, ks), bt, T),
        jgather(JQ.dequantize_kv_pages(qv, vs), bt, T),
        causal=case.causal, q_positions=qpos, kv_valid_len=kvl))
    np.testing.assert_allclose(got, oracle, atol=atol, rtol=rtol)
    masked = np.asarray(qpos)[:, 0] < 0
    assert not masked.any() or np.abs(got[masked]).max() == 0.0


def test_int8_plain_does_not_round_p_for_bf16_q():
    """The TPU kernel dequantizes a page to fp32 before the block step, so
    p.astype(v.dtype) is fp32 and p is not rounded to q's dtype: a bf16 q
    over int8 pages equals the fp32 recurrence on the same (bf16) q values,
    rounded once at the end."""
    case = ATTN_CASES[2]
    q, qk, qv, ks, vs, bt, qpos, kvl, _ = _int8_cell(case, "bfloat16")
    tq, tqk, tqv, tks, tvs, tbt, tqpos, tkvl = _port(q, qk, qv, ks, vs, bt,
                                                     qpos, kvl)
    got = PA.paged_attention(tq, tqk, tqv, tbt, tqpos, tkvl,
                             kv_scales=(tks, tvs))
    f32 = PA.paged_attention(tq.float(), tqk, tqv, tbt, tqpos, tkvl,
                             kv_scales=(tks, tvs))
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_int8_wrapper_validation():
    """The errors of the JAX wrapper (paged_attention.py:275-295), on the
    port; the port's P counts the sink page like any other."""
    q, qk, qv, ks, vs, bt, qpos, kvl = _port(
        *_int8_cell(ATTN_CASES[0], "float32")[:8])
    kp = qk.float()
    with pytest.raises(ValueError, match="dtype mismatch"):
        PA.paged_attention(q, qk, kp, bt, kv_scales=(ks, vs))
    with pytest.raises(ValueError, match="need kv_scales"):
        PA.paged_attention(q, qk, qv, bt)
    with pytest.raises(ValueError, match=r"k_scales has shape"):
        PA.paged_attention(q, qk, qv, bt, kv_scales=(ks[:-1], vs))
    with pytest.raises(ValueError, match=r"v_scales has shape"):
        PA.paged_attention(q, qk, qv, bt, kv_scales=(ks, vs.T))
    with pytest.raises(ValueError, match="not int8"):
        PA.paged_attention(q, kp, kp, bt, kv_scales=(ks, vs))
    # only the paged backend takes kv_scales, and only with a block table
    for pol in (FUSED, UNFUSED):
        with pytest.raises(ValueError, match="quantized KV"):
            api.attention(q, kp, kp, q_positions=qpos, kv_valid_len=kvl,
                          kv_scales=(ks, vs), policy=pol)
    with pytest.raises(ValueError, match="kv_scales"):
        api.attention(q, q, q, q_positions=qpos, kv_valid_len=kvl,
                      kv_scales=(ks, vs), policy=PAGED_INT8)



# B, Sq, H, Hkv, ps, table entries, the route bf16 q takes over int8 pools
# (K3's chooser, shared with K4) and its split count: smollm-135m's decode
# step, 64-column prefill and 32-column chunk, and a long cache.
_INT8_ROUTES = [
    (8, 1, 9, 3, 16, 16, "split", 1),
    (8, 64, 9, 3, 16, 16, "rows", 0),
    (8, 32, 9, 3, 16, 16, "rows", 0),
    (8, 1, 9, 3, 8, 256, "split", 8),
    (2, 5, 6, 2, 32, 8, "split", 1),
]


@pytest.mark.parametrize("case", _INT8_ROUTES, ids=str)
def test_int8_routes_reuse_the_attention_choosers(case):
    """K5 takes K4's routes by q's dtype: bf16 q on split or rows, fp32 q
    on the CUDA cores, with the same split count."""
    B, Sq, H, Hkv, ps, nb, route, splits = case
    assert PA.route_for(torch.bfloat16, Sq, H // Hkv) == route
    assert PA.route_for(torch.float32, Sq, H // Hkv) == "cuda_cores"
    if route == "split":
        assert PA.split_count(B, Hkv, nb * ps) == splits
    PA.check_tc_geometry(route, ps, 64, 64, nb)


@pytest.mark.parametrize("ps,D,Dv,nb", [(4, 64, 64, 2), (64, 64, 64, 2),
                                        (16, 24, 24, 2), (16, 64, 32, 2),
                                        (16, 64, 64, PA.MAX_TABLE + 1)])
def test_tc_geometry_refusals(ps, D, Dv, nb):
    """The geometries the tensor-core kernels refuse (K4 over bf16 pools,
    K5 over int8 pools) raise on both of their routes; the CUDA-core
    route takes them (within its own limits, checked by the wrapper)."""
    for route in ("split", "rows"):
        with pytest.raises(ValueError, match="bf16 kernels take"):
            PA.check_tc_geometry(route, ps, D, Dv, nb)
    PA.check_tc_geometry("cuda_cores", ps, D, Dv, nb)


def test_int8_cpu_call_counts_no_route():
    """On CPU tensors K5's wrapper runs the plain version: no launch, no
    route counted."""
    q, qk, qv, ks, vs, bt, qpos, kvl = _port(
        *_int8_cell(ATTN_CASES[0], "bfloat16")[:8])
    before = (PA.paged_attention.launches_int8,
              dict(PA.paged_attention.launches_int8_by_route))
    PA.paged_attention(q, qk, qv, bt, qpos, kvl, kv_scales=(ks, vs))
    assert (PA.paged_attention.launches_int8,
            PA.paged_attention.launches_int8_by_route) == before
    assert set(before[1]) == {"rows", "split", "cuda_cores"}

def _configs():
    kw = dict(n_layers=2, vocab=64, dtype="float32")
    return jget_smoke_config("smollm-135m", **kw), \
        get_smoke_config("smollm-135m", **kw)


def test_int8_write_path_matches_jax():
    """A bucketed prefill (padding columns and a masked row), a chunk and
    two decode steps through the same shuffled block tables: after each
    write, payload and scales bitwise JAX's on the first P pages (the
    port's extra sink page absorbs the masked writes)."""
    jcfg, cfg = _configs()
    B, ps, P = 3, 8, 9
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    bt = np.asarray([[4, 0, 7], [2, 8, 5], [1, 3, 6]], np.int32)
    rng = np.random.default_rng(12)
    jc = JL.init_paged_attention_cache(jcfg, B, P, ps, jnp.float32,
                                       kv_dtype="int8")
    tc = Lyr.init_paged_attention_cache(cfg, B, P, ps, torch.float32, "cpu",
                                        kv_dtype="int8")
    assert tc["kp"].shape[0] == P + 1 and tc["k_scale"].shape == (P + 1, Hkv)
    pos_prefill = np.full((B, 16), -1, np.int32)
    pos_prefill[0, :11] = np.arange(11)               # 5 padding columns
    pos_prefill[2, :16] = np.arange(16)               # row 1 masked
    steps = [pos_prefill,
             np.asarray([[11, 12, 13, 14, 15], [0, 1, 2, 3, 4],
                         [-1] * 5], np.int32),        # a chunk, row 2 masked
             np.asarray([[16], [5], [16]], np.int32),  # decode: new pages
             np.asarray([[17], [-1], [17]], np.int32)]
    for positions in steps:
        shape = positions.shape + (Hkv, dh)
        k = (rng.standard_normal(shape) * 3).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        k[..., 0, :] *= 10                             # late outliers
        jc = JL._paged_cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(positions), jnp.asarray(bt))
        Lyr._paged_cache_update(tc, *_port(k, v, positions, bt))
        for leaf in ("kp", "vp", "k_scale", "v_scale"):
            np.testing.assert_array_equal(tc[leaf][:P].numpy(),
                                          np.asarray(jc[leaf]), err_msg=leaf)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_int8_write_granularity_bitwise():
    """tests/test_kv_quant.py:92 on the port: token at a time, in chunks
    or in bulk, byte-identical pools and scales; untouched pages keep
    ones-scales and zero payloads."""
    _, cfg = _configs()
    B, T, ps, P = 1, 12, 8, 4
    rng = np.random.default_rng(11)
    k = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32))
    bt = torch.tensor([[2, 0]], dtype=torch.int32)

    def write(chunks):
        cache = Lyr.init_paged_attention_cache(cfg, B, P, ps, torch.float32,
                                               "cpu", kv_dtype="int8")
        t0 = 0
        for n in chunks:
            pos = torch.arange(t0, t0 + n, dtype=torch.int32)[None]
            Lyr._paged_cache_update(cache, k[:, t0:t0 + n], v[:, t0:t0 + n],
                                    pos, bt)
            t0 += n
        return cache

    bulk = write([T])
    for chunks in ([1] * T, [5, 7], [8, 4], [3, 3, 3, 3]):
        got = write(chunks)
        for leaf in ("kp", "vp", "k_scale", "v_scale", "len"):
            assert torch.equal(got[leaf], bulk[leaf]), (leaf, chunks)
    untouched = [1, 3]
    for leaf in ("k_scale", "v_scale"):
        assert (bulk[leaf][untouched] == 1.0).all()
    for leaf in ("kp", "vp"):
        assert (bulk[leaf][untouched] == 0).all()


def test_int8_attention_layer_reads_the_pool_it_wrote():
    """The layer's int8 branch end to end: after an int8 write, attention
    through the paged policy equals attention over the dequantized pool."""
    _, cfg = _configs()
    B, S, ps, P = 2, 8, 8, 4
    bt = torch.tensor([[3, 1], [0, 2]], dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    p = Lyr.init_attention(gen, cfg, torch.float32, "cpu")
    cache = Lyr.init_paged_attention_cache(cfg, B, P, ps, torch.float32,
                                           "cpu", kv_dtype="int8")
    with api.use_attention_policy(PAGED_INT8):
        y, cache = Lyr.attention(p, cfg, x, positions=pos, cache=cache,
                                 block_tables=bt)
    fp = {"kp": cache["kp"].float() * cache["k_scale"][:, None, :, None],
          "vp": cache["vp"].float() * cache["v_scale"][:, None, :, None]}
    q = Lyr.rope(api.linear(x, p["wq"]).reshape(B, S, cfg.n_heads,
                                                cfg.head_dim),
                 pos, cfg.rope_theta)
    out = PA.paged_attention(q, fp["kp"], fp["vp"], bt, pos, cache["len"],
                             scale=cfg.head_dim ** -0.5)
    want = api.linear(out.reshape(B, S, -1), p["wo"])
    torch.testing.assert_close(y, want, atol=1e-6, rtol=1e-6)


def test_init_paged_cache_rejects_unknown_kv_dtype():
    _, cfg = _configs()
    with pytest.raises(ValueError, match="kv_dtype"):
        Lyr.init_paged_attention_cache(cfg, 1, 4, 8, torch.float32, "cpu",
                                       kv_dtype="fp8")
