"""The port's paged attention (repro_torch/kernels/paged_attention.py)
against the JAX package's Pallas kernel in interpret mode.

On the CPU the wrapper runs its plain version (the kernel's per-page
online-softmax recurrence); the cases cover what only the paged layout can
break — shuffled block tables over garbage distractor pages, decode
(Sq = 1), a bucketed prefill with position −1 padding columns and masked
rows, GQA (rep 2 and the full-width rep 3), dead tail entries, and an empty
table — within tests/parity.py's ATTN_TOLS. The CUDA kernel is held
against the plain version on the card by tests/test_torch_cuda.py; here
the routes its bf16 pools take on the card (a pure function of shapes)
are checked.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import ATTN_TOLS, make_paged_operands

from repro.kernels.paged_attention import paged_attention as jpaged
from repro_torch.convert import to_tensor
from repro_torch.kernels import paged_attention as PA

# name, B, Sq, H, Hkv, D, ps, kv_lens, q_starts (None → arange default;
# per row: first query position, −1 → whole row masked), n_real (queries
# per row before −1 bucket padding; None → all)
CASES = [
    ("decode_gqa2", 3, 1, 4, 2, 16, 16, (6, 81, 38), (5, 80, 37), None),
    ("decode_rep3_masked_row", 4, 1, 9, 3, 64, 16, (40, 0, 17, 64),
     (39, -1, 16, 63), None),
    ("prefill_bucket_padding", 3, 16, 4, 2, 16, 16, (11, 16, 5), (0, 0, 0),
     (11, 16, 5)),
    ("chunked_prefill_offset", 2, 8, 4, 4, 16, 8, (32, 48), (24, 40), None),
    ("default_positions", 2, 12, 6, 3, 32, 8, (12, 12), None, None),
    ("noncausal_ragged", 2, 17, 2, 1, 16, 16, (45, 29), None, None),
]


def _operands(case, dtype, seed=0):
    name, B, Sq, H, Hkv, D, ps, lens, starts, n_real = case
    T = max(max(lens), 1)
    rng = np.random.default_rng(seed + B * 100 + Sq)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    kp, vp, bt = make_paged_operands(jnp.asarray(k), jnp.asarray(v),
                                     page_size=ps, seed=seed)
    qpos = None
    if starts is not None:
        qpos = np.full((B, Sq), -1, np.int32)
        for b in range(B):
            n = Sq if n_real is None else n_real[b]
            if starts[b] >= 0:
                qpos[b, :n] = starts[b] + np.arange(n)
    kvl = np.asarray(lens, np.int32)
    dt = jnp.dtype(dtype)
    return (jnp.asarray(q).astype(dt), kp.astype(dt), vp.astype(dt), bt,
            None if qpos is None else jnp.asarray(qpos), jnp.asarray(kvl))


def _to_port(*xs):
    return [None if x is None else to_tensor(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(case, dtype):
    causal = case[0] != "noncausal_ragged"
    q, kp, vp, bt, qpos, kvl = _operands(case, dtype)
    want = np.asarray(jpaged(q, kp, vp, bt, qpos, kvl, causal=causal,
                             block_q=8, interpret=True).astype(jnp.float32))
    before = PA.paged_attention.launches
    got = PA.paged_attention(*_to_port(q, kp, vp, bt, qpos, kvl),
                             causal=causal)
    assert PA.paged_attention.launches == before          # CPU: no launch
    assert got.dtype == to_tensor(np.asarray(q)).dtype
    got = got.float().numpy()
    atol, rtol = ATTN_TOLS[dtype]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    if qpos is not None:
        masked = np.asarray(qpos) < 0
        assert not masked.any() or np.abs(got[masked]).max() == 0.0


def test_soft_cap_matches_jax():
    case = CASES[1]
    q, kp, vp, bt, qpos, kvl = _operands(case, "float32")
    want = np.asarray(jpaged(q, kp, vp, bt, qpos, kvl, soft_cap=5.0,
                             block_q=8, interpret=True))
    got = PA.paged_attention(*_to_port(q, kp, vp, bt, qpos, kvl),
                             soft_cap=5.0).numpy()
    np.testing.assert_allclose(got, want, **dict(zip(("atol", "rtol"),
                                                     ATTN_TOLS["float32"])))


def test_dead_tail_entries_and_clamped_valid_length():
    """Table entries past a row's valid length may name any page (the
    engine leaves them at 0): they contribute nothing. A kv_valid_len past
    nb * page_size is clamped to it."""
    case = CASES[0]
    q, kp, vp, bt, qpos, kvl = _to_port(*_operands(case, "float32"))
    base = PA.paged_attention(q, kp, vp, bt, qpos, kvl)
    ps = kp.shape[1]
    bt2 = bt.clone()
    for b in range(bt.shape[0]):
        bt2[b, -(-int(kvl[b]) // ps):] = 0
    assert torch.equal(PA.paged_attention(q, kp, vp, bt2, qpos, kvl), base)
    big = torch.full_like(kvl, 10_000)
    full = torch.full_like(kvl, bt.shape[1] * ps)
    assert torch.equal(PA.paged_attention(q, kp, vp, bt, qpos, big),
                       PA.paged_attention(q, kp, vp, bt, qpos, full))


def test_empty_block_table_returns_zeros():
    q = torch.randn(2, 3, 4, 16)
    kp = torch.randn(5, 16, 2, 16)
    out = PA.paged_attention(q, kp, kp, torch.zeros((2, 0), dtype=torch.int32))
    want = np.asarray(jpaged(jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
                             jnp.asarray(kp.numpy()),
                             jnp.zeros((2, 0), jnp.int32), interpret=True))
    assert out.shape == want.shape == (2, 3, 4, 16)
    assert not out.any() and not want.any()


def test_paged_backend_rejects_dense_operands():
    """Dense operands under the paged policy are not read as page pools:
    the backend hands them to the flash kernel (K3, the reference's dense
    fallback), whose result is the JAX flash kernel's."""
    from repro.kernels.ops import mha as jmha
    from repro_torch.core import api
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.kernels import flash_attention as FA
    q = torch.randn(1, 4, 2, 16)
    pos = torch.arange(4)[None]
    kvl = torch.tensor([4])
    got = api.attention(q, q, q, q_positions=pos, kv_valid_len=kvl,
                        policy=AttentionPolicy(backend="paged"))
    assert torch.equal(got, FA.flash_attention(q, q, q, pos, kvl))
    jq = jnp.asarray(q.numpy())
    want = np.asarray(jmha(jq, jq, jq, q_positions=jnp.asarray(pos.numpy()),
                           kv_valid_len=jnp.asarray(kvl.numpy()),
                           impl="interpret"))
    np.testing.assert_allclose(got.numpy(), want, *ATTN_TOLS["float32"])


def test_gather_pages_inverts_the_paged_layout():
    case = CASES[2]
    B, T, Hkv, D = 3, 16, 2, 16
    k = np.random.default_rng(0).standard_normal((B, T, Hkv, D)).astype(
        np.float32)
    kp, _, bt = make_paged_operands(jnp.asarray(k), jnp.asarray(k),
                                    page_size=case[6])
    dense = PA.gather_pages(*_to_port(kp, bt), max_len=T)
    np.testing.assert_array_equal(dense.numpy(), k)



# B, Sq, H, Hkv, page size, table entries: the route bf16 pools take on the
# card (K3's chooser, on the same warp tile) and the split count over the
# nb x page_size keys in memory (never the valid lengths).
_ROUTE_CASES = [
    (8, 1, 9, 3, 16, 16, "split", 1),     # smollm decode, 256 keys a slot
    (8, 64, 9, 3, 16, 16, "rows", 0),     # smollm's 64-column prefill
    (8, 32, 9, 3, 16, 16, "rows", 0),     # a 32-column chunk
    (8, 1, 9, 3, 16, 128, "split", 8),    # 2,048 keys: 24 pairs x 8
    (3, 1, 4, 2, 8, 64, "split", 2),      # 512 keys of 8-token pages
    (2, 8, 4, 4, 32, 32, "split", 4),     # chunk of 8 rows, 1,024 keys
    (2, 5, 4, 1, 32, 4, "rows", 0),       # MQA rep 4: 20 rows
    (4, 1, 16, 1, 16, 8, "split", 1),     # rep 16: one full m16 tile
]


@pytest.mark.parametrize("case", _ROUTE_CASES, ids=str)
def test_route_and_split_count(case):
    B, Sq, H, Hkv, ps, nb, route, splits = case
    assert PA.route_for(torch.bfloat16, Sq, H // Hkv) == route
    assert PA.route_for(torch.float32, Sq, H // Hkv) == "cuda_cores"
    if route == "split":
        assert PA.split_count(B, Hkv, nb * ps) == splits
    assert ps in PA.TC_PAGE_SIZES


def test_cpu_call_counts_no_route():
    """On CPU tensors the wrapper runs the plain version: no launch, no
    route counted, fp or int8 pools."""
    case = CASES[1]
    q, kp, vp, bt, qpos, kvl = _to_port(*_operands(case, "bfloat16"))
    before = (PA.paged_attention.launches, PA.paged_attention.launches_int8,
              dict(PA.paged_attention.launches_by_route))
    PA.paged_attention(q, kp, vp, bt, qpos, kvl)
    assert (PA.paged_attention.launches, PA.paged_attention.launches_int8,
            PA.paged_attention.launches_by_route) == before
