"""Contiguous KV caches cut over the sequence (the cache rules'
``act_kv_seq``: over ``data`` for the ``long_500k`` cells, over ``model``
for the ``kvseq`` arm), against the JAX package and the port's own
single-device path. CPU, smoke shapes, fp32; tolerances ``ATTN_TOLS`` /
``TOLS["float32"]`` of ``tests/parity.py`` unless a test says otherwise.

* K3's plain log-sum-exp against a direct ``logsumexp`` of the masked
  scores, and the unfused attention's against both;
* the merge of 1, 2 and 4 cuts of the keys, one cut seeing none, against
  the whole attention (``tp.merge_stack``);
* the cache write at the rank's column offset (decode and prefill)
  against the whole cache's write, sliced;
* ``tp.shard_caches`` and ``init_caches(tpctx=)`` cut as the rules say;
* two gloo ranks, mesh (data 2, model 1) under the long_500k rules:
  zamba2's smoke decode from caches cut in two against the reference's
  single-device ``make_decode_step`` (greedy tokens equal, logits within
  TOLS), for a row whose writes land in rank 1's half (both ranks see
  keys), one in rank 0's (rank 1 sees none) and one crossing; each rank
  holds half the K/V columns; one all_gather over data a layer a step;
* the dry run: zamba2 at long_500k holds 9 x 2 x 80 x 32,769 x 2 x 2
  bytes of caches a rank and counts the merge's all_gathers; smollm at
  decode_32k under ``{"act_kv_seq": "model"}`` cuts on model; the batch
  and the cache specs that cannot both hold raise;
* MLA's latent cache under the kvseq arm is cut, and the dry run lists
  ``wkv_b`` held whole (the cut itself: ``tests/test_torch_mla_seq.py``);
* K3's contract with the log-sum-exp output.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as R
from parity import ATTN_TOLS, TOLS

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.serving.engine import make_decode_step as jmake_decode_step
from repro_torch.analysis import sweep as SW
from repro_torch.analysis.kernel_contracts import (OperandSpec,
                                                   check_contract)
from repro_torch.configs.registry import SHAPES, get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import FUSED, UNFUSED, AttentionPolicy
from repro_torch.distributed import tp as TP
from repro_torch.distributed.launch import spawn
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as Lyr
from repro_torch.models import transformer as T

ATOL, RTOL = ATTN_TOLS["float32"]
LOGIT_ATOL, LOGIT_RTOL = TOLS["float32"]

# (B, Sq, Sk, H, Hkv, q positions (None: bottom-right), valid lengths)
LSE_CASES = {
    "decode": (3, 1, 40, 4, 2, [[5], [39], [-1]], [6, 40, 0]),
    "prefill": (2, 9, 24, 2, 2, None, [24, 17]),
    "chunk_masked": (2, 4, 32, 6, 2, [[10, 11, 12, -1], [-1] * 4],
                     [13, 32]),
}


def _operands(B, Sq, Sk, H, Hkv, qpos, kvl, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    qpos = (torch.arange(Sq) + Sk - Sq).expand(B, Sq) if qpos is None \
        else torch.tensor(qpos)
    return q, k, v, qpos.to(torch.int32), torch.tensor(kvl, dtype=torch.int32)


def _direct_lse(q, k, qpos, kvl):
    """logsumexp of each row's visible scores, -inf where it sees none."""
    B, Sq, H, D = q.shape
    rep = H // k.shape[2]
    kk = k.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bqhk", q, kk) / math.sqrt(D)
    cols = torch.arange(k.shape[1])
    vis = (cols[None, None] < kvl[:, None, None]) \
        & (cols[None, None] <= qpos[:, :, None])           # (B, Sq, Sk)
    s = torch.where(vis[:, :, None], s, torch.full_like(s, -math.inf))
    return torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("case", list(LSE_CASES))
def test_plain_lse_is_logsumexp_of_the_scores(case):
    q, k, v, qpos, kvl = _operands(*LSE_CASES[case])
    out, lse = FA.flash_attention(q, k, v, qpos, kvl, return_lse=True)
    want = _direct_lse(q, k, qpos, kvl)
    dead = torch.isneginf(want)
    assert torch.equal(torch.isneginf(lse), dead)
    torch.testing.assert_close(lse[~dead], want[~dead], atol=ATOL, rtol=RTOL)
    assert torch.equal(out, FA.flash_attention(q, k, v, qpos, kvl))
    uo, ul = api.attention(q, k, v, q_positions=qpos, kv_valid_len=kvl,
                           policy=UNFUSED, return_lse=True)
    assert torch.equal(torch.isneginf(ul), dead)
    torch.testing.assert_close(ul[~dead], want[~dead], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(uo, out, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", list(LSE_CASES))
@pytest.mark.parametrize("n", [1, 2, 4])
def test_merge_of_cuts_equals_whole_attention(case, n):
    """Each cut's attention over its columns with the local positions and
    valid lengths, merged: the whole attention. Every case has a cut that
    sees no key of some row (past the valid length or the position)."""
    q, k, v, qpos, kvl = _operands(*LSE_CASES[case], seed=1)
    Sk = k.shape[1]
    cols = Sk // n
    outs, lses = [], []
    for r in range(n):
        sl = slice(r * cols, (r + 1) * cols)
        o, lse = FA.flash_attention(
            q, k[:, sl], v[:, sl], qpos - r * cols,
            torch.clamp(kvl - r * cols, 0, cols), return_lse=True)
        outs.append(o)
        lses.append(lse)
    if n > 1 and case != "prefill":
        assert any(bool(torch.isneginf(x).any()) for x in lses)
    got = TP.merge_stack(torch.stack(outs), torch.stack(lses))
    want = FA.flash_attention(q, k, v, qpos, kvl)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S", [1, 5])
def test_cache_write_at_the_rank_offset(S):
    """The write into a rank's columns [offset, offset + cols) plus its
    sink, from global positions: the whole cache's write, sliced; a
    position outside the rank's range writes nothing there (decode) or
    goes to the rank's sink (prefill); len advances by the written
    count on every rank."""
    B, T_, Hkv, D, n = 3, 16, 2, 4, 2
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              n_kv_heads=Hkv, d_head=D)
    rng = np.random.default_rng(2)
    new = {name: torch.from_numpy(rng.standard_normal(
        (B, S, Hkv, D)).astype(np.float32)) for name in ("k", "v")}
    start = torch.tensor([[5], [9], [-1]])
    pos = torch.where(start >= 0, start + torch.arange(S), -1).to(torch.int32)
    whole = Lyr._contiguous_cache_update(
        Lyr.init_attention_cache(cfg, B, T_, torch.float32, "cpu"),
        dict(new), pos)
    for r in range(n):
        cut = TP.SeqCut(("data",), r, n, T_ // n)
        c = Lyr._contiguous_cache_update(
            Lyr.init_attention_cache(cfg, B, T_, torch.float32, "cpu",
                                     seq_cut=cut), dict(new), pos)
        assert int(c["seq_offset"]) == cut.offset
        for name in ("k", "v"):
            assert c[name].shape[1] == cut.cols + 1
            assert torch.equal(c[name][:, :cut.cols],
                               whole[name][:, cut.offset:cut.offset
                                           + cut.cols])
        assert torch.equal(c["len"], whole["len"])


def test_shard_caches_and_init_caches_cut_by_the_rules():
    cfg = R.kvseq_config()
    ctx = ST.serve_context(cfg, Mesh.abstract((2, 1), ("data", "model"),
                                              rank=1), SHAPES["long_500k"])
    ssd, attn, _ = R.kvseq_state(cfg)
    whole = R.kvseq_port_caches(ssd, attn)
    cut = TP.shard_caches(whole, ctx, shard_kv=False)
    made = T.init_caches(cfg, 3, R.KVSEQ_MAX_LEN, "float32", "cpu",
                         tpctx=ctx)
    half = R.KVSEQ_MAX_LEN // 2
    for w, c, m in zip(whole, cut, made):
        if "k" not in w:
            assert c.keys() == w.keys() and "seq_offset" not in m
            continue
        assert int(c["seq_offset"]) == int(m["seq_offset"]) == half
        assert m["k"].shape == c["k"].shape == (3, half + 1,
                                                *w["k"].shape[2:])
        assert torch.equal(c["k"][:, :half], w["k"][:, half:-1])
        assert torch.equal(c["len"], w["len"])
    assert TP.seq_cut(None, "k", (1, 64, 4, 32)) is None
    # the KV heads on model take the axis first: no cut (duplicate axes)
    kv = ST.serve_context(cfg, Mesh.abstract((1, 2), ("data", "model")),
                          extra_overrides={"act_kv_seq": "model"})
    assert TP.seq_cut(kv, "k", (1, 64, 4, 32)) is None
    assert TP.seq_cut(kv, "k", (1, 64, 3, 32)) is not None
    # T that does not divide stays whole
    assert TP.seq_cut(ctx, "k", (1, 63, 4, 32)) is None


# ---------------------------------------------------------------------------
# Two ranks against the reference's single-device decode
# ---------------------------------------------------------------------------

def _jax_decode(jcfg, jparams, ssd, attn, tokens):
    g, ng = jcfg.attn_every, jcfg.n_layers // jcfg.attn_every

    def stack(fn):
        return jnp.asarray(np.stack([np.stack([fn(ssd[i * g + j])
                                               for j in range(g)])
                                     for i in range(ng)]))
    caches = {"scan": (
        {"conv": {k: stack(lambda c, k=k: c["conv"][k])
                  for k in ("x", "B", "C")},
         "state": stack(lambda c: c["state"])},
        {k: jnp.asarray(np.stack([c[k] for c in attn]))
         for k in ("k", "v", "len")})}
    step = jax.jit(jmake_decode_step(jcfg, JGemmPolicy(backend="xla"),
                                     JAttentionPolicy(backend="unfused")))
    tok = jnp.asarray(tokens)
    pos = jnp.asarray(np.asarray(R.KVSEQ_LENS, np.int32)[:, None])
    logits, toks = [], []
    for _ in range(R.KVSEQ_STEPS):
        lg, caches = step(jparams, tok, pos, caches)
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        logits.append(np.asarray(lg, np.float32))
        toks.append(np.asarray(tok[:, 0]))
        pos = pos + 1
    return np.stack(logits), np.stack(toks)


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """The JAX single-device decode, the port's, and two ranks' (fused:
    K3's plain version; unfused: the einsum attention)."""
    cfg = R.kvseq_config()
    jcfg = jget_smoke_config("zamba2-2.7b", vocab=64, dtype="float32")
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    ssd, attn, tokens = R.kvseq_state(cfg)
    jl, jt = _jax_decode(jcfg, jparams, ssd, attn, tokens)
    params = from_jax_params(params_np, cfg)
    one = R.kvseq_decode(cfg, params, R.kvseq_port_caches(ssd, attn),
                         tokens, None, FUSED)
    ranks = spawn(R.kvseq_rank, 2, (params_np, ("fused", "unfused")),
                  workdir=str(tmp_path_factory.mktemp("kvseq")), threads=1)
    return (jl, jt), one, ranks


@pytest.mark.parametrize("policy", ["fused", "unfused"])
def test_two_rank_decode_matches_jax(decoded, policy):
    (jl, jt), one, ranks = decoded
    for rk in ranks:
        got = rk[policy]
        np.testing.assert_array_equal(got["tokens"], jt)
        np.testing.assert_allclose(got["logits"], jl, atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(one[1], jt)
    np.testing.assert_allclose(one[0], jl, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_two_rank_caches_and_collectives(decoded):
    """Each rank holds half the K/V columns (and its sink), its offset,
    the global lengths; a step gathers once a shared-attention layer over
    data, as the dry run counts it."""
    _, (_, _, one_caches), ranks = decoded
    cfg = R.kvseq_config()
    one_kv = sum(c[n].numel() * 4 for c in one_caches if "k" in c
                 for n in ("k", "v"))
    n_groups = cfg.n_layers // cfg.attn_every
    B, half = len(R.KVSEQ_LENS), R.KVSEQ_MAX_LEN // 2
    d = DR.run_step(dataclasses.replace(cfg, d_head=64), "decode", B,
                    R.KVSEQ_MAX_LEN, attention=AttentionPolicy("fused"),
                    mesh=Mesh.abstract((2, 1), ("data", "model")),
                    shape_name="long_500k")
    for r, rk in enumerate(ranks):
        got = rk["fused"]
        per_col = one_kv // (n_groups * 2 * B * (R.KVSEQ_MAX_LEN + 1))
        assert got["kv_bytes"] == n_groups * 2 * B * (half + 1) * per_col
        assert got["offsets"] == [r * half] * n_groups
        assert got["init_offsets"] == [r * half] * n_groups
        lens = np.asarray(R.KVSEQ_LENS) + R.KVSEQ_STEPS
        for x in got["lens"]:
            np.testing.assert_array_equal(x, lens)
        calls = got["collectives"]["all_gather:data"]["calls"]
        assert calls == n_groups * R.KVSEQ_STEPS
        assert d["collectives_by_axes"]["all_gather:data"]["calls"] \
            == n_groups


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def test_dry_run_zamba2_long_500k_cuts_the_caches():
    res = DR.dryrun_cell("zamba2-2.7b", "long_500k", verbose=False)
    n_groups, heads, D = 54 // 6, 32 // 16, 80      # K and V, bf16
    assert res["kv_cache_bytes"] == n_groups * heads * D \
        * (524288 // 16 + 1) * 2 * 2
    assert res["collectives_by_axes"]["all_gather:data"]["calls"] \
        == n_groups
    assert not any(p["part"] == "long-context cache"
                   for p in res["parts_from_reference"])


def test_dry_run_kvseq_on_model_cuts_smollm():
    """smollm-135m's 3 KV heads do not divide over 16 model ranks, so the
    kvseq arm's act_kv_seq -> model cuts its caches' 32,768 columns in
    2,048 a rank (the batch's 128 rows over data, 8 a rank)."""
    res = DR.dryrun_cell("smollm-135m", "decode_32k", verbose=False,
                         rules_overrides={"act_kv_seq": "model"})
    whole = DR.dryrun_cell("smollm-135m", "decode_32k", verbose=False)
    assert res["kv_cache_bytes"] * 32769 == whole["kv_cache_bytes"] * 2049
    assert res["collectives_by_axes"]["all_gather:model"]["calls"] == 30


def test_dry_run_raises_where_batch_and_cache_specs_cannot_both_hold():
    cfg = dataclasses.replace(R.kvseq_config(), d_head=64)
    with pytest.raises(ValueError, match="batch spec.*cache spec"):
        DR.run_step(cfg, "decode", 4, 64,
                    mesh=Mesh.abstract((2, 1), ("data", "model")),
                    shape_name="long_500k")


def test_mla_latent_cache_cut_and_the_dry_run_holds_wkv_b_whole():
    """Under the kvseq arm deepseek's smoke rank holds half the latent
    (MLA's cut: tests/test_torch_mla_seq.py), and the dry run's parts from
    the reference name wkv_b held whole (2 layers of kv_lora_rank x H x
    256, bf16), no longer the latent."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b",
                                               n_layers=2),
                              qk_nope_head_dim=128, qk_rope_head_dim=64,
                              v_head_dim=128)
    mesh = Mesh.abstract((1, 2), ("data", "model"))
    got = DR.run_step(cfg, "decode", 2, 64, attention=FUSED, mesh=mesh,
                      shape_name="decode_32k",
                      rules_overrides={"act_kv_seq": "model"})
    whole = DR.run_step(cfg, "decode", 2, 64, attention=FUSED, mesh=mesh,
                        shape_name="decode_32k")
    assert got["kv_cache_bytes"] * 65 == whole["kv_cache_bytes"] * 33
    parts = {p["part"]: p for p in got["parts_from_reference"]}
    assert "MLA latent cache" not in parts
    wkv_b = cfg.n_layers * cfg.kv_lora_rank * cfg.n_heads * 256 * 2
    assert f"{wkv_b} B a rank" in parts["MLA up-projection wkv_b"]["detail"]
    assert "MLA up-projection wkv_b" not in {
        p["part"] for p in whole["parts_from_reference"]}


# ---------------------------------------------------------------------------
# K3's contract with the log-sum-exp
# ---------------------------------------------------------------------------

def test_lse_contract_cells_check_clean_and_a_double_write_is_caught():
    entries = SW.sweep_lse("cuda")
    assert {e.route for e in entries} == {"split", "rows", "cuda_cores"}
    assert all(e.ok for e in entries)
    B, H, Hkv, D, keys = SW.lse_rank_shape()
    assert (B, H, Hkv, D, keys) == (1, 2, 2, 80, 524288 // 16)
    c = FA.flash_attention_contract(B=1, H=2, Hkv=2, Sq=1, Sk=4096, D=80,
                                    Dv=80, device="cuda", lse=True)
    lse = next(o for o in c.operands if o.name == "lse")
    assert c.cluster > 1 and lse.nblocks[-1] == c.cluster
    rows = [r for z in range(c.cluster)
            for r in FA.lse_segment_rows("split", z, c.cluster, 80, 16)]
    assert rows == list(range(16))             # each row by one rank
    bad = dataclasses.replace(c, operands=tuple(
        OperandSpec("lse", "output", o.nblocks, o.block_shape,
                    lambda b, g, t, z, s: (b, g, t, z))
        if o.name == "lse" else o for o in c.operands))
    assert any(v.kind == "write_race" for v in check_contract(bad))
