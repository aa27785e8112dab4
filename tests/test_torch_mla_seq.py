"""MLA's latent cache (``ckv``, ``krope``) cut over the sequence, against
the JAX package's single-device serving and the port's own. CPU,
deepseek-v2-236b's smoke config at 2 layers (its dense layer and one MoE
layer), fp32, inputs from numpy seeds; tolerances ``TOLS["float32"]`` /
``ATTN_TOLS["float32"]`` of ``tests/parity.py``.

* K3's plain log-sum-exp at MLA's published head dims (q/k 192, v 128)
  against ``jax.nn.logsumexp`` of the JAX scores;
* ``init_caches(tpctx=)`` and ``tp.shard_caches`` cut both latent leaves
  to the rank's columns and a sink, with ``seq_offset``;
* two gloo ranks prefill a chunk that crosses the ranks' boundary, then
  decode, on mesh (data 1, model 2) with ``act_kv_seq -> model`` (the cut
  shares model with the query heads: ``wkv_b`` whole, the queries
  gathered) and on (data 2, model 1) with ``act_kv_seq -> data`` at one
  row (long_500k's batch), each against the JAX decode (greedy tokens
  equal); their caches, offsets and all-gathers against the closed form
  and the dry run's count;
* the dry run cuts the latent: deepseek-v2-236b's decode_32k on 16 x 16
  holds 1.13 GB of latent a rank where it held 18.12 GB, and names
  ``wkv_b`` held whole (the smoke config's parts:
  ``tests/test_torch_kv_seq.py``).
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as R
from parity import ATTN_TOLS, TOLS

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro_torch.convert import from_jax_params
from repro_torch.core.plan import FUSED, AttentionPolicy
from repro_torch.distributed import tp as TP
from repro_torch.distributed.launch import spawn
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T

ATOL, RTOL = ATTN_TOLS["float32"]
LOGIT_ATOL, LOGIT_RTOL = TOLS["float32"]
KVSEQ = {"act_kv_seq": "model"}

# (B, Sq, Sk, H, q positions (None: bottom-right), valid lengths)
LSE_CASES = {
    "decode": (3, 1, 40, 4, [[5], [39], [-1]], [6, 40, 0]),
    "prefill": (2, 9, 24, 2, None, [24, 17]),
    "chunk_masked": (2, 4, 32, 3, [[10, 11, 12, -1], [-1] * 4], [13, 32]),
}


@pytest.mark.parametrize("case", list(LSE_CASES))
def test_plain_lse_at_mla_head_dims_is_logsumexp_of_jax_scores(case):
    B, Sq, Sk, H, qpos, kvl = LSE_CASES[case]
    D, Dv = 192, 128
    rng = np.random.default_rng(11)
    q, k = (rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, H, D)))
    v = rng.standard_normal((B, Sk, H, Dv)).astype(np.float32)
    qpos = (np.arange(Sq) + Sk - Sq)[None].repeat(B, 0) if qpos is None \
        else np.asarray(qpos)
    qpos, kvl = qpos.astype(np.int32), np.asarray(kvl, np.int32)
    s = jnp.einsum("bqhd,bkhd->bqhk", q, k) / np.sqrt(D)
    cols = jnp.arange(Sk)
    vis = (cols[None, None] < kvl[:, None, None]) \
        & (cols[None, None] <= qpos[:, :, None])
    want = np.asarray(jax.nn.logsumexp(
        jnp.where(vis[:, :, None], s, -jnp.inf), axis=-1))
    out, lse = FA.flash_attention(*(torch.from_numpy(a) for a in
                                    (q, k, v, qpos, kvl)), return_lse=True)
    assert out.shape == (B, Sq, H, Dv) and lse.shape == (B, Sq, H)
    dead = np.isneginf(want)
    np.testing.assert_array_equal(torch.isneginf(lse).numpy(), dead)
    np.testing.assert_allclose(lse.numpy()[~dead], want[~dead], atol=ATOL,
                               rtol=RTOL)


def _ctx(case, rank):
    shape, overrides, _ = R.MLASEQ_CASES[case]
    return ST.serve_context(
        R.mlaseq_config(), Mesh.abstract(shape, ("data", "model"),
                                         rank=rank),
        extra_overrides=overrides)


@pytest.mark.parametrize("case", list(R.MLASEQ_CASES))
def test_init_and_shard_caches_cut_the_latent(case):
    cfg = R.mlaseq_config()
    lens = R.MLASEQ_CASES[case][2]
    whole = R.mlaseq_port_caches(R.mlaseq_state(cfg, lens)[0])
    half = R.MLASEQ_MAX_LEN // 2
    for rank in range(2):
        ctx = _ctx(case, rank)
        cut = TP.shard_caches(whole, ctx, shard_kv=False)
        made = T.init_caches(cfg, len(lens), R.MLASEQ_MAX_LEN, "float32",
                             "cpu", tpctx=ctx)
        assert len(cut) == len(made) == cfg.n_layers
        for w, c, m in zip(whole, cut, made):
            assert int(c["seq_offset"]) == int(m["seq_offset"]) \
                == rank * half
            for name in ("ckv", "krope"):
                assert m[name].shape == c[name].shape \
                    == (len(lens), half + 1, w[name].shape[-1])
                assert torch.equal(c[name][:, :half],
                                   w[name][:, rank * half:(rank + 1) * half])
            assert torch.equal(c["len"], w["len"])
    # no cut where the rules give the sequence no axis, or T does not divide
    plain = ST.serve_context(cfg, Mesh.abstract((1, 2), ("data", "model")))
    assert "seq_offset" not in T.init_caches(cfg, 1, 64, "float32", "cpu",
                                             tpctx=plain)[0]
    assert T.cache_seq_cut(cfg, 1, 63, _ctx(case, 0)) is None


# ---------------------------------------------------------------------------
# Two ranks against the reference's single-device serving
# ---------------------------------------------------------------------------

def _jax_serve(jcfg, jparams, state):
    """The chunk's prefill then MLASEQ_STEPS greedy decode steps through
    the reference's forward over the same latent caches."""
    latent, tokens, pos, last = state
    stack = {n: jnp.asarray(np.stack([c[n] for c in latent[1:]]))
             for n in ("ckv", "krope", "len")}
    caches = {"dense": [{n: jnp.asarray(latent[0][n])
                         for n in ("ckv", "krope", "len")}],
              "scan": stack}
    fwd = jax.jit(lambda p, b, c: JT.forward(p, jcfg, b, caches=c,
                                             remat=False))
    rows = np.arange(len(last))
    logits, toks = [], []
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        lg, caches, _ = fwd(jparams, {"tokens": jnp.asarray(tokens),
                                      "positions": jnp.asarray(pos)}, caches)
        lg = np.asarray(lg)[rows, last]
        nxt = (pos[rows, last] + 1)[:, None]
        for i in range(R.MLASEQ_STEPS + 1):
            if i:
                lg, caches, _ = fwd(jparams, {
                    "tokens": jnp.asarray(tok),
                    "positions": jnp.asarray(nxt)}, caches)
                lg = np.asarray(lg)[:, 0]
                nxt = nxt + 1
            tok = lg.argmax(-1)[:, None].astype(np.int32)
            logits.append(lg)
            toks.append(tok[:, 0])
    return np.stack(logits), np.stack(toks)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX single-device serving and the port's of each case, and
    two ranks' (fused: K3's plain version; unfused: the einsum
    attention)."""
    cfg = R.mlaseq_config()
    jcfg = jget_smoke_config("deepseek-v2-236b", n_layers=2, vocab=64,
                             dtype="float32")
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    params = from_jax_params(params_np, cfg)
    want, one = {}, {}
    for case, (_, _, lens) in R.MLASEQ_CASES.items():
        state = R.mlaseq_state(cfg, lens)
        want[case] = _jax_serve(jcfg, jparams, state)
        one[case] = R.mlaseq_serve(cfg, params, R.mlaseq_port_caches(
            state[0]), state, None, FUSED)
    ranks = spawn(R.mlaseq_rank, 2, (params_np, ("fused", "unfused")),
                  workdir=str(tmp_path_factory.mktemp("mlaseq")), threads=1)
    return want, one, ranks


@pytest.mark.parametrize("policy", ["fused", "unfused"])
@pytest.mark.parametrize("case", list(R.MLASEQ_CASES))
def test_two_rank_prefill_and_decode_match_jax(served, case, policy):
    want, one, ranks = served
    jl, jt = want[case]
    for rk in ranks:
        got = rk[case, policy]
        np.testing.assert_array_equal(got["tokens"], jt)
        np.testing.assert_allclose(got["logits"], jl, atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(one[case][1], jt)
    np.testing.assert_allclose(one[case][0], jl, atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)


def _mla_published(cfg):
    """The smoke config at MLA's published head dims, which the card's K3
    takes (the dry run's wrappers take the card's route)."""
    return dataclasses.replace(cfg, qk_nope_head_dim=128,
                               qk_rope_head_dim=64, v_head_dim=128)


@pytest.mark.parametrize("case", list(R.MLASEQ_CASES))
def test_two_rank_caches_and_collectives(served, case):
    """Each rank holds its half of every latent column (the one-device
    caches' after the same steps, within ATTN_TOLS: the ranks' row-parallel
    sums round apart), its offset, the global lengths; it
    holds wkv_b whole where the cut shares model with the heads; a step
    gathers, a layer, the queries (on model) and the merge's partials,
    the closed form's bytes and the dry run's count."""
    _, one, ranks = served
    cfg = R.mlaseq_config()
    shape, overrides, lens = R.MLASEQ_CASES[case]
    B, half, L = len(lens), R.MLASEQ_MAX_LEN // 2, cfg.n_layers
    H, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    on_model = case == "model"
    axis = "model" if on_model else "data"
    steps = 1 + R.MLASEQ_STEPS
    q_bytes = B * H * (dn + dr) * 4                  # a decode step's
    merge_bytes = 2 * B * H * (dv + 1) * 4
    one_caches = one[case][2]
    for rank, rk in enumerate(ranks):
        got = rk[case, "fused"]
        assert got["offsets"] == [rank * half] * L
        assert got["shapes"] == [((B, half + 1, r), (B, half + 1, dr))] * L
        assert got["init"] == [((B, half + 1, r), rank * half)] * L
        for c, w in zip(got["ckv"], one_caches):      # TP's sums round
            np.testing.assert_allclose(
                c, w["ckv"][:, rank * half:(rank + 1) * half].numpy(),
                atol=ATOL, rtol=RTOL)
        for x, w in zip(got["lens"], one_caches):
            np.testing.assert_array_equal(x, w["len"].numpy())
        assert got["wkv_b"] == (r, H * (dn + dv))
        assert got["wq_b"][1] == H * (dn + dr) // shape[1]
        gathers = got["collectives"][f"all_gather:{axis}"]
        per_step = (2 if on_model else 1) * L
        assert gathers["calls"] == per_step * steps
        chunk = R.MLASEQ_CHUNK
        want = L * (merge_bytes * (chunk + R.MLASEQ_STEPS)
                    + (q_bytes * (chunk + R.MLASEQ_STEPS) if on_model
                       else 0))
        assert gathers["bytes"] == want
    d = DR.run_step(_mla_published(cfg), "decode", B, R.MLASEQ_MAX_LEN,
                    attention=AttentionPolicy("fused"),
                    mesh=Mesh.abstract(shape, ("data", "model")),
                    rules_overrides=overrides)
    assert d["collectives_by_axes"][f"all_gather:{axis}"]["calls"] \
        == per_step


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def test_dry_run_deepseek_decode_32k_kvseq_cuts_the_latent():
    """deepseek-v2-236b's decode_32k on 16 x 16 under act_kv_seq -> model:
    8 rows a rank of 2,048 of the 32,768 latent columns (and a sink), 60
    layers of 512 + 64 bf16: 1.13 GB a rank, 18.12 GB whole; two
    all-gathers a layer over model."""
    res = DR.dryrun_cell("deepseek-v2-236b", "decode_32k", verbose=False,
                         rules_overrides=KVSEQ)
    assert res["kv_cache_bytes"] == 60 * 8 * (2048 + 1) * (512 + 64) * 2
    assert res["kv_cache_bytes"] <= 1.2e9
    assert res["collectives_by_axes"]["all_gather:model"]["calls"] == 120
    q, merge = 8 * 128 * 192 * 2, 16 * 8 * 128 * 129 * 4
    assert res["collectives_by_axes"]["all_gather:model"]["bytes"] \
        == 60 * (q + merge)
    assert any(p["part"] == "MLA up-projection wkv_b"
               for p in res["parts_from_reference"])
