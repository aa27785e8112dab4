"""The port's dry run (``launch/dryrun.py``) on ``meta`` tensors, against
the JAX package.

  * ``count_params_abstract_cfg`` and ``active_params`` equal the
    reference's for every arch of the registry;
  * one decode step (the fp32 smollm-135m smoke config at head_dim 64, a
    head dim the card's kernels take; 2 layers, 8 slots of 256 tokens,
    contiguous caches, one device, the reference's layers unrolled: XLA
    counts a scanned body once): the arguments the port holds equal
    XLA's ``memory_analysis()`` of the reference's ``make_decode_step``
    but for the caches' write sinks (the port writes masked positions to
    one column past ``max_len``, which the dry run lists); the kernels'
    FLOPs (K1's GEMMs, K3's attention over every cached key) equal their
    closed form exactly; the total, elementwise work included (one FLOP
    an element, as XLA counts it), lies within ``FLOP_BAND`` of XLA's
    ``cost_analysis()`` FLOPs, and so do the transcendentals counted
    apart; the kernel launches the cost ledger records on ``meta``,
    by kernel and route, equal the calls the same step makes on the CPU,
    and no launch counter moves (nothing launches on ``meta``);
  * a K1 call on ``meta`` marks its batched and backward launches in the
    ledger, as the card's counters mark them, and moves no counter;
  * under ``Mesh.abstract((1, 2))`` the dry run's collectives equal those
    a real TP=2 run of the same decode step issues on the CPU (two ranks
    over gloo): kinds, counts and bytes;
  * a ``meta`` tensor reaching a real group raises, and so does a CPU
    tensor under an abstract mesh.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import concurrent.futures
import contextlib
import os

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_mesh_ranks as R
from repro.configs import registry as JR
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.serving.engine import make_decode_step as jmake_decode_step
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.core import api
from repro_torch.core.plan import (AttentionPolicy, GemmPolicy,
                                   unregister_attention_backend,
                                   unregister_backend)
from repro_torch.distributed import tp as TP
from repro_torch.distributed.launch import spawn
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import matrixflow_gemm as MF
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.serving.engine import make_decode_step

B, MAX_LEN = 8, 256
# The port's total FLOPs over XLA's for the step below: both count the
# GEMMs, attention and the elementwise work (one FLOP an element, softmax
# as its parts); the ops each lowers to differ (the port's K3 against
# XLA's unfused attention, its casts and fusions).
FLOP_BAND = (0.9, 1.05)


def _cfg():
    return get_smoke_config("smollm-135m", d_head=64, dtype="float32")


@pytest.fixture(scope="module")
def jdr():
    """The reference's dry-run module, imported with the XLA_FLAGS it sets
    (512 placeholder devices) put back, so this process keeps its one
    CPU device."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_reference(jdr, arch):
    n = DR.count_params_abstract_cfg(get_config(arch))
    jcfg = JR.get_config(arch)
    # the param tree of the reference's abstract_params_and_axes
    params_abs = jax.eval_shape(lambda k: JT.init_model(k, jcfg)[0],
                                jax.random.PRNGKey(0))
    assert n == jdr.count_params_abstract(params_abs)
    assert DR.active_params(get_config(arch), n) == \
        jdr.active_params(jcfg, n)


@pytest.fixture(scope="module")
def decode():
    cfg = _cfg()
    # unrolled layers: XLA counts a scanned body once
    jcfg = JR.get_smoke_config("smollm-135m", d_head=64, dtype="float32",
                               scan_layers=False)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    caches = JT.init_caches(jcfg, B, MAX_LEN, jcfg.param_dtype)
    tok = jnp.zeros((B, 1), jnp.int32)
    step = jmake_decode_step(jcfg)
    with japi.use_policy(JGemmPolicy(backend="xla")), \
            japi.use_attention_policy(JAttentionPolicy(backend="unfused")):
        compiled = jax.jit(step).lower(jparams, tok, tok, caches).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    xla = {"argument": compiled.memory_analysis().argument_size_in_bytes,
           "flops": float(cost["flops"]),
           "transcendentals": float(cost.get("transcendentals", 0.0))}
    def card_counts():
        return (MF.matrixflow_gemm_block_major.cuda_core_launches,
                FA.flash_attention.launches_by_route["cuda_cores"])

    before = card_counts()
    res = DR.run_step(cfg, "decode", B, MAX_LEN)
    moved = tuple(a - b for a, b in zip(card_counts(), before))
    return {"cfg": cfg, "xla": xla, "res": res, "moved": moved}


def test_argument_bytes_equal_xla_memory_analysis(decode):
    res = decode["res"]
    sink = [p["bytes"] for p in res["parts_from_reference"]
            if p["part"] == "cache write sink"]
    assert len(sink) == 1 and sink[0] > 0
    assert res["memory"]["argument_size_in_bytes"] - sink[0] == \
        decode["xla"]["argument"]


def test_kernel_flops_equal_closed_form(decode):
    cfg, res = decode["cfg"], decode["res"]
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    macs = L * (d * H * D + 2 * d * Hkv * D + H * D * d + d * 2 * f
                + f * d) + d * V
    gemm = 2.0 * B * macs
    attn = 2.0 * 2 * D * H * B * MAX_LEN * L       # q·k and p·v, every key
    assert res["cost"]["kernel_flops"] == gemm + attn
    assert res["launches"] == {"matrixflow_gemm": {"cuda_core": 6 * L + 1},
                               "flash_attention": {"cuda_cores": L}}


def test_total_flops_within_band_of_xla(decode):
    print("port / XLA FLOPs", decode["res"]["cost"]["flops"],
          decode["xla"]["flops"], "transcendentals",
          decode["res"]["cost"]["transcendentals"],
          decode["xla"]["transcendentals"])
    ratio = decode["res"]["cost"]["flops"] / decode["xla"]["flops"]
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


def test_transcendentals_within_band_of_xla(decode):
    """The exps, rsqrts and the like apart from the FLOPs, under XLA's own
    key: the kernels' (K3's exp a visible pair and head) and the aten
    ops'."""
    ratio = decode["res"]["cost"]["transcendentals"] \
        / decode["xla"]["transcendentals"]
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], ratio


@contextlib.contextmanager
def _spy():
    """The step's kernel calls on the CPU, by kernel and the route the card
    would take: the K1 and K3 wrappers wrapped in backends of their own."""
    calls = {}

    def note(kernel, route):
        calls.setdefault(kernel, {}).setdefault(route, 0)
        calls[kernel][route] += 1

    def block(a_bm, b_bm, *, out_dtype, backward=False, problem=None):
        note("matrixflow_gemm", MF.route_for(a_bm.dtype, a_bm.shape[-2]))
        return MF.matrixflow_gemm_block_major(a_bm, b_bm, out_dtype=out_dtype)

    def attention(q, k, v, *, q_positions, kv_valid_len, causal, scale,
                  soft_cap, block_tables=None, kv_scales=None):
        note("flash_attention", FA.route_for(q.dtype, q.shape[1],
                                             q.shape[2] // k.shape[2],
                                             k.dtype))
        return FA.flash_attention(q, k, v, q_positions, kv_valid_len,
                                  causal=causal, scale=scale,
                                  soft_cap=soft_cap)

    api.register_backend("spy_matrixflow", lambda *a: None, block_fn=block)
    api.register_attention_backend("spy_fused", attention)
    try:
        with api.use_policy(GemmPolicy(backend="spy_matrixflow")), \
                api.use_attention_policy(AttentionPolicy(backend="spy_fused")):
            yield calls
    finally:       # the registries are process-wide: leave them as found
        unregister_backend("spy_matrixflow")
        unregister_attention_backend("spy_fused")


def test_meta_launches_equal_cpu_run(decode):
    cfg = decode["cfg"]
    params = T.init_model(cfg, seed=0, device="cpu")
    caches = T.init_caches(cfg, B, MAX_LEN, cfg.param_dtype, "cpu")
    tok = torch.zeros((B, 1), dtype=torch.int32)
    with _spy() as calls, torch.no_grad():
        make_decode_step(cfg)(params, tok, tok, caches)
    res, L = decode["res"], cfg.n_layers
    assert calls == res["launches"] and res["launches_marked"] == {}
    assert DR.launch_counters(res) == {
        "matrixflow_gemm": 6 * L + 1, "matrixflow_gemm_cuda_core": 6 * L + 1,
        "flash_attention": L, "flash_attention_cuda_cores": L}
    assert decode["moved"] == (0, 0)


def test_meta_k1_marks_batched_and_backward_in_the_ledger():
    from repro_torch.roofline import analysis as RA
    k1 = MF.matrixflow_gemm_block_major
    a = torch.empty((3, 2, 1, 64, 64), dtype=torch.bfloat16, device="meta")
    b = torch.empty((3, 2, 1, 64, 64), dtype=torch.bfloat16, device="meta")
    names = ("launches", "wgmma_launches", "batched_launches",
             "backward_launches")
    before = [getattr(k1, n) for n in names]
    ledger = RA.CostLedger()
    with RA.use_ledger(ledger):
        c = k1(a, b, out_dtype=torch.bfloat16, backward=True)
        k1(a[0], b[0], out_dtype=torch.bfloat16)
    assert c.device.type == "meta" and c.shape == (3, 2, 2, 64, 64)
    assert [getattr(k1, n) for n in names] == before
    assert ledger.launches == {"matrixflow_gemm": {"wgmma": 2}}
    assert ledger.marked == {"matrixflow_gemm": {"batched": 1,
                                                 "backward": 1}}
    assert ledger.flops == 2.0 * 128 * 128 * 64 * (3 + 1)


TP_ROWS = 2


def test_abstract_tp2_collectives_equal_real_tp2_run(tmp_path):
    cfg = R.tp_dryrun_config()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.tp_decode_rank, 2, (TP_ROWS, MAX_LEN),
                            workdir=str(tmp_path), timeout_s=180,
                            collective_timeout_s=60, threads=1)
        res = DR.run_step(cfg, "decode", TP_ROWS, MAX_LEN,
                          mesh=Mesh.abstract((1, 2), ("data", "model")))
        ranks = ranks.result()
    for snap in ranks:
        assert res["collective_counts"] == snap["calls"]
        assert {k: float(v) for k, v in snap["bytes"].items()} == {
            k: res["collectives"][k] for k in snap["bytes"]}
    assert res["collective_counts"]["all_reduce"] >= 2 * cfg.n_layers + 1


def test_meta_and_real_groups_do_not_mix(monkeypatch):
    """A CPU tensor under an abstract mesh raises, a meta one is counted;
    a meta tensor over a real group of two ranks (its size stubbed: no
    collective is issued) raises before reaching torch.distributed."""
    mesh = Mesh.abstract((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="abstract mesh"):
        TP.all_reduce(torch.zeros(4), mesh.group("model"))
    t = torch.empty(4, device="meta")
    before = TP.collectives.snapshot()["calls"]["all_reduce"]
    assert TP.all_reduce(t, mesh.group("model")).device.type == "meta"
    assert TP.collectives.snapshot()["calls"]["all_reduce"] == before + 1
    monkeypatch.setattr(TP.dist, "get_world_size", lambda group: 2)
    with pytest.raises(ValueError, match="meta tensor"):
        TP.all_reduce(t, object())
