"""The port's static analysis (repro_torch/analysis) against the JAX
package's (repro/analysis), on the CPU.

  1. **Clean pass** — every builtin contract, at the CPU's geometry (the
     reference's grid, compared with the reference's contract for the same
     shapes) and at the card's launch; the full sweep on ``cuda`` and on
     ``cpu``; ``plan(validate=True)`` over the parity shapes.
  2. **Mutation suite** — the reference's nine seeded defects, each giving
     the same violation kinds from the port's checker as from the
     reference's on the same declarative contract, and from the port's own
     contract mutated the same way; a tenth, a cluster split over 9 CTAs,
     is a ``semantics`` violation.
  3. **Drift guards and the lint** — the sweep's grid against
     tests/parity.py and repro.analysis.sweep; each lint rule fired by a
     small step made for it; the instrumented smoke engine lints clean,
     beside the reference's lint of the JAX engine.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import dataclasses
import io

import numpy as np
import pytest
import torch

import parity
from repro.analysis import check_contract as jcheck_contract
from repro.analysis import get_contract_builder as jget_contract_builder
from repro.analysis import sweep as JSW
from repro.core import layout as JL
from repro_torch.analysis import (ContractViolationError, KernelContract,
                                  OperandSpec, Precondition, check_contract,
                                  get_contract_builder, lint_step,
                                  registered_contracts, require)
from repro_torch.analysis import sweep as SW
from repro_torch.analysis.__main__ import lint_engine_for, main
from repro_torch.analysis.kernel_contracts import (MAX_CLUSTER,
                                                   VIOLATION_KINDS,
                                                   touched_blocks)
from repro_torch.analysis.trace_lint import LINT_RULES, lint_engine
from repro_torch.core import layout as L
from repro_torch.core import plan as P
from repro_torch.kernels import flash_attention as FA
from repro_torch.roofline import analysis as RA


def kinds(violations):
    return {v.kind for v in violations}


# ---------------------------------------------------------------------------
# Tier 1: clean pass
# ---------------------------------------------------------------------------

def test_all_five_kernels_register_contracts():
    assert registered_contracts() == (
        "blockflow", "flash_attention", "matrixflow_gemm",
        "paged_attention", "ssd_scan")


GEMM_BLK = L.BlockLayout(bm=16, bn=32, bk=32)
JGEMM_BLK = JL.BlockLayout(bm=16, bn=32, bk=32)
PAGED_KW = dict(B=2, Sq=1, H=4, Hkv=2, D=16, Dv=16, P=8, page_size=16,
                block_tables=np.array([[2, 0, 5], [1, 3, 4]], np.int32),
                block_q=32)

# (name, the reference builder's keyword arguments; the port's take them
# too, with BlockLayout from each package)
BUILTINS = [
    ("matrixflow_gemm", dict(a_shape=(4, 3, 16, 32), b_shape=(5, 3, 32, 32))),
    ("matrixflow_gemm", dict(a_shape=(4, 3, 16, 32), b_shape=(5, 3, 32, 32),
                             fused=True)),
    ("flash_attention", dict(B=2, H=4, Hkv=2, Sq=33, Sk=65, D=64, Dv=64,
                             block_q=32, block_k=32)),
    ("paged_attention", PAGED_KW),
    ("paged_attention", dict(PAGED_KW, quantized=True)),
    ("ssd_scan", dict(B=2, S=96, H=3, P=16, N=8, chunk=32)),
    ("blockflow", dict(nbm=3, nbn=4, nbk=2)),
]


def port_contract(name, kw, device):
    kw = dict(kw)
    if name == "matrixflow_gemm":
        kw["blk"] = GEMM_BLK
    return get_contract_builder(name)(device=device, **kw)


def ref_contract(name, kw):
    kw = dict(kw)
    if name == "matrixflow_gemm":
        kw["blk"] = JGEMM_BLK
    return jget_contract_builder(name)(**kw)


def same_geometry(a, b):
    """The two contracts' grid, semantics and operands agree, and every
    operand's index map gives the same block at every grid point."""
    assert tuple(a.grid) == tuple(b.grid)
    assert tuple(a.dimension_semantics) == tuple(b.dimension_semantics)
    assert tuple(a.sequential_axes) == tuple(b.sequential_axes)
    assert [(o.name, o.role, tuple(o.nblocks), tuple(o.reduction_axes))
            for o in a.operands] == \
        [(o.name, o.role, tuple(o.nblocks), tuple(o.reduction_axes))
         for o in b.operands]
    for gp in np.ndindex(*a.grid):
        for oa, ob in zip(a.operands, b.operands):
            assert tuple(map(int, oa.index_map(*gp))) == \
                tuple(map(int, ob.index_map(*gp))), (oa.name, gp)


@pytest.mark.parametrize("name,kw", BUILTINS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(BUILTINS)])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_builtin_contract_clean(name, kw, device):
    c = port_contract(name, kw, device)
    assert check_contract(c) == []
    if device == "cpu":
        same_geometry(c, ref_contract(name, kw))
        assert jcheck_contract(ref_contract(name, kw)) == []


@pytest.fixture(scope="module")
def sweeps():
    out = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        entries, n_bad = SW.run_sweep(device=device, out=buf)
        out[device] = (entries, n_bad, buf.getvalue())
    return out


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_full_sweep_zero_violations(sweeps, device):
    """The gate, in-process: every backend × dtype × shape plus the
    configs/ registry contract-check clean on the card's launches and on
    the CPU's plain versions."""
    entries, n_bad, report = sweeps[device]
    assert n_bad == 0, report
    counts = SW.count_by_route(entries)
    assert sum(counts.values()) == len(entries)
    if device == "cuda":     # every route of every kernel is swept
        for key in ("matrixflow_gemm/wgmma", "matrixflow_gemm/mma",
                    "matrixflow_gemm/cuda_core", "flash_attention/rows",
                    "flash_attention/split", "flash_attention/cuda_cores",
                    "paged_attention/rows", "paged_attention/split",
                    "paged_attention/cuda_cores", "ssd_scan/walk",
                    "ssd_scan/chunks", "blockflow/plain"):
            assert counts.get(key, 0) > 0, key
        assert f"contracts matrixflow_gemm/mma: {counts['matrixflow_gemm/mma']}" \
            in report


def test_cli_exit_status():
    assert main(["--all-backends", "--device", "cpu", "--no-configs",
                 "--dtypes", "int8"]) == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_plan_validate_accepts_auto_mode_choices(device):
    for backend in ("blockflow", "matrixflow"):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for (M, K, N) in parity.SHAPES:
                P.plan(M, N, K, dtype, P.GemmPolicy(backend=backend),
                       device, validate=True)


def test_plan_validate_raises_for_a_bad_layout(monkeypatch):
    """A block geometry the card's kernel is not built for (bn 48) fails
    the contract's precondition before anything launches."""
    P.plan_cache_clear()
    real = L.choose_layout
    monkeypatch.setattr(L, "choose_layout", lambda *a, **k: dataclasses.replace(
        real(*a, **k), bn=48))
    try:
        with pytest.raises(ContractViolationError, match="instantiated block"):
            P.plan(64, 96, 48, torch.bfloat16,
                   P.GemmPolicy(backend="matrixflow"), "cuda", validate=True)
        P.plan(64, 96, 48, torch.bfloat16,       # plain on the CPU: no grid
               P.GemmPolicy(backend="blockflow"), "cpu", validate=True)
    finally:
        P.plan_cache_clear()


def test_d16_flash_contract_is_the_guard_that_raises():
    """Parity's head dim 16 is not one the card's flash kernel is built
    for: its cuda contract carries exactly the precondition the wrapper
    raises today."""
    v = check_contract(get_contract_builder("flash_attention")(
        B=2, H=4, Hkv=2, Sq=32, Sk=32, D=16, Dv=16, device="cuda"))
    assert kinds(v) == {"precondition"} and len(v) == 1
    q = torch.empty((2, 32, 4, 16), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 32, 2, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError) as e:
        FA.flash_attention(q, kv, kv)
    assert v[0].detail == f"instantiated head dims: {e.value}"


def test_card_contracts_cover_their_outputs():
    """The blocks a card contract writes are every block of its output: the
    set the coverage probe holds each launch to."""
    c = get_contract_builder("matrixflow_gemm")(
        a_shape=(3, 4, 64, 64), b_shape=(5, 4, 64, 32),
        blk=L.BlockLayout(64, 32, 64), device="cuda")
    assert touched_blocks(c, "c_bm") == set(np.ndindex(1, 3, 5, 1, 1))
    c = get_contract_builder("flash_attention")(
        B=1, H=6, Hkv=2, Sq=1, Sk=1024, D=64, Dv=64, device="cuda")
    assert c.cluster > 1 and "split" in c.description
    assert touched_blocks(c, "o") == {(0, g, 0, 0) for g in range(2)}
    from repro_torch.analysis.probe import written_rows
    assert written_rows(16, 0, 3, 3, 1) == [(0, 3), (0, 4), (0, 5)]


# ---------------------------------------------------------------------------
# Tier 2: the mutation suite, on the reference's contract and the port's
# ---------------------------------------------------------------------------

GEMM_KW = dict(a_shape=(4, 3, 8, 8), b_shape=(5, 3, 8, 8))


def port_gemm(**over):
    kw = dict(GEMM_KW, blk=L.BlockLayout(8, 8, 8), device="cpu")
    kw.update(over)
    return get_contract_builder("matrixflow_gemm")(**kw)


def ref_gemm(**over):
    kw = dict(GEMM_KW, blk=JL.BlockLayout(bm=8, bn=8, bk=8))
    kw.update(over)
    return jget_contract_builder("matrixflow_gemm")(**kw)


def port_paged(**over):
    return get_contract_builder("paged_attention")(
        **dict(PAGED_KW, device="cpu", **over))


def ref_paged(**over):
    return jget_contract_builder("paged_attention")(**dict(PAGED_KW, **over))


def as_port(c) -> KernelContract:
    """The reference's declarative contract in the port's dataclasses."""
    return KernelContract(
        kernel=c.kernel, grid=tuple(c.grid),
        operands=tuple(OperandSpec(
            o.name, o.role, tuple(o.nblocks), tuple(o.block_shape),
            o.index_map, tuple(o.reduction_axes), o.expected_blocks,
            o.check_coverage) for o in c.operands),
        dimension_semantics=tuple(c.dimension_semantics),
        sequential_axes=tuple(c.sequential_axes),
        preconditions=tuple(Precondition(p.name, p.ok, p.message)
                            for p in c.preconditions),
        description=c.description)


def mutate(contract, op_name, **changes):
    ops = tuple(dataclasses.replace(op, **changes) if op.name == op_name
                else op for op in contract.operands)
    return dataclasses.replace(contract, operands=ops)


def revisit_mutant(K, O):
    return K(kernel="mutant", grid=(2, 2, 2),
             operands=(O("o", "output", (2, 2), (1, 1),
                         lambda k, i, j: (i, j), reduction_axes=(0,)),),
             dimension_semantics=("arbitrary", "parallel", "parallel"))


# (name, the mutation of a contract built by ``make``, the kinds expected
# — the reference test's assertions)
MUTATIONS = [
    ("off_by_one_index_map", "gemm",
     lambda c: mutate(c, "a_bm", index_map=lambda i, j, k: (i + 1, k, 0, 0)),
     {"bounds"}),
    ("swapped_axes", "gemm",
     lambda c: mutate(c, "a_bm", index_map=lambda i, j, k: (j, k, 0, 0)),
     {"bounds"}),
    ("missing_reduction_axis", "gemm",
     lambda c: mutate(c, "c_bm", reduction_axes=()), {"write_race"}),
    ("dropped_divisibility_guard", "gemm_k2", lambda c: c, {"precondition"}),
    ("coverage_hole", "gemm",
     lambda c: mutate(c, "c_bm", index_map=lambda i, j, k: (i, 0, 0, 0)),
     {"coverage"}),
    ("parallel_reduction_axis", "gemm",
     lambda c: dataclasses.replace(
         c, dimension_semantics=("parallel", "parallel", "parallel")),
     {"semantics"}),
    ("zero_extent_grid", "gemm",
     lambda c: dataclasses.replace(c, grid=(4, 5, 0)), {"grid"}),
    ("empty_block_table", "paged_empty", lambda c: c, {"precondition"}),
    ("out_of_range_block_table", "paged_oob", lambda c: c, {"bounds"}),
    ("non_contiguous_revisit", "revisit", lambda c: c, {"revisit_order"}),
]
MAKERS = {
    "gemm": (port_gemm, ref_gemm),
    "gemm_k2": (lambda: port_gemm(b_shape=(5, 2, 8, 8)),
                lambda: ref_gemm(b_shape=(5, 2, 8, 8))),
    "paged_empty": (lambda: port_paged(block_tables=np.zeros((2, 0), np.int32)),
                    lambda: ref_paged(block_tables=np.zeros((2, 0), np.int32))),
    "paged_oob": (
        lambda: port_paged(block_tables=np.array([[2, 0, 9], [1, 3, 4]])),
        lambda: ref_paged(block_tables=np.array([[2, 0, 9], [1, 3, 4]]))),
}


@pytest.mark.parametrize("name,make,mut,expect", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_mutation_same_kinds_as_reference(name, make, mut, expect):
    from repro.analysis import KernelContract as JK
    from repro.analysis import OperandSpec as JO
    if make == "revisit":
        port_c, ref_c = revisit_mutant(KernelContract, OperandSpec), \
            revisit_mutant(JK, JO)
    else:
        mk_port, mk_ref = MAKERS[make]
        port_c, ref_c = mut(mk_port()), mut(mk_ref())
    want = kinds(jcheck_contract(ref_c))
    assert expect <= want
    assert kinds(check_contract(as_port(ref_c))) == want
    assert kinds(check_contract(port_c)) == want


def test_mutation_suite_spans_every_kind():
    caught = set()
    for name, make, mut, expect in MUTATIONS:
        caught |= expect
    caught |= kinds(check_contract(cluster_mutant(9)))
    assert caught == set(VIOLATION_KINDS)


def split_gemm():
    """K1 on its mma route at a decode shape: K split over 8 CTAs of one
    cluster (tc_tile), the split axis declared "cluster"."""
    c = get_contract_builder("matrixflow_gemm")(
        a_shape=(1, 32, 16, 32), b_shape=(2, 32, 32, 128),
        blk=L.BlockLayout(16, 128, 32), device="cuda")
    assert c.dimension_semantics[2] == "cluster" and c.cluster == 8
    assert check_contract(c) == []
    return c


def cluster_mutant(n):
    """K1's mma launch with its K split over ``n`` CTAs of one cluster:
    tc_tile allowed more splits than a portable cluster holds."""
    from repro_torch.kernels import matrixflow_gemm as MF
    old = MF.MAX_SPLITS
    MF.MAX_SPLITS = n
    try:
        c = get_contract_builder("matrixflow_gemm")(
            a_shape=(1, 36, 16, 32), b_shape=(1, 36, 32, 128),
            blk=L.BlockLayout(16, 128, 32), device="cuda")
    finally:
        MF.MAX_SPLITS = old
    assert c.cluster == c.grid[2] == n
    return c


def test_mutation_cluster_of_nine_is_semantics():
    """A tenth defect: a split over 9 CTAs outgrows the portable cluster
    (MAX_CLUSTER = 8), and an axis longer than the launch's cluster
    cannot add its partials in one."""
    assert MAX_CLUSTER == 8
    v = check_contract(cluster_mutant(9))
    assert kinds(v) == {"semantics"}
    assert "portable cluster size" in v[0].detail
    c = split_gemm()
    assert kinds(check_contract(dataclasses.replace(c, cluster=4))) == \
        {"semantics"}


def test_aliasing_parallel_axis_stays_a_race():
    c = split_gemm()
    par = dataclasses.replace(c, dimension_semantics=(
        "parallel", "parallel", "parallel", "arbitrary"))
    assert kinds(check_contract(par)) == {"semantics"}
    v = check_contract(mutate(par, "c_bm", reduction_axes=(3,)))
    assert kinds(v) == {"write_race"}


def test_require_raises_value_error_not_assertion():
    with pytest.raises(ValueError, match="broke"):
        require(Precondition.check("x", False, "it broke"),
                Precondition.check("y", True, "fine"))
    require(Precondition.check("y", True, "fine"))
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 3, 16))                  # 4 % 3 != 0
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention(q, kv, kv)


def test_contract_violation_error_formats_all():
    v = check_contract(port_gemm(b_shape=(5, 2, 8, 8)))
    err = ContractViolationError(v)
    assert "precondition" in str(err) and err.violations == tuple(v)


# ---------------------------------------------------------------------------
# Tier 3: drift guards and the lint
# ---------------------------------------------------------------------------

def test_sweep_grid_matches_parity_and_reference():
    """Drift guard: the static sweep covers the cells the runtime parity
    harness proves, as the reference's sweep does. Extend them together."""
    assert SW.GEMM_SHAPES == parity.SHAPES == JSW.GEMM_SHAPES
    assert SW.GEMM_DTYPES == parity.DTYPES == JSW.GEMM_DTYPES
    assert SW.ATTN_PAGE_SIZE == parity.ATTN_PAGE_SIZE == JSW.ATTN_PAGE_SIZE
    assert (SW.ATTN_BLOCK, SW.ATTN_HEAD_DIM) == (JSW.ATTN_BLOCK,
                                                 JSW.ATTN_HEAD_DIM)
    assert SW.ATTN_DTYPES == parity.ATTN_DTYPES
    mirrored = tuple((c.name, c.B, c.Sq, c.T, c.H, c.Hkv)
                     for c in parity.ATTN_CASES)
    assert SW.ATTN_CASES == mirrored == JSW.ATTN_CASES
    assert SW.ATTN_CASE_SEMANTICS == {
        c.name: (c.causal, c.q_offsets, c.kv_lens) for c in parity.ATTN_CASES}
    for (name, B, Sq, T, H, Hkv) in SW.ATTN_CASES:
        np.testing.assert_array_equal(SW._paged_block_tables(B, T),
                                      JSW._paged_block_tables(B, T))


META = torch.ones(4, device="meta")


def record_int8_launch(x):
    """A launch record as a wrapper leaves on meta: int8 pools, no scales."""
    RA.record_launch("paged_attention", "split", B=1, Sq=1, H=2, Hkv=1, D=16,
                     page_size=16, n_blocks=2, dtype=torch.bfloat16,
                     kv_dtype=torch.int8)
    return x


LINT_STEPS = [
    ("host-sync", lambda x: x * x.sum().item()),
    ("host-sync", lambda x: x.cpu()),
    ("host-sync", lambda x: x[x > 0]),
    ("fp64-promotion", lambda x: x.double() + 1),
    ("host-transfer", lambda x: x + torch.arange(4).to(x.device)),
    ("int8-pool-no-scales", record_int8_launch),
]


@pytest.mark.parametrize("rule,step", LINT_STEPS,
                         ids=[f"{r}{i}" for i, (r, _) in enumerate(LINT_STEPS)])
def test_lint_rule_fires(rule, step):
    assert rule in LINT_RULES
    findings = lint_step(step, META)
    assert {f.rule for f in findings} == {rule}, findings
    assert lint_step(lambda x: (x * 2).sum(0), META) == []


@pytest.fixture(scope="module")
def jax_smoke():
    """The reference's smoke config and params of its shapes (zeros: the
    lint reads shapes and dtypes only)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config
    from repro.models import transformer as JT
    cfg = get_smoke_config("smollm-135m", n_layers=2, vocab=64)
    shapes = jax.eval_shape(
        lambda: JT.init_model(jax.random.PRNGKey(0), cfg)[0])
    return cfg, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def test_instrumented_engine_lints_clean(jax_smoke):
    """The counterpart of tests/test_obs.py's lint test: the port's
    instrumented smollm smoke engine's prefill and decode steps, on meta at
    the card's routes, hold no host sync, fp64, per-step transfer or
    scale-less int8 pool — and the reference's lint of the JAX engine on the
    same config finds nothing either."""
    from repro.analysis.trace_lint import lint_engine as jlint_engine
    from repro.obs import Observability as JObservability
    from repro.serving.engine import ServeConfig as JServeConfig
    from repro.serving.engine import ServingEngine as JServingEngine
    eng = lint_engine_for("smollm-135m", "cpu")
    assert eng.obs.enabled and eng.paged
    assert lint_engine(eng) == []
    cfg, params = jax_smoke
    jeng = JServingEngine(cfg, params, JServeConfig(
        batch_slots=2, max_len=32, obs=JObservability()))
    assert jlint_engine(jeng) == []
