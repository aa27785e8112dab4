"""Declarative kernel contracts and a static checker of launch grids
(``repro/analysis/kernel_contracts.py``, for the card's launches).

MatrixFlow's correctness story (paper §3.3) rests on a *provably correct
dataflow mapping*: every operand block is fetched exactly when the schedule
needs it, every output block is written by a deterministic revisit sequence
along the K-stream, and nothing ever reads past the blocked array. On the
card that mapping is the CUDA kernels' grid and the block indices each CTA
computes from ``blockIdx`` — which nothing checked until a runtime test
happened to hit the broken cell.

This module makes the mapping a first-class, checkable object:

  * each kernel registers a **contract builder**
    (:func:`register_contract`) that, for concrete shapes and a device,
    produces a :class:`KernelContract` — the grid, the per-operand block
    geometry and each CTA's index maps. For a CUDA device the builder
    takes the route, grid and cluster shape from the functions the launch
    itself calls and writes each index map beside the launch, citing the
    ``.cu`` line that computes the same index; for the CPU it gives the
    reference's geometry;
  * :func:`check_contract` exhaustively enumerates the grid and verifies

      - **preconditions** — the structured shape guards the wrappers
        raise as ``ValueError``, evaluated without running anything;
      - **bounds** — no index map ever exceeds the blocked array;
      - **coverage** — every input block is fetched and every output block
        written (a paged contract narrows coverage to the pages its block
        table actually references — distractor pages are dead by design);
      - **write races / revisit order** — grid points aliasing an output
        block must differ only along declared reduction axes, those axes
        must be sequential (``"arbitrary"`` dimension semantics — a
        parallel axis revisiting an output block is a race) or the CTAs of
        one thread-block cluster (``"cluster"``, below), and the revisit
        must be one contiguous run in grid-linear order (the paper's dc/dm
        discipline: leave a C block and come back, and the flush order is
        undefined).

Two things the card needs that the TPU grid did not:

  * **a reduction a thread-block cluster performs.** K1's and K2's ``mma``
    split and K3's, K4's and K5's ``split`` route give one output tile to
    the CTAs of a cluster, which run in parallel and add their partials
    through distributed shared memory. Such an axis is declared
    ``"cluster"``: it may alias an output block when its extent is no more
    than the cluster dimension the launch sets (``KernelContract.cluster``)
    and that dimension is at most :data:`MAX_CLUSTER`, the portable
    cluster size; otherwise it is a ``semantics`` violation. An aliasing
    ``"parallel"`` axis stays a ``write_race``.
  * **predicated-off points.** A CTA past a ragged edge of the block grid,
    or a split rank past the end of its share of the K stream, skips the
    access behind a guard; its index map returns ``None`` there (the
    guard's own predicate), and the point touches nothing.

Violations surface as structured :class:`ContractViolation` records —
``python -m repro_torch.analysis`` sweeps them over the backend registry,
``plan(validate=True)`` gates auto-mode block choices (core/plan.py), and
the tests' mutation suite proves each defect class is actually caught.

This module is dependency-light on purpose (dataclasses + numpy): kernel
modules import it at module scope to register their contracts.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Precondition", "OperandSpec", "KernelContract",
    "ContractViolation", "ContractViolationError",
    "check_contract", "require", "touched_blocks",
    "register_contract", "registered_contracts", "get_contract_builder",
    "load_builtin_contracts", "MAX_CLUSTER", "VIOLATION_KINDS",
]

# Kinds a ContractViolation can carry (the violation catalog —
# docs/analysis.md#violation-catalog documents each with its defect class).
VIOLATION_KINDS = (
    "precondition",    # a structured divisibility/shape guard failed
    "grid",            # degenerate grid: an output exists but never runs
    "bounds",          # an index map exceeded the blocked array
    "coverage",        # an input/output block is never fetched/written
    "write_race",      # output block aliased across non-reduction axes
    "revisit_order",   # output revisit is not one contiguous sequential run
    "semantics",       # a reduction/carry axis is declared "parallel",
                       # or a cluster axis outgrows its cluster
)

# CTAs one thread-block cluster may hold portably (the cluster size every
# Hopper launch may take without opting in to a non-portable one).
MAX_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class Precondition:
    """One structured kernel precondition, evaluated at contract build.

    The kernel modules build these from the same predicates their runtime
    ``ValueError`` guards raise (:func:`require`), so the static checker
    and the runtime cite identical conditions.
    """

    name: str          # short predicate, e.g. "H % Hkv == 0"
    ok: bool
    message: str       # full diagnostic with the concrete values

    @classmethod
    def check(cls, name: str, ok: bool, message: str) -> "Precondition":
        return cls(name=name, ok=bool(ok), message=message)


def require(*preconditions: Precondition) -> None:
    """Raise ``ValueError`` listing every failed precondition.

    The runtime twin of the static pass: kernels call this where a bare
    ``assert`` used to sit (asserts vanish under ``python -O``; these
    don't), and their contract builders hand the same Precondition tuple
    to the checker.
    """
    bad = [p for p in preconditions if not p.ok]
    if bad:
        raise ValueError("; ".join(p.message for p in bad))


@dataclasses.dataclass(frozen=True)
class OperandSpec:
    """One kernel operand: blocked geometry + the kernel's index map.

    nblocks        blocked-array shape — blocks per dim, the index map's
                   codomain (bounds: 0 <= idx[d] < nblocks[d]).
    block_shape    elements per block per dim (documentation + divisibility
                   context in reports; the checker works at block
                   granularity — padding to block multiples is the
                   kernels' own precondition).
    index_map      grid indices → block indices, as the CTA computes them
                   from its ``blockIdx`` and loop counters; ``None`` where
                   the kernel's guard predicates the access off. Paged
                   operands close over the concrete block table.
    role           "input" | "output".
    reduction_axes grid axes along which an *output* block may legally be
                   revisited (the accumulation stream; e.g. the GEMM K
                   axis). Inputs ignore this.
    expected_blocks  when set, coverage requires exactly this set of block
                   indices to be touched instead of the full cartesian
                   product — the paged pool's contract, where distractor
                   pages are intentionally never fetched.
    check_coverage False skips the coverage pass for this operand (e.g.
                   scalar-prefetch operands the grid consumes wholesale).
    """

    name: str
    role: str
    nblocks: Tuple[int, ...]
    block_shape: Tuple[int, ...]
    index_map: Callable[..., Tuple[int, ...]]
    reduction_axes: Tuple[int, ...] = ()
    expected_blocks: Optional[FrozenSet[Tuple[int, ...]]] = None
    check_coverage: bool = True

    def __post_init__(self):
        if self.role not in ("input", "output"):
            raise ValueError(f"operand role must be input/output, "
                             f"got {self.role!r}")
        if len(self.nblocks) != len(self.block_shape):
            raise ValueError(
                f"operand {self.name!r}: nblocks rank {len(self.nblocks)} "
                f"!= block_shape rank {len(self.block_shape)}")


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """The declarative dataflow mapping of one kernel instance.

    grid                 the grid (already concrete): the launch's CTA grid
                         and, innermost, the loops a CTA walks.
    dimension_semantics  per grid axis: "parallel" (CTAs, or the warps of
                         one, that run independently), "arbitrary" (a
                         sequential loop) or "cluster" (the CTAs of one
                         thread-block cluster, which may add partials of
                         one output block).
    sequential_axes      grid axes that carry state across steps
                         (accumulators, the SSD chunk scan) and therefore
                         must be "arbitrary" — checked even when no output
                         block is revisited along them.
    preconditions        the structured guards (see :class:`Precondition`).
    cluster              CTAs of one thread-block cluster the launch sets
                         along its cluster axis (1: no cluster).
    """

    kernel: str
    grid: Tuple[int, ...]
    operands: Tuple[OperandSpec, ...]
    dimension_semantics: Tuple[str, ...]
    sequential_axes: Tuple[int, ...] = ()
    preconditions: Tuple[Precondition, ...] = ()
    description: str = ""
    cluster: int = 1

    def __post_init__(self):
        if len(self.dimension_semantics) != len(self.grid):
            raise ValueError(
                f"contract {self.kernel!r}: {len(self.grid)} grid axes but "
                f"{len(self.dimension_semantics)} dimension semantics")

    def outputs(self) -> Tuple[OperandSpec, ...]:
        return tuple(op for op in self.operands if op.role == "output")


@dataclasses.dataclass(frozen=True)
class ContractViolation:
    """One structured defect found by the static pass."""

    kernel: str
    kind: str                          # one of VIOLATION_KINDS
    detail: str
    operand: Optional[str] = None
    grid_point: Optional[Tuple[int, ...]] = None

    def __str__(self) -> str:
        loc = f" operand={self.operand}" if self.operand else ""
        at = f" at grid{self.grid_point}" if self.grid_point else ""
        return f"[{self.kind}] {self.kernel}{loc}{at}: {self.detail}"


class ContractViolationError(ValueError):
    """Raised by callers that want violations to be fatal (plan validate)."""

    def __init__(self, violations: Sequence[ContractViolation]):
        self.violations = tuple(violations)
        super().__init__(
            f"{len(self.violations)} contract violation(s):\n  "
            + "\n  ".join(str(v) for v in self.violations))


# Exhaustive enumeration is the point — but guard against a pathological
# contract (a serving-scale grid) locking up the analysis run.
MAX_GRID_POINTS = 1 << 20


def _grid_points(grid: Tuple[int, ...]) -> np.ndarray:
    """All grid points in linear order (row-major, last axis innermost)
    as an (n_points, rank) int array."""
    return np.stack(np.meshgrid(*[np.arange(g) for g in grid],
                                indexing="ij"),
                    axis=-1).reshape(-1, len(grid))


def check_contract(contract: KernelContract, *,
                   max_grid_points: int = MAX_GRID_POINTS,
                   ) -> List[ContractViolation]:
    """Statically verify one contract; returns every violation found.

    Nothing is executed: the checker walks the grid, evaluates each
    operand's index map at every point, and compares the resulting
    fetch/write pattern against the declared dataflow. An empty list is
    the proof obligation every registered kernel must meet (python -m
    repro_torch.analysis).
    """
    v: List[ContractViolation] = []
    name = contract.kernel

    # -- preconditions: if the declared guards fail, the geometry below is
    # meaningless — report them and stop (the kernel would have raised).
    for p in contract.preconditions:
        if not p.ok:
            v.append(ContractViolation(name, "precondition",
                                       f"{p.name}: {p.message}"))
    if v:
        return v

    # -- grid sanity: a zero-extent axis means the flush step never runs —
    # outputs would be returned uninitialized (the PR 7 nb==0 regression).
    if any(g == 0 for g in contract.grid) and contract.outputs():
        v.append(ContractViolation(
            name, "grid",
            f"grid {contract.grid} has a zero-extent axis but the kernel "
            f"has outputs: the flush step never runs and the output "
            f"buffer is returned uninitialized"))
        return v

    n_points = int(np.prod([max(g, 1) for g in contract.grid], dtype=np.int64))
    if n_points > max_grid_points:
        raise ValueError(
            f"contract {name!r}: grid {contract.grid} has {n_points} points "
            f"(> {max_grid_points}); check a reduced shape — the contract "
            f"is shape-generic, the enumeration is not")

    # -- declared semantics: carry axes must be sequential, reduction axes
    # sequential or the CTAs of one cluster no larger than the launch's.
    seq_axes = set(contract.sequential_axes)
    red_axes = set()
    for op in contract.operands:
        if op.role == "output":
            red_axes.update(op.reduction_axes)
    for ax, sem in enumerate(contract.dimension_semantics):
        if sem != "cluster":
            continue
        if contract.grid[ax] > contract.cluster \
                or contract.cluster > MAX_CLUSTER:
            v.append(ContractViolation(
                name, "semantics",
                f"grid axis {ax} is declared 'cluster' with extent "
                f"{contract.grid[ax]}, but the launch's cluster holds "
                f"{contract.cluster} CTAs (at most {MAX_CLUSTER}, the "
                f"portable cluster size): the CTAs adding one block's "
                f"partials must all sit in one cluster"))
    for ax in sorted(seq_axes | red_axes):
        if ax >= len(contract.grid):
            v.append(ContractViolation(
                name, "semantics",
                f"declared sequential/reduction axis {ax} is outside the "
                f"{len(contract.grid)}-axis grid"))
        elif ax in red_axes and ax not in seq_axes \
                and contract.dimension_semantics[ax] == "cluster":
            continue
        elif contract.dimension_semantics[ax] != "arbitrary":
            v.append(ContractViolation(
                name, "semantics",
                f"grid axis {ax} carries accumulation/state but is "
                f"declared {contract.dimension_semantics[ax]!r}; a "
                f"parallel axis gives the compiler license to reorder "
                f"revisits — it must be 'arbitrary'"))

    points = _grid_points(contract.grid)
    pts = points.tolist()

    for op in contract.operands:
        rank = len(op.nblocks)
        steps, idx, bad = _evaluate(op, pts)
        if bad is not None:
            v.append(ContractViolation(
                name, "bounds",
                f"index map returned rank {bad[1]} for a rank-{rank} "
                f"blocked array", operand=op.name,
                grid_point=tuple(pts[bad[0]])))
            return v  # geometry broken; everything below is noise
        oob = np.flatnonzero(((idx < 0) | (idx >= np.array(op.nblocks)))
                             .any(axis=1))
        for i in oob[:3]:                       # cap the per-operand spam
            v.append(ContractViolation(
                name, "bounds",
                f"index map hit block {tuple(int(x) for x in idx[i])}, "
                f"outside the blocked array {op.nblocks} (block_shape="
                f"{op.block_shape})", operand=op.name,
                grid_point=tuple(pts[steps[i]])))
        if len(oob) > 3:
            v.append(ContractViolation(
                name, "bounds",
                f"... and {len(oob) - 3} more out-of-bounds fetches",
                operand=op.name))
        if len(oob):
            continue                    # coverage/races would double-count
        if len(idx):
            lin, inv = np.unique(np.ravel_multi_index(idx.T, op.nblocks),
                                 return_inverse=True)
            blocks = np.stack(np.unravel_index(lin, op.nblocks), axis=1)
            inv = inv.reshape(-1)
        else:
            blocks, inv = idx, np.zeros(0, dtype=np.int64)
        touched = set(map(tuple, blocks.tolist()))

        # -- coverage
        verb = "written" if op.role == "output" else "fetched"
        if op.check_coverage:
            if op.expected_blocks is None:
                total = int(np.prod(op.nblocks, dtype=np.int64))
                if len(touched) != total:
                    missing = _first_missing(op.nblocks, touched)
                    v.append(ContractViolation(
                        name, "coverage",
                        f"{total - len(touched)} of {total} blocks never "
                        f"{verb} (first missing: {missing})",
                        operand=op.name))
            else:
                missing_set = op.expected_blocks - touched
                if missing_set:
                    v.append(ContractViolation(
                        name, "coverage",
                        f"{len(missing_set)} required blocks never {verb} "
                        f"(first: {sorted(missing_set)[0]})",
                        operand=op.name))

        # -- write races + revisit order (outputs only): the grid points
        # writing each block, grouped, their extent per axis and steps
        if op.role != "output" or not len(idx):
            continue
        red = set(op.reduction_axes)
        order = np.argsort(inv, kind="stable")
        grouped = inv[order]
        starts = np.r_[0, np.flatnonzero(np.diff(grouped)) + 1]
        counts = np.diff(np.r_[starts, len(order)])
        at = steps[order]
        gp = points[at]
        lo = np.minimum.reduceat(gp, starts, axis=0)
        hi = np.maximum.reduceat(gp, starts, axis=0)
        first = np.minimum.reduceat(at, starts)
        last = np.maximum.reduceat(at, starts)
        for g in np.flatnonzero(counts > 1):
            blk = tuple(int(x) for x in blocks[grouped[starts[g]]])
            n = int(counts[g])
            varying = {int(ax) for ax in np.flatnonzero(lo[g] != hi[g])}
            illegal = varying - red
            if illegal:
                v.append(ContractViolation(
                    name, "write_race",
                    f"block {blk} is written from {n} grid points "
                    f"that differ along non-reduction axes "
                    f"{sorted(illegal)} (declared reduction axes: "
                    f"{sorted(red)}) — concurrent grid points would race "
                    f"on the same output window",
                    operand=op.name))
                continue
            if int(last[g] - first[g]) + 1 != n:
                run = sorted(int(x) for x in at[starts[g]:starts[g] + 4])
                v.append(ContractViolation(
                    name, "revisit_order",
                    f"block {blk} is revisited non-contiguously (grid-"
                    f"linear steps {run}...): the block is flushed, "
                    f"left, and re-entered — the dc/dm revisit order must "
                    f"be one sequential run",
                    operand=op.name))
    return v


def _evaluate(op: OperandSpec, pts):
    """``op``'s index map at every grid point of ``pts``: (the steps it
    touches, their block indices as an (n, rank) array, and (step, rank)
    of the first result of the wrong rank, else None). A None result is a
    predicated-off point and touches nothing."""
    rank = len(op.nblocks)
    raw = [op.index_map(*gp) for gp in pts]
    steps = [i for i, idx in enumerate(raw) if idx is not None]
    vals = raw if len(steps) == len(raw) else [raw[i] for i in steps]
    try:
        idx = np.array(vals, dtype=np.int64).reshape(len(vals), -1)
    except ValueError:                       # results of mixed ranks
        idx = None
    if idx is None or idx.shape[1:] != (rank,):
        i = next(i for i, v in zip(steps, vals)
                 if len(v if isinstance(v, tuple) else (v,)) != rank)
        v = raw[i]
        return None, None, (i, len(v if isinstance(v, tuple) else (v,)))
    return np.array(steps, dtype=np.int64), idx, None


def touched_blocks(contract: KernelContract, operand: str) -> set:
    """The blocks of ``operand`` the contract's grid touches (for an
    output, the blocks it writes): what a runtime probe holds a launch to."""
    op = next(o for o in contract.operands if o.name == operand)
    _, idx, _ = _evaluate(op, _grid_points(contract.grid).tolist())
    return set(map(tuple, np.unique(idx, axis=0).tolist())) if len(idx) \
        else set()


def _first_missing(nblocks: Tuple[int, ...], touched) -> Tuple[int, ...]:
    for idx in np.ndindex(*nblocks):
        if tuple(int(i) for i in idx) not in touched:
            return tuple(int(i) for i in idx)
    return ()


# ---------------------------------------------------------------------------
# Registry: kernels register a builder; the sweep/CLI resolves by name
# ---------------------------------------------------------------------------

_CONTRACTS: Dict[str, Callable[..., KernelContract]] = {}

# Modules whose import registers the built-in contracts (each kernel
# registers its own builder at import time, next to its index maps).
_BUILTIN_MODULES = (
    "repro_torch.kernels.ref",
    "repro_torch.kernels.matrixflow_gemm",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.paged_attention",
    "repro_torch.kernels.ssd_scan",
)


def register_contract(name: str, *, overwrite: bool = False):
    """Decorator: register ``fn(**shape_kwargs) -> KernelContract``
    (each builder also takes ``device``)."""
    def deco(fn):
        if name in _CONTRACTS and not overwrite:
            raise ValueError(f"contract {name!r} already registered")
        _CONTRACTS[name] = fn
        return fn
    return deco


def load_builtin_contracts() -> None:
    """Import every kernel module so its contract builder registers."""
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def get_contract_builder(name: str) -> Callable[..., KernelContract]:
    if name not in _CONTRACTS:
        load_builtin_contracts()
    if name not in _CONTRACTS:
        raise ValueError(f"unknown kernel contract {name!r}; registered: "
                         f"{sorted(_CONTRACTS)}")
    return _CONTRACTS[name]


def registered_contracts() -> Tuple[str, ...]:
    load_builtin_contracts()
    return tuple(sorted(_CONTRACTS))
