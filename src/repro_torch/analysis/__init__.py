"""Static analysis of the port's kernel launches and serving steps
(``repro/analysis``).

Two passes, both *ahead of execution*:

  * :mod:`repro_torch.analysis.kernel_contracts` — declarative
    :class:`~repro_torch.analysis.kernel_contracts.KernelContract`\\ s
    registered by each kernel wrapper (and the blockflow plain version),
    plus a checker that exhaustively enumerates a launch's grid and
    verifies coverage, bounds, preconditions, and write-ordering (the
    paper's dc/dm block-revisit discipline, and the reduction a
    thread-block cluster performs — checked, not assumed).
  * :mod:`repro_torch.analysis.trace_lint` — a lint of the serving steps,
    run on ``meta`` tensors under a ``TorchDispatchMode`` (or for real on
    the card): host syncs, silent fp64 promotions, per-step host-to-device
    copies, and int8 KV pools reaching a kernel without scales.

``python -m repro_torch.analysis --all-backends`` sweeps every registered
GEMM/attention backend over the parity shape×dtype grid and the configs/
registry, on the card's routes (``--device cuda``, the default, worked out
without a card) or the CPU's, and prints a violation report.
"""
from repro_torch.analysis.kernel_contracts import (
    ContractViolation,
    ContractViolationError,
    KernelContract,
    OperandSpec,
    Precondition,
    check_contract,
    get_contract_builder,
    load_builtin_contracts,
    register_contract,
    registered_contracts,
    require,
)
from repro_torch.analysis.trace_lint import (
    LINT_RULES,
    LintFinding,
    lint_engine,
    lint_step,
)
from repro_torch.analysis.sweep import run_sweep

__all__ = [
    "ContractViolation", "ContractViolationError", "KernelContract",
    "OperandSpec", "Precondition", "check_contract", "get_contract_builder",
    "load_builtin_contracts", "register_contract", "registered_contracts",
    "require",
    "LINT_RULES", "LintFinding", "lint_engine", "lint_step", "run_sweep",
]
