"""``python -m repro_torch.analysis`` — the static-analysis gate.

Sweeps every registered kernel contract over the backend registry × the
parity shape/dtype grid (and the configs/ registry), on the card's launches
(``--device cuda``, the default: routes, grids and clusters worked out
without a card) or the CPU's plain versions, printing a violation report
and the count of contract instances by kernel and route; optionally lints
a smoke serving engine's prefill and decode steps. Exit status is the
violation count clamped to 1.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.analysis import sweep as S


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--all-backends", action="store_true",
                    help="sweep every backend in the registry (the default "
                         "sweeps them too; the flag is the explicit CI "
                         "spelling)")
    ap.add_argument("--backends", nargs="+", default=None,
                    help="restrict the GEMM sweep to these backends")
    ap.add_argument("--dtypes", nargs="+", default=list(S.GEMM_DTYPES),
                    choices=list(S.GEMM_DTYPES))
    ap.add_argument("--no-configs", action="store_true",
                    help="skip the configs/ registry sweep")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="whose launches to check: the card's (no card "
                         "needed) or the CPU's plain versions; also where "
                         "--lint-engine builds its engine")
    ap.add_argument("--lint-engine", metavar="ARCH", default=None,
                    help="also build a smoke ServingEngine for ARCH "
                         "(configs/ registry, observability on) on --device "
                         "and lint its prefill/decode steps on meta tensors "
                         "(repro_torch.analysis.trace_lint); on cuda, also "
                         "live")
    args = ap.parse_args(argv)

    backends = None if args.all_backends else args.backends
    _, n_bad = S.run_sweep(gemm_backends=backends, dtypes=args.dtypes,
                           include_configs=not args.no_configs,
                           device=args.device)
    if args.lint_engine:
        n_bad += _lint_engine(args.lint_engine, args.device)
    return 1 if n_bad else 0


def lint_engine_for(arch: str, device: str):
    """The smoke engine the CLI lints: ``arch`` at 2 layers and a 64-token
    vocab, 2 slots of 32 tokens, observability on — the lint proves the
    instrumented engine's steps free of host syncs: all telemetry lives
    on the host side of the step."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    cfg = get_smoke_config(arch, n_layers=2, vocab=64)
    params = T.init_model(cfg, seed=0, device=device)
    return ServingEngine(cfg, params, ServeConfig(
        batch_slots=2, max_len=32, device=device, obs=Observability()))


def _lint_engine(arch: str, device: str) -> int:
    """Lint the smoke engine's steps on meta (and live on the card)."""
    from repro_torch.analysis.trace_lint import lint_engine, lint_report
    n = lint_report(lint_engine(lint_engine_for(arch, device)),
                    f"{arch} meta")
    if device == "cuda":
        n += lint_report(lint_engine(lint_engine_for(arch, device),
                                     live=True), f"{arch} live")
    return n


if __name__ == "__main__":
    sys.exit(main())
