"""A lint of the serving steps (``repro/analysis/trace_lint.py``, for
eager PyTorch).

The second static pass: where ``kernel_contracts`` verifies the *dataflow
mapping* of each kernel, this module verifies what the serving steps do
around the kernels — ``serving/engine.py::make_prefill_step`` and
``make_decode_step`` are the two programs that run per request, and a
single host sync or silent fp64 upcast in either one is a fleet-wide
regression no parity test notices.

The reference traces the jitted closures with ``jax.make_jaxpr``. The port
has no trace to read, so it runs the step once under a
``TorchDispatchMode`` that sees every aten op (the dry run's mechanism,
``launch/dryrun.py::OpCounter``): on ``meta`` tensors by default, where
nothing runs, no cache byte is touched and the kernel wrappers take the
card's routes through their ``meta`` paths (recording each launch in a
cost ledger); or, with ``live=True`` on the card, for real.

Rules (each is a ``LintFinding.rule``), with the reference rule each one
answers:

  host-sync            (answers ``host-callback``) the host waits on the
                       device inside the step: ``aten._local_scalar_dense``
                       (``.item()``, ``int(t)``), a copy from the step's
                       device to the CPU, or ``aten.nonzero`` /
                       ``masked_select`` (and indexing by a bool mask,
                       which runs nonzero), whose data-dependent shapes
                       force a sync on CUDA.
  fp64-promotion       an op yields float64 from inputs that hold none: a
                       silent promotion (a Python float, an ``np.float64``
                       constant, a plain path's float64 accumulator) that
                       doubles the bandwidth of everything downstream.
  host-transfer        (answers ``weak-type``) a CPU tensor made inside the
                       step reaches the device on every step: a copy from
                       the CPU to the step's device, or a CPU tensor (not a
                       0-dim scalar) among a device op's inputs. Eager
                       torch pays it per step where JAX pays a retrace.
  int8-pool-no-scales  a ``paged_attention`` launch record with int8 pools
                       and no ``kv_scales``: the kernel would read quantized
                       codes as values (``meta`` only: a live launch leaves
                       no record).

A ``.item()`` (or a copy to the CPU) on ``meta`` has no value to give: the
mode records the finding first, then goes on with a placeholder (zero, or
an empty or zero tensor), so one run reports every finding of the step.
"""
from __future__ import annotations

import dataclasses
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.roofline import analysis as RA

__all__ = ["LintFinding", "lint_step", "lint_engine", "LINT_RULES",
           "LintMode"]

LINT_RULES = (
    "host-sync",
    "fp64-promotion",
    "host-transfer",
    "int8-pool-no-scales",
)

aten = torch.ops.aten
# Ops whose result the host must wait for: a scalar read, and the ops whose
# output shape depends on the data.
_SCALAR_READ = {aten._local_scalar_dense}
_DATA_SHAPED = {aten.nonzero, aten.masked_select}
_COPIES = {aten._to_copy, aten.copy_}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One hazard found in a serving step."""

    rule: str                  # one of LINT_RULES
    message: str
    path: str                  # e.g. "decode/aten.nonzero.default"

    def __str__(self) -> str:
        return f"[{self.rule}] {self.path}: {self.message}"


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _site() -> str:
    """The innermost frame of the step's own code (outside this module and
    torch): where the op was issued."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        f = fr.filename.replace("\\", "/")
        if "/torch/" in f or f.endswith("analysis/trace_lint.py"):
            continue
        return f"{f.rsplit('/src/', 1)[-1]}:{fr.lineno} ({fr.name})"
    return "?"


def _mask_index(func, args) -> bool:
    """Indexing by a bool mask: ``x[mask]`` runs ``nonzero``."""
    return func.overloadpacket is aten.index and any(
        isinstance(i, torch.Tensor) and i.dtype == torch.bool
        for i in args[1])


def _placeholder(func, args, kwargs):
    """What a value-needing op gives on ``meta``: zero for a scalar read,
    an empty result for a data-shaped op, zeros on the CPU for a copy
    there."""
    packet = func.overloadpacket
    x = args[0]
    if packet in _SCALAR_READ:
        return False if x.dtype == torch.bool else (
            0.0 if x.dtype.is_floating_point else 0)
    if packet is aten.nonzero:
        return torch.zeros((0, x.dim()), dtype=torch.long, device=x.device)
    if packet is aten.masked_select:
        return torch.zeros((0,), dtype=x.dtype, device=x.device)
    if packet is aten.copy_:
        return x
    if packet is aten.index:             # an empty selection for each mask
        idx = []
        for i in args[1]:
            if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
                idx += [torch.zeros(0, dtype=torch.long, device=i.device)] \
                    * i.dim()
            else:
                idx.append(i)
        return func(x, idx)
    return torch.zeros(x.shape, dtype=kwargs.get("dtype") or x.dtype,
                       device="cpu")


class LintMode(TorchDispatchMode):
    """Records the lint's findings for the aten ops run while it is
    active, as a step on ``device_type`` ("meta" or "cuda") runs them."""

    def __init__(self, device_type: str, path: str):
        super().__init__()
        self.device_type = device_type
        self.path = path
        self.findings: List[LintFinding] = []

    def _add(self, rule: str, func, message: str) -> None:
        self.findings.append(LintFinding(
            rule, f"{message} at {_site()}", f"{self.path}/{func}"))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        dev = self.device_type
        on_device = [t for t in ins if t.device.type == dev]
        sync = False
        if (packet in _SCALAR_READ | _DATA_SHAPED or _mask_index(func, args)) \
                and args[0].device.type != "cpu":
            sync = True
            self._add("host-sync", func,
                      f"{func} waits for the device's values on the host "
                      f"(a scalar read or a data-dependent shape): the "
                      f"device drains every step — keep the value on the "
                      f"device")
        elif packet in _COPIES:
            if packet is aten._to_copy:
                src = args[0].device.type
                dst = torch.device(kwargs.get("device") or args[0].device).type
            else:
                dst, src = args[0].device.type, args[1].device.type
            if src == dev != "cpu" and dst == "cpu":
                sync = True
                self._add("host-sync", func,
                          f"{func} copies a {dev} tensor to the CPU: the host "
                          f"waits for the device every step")
            elif src == "cpu" and dst == dev != "cpu":
                self._add("host-transfer", func,
                          f"{func} copies a CPU tensor to {dev} inside the "
                          f"step: a host-to-device transfer every step — "
                          f"make it on the device")
        elif on_device and dev != "cpu" and any(
                t.device.type == "cpu" and t.dim() > 0 for t in ins):
            self._add("host-transfer", func,
                      f"{func} takes a CPU tensor beside {dev} ones: it "
                      f"crosses to the device every step — make it there")
        if sync and dev == "meta":
            out = _placeholder(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(t.dtype == torch.float64 for t in outs) \
                and not any(t.dtype == torch.float64 for t in ins):
            self._add("fp64-promotion", func,
                      f"{func} yields float64 {[tuple(t.shape) for t in outs]}"
                      f" from inputs that hold none: a silent promotion that "
                      f"doubles downstream bandwidth — cast explicitly")
        return out


def _check_records(records: List[Dict], path: str) -> List[LintFinding]:
    out = []
    for r in records:
        if not r["kernel"].startswith("paged_attention"):
            continue
        kv = r.get("kv_dtype")
        if kv is not None and RA.dtype_name(kv) == "int8" \
                and not r.get("kv_scales"):
            out.append(LintFinding(
                "int8-pool-no-scales",
                f"a {r['kernel']} launch ({r['route']} route) reads int8 "
                f"page pools with no kv_scales: the kernel would treat "
                f"quantized codes as values — pass kv_scales=(k_scales, "
                f"v_scales) of shape (P, Hkv)", f"{path}/{r['kernel']}"))
    return out


def _device_type(args) -> str:
    types = {t.device.type for t in _tensors(args)} - {"cpu"}
    if len(types) > 1:
        raise ValueError(f"a step over tensors on {sorted(types)}: lint one "
                         f"device's step")
    return types.pop() if types else "cpu"


def lint_step(fn: Callable, *args, path: str = "step",
              **kwargs) -> List[LintFinding]:
    """Run ``fn(*args, **kwargs)`` once under :class:`LintMode`, without
    autograd, and return every finding (an empty list is the serving
    steps' proof obligation). The step's device is that of its tensor
    arguments: ``meta`` (nothing runs; the wrappers record their launches,
    whose records the ``int8-pool-no-scales`` rule reads) or ``cuda``."""
    mode = LintMode(_device_type((args, kwargs)), path)
    ledger = RA.CostLedger()
    with torch.no_grad(), RA.use_ledger(ledger), mode:
        fn(*args, **kwargs)
    return mode.findings + _check_records(ledger.records, path)


def to_meta(tree):
    """Params, caches and the like moved to ``meta`` (shapes and dtypes,
    no storage); a PackedWeight or QuantizedPackedWeight through its own
    ``to``."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor) or hasattr(tree, "to"):
        return tree.to("meta")
    return tree


def lint_engine(engine, *, prompt_len: int = 8,
                live: bool = False) -> List[LintFinding]:
    """Lint a ``ServingEngine``'s prefill and decode steps — the engine's
    own ``make_prefill_step`` / ``make_decode_step`` under its GEMM and
    attention policies and TP context, over its params, caches and block
    tables.

    By default all of those are moved to ``meta``: nothing runs and no
    cache byte is touched, and the kernel wrappers take the card's routes.
    ``live=True`` runs the steps for real on the engine's own device and
    caches (an engine made for the lint: its caches are written), where a
    real device-to-host copy shows."""
    from repro_torch.serving.engine import make_decode_step, make_prefill_step
    cfg, sc = engine.cfg, engine.sc
    B = sc.batch_slots
    S = min(prompt_len, sc.max_len - 1)
    dev = engine.device if live else torch.device("meta")
    params = engine.params if live else to_meta(engine.params)
    caches = engine.caches if live else to_meta(engine.caches)
    bt = None
    if engine.paged:
        bt = torch.from_numpy(np.ascontiguousarray(engine.block_tables)) \
            .to(dev)
    tokens = torch.zeros((B, S), dtype=torch.int32, device=dev)
    positions = torch.arange(S, dtype=torch.int32,
                             device=dev)[None].expand(B, S).contiguous()
    batch: Dict[str, Any] = {
        "tokens": tokens, "positions": positions,
        "last_cols": torch.full((B,), S - 1, dtype=torch.int64, device=dev)}
    if bt is not None:
        batch["block_tables"] = bt
    prefill = make_prefill_step(cfg, engine.gemm, engine.attn, engine.tp)
    decode = make_decode_step(cfg, engine.gemm, engine.attn, engine.tp)
    findings = lint_step(prefill, params, batch, caches, path="prefill")
    tok1 = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos1 = torch.full((B, 1), S, dtype=torch.int32, device=dev)
    findings += lint_step(decode, params, tok1, pos1, caches, bt,
                          path="decode")
    return findings


def lint_report(findings: List[LintFinding], name: str,
                out: Optional[Any] = None) -> int:
    """Print ``findings`` as the CLI does; returns their count."""
    for f in findings:
        print(f"lint FAIL {f}", file=out)
    print(f"lint: {name} prefill+decode, {len(findings)} finding(s)",
          file=out)
    return len(findings)
