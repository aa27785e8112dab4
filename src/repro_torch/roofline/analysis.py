"""Three-term roofline with the H100's constants (``repro/roofline/
analysis.py``), the least work of one kernel launch, and the cost ledger
that the kernel wrappers fill on ``meta`` tensors.

  compute term    = FLOPs / (the peak FLOP/s of their type)
  memory term     = bytes / HBM bandwidth
  collective term = collective bytes / (link bandwidth x links)

The reference reads its FLOPs and bytes from XLA's ``cost_analysis()`` and
its collective bytes from the optimized HLO. The port has no compiler
between it and the card: ``launch/dryrun.py`` runs a step on ``meta``
tensors, each kernel wrapper adds :func:`launch_cost` of the launch it
would make to the active :class:`CostLedger`, and the other aten ops are
counted by the dry run's dispatch mode. Collective bytes come from
``distributed/tp.py``'s counter (:func:`collective_bytes_from_counts`).

:class:`HW`'s defaults are data-sheet figures of an NVIDIA H100 80GB HBM3
(SXM) at its 700 W power limit, the card the port's chip runs report: 989
TFLOP/s bf16 on the tensor cores (dense), 67 TFLOP/s fp32 outside them
(TF32 stays off), 1,979 TOP/s int8, 3.35 TB/s of HBM and 450 GB/s each way
of NVLink 4. They are not measurements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Mapping, Optional, Tuple

import torch

# Peak operation rates of an H100 SXM by operand type (data sheet, dense).
H100_PEAKS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "int8": 1979e12}


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's rates. ``peak_flops`` is the bf16 peak, the one a cost
    without a type is divided by (the reference's single peak);
    ``peaks`` the other types'."""

    peak_flops: float = H100_PEAKS["bfloat16"]   # FLOP/s, bf16 dense
    hbm_bw: float = 3.35e12                       # bytes/s
    ici_bw: float = 450e9                         # bytes/s a link each way
    peaks: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(H100_PEAKS))

    def peak(self, dtype=None) -> float:
        """FLOP/s for operands of ``dtype`` (a name or a torch dtype);
        bf16, fp16 and None take ``peak_flops``."""
        name = dtype_name(dtype) if dtype is not None else "bfloat16"
        if name in ("bfloat16", "float16"):
            return self.peak_flops
        return self.peaks[name]


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` or ``"bfloat16"`` → ``"bfloat16"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def _itemsize(dtype) -> int:
    return getattr(torch, dtype_name(dtype)).itemsize


def roofline_terms(cost: Dict[str, float], collective_bytes: float,
                   hw: HW = HW(), model_flops: Optional[float] = None,
                   links_per_chip: int = 1) -> Dict[str, float]:
    """The reference's terms of one rank's ``cost`` ({"flops", "bytes
    accessed"}). A cost that carries ``"flops_by_dtype"`` ({type: FLOPs})
    divides each type's FLOPs by its own peak; otherwise ``flops`` is
    divided by ``hw.peak_flops``."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    by_dtype = cost.get("flops_by_dtype")
    if by_dtype:
        t_compute = sum(float(f) / hw.peak(dt) for dt, f in by_dtype.items())
    else:
        t_compute = flops / hw.peak_flops
    t_memory = bytes_accessed / hw.hbm_bw
    t_collective = collective_bytes / (hw.ici_bw * links_per_chip)
    terms = {
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_accessed,
        "coll_bytes_per_chip": collective_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
    }
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_collective), key=lambda kv: kv[1])
    terms["bottleneck"] = dominant[0]
    t_bound = max(t_compute, t_memory, t_collective)
    terms["roofline_fraction"] = (t_compute / t_bound) if t_bound > 0 else 0.0
    if model_flops is not None and flops > 0:
        terms["model_flops"] = model_flops
        terms["useful_flops_ratio"] = model_flops / flops
    return terms


def model_flops_estimate(n_params_active: float, tokens: float,
                         kind: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference forward)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def collective_bytes_from_counts(snapshot: Dict[str, Dict[str, int]]
                                 ) -> Dict[str, float]:
    """Bytes per collective kind from ``tp.collectives.snapshot()`` (or the
    difference of two), with ``total`` and ``counts`` (calls per kind): the
    dict :func:`collective_bytes_from_hlo` gives in the reference."""
    out = {k: float(v) for k, v in snapshot["bytes"].items()}
    out["total"] = sum(out.values())
    out["counts"] = dict(snapshot["calls"])        # type: ignore
    return out


# ---------------------------------------------------------------------------
# The least work of one launch
# ---------------------------------------------------------------------------

# The operand type whose peak bounds a route (its inputs' type otherwise).
_ROUTE_DTYPE = {"cuda_cores": "float32", "cuda_cores_bf16kv": "float32"}


def launch_cost(kernel: str, route: str, **s) -> Dict:
    """{"flops", "bytes", "dtype"[, "transcendentals"]} of one launch of
    ``kernel`` on ``route``: each input read once and each output written
    once, and the useful operations — of the logical problem, not of the
    padded tiles; the attention kernels' and K6's ``exp`` s apart, as
    XLA's cost analysis counts transcendentals.

      matrixflow_gemm          M, N, K, dtype[, out_dtype (dtype), G (1)]
      matrixflow_gemm_dequant  M, N, K[, out_dtype (fp32)]: int8 operands,
                               fp32 row and channel scales
      flash_attention          B, Sq, Sk, H, Hkv, D, dtype[, Dv (D),
                               kv_dtype (dtype), keys (B·Sk: the keys read
                               per kv head, summed over rows), pairs
                               (B·Sq·Sk: the visible (query, key) pairs),
                               lse (False: the fp32 log-sum-exp of each
                               (row, head) written too)]
      paged_attention          B, Sq, H, Hkv, D, page_size, n_blocks, dtype
                               (q's)[, kv_dtype (dtype; int8 pools carry
                               fp32 scales per page and head), pages
                               (B·n_blocks: the pages read), pairs]
      ssd_scan                 B, S, H, P, N, dtype[, Q (the chunk)]

    Where the work depends on the data (the keys a row sees), the caller
    passes what its data needs; the defaults are every key in memory.
    """
    if kernel == "matrixflow_gemm":
        M, N, K, G = s["M"], s["N"], s["K"], s.get("G", 1)
        dt = dtype_name(s["dtype"])
        out = s.get("out_dtype") or dt
        return dict(flops=2.0 * G * M * N * K,
                    bytes=G * ((M * K + K * N) * _itemsize(dt)
                               + M * N * _itemsize(out)),
                    dtype=dt)
    if kernel == "matrixflow_gemm_dequant":
        M, N, K = s["M"], s["N"], s["K"]
        out = s.get("out_dtype") or "float32"
        return dict(flops=2.0 * M * N * K,
                    bytes=M * K + K * N + 4 * (M + N) + M * N * _itemsize(out),
                    dtype="int8")
    if kernel == "flash_attention":
        B, Sq, Sk, H, Hkv, D = (s[k] for k in ("B", "Sq", "Sk", "H", "Hkv",
                                               "D"))
        Dv = s.get("Dv") or D
        dt = dtype_name(s["dtype"])
        kv = s.get("kv_dtype") or dt
        keys = s.get("keys", B * Sk)
        pairs = s.get("pairs", B * Sq * Sk)
        return dict(flops=2.0 * (D + Dv) * H * pairs,
                    transcendentals=float(H * pairs),
                    bytes=(D + Dv) * keys * Hkv * _itemsize(kv)
                    + B * Sq * H * (D + Dv) * _itemsize(dt)
                    + 4 * (B * Sq + B) + (4 * B * Sq * H if s.get("lse")
                                          else 0),
                    dtype=_ROUTE_DTYPE.get(route, dt))
    if kernel == "paged_attention":
        B, Sq, H, Hkv, D, ps, nb = (s[k] for k in ("B", "Sq", "H", "Hkv", "D",
                                                   "page_size", "n_blocks"))
        dt = dtype_name(s["dtype"])
        kv = dtype_name(s.get("kv_dtype") or dt)
        pages = s.get("pages", B * nb)
        pairs = s.get("pairs", B * Sq * nb * ps)
        page_bytes = ps * Hkv * D * _itemsize(kv) + (4 * Hkv if kv == "int8"
                                                     else 0)
        return dict(flops=4.0 * D * H * pairs,
                    transcendentals=float(H * pairs),
                    bytes=2 * pages * page_bytes
                    + 2 * B * Sq * H * D * _itemsize(dt) + 4 * (B * nb + B * Sq),
                    dtype=_ROUTE_DTYPE.get(route, dt))
    if kernel == "ssd_scan":
        B, S, H, P, N = (s[k] for k in ("B", "S", "H", "P", "N"))
        dt = dtype_name(s["dtype"])
        Q = s.get("Q")
        if Q is None:
            from repro_torch.kernels.ref import ssd_chunk_size
            Q = ssd_chunk_size(S, 128)
        # C Bᵀ over each chunk's lower triangle once per (row, chunk), shared
        # by the heads; per head the decay-masked product with dt·x, C hᵀ
        # for every chunk after the first and the state update
        nc, tri = S // Q, Q * (Q + 1) / 2
        flops = B * nc * tri * 2 * N + B * H * (
            nc * (tri * (2 * P + 1) + 2 * Q * P * N + 3 * Q * P)
            + (nc - 1) * 2 * Q * N * P)
        nbytes = (2 * B * S * H * P + 2 * B * S * N) * _itemsize(dt) \
            + 4 * (B * S * H + H + B * H * P * N)
        return dict(flops=float(flops), bytes=nbytes,
                    transcendentals=float(B * H * nc * tri),
                    dtype=_ROUTE_DTYPE.get(route, dt))
    raise ValueError(f"no cost model for kernel {kernel!r}")


def bound(cost: Dict, hw: HW = HW()) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card takes
    for ``cost`` — the larger of its bytes over the memory rate and its
    operations over the peak of their type."""
    t_bytes = cost["bytes"] / hw.hbm_bw
    t_ops = cost["flops"] / hw.peak(cost["dtype"])
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# The cost ledger of the meta paths
# ---------------------------------------------------------------------------

class CostLedger:
    """Launches, FLOPs by type and bytes of the kernel launches recorded
    while it is active (:func:`use_ledger`), and each launch's record
    (kernel, route and the shapes the wrapper passed: ``records``, which
    the serving steps' lint reads)."""

    def __init__(self):
        self.launches: Dict[str, Dict[str, int]] = {}
        self.records: List[Dict] = []
        # launches also counted under a mark (K1's "batched", "backward")
        self.marked: Dict[str, Dict[str, int]] = {}
        self.flops_by_dtype: Dict[str, float] = {}
        self.bytes = 0.0
        self.transcendentals = 0.0

    def add(self, kernel: str, route: str, cost: Dict,
            marks: Tuple[str, ...] = (),
            shapes: Optional[Mapping] = None) -> None:
        self.records.append(dict(shapes or {}, kernel=kernel, route=route))
        by_route = self.launches.setdefault(kernel, {})
        by_route[route] = by_route.get(route, 0) + 1
        for m in marks:
            by_mark = self.marked.setdefault(kernel, {})
            by_mark[m] = by_mark.get(m, 0) + 1
        dt = cost["dtype"]
        self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0.0) \
            + cost["flops"]
        self.bytes += cost["bytes"]
        self.transcendentals += cost.get("transcendentals", 0.0)

    @property
    def flops(self) -> float:
        return sum(self.flops_by_dtype.values())


_state = threading.local()


@contextlib.contextmanager
def use_ledger(ledger: CostLedger):
    """Record every meta launch of the enclosed region in ``ledger``."""
    stack = getattr(_state, "ledgers", None)
    if stack is None:
        stack = _state.ledgers = []
    stack.append(ledger)
    try:
        yield ledger
    finally:
        stack.pop()


def record_launch(kernel: str, route: str, *, name: Optional[str] = None,
                  marks: Tuple[str, ...] = (), **shapes) -> None:
    """Add :func:`launch_cost` of one launch to the active ledger (none
    active: nothing to add), under ``name`` (default ``kernel``: K5 is
    the paged kernel's cost over int8 pools, counted apart) and each of
    ``marks``. This ledger, not the wrappers' launch counters, is where a
    ``meta`` call is counted: nothing launches there."""
    stack = getattr(_state, "ledgers", None)
    if stack:
        stack[-1].add(name or kernel, route,
                      launch_cost(kernel, route, **shapes), marks, shapes)
