"""Analytic system-performance model calibrated to the paper's gem5 setup.

A pure-Python copy of ``repro/core/sysmodel.py``; ``core/plan.py``'s
``mode="auto"`` asks it for the DC-vs-DM access mode per GEMM shape.

The paper evaluates MatrixFlow in gem5 full-system simulation (Table 1:
ARM @1 GHz, DDR3-1600, PCIe 6.0 ×16 = 64 Gb/s; SA 16×16 @1 GHz int /
600 MHz fp — Table 2). gem5 is not available in this container, so this
module is the quantitative stand-in: a transaction-level analytic model that
reproduces the paper's reported trends and magnitudes (Figs 6, 7, 9;
Table 3) from first principles plus a small set of calibration constants.

Model structure (derived from the paper's own accounting, §4.5):
  * The accelerator is *streaming*: transfer overlaps compute, so a GEMM
    costs max(compute, transfer) + per-offload control. MatrixFlow's whole
    point (C1/C2) is that the block-major layout keeps `transfer` at link
    speed so the max() lands on compute for transformer GEMMs.
  * In a transformer pipeline, weights are laid out block-major offline and
    every activation is *already* block-major because it was written as the
    previous GEMM's C blocks (Fig. 5). Re-layout cost therefore only appears
    in the standalone GEMM benchmarks (include_layout_cost=True ⇒ Fig. 7's
    ~400× at 1024³ instead of the transformer-regime ~1000× GEMM speedup).
  * Conventional row-major feeding (Fig. 4 top) fragments each block fetch
    into per-row DMA descriptors; the DMA engine's descriptor issue rate
    then becomes the binding resource — this is the loosely-coupled-baseline
    penalty MatrixFlow removes.
  * DC routes fine-grained (64 B) requests through the LLC — stationary
    panels get cached, descriptor issue is cheap; DM uses big bursts straight
    to DRAM — slightly higher per-descriptor cost and DRAM contention
    (paper: DC 400× vs DM 385× on GEMM-1024).

Modeled backends (the paper's comparison set, §4):
  cpu1        single-thread naive loop GEMM          (baseline, speedup=1)
  omp         256-core OpenMP                        (parallel-efficiency model)
  neon        128-bit SIMD                           (lane count × efficiency)
  smaug       loosely-coupled fp16 accel, conventional layout [19]
  ticsat      tightly-coupled 16×16 SA in the CPU pipeline [2]
  mf_dc/mf_dm MatrixFlow (this paper), DC / DM access modes

Calibration constants were fitted once against the paper's headline numbers;
benchmarks/transformer_e2e.py prints model vs paper side by side with ratios.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core import layout as L

# ---------------------------------------------------------------------------
# Hardware constants (paper Tables 1 & 2) + calibration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SystemConfig:
    cpu_freq_hz: float = 1.0e9          # ARM @ 1 GHz (Table 1)
    llc_bytes: int = 2 * 2**20          # 2 MB LLC
    dram_bw: float = 12.8e9             # DDR3-1600 ≈ 12.8 GB/s
    # Table 1: "PCIe 6.0, 64 Gb/s, 16 Lanes" — 64 Gb/s is the *total* link
    # rate (Fig. 9's configs "16 lanes-64 Gbps / 4 lanes-16 Gbps /
    # 4 lanes-5 Gbps" are consistent at ~4 Gb/s per lane).
    pcie_total_gbps: float = 64.0
    pcie_lanes: int = 16
    pcie_efficiency: float = 0.92
    sa_dim: int = 16                    # 16×16 systolic array
    sa_freq_int_hz: float = 1.0e9       # Table 2: int designs close at 1 GHz
    sa_freq_fp_hz: float = 0.6e9        # Table 2: fp designs close at 600 MHz
    page_bytes: int = L.PAGE_BYTES
    # --- calibration (documented fits) ---
    cpu_cpi_mac: float = 4.0            # naive scalar loop, in-order ARM
    cpu_fp16_penalty: float = 2.5       # §4.3.2: no native fp16 → converts
    cpu_cpi_vec_elem: float = 1.0       # Neon-vectorized non-GEMM layers
    relayout_cyc_per_byte: float = 3.0  # CPU block-major transform (GEMM bench)
    desc_issue_dc_s: float = 30e-9      # DMA descriptor issue, DC
    desc_issue_dm_s: float = 45e-9      # DMA descriptor issue, DM bursts
    dm_contention: float = 1.06         # DM bypasses LLC → DRAM contention
    dm_burst_panels: int = 16           # DM burst covers N row-panels of B
    tlp_header_bytes: float = 64.0      # per-descriptor PCIe TLP+DLLP cost
    cmd_overhead_s: float = 45e-6       # driver doorbell+descr ring+IRQ per offload
    omp_cores: int = 256
    omp_efficiency: float = 0.096       # paper: 23.7–25.6× on 256 cores
    neon_lanes_bytes: int = 16          # 128-bit SIMD
    neon_efficiency: float = 0.45
    ticsat_tile_cycles: float = 200.0   # per 16×16×16 tile pass issue cost [2]
    smaug_macs: int = 48                # NVDLA-class fp16 datapath [19]
    smaug_chunk_bytes: int = 256 * 1024 # SMAUG SPM tile granularity
    smaug_chunk_overhead_s: float = 45e-6
    # Non-SA-aligned sequence lengths (ViT: 197/257) break the Fig. 5 C→A
    # block handoff: the CPU repacks each layer's activations into padded
    # block-major form before DMA (scalar gather/scatter, ~8 cyc/byte).
    # BERT's S=128 is aligned → no repack. TiC-SAT shows no BERT↔ViT gap in
    # the paper's Table 3 while MatrixFlow does — this is the mechanism.
    repack_cyc_per_elem: float = 32.0   # 8 cyc/B × 4 B/elem

    @property
    def pcie_bw(self) -> float:         # bytes/s, one direction
        return self.pcie_total_gbps / 8 * 1e9 * self.pcie_efficiency


DEFAULT = SystemConfig()

_DTYPE_BYTES = {"int8": 1, "int16": 2, "int32": 4, "fp16": 2, "fp32": 4,
                "bf16": 2}


def _dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES[dtype]


def _is_int(dtype: str) -> bool:
    return dtype.startswith("int")


# ---------------------------------------------------------------------------
# Workload description: a model forward = list of GEMMs + elementwise ops
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Gemm:
    M: int
    K: int
    N: int
    count: int = 1          # per-layer / per-head repeats
    tag: str = "gemm"       # FF1 / FF2 / QKV / scores / ... for Fig-8 breakdown

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N * self.count


@dataclasses.dataclass(frozen=True)
class Elementwise:
    elems: int
    count: int = 1
    tag: str = "nongemm"    # softmax / layernorm / transpose / residual


Workload = Tuple[Tuple[Gemm, ...], Tuple[Elementwise, ...]]


# ---------------------------------------------------------------------------
# Per-backend GEMM time models
# ---------------------------------------------------------------------------

def cpu1_gemm_time(g: Gemm, dtype: str, sys: SystemConfig = DEFAULT) -> float:
    cpi = sys.cpu_cpi_mac
    if dtype == "fp16":
        cpi *= sys.cpu_fp16_penalty
    return g.macs * cpi / sys.cpu_freq_hz


def omp_gemm_time(g: Gemm, dtype: str, sys: SystemConfig = DEFAULT) -> float:
    return cpu1_gemm_time(g, dtype, sys) / (sys.omp_cores * sys.omp_efficiency)


def neon_gemm_time(g: Gemm, dtype: str, sys: SystemConfig = DEFAULT) -> float:
    lanes = max(sys.neon_lanes_bytes // _dtype_bytes(dtype), 1)
    eff = sys.neon_efficiency
    if dtype == "fp16":  # emulated through fp32 lanes + converts (§4.3.2)
        lanes, eff = 4, eff * 0.5
    base = cpu1_gemm_time(g, "int32" if _is_int(dtype) else "fp32", sys)
    return base / (lanes * eff)


def _sa_compute_time(g: Gemm, dtype: str, sys: SystemConfig,
                     macs_per_cycle: float | None = None) -> float:
    """SA time for all ``g.count`` instances (g.macs already includes count)."""
    freq = sys.sa_freq_int_hz if _is_int(dtype) else sys.sa_freq_fp_hz
    mpc = macs_per_cycle or float(sys.sa_dim ** 2)
    fill = 2 * sys.sa_dim  # pipeline fill/drain per output-tile pass
    n_tiles = L.cdiv(g.M, sys.sa_dim) * L.cdiv(g.N, sys.sa_dim) * g.count
    cycles = g.macs / mpc + n_tiles * fill
    return cycles / freq


def _traffic_bytes(g: Gemm, itemsize: int, sys: SystemConfig,
                   llc_streaming: bool) -> int:
    """PCIe traffic of Algorithm 1.

    DC (llc_streaming): the A row-strip and the C accumulator strip are
    served from the LLC, so whenever (A + C) fits the 2 MB LLC the weight
    matrix B streams across the link exactly ONCE — the co-design's key
    property. When (A + C) exceeds the LLC, the M dimension is processed in
    groups and B re-streams once per group (the "LLC residency cliff":
    BERT's S=128 strips fit; ViT's S=197/257 strips do not — this is what
    makes the paper's ViT speedups systematically lower than BERT's).

    DM: no cache assist; B re-streams once per burst-group of
    ``dm_burst_panels`` SA row-panels (large adjustable bursts, §4.3).
    """
    a, b = g.M * g.K * itemsize, g.K * g.N * itemsize
    c = g.M * g.N * 4  # int32/fp32 accumulators written back
    if llc_streaming:
        # the C accumulator strip is read-modify-written across the whole
        # K-walk, so it must stay LLC-resident; A and B blocks stream.
        groups = max(L.cdiv(c, sys.llc_bytes), 1)
    else:
        groups = L.cdiv(g.M, sys.sa_dim * sys.dm_burst_panels)
    return (a + b * groups + c) * g.count


def matrixflow_gemm_time(
    g: Gemm, dtype: str, mode: str = "dc", sys: SystemConfig = DEFAULT,
    conventional_layout: bool = False,
    include_layout_cost: bool = False,
) -> Dict[str, float]:
    """MatrixFlow GEMM: total = max(compute, transfer) + control [+ relayout]."""
    itemsize = _dtype_bytes(dtype)
    compute = _sa_compute_time(g, dtype, sys)
    traffic = _traffic_bytes(g, itemsize, sys, llc_streaming=(mode == "dc"))
    bw = sys.pcie_bw / (sys.dm_contention if mode == "dm" else 1.0)
    # block geometry: one 4 kB page per block (paper §3.3)
    bk_elems = sys.page_bytes // (sys.sa_dim * itemsize)
    n_blocks = L.cdiv(traffic, sys.page_bytes)
    if conventional_layout:
        desc_per_block = L.descriptors_per_block_conventional(
            sys.sa_dim, bk_elems, g.K * itemsize, itemsize, sys.page_bytes)
    else:
        desc_per_block = L.descriptors_per_block_matrixflow(
            sys.sa_dim, bk_elems, itemsize, sys.page_bytes)
    issue = sys.desc_issue_dc_s if mode == "dc" else sys.desc_issue_dm_s
    n_desc = n_blocks * desc_per_block
    # every descriptor is a separate PCIe transaction → TLP header bytes;
    # the conventional layout's per-row fragments pay this ~16× more often
    wire_bytes = traffic + n_desc * sys.tlp_header_bytes
    transfer = max(wire_bytes / bw, n_desc * issue)
    control = sys.cmd_overhead_s * g.count
    if mode == "dm":
        # DM's coarse bursts pipeline less finely with compute than DC's
        # cache-line-granularity stream → a residual non-overlapped tail.
        control += 0.1 * min(compute, transfer)
    relayout = 0.0
    if include_layout_cost:
        relayout = ((g.M * g.K + g.K * g.N) * itemsize * g.count *
                    sys.relayout_cyc_per_byte / sys.cpu_freq_hz)
    total = max(compute, transfer) + control + relayout
    return {"compute": compute, "transfer": transfer, "control": control,
            "relayout": relayout, "total": total}


def smaug_gemm_time(g: Gemm, dtype: str, sys: SystemConfig = DEFAULT) -> float:
    """SMAUG [19]: fp16 NVDLA-class datapath, conventional layout, SPM chunks;
    compute and transfer serialize per chunk (no streaming co-design)."""
    t = matrixflow_gemm_time(g, "fp16", mode="dm", sys=sys,
                             conventional_layout=True)
    compute = _sa_compute_time(g, "fp16", sys, macs_per_cycle=sys.smaug_macs)
    traffic = _traffic_bytes(g, 2, sys, llc_streaming=False)
    chunks = L.cdiv(traffic, sys.smaug_chunk_bytes)
    return compute + t["transfer"] + chunks * sys.smaug_chunk_overhead_s


def ticsat_gemm_time(g: Gemm, dtype: str, sys: SystemConfig = DEFAULT) -> float:
    """TiC-SAT [2]: SA as a functional unit — no PCIe, but every 16×16×16
    tile pass issues custom instructions through the CPU pipeline (loads
    into the SA regs, compute, drain)."""
    compute = _sa_compute_time(g, dtype, sys)
    tiles = (L.cdiv(g.M, sys.sa_dim) * L.cdiv(g.N, sys.sa_dim)
             * L.cdiv(g.K, sys.sa_dim)) * g.count
    issue = tiles * sys.ticsat_tile_cycles / sys.cpu_freq_hz
    return compute + issue


def nongemm_time(e: Elementwise, sys: SystemConfig = DEFAULT) -> float:
    return e.elems * e.count * sys.cpu_cpi_vec_elem / sys.cpu_freq_hz


# ---------------------------------------------------------------------------
# Full-workload evaluation (drives Table 3 / Figs 6-9 benchmarks)
# ---------------------------------------------------------------------------

BACKENDS = ("cpu1", "omp", "neon", "smaug", "ticsat", "mf_dc", "mf_dm")


def workload_time(
    workload: Workload, dtype: str, backend: str,
    sys: SystemConfig = DEFAULT,
    include_layout_cost: bool = False,
) -> Dict[str, object]:
    gemms, elems = workload
    parts: Dict[str, float] = {}
    gemm_t = control_t = 0.0
    for g in gemms:
        if backend == "cpu1":
            t = cpu1_gemm_time(g, dtype, sys)
        elif backend == "omp":
            t = omp_gemm_time(g, dtype, sys)
        elif backend == "neon":
            t = neon_gemm_time(g, dtype, sys)
        elif backend == "smaug":
            t = smaug_gemm_time(g, dtype, sys)
        elif backend == "ticsat":
            t = ticsat_gemm_time(g, dtype, sys)
        elif backend in ("mf_dc", "mf_dm"):
            d = matrixflow_gemm_time(g, dtype, mode=backend[3:], sys=sys,
                                     include_layout_cost=include_layout_cost)
            t = d["total"]
            control_t += d["control"]
        else:
            raise ValueError(backend)
        gemm_t += t
        parts[g.tag] = parts.get(g.tag, 0.0) + t
    nong_t = 0.0
    for e in elems:
        if e.tag == "repack":
            # block-major repack of unaligned activations: an accelerator-
            # only cost (CPU/Neon/TiC-SAT consume row-major directly)
            if backend in ("mf_dc", "mf_dm", "smaug"):
                t = (e.elems * e.count * sys.repack_cyc_per_elem
                     / sys.cpu_freq_hz)
            else:
                continue
        else:
            # non-GEMM layers stay on the (vectorized) CPU in every scenario
            t = nongemm_time(e, sys)
            if backend == "omp":
                t /= sys.omp_cores * sys.omp_efficiency
        nong_t += t
        parts[e.tag] = parts.get(e.tag, 0.0) + t
    total = gemm_t + nong_t
    return {"total": total, "gemm": gemm_t, "nongemm": nong_t,
            "control": control_t, "parts": parts}


def speedup_table(workload: Workload, dtype: str,
                  sys: SystemConfig = DEFAULT,
                  include_layout_cost: bool = False) -> Dict[str, float]:
    base = workload_time(workload, dtype, "cpu1", sys)["total"]
    return {b: base / workload_time(workload, dtype, b, sys,
                                    include_layout_cost)["total"]
            for b in BACKENDS}
