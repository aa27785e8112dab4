"""Mamba-2 SSD chunked scan: wrapper of the CUDA kernels ``csrc/ssd_scan.cu``
(K6), which replace the Pallas TPU kernel
``repro/kernels/ssd_scan.py::_kernel``.

It runs every SSD prefill of the Mamba-2 and Zamba-2 models
(``models/ssm.py::ssd_chunked``): y and, when asked, the fp32 state after
the last step, which a prefill with a cache stores for the decode steps.
Operands stay in the model layout and the kernels read them through their
strides and form dt·x and dt·A themselves. For tensors on the CPU
:func:`ssd_scan` runs :func:`ssd_scan_plain` (``kernels/ref.py::
ssd_chunked_ref``); for CUDA tensors it launches a kernel or raises.

On the card the scan takes one of three routes (:func:`route_for`), each
counted in ``ssd_scan.launches_by_route`` (one a call), their sum in
``ssd_scan.launches``:

  ``walk``        bf16, at most :data:`SEG_TILES` tiles of :data:`TILE`
                  steps a row: the four products on the tensor cores
                  (mma.sync), one CTA per (head, row) walking its tiles
                  with the state in registers; one launch
  ``chunks``      bf16, longer rows: the tiles cut into segments of
                  :data:`SEG_TILES`, spread over CTAs — the segments'
                  states, a pass over them, then the walk of every segment
                  from its starting state; three launches
  ``cuda_cores``  fp32 (TF32 stays off): FMA on the CUDA cores, chunks of
                  the reference's Q

The tensor-core routes tile by :data:`TILE` steps whatever Q is (the
scan's function does not depend on the tiling, only its rounding does),
and depend on S alone, never on B, so a row's result does not depend on
what else shares the batch. A bf16 geometry they do not take (P above
:data:`MAX_P`, N above :data:`MAX_N`) raises.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) the wrapper takes
the route the card would take, records that launch and its least work
(``roofline.launch_cost``) in the active cost ledger, and returns empty
``meta`` results. Nothing launches there, so the launch counters do not
move: they count real launches only.

:func:`ssd_contract` (registered as ``"ssd_scan"``) states the grid of
each launch of a route (:func:`route_launches`) and the tiles every CTA
reads and writes, for the static checker (``analysis/kernel_contracts.
py``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis.kernel_contracts import (KernelContract,
                                                   OperandSpec, Precondition,
                                                   register_contract, require)
from repro_torch.kernels import _build
from repro_torch.kernels.forward_only import refuse_grad
from repro_torch.kernels.ref import ssd_chunk_size
from repro_torch.kernels.ref import ssd_chunked_ref as ssd_scan_plain
from repro_torch.roofline import analysis as RA

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_chunk_size", "route_for",
           "tile_plan", "route_launches", "ssd_contract"]

MAX_CHUNK = 128           # the bound on Q (csrc/ssd_scan.cu, fp32 kernel)
ROUTES = ("walk", "chunks", "cuda_cores")
# The tensor-core kernels (csrc/ssd_scan.cu, namespace tc): steps a tile,
# P padded to MAX_P, N to 64 or MAX_N. A segment of the chunks route holds
# SEG_TILES tiles (512 steps): Mamba-2's batched prefills (8 x 384, 64 heads)
# walk with 512 CTAs already; a 4096-step prompt gets 8 segments a head.
TILE = 64
MAX_P, MAX_N = 64, 128
SEG_TILES = 8


def route_for(dtype: torch.dtype, S: int, P: int, N: int) -> str:
    """The route of the scan on the card for rows of ``S`` steps: ``walk``
    or ``chunks`` (bf16) or ``cuda_cores`` (fp32). Raises ValueError for a
    bf16 geometry no tensor-core route takes."""
    if dtype != torch.bfloat16:
        return "cuda_cores"
    require(tc_precondition(P, N))
    return "walk" if tile_plan(S, P, N)["segments"] == 1 else "chunks"


def tc_precondition(P: int, N: int) -> Precondition:
    """The geometry the tensor-core routes take (P up to MAX_P, N up to
    MAX_N): the guard :func:`route_for` raises and the contract states."""
    return Precondition.check(
        "tensor-core geometry", P <= MAX_P and N <= MAX_N,
        f"no tensor-core SSD route takes P={P} N={N} (at most P {MAX_P}, N "
        f"{MAX_N})")


def tile_plan(S: int, P: int, N: int) -> Dict[str, int]:
    """How the tensor-core routes cut rows of ``S`` steps: ``tiles`` of
    TILE steps (the last may be short), ``segments`` of ``seg_tiles``
    tiles, and the fp32 scratch a (head, row) needs (``scratch_floats``:
    one state per segment but the last, and its decay)."""
    tiles = -(-S // TILE)
    segments = -(-tiles // SEG_TILES)
    return dict(tiles=tiles, seg_tiles=SEG_TILES, segments=segments,
                scratch_floats=(segments - 1) * (P * N + 1))


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if lib.ssd_scan.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        strides = [ll] * 10
        lib.ssd_scan.argtypes = [vp] * 7 + [i] * 6 + strides + [vp]
        lib.ssd_scan.restype = ctypes.c_int
        lib.ssd_scan_tc.argtypes = [vp] * 9 + [i] * 7 + strides + [vp]
        lib.ssd_scan_tc.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(x, dt, A, Bc, Cc) -> None:
    Bsz, S, H, _ = x.shape
    N = Bc.shape[-1]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bc.shape) != (Bsz, S, N) or tuple(Cc.shape) != (Bsz, S, N):
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(Bc.shape)}, C {tuple(Cc.shape)} disagree on "
            f"(B, S, H, P, N)")


def check_operands(x, dt, A, Bc, Cc, chunk: int = 128) -> Tuple[str, int]:
    """What the card's kernels take, checked before anything launches:
    shapes that agree, fp32 or bf16 x, B and C of one dtype, fp32 dt and A,
    every operand on x's device, Q = ``ssd_chunk_size(S, chunk)`` at most
    MAX_CHUNK, and a geometry the dtype's route takes. Returns (the route,
    Q); raises ValueError."""
    _check_shapes(x, dt, A, Bc, Cc)
    _, S, _, P = x.shape
    N = Bc.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or {Bc.dtype, Cc.dtype} != {x.dtype} \
            or {dt.dtype, A.dtype} != {torch.float32}:
        raise ValueError(
            f"the kernel takes fp32 or bf16 x, B and C of one dtype and fp32 "
            f"dt and A, got x {x.dtype}, B {Bc.dtype}, C {Cc.dtype}, dt "
            f"{dt.dtype}, A {A.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", Bc), ("C", Cc)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    Q = ssd_chunk_size(S, chunk)
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk {Q} exceeds the kernel's {MAX_CHUNK}")
    return route_for(x.dtype, S, P, N), Q


def ssd_scan(x: torch.Tensor,          # (B, S, H, P)
             dt: torch.Tensor,         # (B, S, H) softplus-ed step sizes
             A: torch.Tensor,          # (H,) negative decay rates
             Bc: torch.Tensor,         # (B, S, N)
             Cc: torch.Tensor,         # (B, S, N)
             *, chunk: int = 128, final_state: bool = True
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chunked SSD scan with chunks of ``ssd_chunk_size(S, chunk)``
    steps. Returns (y (B, S, H, P) in x's dtype, the fp32 state (B, H, P,
    N) after the last chunk, or None when ``final_state`` is False).
    Forward-only: it raises under autograd (``kernels/forward_only.py``);
    ``models/ssm.py`` trains through :func:`ssd_scan_plain` on the CPU."""
    refuse_grad("ssd_scan (K6)", x, dt, A, Bc, Cc,
                remedy="SSD training on a CUDA device is not ported "
                       "(ROADMAP.md queue 3)")
    _check_shapes(x, dt, A, Bc, Cc)
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bc, Cc, chunk=chunk,
                              final_state=final_state)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"no SSD scan kernel for device {dev}")
    route, Q = check_operands(x, dt, A, Bc, Cc, chunk)
    Bsz, S, H, P = x.shape
    N = Bc.shape[-1]
    if dev.type == "meta":
        RA.record_launch("ssd_scan", route, B=Bsz, S=S, H=H, P=P, N=N,
                         dtype=x.dtype, Q=Q)
        return (torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev),
                torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
                if final_state else None)
    x, Bc, Cc = (t if t.stride(-1) == 1 else t.contiguous()
                 for t in (x, Bc, Cc))
    A = A.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    state = (torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
             if final_state else None)
    lib = _lib()
    strides = (*x.stride()[:3], *dt.stride(), *Bc.stride()[:2],
               *Cc.stride()[:2])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), y.data_ptr(),
            None if state is None else state.data_ptr())
    if route == "cuda_cores":
        err = lib.ssd_scan(*ptrs, Bsz, S, H, P, N, Q, *strides, stream)
    else:
        plan = tile_plan(S, P, N)
        nseg = plan["segments"]
        seg_state = seg_decay = None
        if nseg > 1:
            scratch = torch.empty(Bsz * H * plan["scratch_floats"],
                                  dtype=torch.float32, device=dev)
            seg_state = scratch.data_ptr()
            seg_decay = scratch[Bsz * H * (nseg - 1) * P * N:].data_ptr()
        err = lib.ssd_scan_tc(*ptrs, seg_state, seg_decay, Bsz, S, H, P, N,
                              plan["seg_tiles"], nseg, *strides, stream)
    if err:
        raise RuntimeError(
            f"ssd_scan ({route}) launch failed for B={Bsz} S={S} H={H} P={P} "
            f"N={N} Q={Q}: {lib.ssd_error_string(err).decode()}")
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[route] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)


# ---------------------------------------------------------------------------
# The launch grids, stated for the static checker
# ---------------------------------------------------------------------------

# Threads of one CTA of the segment pass (csrc/ssd_scan.cu:712).
PASS_THREADS = 256
# The launches of each route, in order.
ROUTE_LAUNCHES = {
    "walk": ("ssd_walk_kernel",),
    "chunks": ("ssd_segment_state_kernel", "ssd_segment_pass_kernel",
               "ssd_walk_kernel"),
    "cuda_cores": ("ssd_scan_kernel",),
}


def route_launches(dtype: torch.dtype, S: int, P: int, N: int
                   ) -> Tuple[str, ...]:
    """The kernels one call launches on the card, in order: the
    contract's ``launch`` names."""
    return ROUTE_LAUNCHES[route_for(dtype, S, P, N)]


def _seq_operands(B, n, H, T, P, N, step_map, expected=None):
    """x, dt, A, B and C of a walk over ``n`` tiles of ``T`` steps, read at
    the tile ``step_map`` names (None: predicated off)."""
    def on(f):
        def m(*pt):
            t = step_map(*pt)
            return None if t is None else f(*t)
        return m
    exp = None if expected is None else frozenset(
        (b, t, h, 0) for b, t, h in expected)
    exp_dt = None if expected is None else frozenset(
        (b, t, h) for b, t, h in expected)
    exp_bc = None if expected is None else frozenset(
        (b, t, 0) for b, t, _ in expected)
    return [
        OperandSpec("x", "input", (B, n, H, 1), (1, T, 1, P),
                    on(lambda b, t, h: (b, t, h, 0)), expected_blocks=exp),
        OperandSpec("dt", "input", (B, n, H), (1, T, 1),
                    on(lambda b, t, h: (b, t, h)), expected_blocks=exp_dt),
        OperandSpec("A", "input", (H,), (1,), on(lambda b, t, h: (h,))),
        OperandSpec("Bc", "input", (B, n, 1), (1, T, N),
                    on(lambda b, t, h: (b, t, 0)), expected_blocks=exp_bc),
    ]


@register_contract("ssd_scan")
def ssd_contract(*, B, S, H, P, N, chunk: int = 128, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 launch: Optional[str] = None) -> KernelContract:
    """Contract of one launch of :func:`ssd_scan` for one logical shape:
    ``launch`` names it among :func:`route_launches` (default: the route's
    last, the one that writes y).

    For a CUDA device: ``ssd_scan_kernel`` (fp32, grid (H, B), chunks of Q
    steps walked in order), ``ssd_walk_kernel`` (grid (H, nseg, B), CTA (h,
    k, b) walking segment k's tiles of TILE steps), and on the ``chunks``
    route first ``ssd_segment_state_kernel`` (grid (H, nseg - 1, B)) and
    ``ssd_segment_pass_kernel`` (one thread per (b, h, state entry),
    PASS_THREADS a CTA, the segments in order); each carries the state
    along its walk (``sequential_axes``). For the CPU, the reference's
    grid (B, H, nc) of the plain chunked scan."""
    Q = ssd_chunk_size(S, chunk)
    nc = S // Q if Q else 0
    pre = (Precondition.check(
        "chunk divides sequence", Q > 0 and S % Q == 0,
        f"derived chunk Q={Q} does not divide S={S}; ssd_chunk_size "
        f"guarantees this by construction"),)
    if torch.device(device).type == "cpu":
        operands = (
            OperandSpec("x", "input", (B, H, nc, 1, 1), (1, 1, 1, Q, P),
                        lambda b, h, k: (b, h, k, 0, 0)),
            OperandSpec("a", "input", (B, H, nc, 1), (1, 1, 1, Q),
                        lambda b, h, k: (b, h, k, 0)),
            OperandSpec("Bc", "input", (B, nc, 1, 1), (1, 1, Q, N),
                        lambda b, h, k: (b, k, 0, 0)),
            OperandSpec("Cc", "input", (B, nc, 1, 1), (1, 1, Q, N),
                        lambda b, h, k: (b, k, 0, 0)),
            OperandSpec("y", "output", (B, H, nc, 1, 1), (1, 1, 1, Q, P),
                        lambda b, h, k: (b, h, k, 0, 0)),
        )
        return KernelContract(
            kernel="ssd_scan", grid=(B, H, nc), operands=operands,
            dimension_semantics=("parallel", "parallel", "arbitrary"),
            sequential_axes=(2,), preconditions=pre,
            description="plain chunked SSD scan, state carried along chunks")
    if dtype == torch.bfloat16:
        pre += (tc_precondition(P, N),)
        route = "walk" if tile_plan(S, P, N)["segments"] == 1 else "chunks"
    else:
        pre += (Precondition.check(
            "chunk bound", Q <= MAX_CHUNK,
            f"chunk {Q} exceeds the kernel's {MAX_CHUNK}"),)
        route = "cuda_cores"
    launch = launch or ROUTE_LAUNCHES[route][-1]
    if launch not in ROUTE_LAUNCHES[route]:
        raise ValueError(f"the {route} route launches "
                         f"{ROUTE_LAUNCHES[route]}, not {launch!r}")
    par = "parallel"
    if launch == "ssd_scan_kernel":
        # grid (H, B) at csrc/ssd_scan.cu:782, CTA (h = blockIdx.x, b =
        # blockIdx.y) at :160 walking chunks c < S / Q (:163, :171); the
        # final state written after the last chunk
        step = lambda h, b, c: (b, c, h)
        ops = _seq_operands(B, nc, H, Q, P, N, step)
        ops += [
            OperandSpec("Cc", "input", (B, nc, 1), (1, Q, N),
                        lambda h, b, c: (b, c, 0)),
            OperandSpec("y", "output", (B, nc, H, 1), (1, Q, 1, P),
                        lambda h, b, c: (b, c, h, 0)),
            OperandSpec("state", "output", (B, H), (P, N),
                        lambda h, b, c: (b, h) if c == nc - 1 else None),
        ]
        return KernelContract(
            kernel="ssd_scan", grid=(H, B, nc), operands=tuple(ops),
            dimension_semantics=(par, par, "arbitrary"),
            sequential_axes=(2,), preconditions=pre,
            description=f"ssd_scan_kernel cuda_cores (Q={Q})")
    plan = tile_plan(S, P, N)
    nt, seg, nseg = plan["tiles"], plan["seg_tiles"], plan["segments"]
    if launch == "ssd_segment_pass_kernel":
        # one thread per (b, h, state entry) i = blockIdx.x * 256 +
        # threadIdx.x (:714-:716), past B * H * P * N idle; each walks the
        # segments' states in order (:719-:722), written over S_k
        n = B * H * P * N
        ctas = -(-n // PASS_THREADS)
        ops = (
            OperandSpec("seg_state (in)", "input", (ctas, nseg - 1),
                        (PASS_THREADS, 1), lambda x, k: (x, k)),
            OperandSpec("seg_decay", "input", (ctas, nseg - 1),
                        (PASS_THREADS, 1), lambda x, k: (x, k)),
            OperandSpec("seg_state", "output", (ctas, nseg - 1),
                        (PASS_THREADS, 1), lambda x, k: (x, k)),
        )
        return KernelContract(
            kernel="ssd_scan", grid=(ctas, nseg - 1), operands=ops,
            dimension_semantics=(par, "arbitrary"), sequential_axes=(1,),
            preconditions=pre,
            description=f"ssd_segment_pass_kernel chunks ({nseg} segments)")
    if launch == "ssd_segment_state_kernel":
        # grid (H, nseg - 1, B) at :741; CTA (h, k, b) at :703 walks the
        # full segment k's tiles t0 = k * seg_tiles .. t0 + seg_tiles (:704)
        # and writes its state and decay to slot (b, h, k) (:705-:707)
        step = lambda h, k, b, s: (b, k * seg + s, h)
        expected = [(b, t, h) for b in range(B) for h in range(H)
                    for t in range((nseg - 1) * seg)]
        ops = _seq_operands(B, nt, H, TILE, P, N, step, expected)
        ops += [OperandSpec(name, "output", (B, H, nseg - 1), block,
                            lambda h, k, b, s: (b, h, k)
                            if s == seg - 1 else None)
                for name, block in (("seg_state", (1, 1, P * N)),
                                    ("seg_decay", (1, 1, 1)))]
        return KernelContract(
            kernel="ssd_scan", grid=(H, nseg - 1, B, seg),
            operands=tuple(ops),
            dimension_semantics=(par, par, par, "arbitrary"),
            sequential_axes=(3,), preconditions=pre,
            description=f"ssd_segment_state_kernel chunks ({nseg} segments "
                        f"of {seg} tiles)")
    # ssd_walk_kernel: grid (H, nseg, B) at :749; CTA (h, k, b) at :687
    # walks tiles t0 = k * seg_tiles .. min(nt, t0 + seg_tiles) (:689),
    # from segment k - 1's slot when k > 0 (:691), writing y and, in the
    # last segment, the final state (:692-:694)

    def tile(h, k, b, s):
        t = k * seg + s
        return (b, t, h) if t < nt else None

    def last(k):
        return min(nt, (k + 1) * seg) - k * seg - 1

    ops = _seq_operands(B, nt, H, TILE, P, N, tile)
    ops += [
        OperandSpec("Cc", "input", (B, nt, 1), (1, TILE, N),
                    lambda h, k, b, s: None if tile(h, k, b, s) is None
                    else (b, k * seg + s, 0)),
        OperandSpec("y", "output", (B, nt, H, 1), (1, TILE, 1, P),
                    lambda h, k, b, s: None if tile(h, k, b, s) is None
                    else (b, k * seg + s, h, 0)),
        OperandSpec("state", "output", (B, H), (P, N),
                    lambda h, k, b, s: (b, h)
                    if k == nseg - 1 and s == last(k) else None),
    ]
    if nseg > 1:
        ops.append(OperandSpec(
            "seg_state", "input", (B, H, nseg - 1), (1, 1, P * N),
            lambda h, k, b, s: (b, h, k - 1) if k > 0 and s == 0 else None))
    return KernelContract(
        kernel="ssd_scan", grid=(H, nseg, B, seg), operands=tuple(ops),
        dimension_semantics=(par, par, par, "arbitrary"),
        sequential_axes=(3,), preconditions=pre,
        description=f"ssd_walk_kernel {route} ({nt} tiles, {nseg} segments)")
