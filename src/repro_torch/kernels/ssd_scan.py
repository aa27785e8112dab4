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
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunk_size
from repro_torch.kernels.ref import ssd_chunked_ref as ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_chunk_size", "route_for",
           "tile_plan"]

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
    if P > MAX_P or N > MAX_N:
        raise ValueError(
            f"no tensor-core SSD route takes P={P} N={N} (at most P "
            f"{MAX_P}, N {MAX_N})")
    return "walk" if tile_plan(S, P, N)["segments"] == 1 else "chunks"


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
    N) after the last chunk, or None when ``final_state`` is False)."""
    _check_shapes(x, dt, A, Bc, Cc)
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bc, Cc, chunk=chunk,
                              final_state=final_state)
    if dev.type != "cuda":
        raise ValueError(f"no SSD scan kernel for device {dev}")
    route, Q = check_operands(x, dt, A, Bc, Cc, chunk)
    Bsz, S, H, P = x.shape
    N = Bc.shape[-1]
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
