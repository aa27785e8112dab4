"""Mamba-2 SSD chunked scan: wrapper of the CUDA kernel
``csrc/ssd_scan.cu`` (K6), which replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::_kernel``.

It runs every SSD prefill of the Mamba-2 and Zamba-2 models
(``models/ssm.py::ssd_chunked``): y and, when asked, the fp32 state after
the last chunk, which a prefill with a cache stores for the decode steps.
Operands stay in the model layout and the kernel reads them through their
strides and forms dt·x and dt·A itself, so the wrapper launches nothing
else. For tensors on the CPU :func:`ssd_scan` runs :func:`ssd_scan_plain`
(``kernels/ref.py::ssd_chunked_ref``); for CUDA tensors it launches the
kernel or raises. ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunk_size
from repro_torch.kernels.ref import ssd_chunked_ref as ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_chunk_size"]

MAX_CHUNK = 128           # the kernel's bound on Q (csrc/ssd_scan.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if lib.ssd_scan.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan.argtypes = [i, vp, vp, vp, vp, vp, vp, vp,
                                 i, i, i, i, i, i,
                                 ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, vp]
        lib.ssd_scan.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


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
    Bsz, S, H, P = x.shape
    N = Bc.shape[-1]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bc.shape) != (Bsz, S, N) or tuple(Cc.shape) != (Bsz, S, N):
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(Bc.shape)}, C {tuple(Cc.shape)} disagree on "
            f"(B, S, H, P, N)")
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bc, Cc, chunk=chunk,
                              final_state=final_state)
    if dev.type != "cuda":
        raise ValueError(f"no SSD scan kernel for device {dev}")
    if x.dtype not in _DTYPE_CODES or {Bc.dtype, Cc.dtype} != {x.dtype} \
            or {dt.dtype, A.dtype} != {torch.float32}:
        raise ValueError(
            f"the kernel takes fp32 or bf16 x, B and C of one dtype and fp32 "
            f"dt and A, got x {x.dtype}, B {Bc.dtype}, C {Cc.dtype}, dt "
            f"{dt.dtype}, A {A.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", Bc), ("C", Cc)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    Q = ssd_chunk_size(S, chunk)
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk {Q} exceeds the kernel's {MAX_CHUNK}")
    x, Bc, Cc = (t if t.stride(-1) == 1 else t.contiguous()
                 for t in (x, Bc, Cc))
    A = A.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    state = (torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
             if final_state else None)
    lib = _lib()
    err = lib.ssd_scan(
        _DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bc.data_ptr(), Cc.data_ptr(), y.data_ptr(),
        None if state is None else state.data_ptr(),
        Bsz, S, H, P, N, Q, *x.stride()[:3], *dt.stride(),
        *Bc.stride()[:2], *Cc.stride()[:2],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"ssd_scan launch failed for B={Bsz} S={S} H={H} P={P} N={N} "
            f"Q={Q}: {lib.ssd_error_string(err).decode()}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
