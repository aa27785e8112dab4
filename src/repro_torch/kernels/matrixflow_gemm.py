"""MatrixFlow blocked GEMM (paper Algorithm 1): wrapper of the CUDA kernel
``csrc/matrixflow_gemm.cu``, which replaces the Pallas TPU kernel
``repro/kernels/matrixflow_gemm.py::_kernel``.

:func:`matrixflow_gemm_block_major` takes block-major operands — including a
resident ``PackedWeight``'s blocks — and returns C block-major. For tensors
on the CPU it runs the plain version (``kernels/ref.py::block_matmul_ref``);
for CUDA tensors it launches the kernel or raises. ``launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import layout as L
from repro_torch.kernels import _build
from repro_torch.kernels.ref import acc_dtype_for, block_matmul_ref

# Plain version of the kernel (Algorithm 1, K innermost).
plain = block_matmul_ref

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
# (input dtype, output dtype) pairs the kernel instantiates.
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32), (torch.int8, torch.int32)}


def _lib() -> ctypes.CDLL:
    lib = _build.load("matrixflow_gemm")
    if lib.mf_gemm.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mf_gemm.argtypes = [i, i, i, i, vp, vp, vp, i, i, i, i, vp]
        lib.mf_gemm.restype = ctypes.c_int
        lib.mf_error_string.argtypes = [i]
        lib.mf_error_string.restype = ctypes.c_char_p
    return lib


def matrixflow_gemm_block_major(
    a_bm: torch.Tensor, b_bm: torch.Tensor, *,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """C_bm = A_bm @ B_bm over MatrixFlow block-major operands.

    a_bm (nbm, nbk, bm, bk), b_bm (nbn, nbk, bk, bn) → C_bm (nbm, nbn, bm,
    bn). Accumulates in fp32 (int32 for int8); ``out_dtype`` defaults to
    the accumulator dtype, as in the TPU kernel.
    """
    if a_bm.dim() != 4 or b_bm.dim() != 4:
        raise ValueError(f"block-major operands must be 4-D, got "
                         f"{tuple(a_bm.shape)} and {tuple(b_bm.shape)}")
    nbm, nbk, bm, bk = a_bm.shape
    nbn, nbk2, bk2, bn = b_bm.shape
    if (nbk, bk) != (nbk2, bk2):
        raise ValueError(
            f"block-major operands disagree on the K stream: a_bm "
            f"{tuple(a_bm.shape)} walks {nbk} blocks of bk={bk}, b_bm "
            f"{tuple(b_bm.shape)} walks {nbk2} blocks of bk={bk2}")
    if a_bm.dtype != b_bm.dtype:
        raise ValueError(f"operand dtypes differ: {a_bm.dtype} vs {b_bm.dtype}")
    if a_bm.device != b_bm.device:
        raise ValueError(f"operands on {a_bm.device} and {b_bm.device}")
    out_dtype = out_dtype or acc_dtype_for(a_bm.dtype)
    if a_bm.device.type == "cpu":
        return plain(a_bm, b_bm, out_dtype=out_dtype)
    if a_bm.device.type != "cuda":
        raise ValueError(f"no MatrixFlow GEMM for device {a_bm.device}")
    if (a_bm.dtype, out_dtype) not in _PAIRS:
        raise ValueError(f"the kernel takes {sorted(map(str, _PAIRS))} "
                         f"(input, output) dtypes, not ({a_bm.dtype}, "
                         f"{out_dtype})")
    if bm not in L.BM_CHOICES or bn not in L.BN_CHOICES or bk % L.K_SLICE:
        raise ValueError(
            f"block geometry (bm={bm}, bn={bn}, bk={bk}) is not one the "
            f"kernel instantiates: bm in {L.BM_CHOICES}, bn in "
            f"{L.BN_CHOICES}, bk a multiple of {L.K_SLICE} "
            f"(core/layout.py::choose_layout picks these)")
    if not (a_bm.is_contiguous() and b_bm.is_contiguous()):
        raise ValueError("block-major operands must be contiguous")
    if a_bm.data_ptr() % 16 or b_bm.data_ptr() % 16:
        raise ValueError("operands must be 16-byte aligned")
    c_bm = torch.empty((nbm, nbn, bm, bn), dtype=out_dtype,
                       device=a_bm.device)
    lib = _lib()
    err = lib.mf_gemm(_IN_CODES[a_bm.dtype], _OUT_CODES[out_dtype], bm, bn,
                      a_bm.data_ptr(), b_bm.data_ptr(), c_bm.data_ptr(),
                      nbm, nbn, nbk, bk,
                      torch.cuda.current_stream(a_bm.device).cuda_stream)
    if err:
        raise RuntimeError(f"matrixflow_gemm launch failed: "
                           f"{lib.mf_error_string(err).decode()}")
    matrixflow_gemm_block_major.launches += 1
    return c_bm


matrixflow_gemm_block_major.launches = 0
