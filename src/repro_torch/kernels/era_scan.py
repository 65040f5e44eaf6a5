"""WFE cleanup() interval scan (paper Fig. 4, Theorem 4): the CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/era_scan.py``
``era_scan_interval`` (:96).  The kernel lives in ``csrc/era_scan.cu``
(design and what bounds it on an H100 are in its header); this module
checks the operands and launches it on the current CUDA stream.  Its plain
PyTorch version is ``era_scan_interval_ref``.

The wrapper takes CUDA tensors only; ``ops.can_delete_blocks_interval``
brings the era table's NumPy mirrors to the device and the mask back.
"""

from __future__ import annotations

import torch

from . import build
from .ref import INF_ERA32, era_scan_interval_ref

__all__ = ["era_scan_interval", "era_scan_interval_ref",
           "INF_ERA32", "LAUNCHES"]

#: launches of the kernel (``LAUNCHES.n``), bumped once per launch
LAUNCHES = build.Counter()


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.ndim != 1 or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def era_scan_interval(alloc_eras: torch.Tensor, retire_eras: torch.Tensor,
                      res_lo: torch.Tensor, res_hi: torch.Tensor
                      ) -> torch.Tensor:
    """(R,), (R,), (S,), (S,) int32 CUDA tensors -> (R,) bool mask."""
    for name, t in (("alloc_eras", alloc_eras), ("retire_eras", retire_eras),
                    ("res_lo", res_lo), ("res_hi", res_hi)):
        _check(name, t)
    r, s = alloc_eras.shape[0], res_lo.shape[0]
    if retire_eras.shape[0] != r or res_hi.shape[0] != s:
        raise ValueError("alloc/retire and lo/hi lengths must match")
    out = torch.empty((r,), dtype=torch.bool, device=alloc_eras.device)
    if r == 0:
        return out
    stream = torch.cuda.current_stream(alloc_eras.device).cuda_stream
    err = build.library().era_scan_interval(
        alloc_eras.data_ptr(), retire_eras.data_ptr(), res_lo.data_ptr(),
        res_hi.data_ptr(), out.data_ptr(), r, s, stream)
    build.check(err, "era_scan_interval")
    LAUNCHES.n += 1
    return out

