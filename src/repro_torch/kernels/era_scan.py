"""WFE cleanup() interval scan (paper Fig. 4, Theorem 4): the CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/era_scan.py``
``era_scan_interval`` (:96).  The kernel lives in ``csrc/era_scan.cu``
(design, tile choice and what bounds it on an H100 are in its header);
this module checks the operands and launches it on the current CUDA
stream.  Its plain PyTorch version is ``era_scan_interval_ref``.

``era_scan_interval`` takes CUDA tensors.  ``round_trip`` is the route the
era table's ``cuda`` backend takes from its NumPy mirrors: one packed
pinned host-to-device copy, the launch, one device-to-host copy of the
mask and one stream sync (``ops.can_delete_blocks_interval``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import build
from .ref import INF_ERA32, era_scan_interval_ref

__all__ = ["era_scan_interval", "era_scan_interval_ref", "round_trip",
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
    LAUNCHES.bump()
    return out


class _Staging:
    """One device's pinned and device buffers for ``round_trip``, grown on
    demand to the next power of two."""

    def __init__(self, device: torch.device):
        self.device = device
        self.n_in = self.n_mask = 0

    def reserve(self, n_in: int, n_mask: int) -> None:
        if n_in > self.n_in:
            self.n_in = 1 << max(n_in - 1, 255).bit_length()
            self.host_in = torch.empty(self.n_in, dtype=torch.int32,
                                       pin_memory=True)
            self.host_in_np = self.host_in.numpy()
            self.dev_in = torch.empty(self.n_in, dtype=torch.int32,
                                      device=self.device)
        if n_mask > self.n_mask:
            self.n_mask = 1 << max(n_mask - 1, 255).bit_length()
            self.host_mask = torch.empty(self.n_mask, dtype=torch.uint8,
                                         pin_memory=True)
            self.host_mask_np = self.host_mask.numpy()
            self.dev_mask = torch.empty(self.n_mask, dtype=torch.uint8,
                                        device=self.device)


# the staging buffers of each device and the lock that guards them: the
# per-thread cleanup and cleanup_all may scan from two threads at once
_staging: dict = {}
_staging_lock = threading.Lock()


def round_trip(alloc: np.ndarray, retire: np.ndarray, lo: np.ndarray,
               hi: np.ndarray, device=None) -> np.ndarray:
    """The scan of NumPy int32 mirrors on a CUDA device, in one round trip:
    the four mirrors are packed into one pinned buffer and copied to the
    card in one non-blocking copy, the kernel runs, the mask comes back
    into pinned memory and the stream is synchronised once.  Returns a
    (R,) bool array of its own (the next scan reuses the buffers)."""
    r, s = len(alloc), len(lo)
    if len(retire) != r or len(hi) != s:
        raise ValueError("alloc/retire and lo/hi lengths must match")
    if r == 0:
        return np.ones(0, dtype=bool)
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"round_trip runs on a CUDA device, got {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    lib = build.library()
    with _staging_lock:
        st = _staging.get(dev.index)
        if st is None:
            st = _staging[dev.index] = _Staging(dev)
        st.reserve(2 * r + 2 * s, r)
        buf = st.host_in_np
        buf[:r] = alloc
        buf[r:2 * r] = retire
        buf[2 * r:2 * r + s] = lo
        buf[2 * r + s:2 * r + 2 * s] = hi
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.era_scan_round_trip(
            st.host_in.data_ptr(), st.dev_in.data_ptr(),
            st.dev_mask.data_ptr(), st.host_mask.data_ptr(), r, s, stream)
        build.check(err, "era_scan_round_trip")
        LAUNCHES.bump()
        return st.host_mask_np[:r].astype(bool)

