"""PyTorch/CUDA port of the WFE reproduction (``repro``), for NVIDIA Hopper.

The tree mirrors ``repro``: ``repro_torch/X/y.py`` ports ``repro/X/y.py``.
The package imports ``torch`` and never ``jax`` or ``repro``; the host
layer (SMR schemes, era tables, pools, scheduler) is a copy whose cleanup
backends are ``scalar|numpy|torch|cuda``.  Entry points run on CUDA unless
the caller passes ``device="cpu"``.
"""


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: CUDA unless the caller
    names another.  Raises where CUDA is asked for (or defaulted to) and
    absent, rather than carrying on on the CPU."""
    import torch  # here, so the host layer (core/, blocks/) imports no torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev
