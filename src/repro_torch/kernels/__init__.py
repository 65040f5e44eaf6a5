"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref``) and the device selectors (``ops``).

Nothing here builds or loads a kernel at import time: the first launch
builds ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` (``build.library``).
The dense attention selector is ``ops.flash_attention``; it is not
re-exported here, where its name would hide the ``flash_attention`` module.
"""

from .ops import (can_delete_blocks, can_delete_blocks_interval,
                  paged_chunk_attention, paged_decode_attention)

__all__ = ["can_delete_blocks", "can_delete_blocks_interval",
           "paged_chunk_attention", "paged_decode_attention"]
