"""Performance toggles of ``repro.models.perf_flags`` that the port reads.

* ``scatter_cache_update`` — decode writes the new token's K/V (or MLA
  latent) with an indexed write into the cache instead of a one-hot blend
  that rewrites the whole (B, S, ...) cache.  Numerically exact; on by
  default, the blend stays selectable.
* ``bf16_weight_gather`` — the train step casts the floating f32 master
  leaves to the activation dtype once per microbatch, before the forward
  (cast-then-gather: on a mesh every FSDP weight gather then moves bf16,
  half the master copy's bytes); gradients flow back to f32 through the
  cast.  Off by default.
* ``bf16_collective_matmul`` — ``layers.matmul`` (and the MoE expert
  products) round each shard's product to the activation dtype, so the
  tensor-parallel all-reduce of row-parallel partials (and of the
  gradients' partials) moves bf16, not f32: half the TP-activation
  collective bytes.  Numerics: each shard's GEMM still accumulates in f32;
  the cross-shard sum rounds to bf16.  Off by default: the partials are
  f32 and rounded once after the sum, as the reference computes them.
"""

FLAGS = {
    "scatter_cache_update": True,
    "bf16_weight_gather": False,
    "bf16_collective_matmul": False,
}


def set_flags(**kw) -> dict:
    """Set flags by name and return the previous settings (restore them
    with ``set_flags(**prev)``)."""
    prev = dict(FLAGS)
    for k, v in kw.items():
        if k not in FLAGS:
            raise KeyError(k)
        FLAGS[k] = v
    return prev


def optimized() -> dict:
    """Set every flag on and return the previous settings."""
    return set_flags(scatter_cache_update=True, bf16_weight_gather=True,
                     bf16_collective_matmul=True)
