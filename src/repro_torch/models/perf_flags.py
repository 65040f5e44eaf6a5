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
"""

FLAGS = {
    "scatter_cache_update": True,
    "bf16_weight_gather": False,
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
