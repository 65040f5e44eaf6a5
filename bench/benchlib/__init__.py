"""The benchmark's library: loading cells by name, the serving and training
drivers, the plain reference models, the profiler reductions and the
arithmetic of rates, tails and rooflines.  Nothing here imports ``jax`` or
the JAX package; the system under test is ``repro_torch``."""
