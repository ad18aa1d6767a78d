"""XLA's lowest CPU optimisation level for the JAX side of the port's
parity tests (tests/test_torch_port_*.py): their programs are small and run
once, so compiling them is most of their cost."""

import functools

import jax

FAST_COMPILE = {"xla_backend_optimization_level": 0}
fast_jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)
