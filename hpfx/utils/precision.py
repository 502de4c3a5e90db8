"""Matmul-precision control.

JAX's default matmul precision lets an accelerator compute f32 products
at reduced precision: on an NVIDIA GPU with tensor cores a plain f32
product may run in TF32, which keeps about three decimal digits.  That is
the right default for neural-net training and the wrong one for
Newton-Raphson: residual evaluation needs the full f32 mantissa or
convergence stalls around a 1e-2..1e-4 floor (the matmuls inside a
batched ``jnp.linalg.solve`` also honor the ambient default).  Every hpfx
solver entry point traces its computation under ``highest`` precision;
``hpfx.cx`` contractions additionally request ``Precision.HIGHEST``
explicitly.
"""
from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Decorator: trace ``fn`` under jax.default_matmul_precision('highest')."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
