"""Batched dense linear solves of the Newton step.

Every Newton-Raphson trip of a scenario sweep solves many small dense
real systems: the per-harmonic blocks and the Woodbury capacitance system
of the arrow step (hpfx.arrow, hpfx.lanes), the dense Jacobian of the
reference-form step, and the exact-linear warm seed.  This module holds
the two dispatchers — :func:`batched_solve` for batch-major operands
(B, n, n) and :func:`batched_solve_lanes` for the lane-major (n, n, B)
operands of hpfx.lanes — and the ``custom_vmap`` primitives that route a
vmapped per-scenario solve through one batched call.

f32 solves are equilibrated (row and column max-abs scaling) before the
elimination: the HPF Jacobian mixes O(1) power rows with O(|Y|) current
rows, and raw f32 elimination loses that spread in accuracy.  f64 solves
keep XLA's raw LU, the arithmetic the reference-parity gates were tuned
on.  Which route a lane-minor solve takes is decided by
:func:`hpfx.ops.dispatch.solve_route`.
"""
from __future__ import annotations

import jax
import jax.custom_batching
import jax.numpy as jnp

from .dispatch import solve_route
from .gj_triton import gj_solve_triton_lanes


def equilibrated(solve):
    """Wrap a batched solver with row+column max-abs equilibration.

    The HPF Jacobian mixes power rows (O(1)) with current-balance rows
    (O(|Y|), up to ~1e4 on stiff grids): raw f32 elimination loses ~the
    scale spread in accuracy and partial pivoting picks structurally wrong
    pivots.  Scaling D_r·A·D_c x' = D_r·b, x = D_c·x' is exact in exact
    arithmetic (pure diagonal scalings) and restores f32 step accuracy.
    Applied on the f32 fast path only — the f64 parity path must keep the
    reference's raw arithmetic for trajectory/iteration-count parity.
    """
    def wrapped(A, b):
        multi = b.ndim == A.ndim
        absA = jnp.abs(A)
        r = 1.0 / jnp.maximum(jnp.max(absA, axis=-1), 1e-30)   # (B, n)
        As = A * r[..., :, None]
        c = 1.0 / jnp.maximum(jnp.max(jnp.abs(As), axis=-2), 1e-30)
        As = As * c[..., None, :]
        bs = b * (r[..., :, None] if multi else r)
        x = solve(As, bs)
        return x * (c[..., :, None] if multi else c)
    return wrapped


def _lu_solve(A, b):
    if b.ndim == A.ndim:              # (B, n, R)
        return jnp.linalg.solve(A, b)
    return jnp.linalg.solve(A, b[..., None])[..., 0]


def batched_solve(A, b):
    """Batched dense solve, batch-major: A (B, n, n), b (B, n) or
    (B, n, R) (multi-RHS).  f64: raw XLA LU; f32: XLA LU behind
    :func:`equilibrated`."""
    if A.dtype == jnp.float64:
        return _lu_solve(A, b)
    return equilibrated(_lu_solve)(A, b)


def equilibrated_lanes(solve):
    """Batch-minor twin of :func:`equilibrated`: A (n, n, B), b (n, R, B)."""
    def wrapped(A, b):
        absA = jnp.abs(A)
        r = 1.0 / jnp.maximum(jnp.max(absA, axis=1), 1e-30)    # (n, B)
        As = A * r[:, None, :]
        c = 1.0 / jnp.maximum(jnp.max(jnp.abs(As), axis=0), 1e-30)
        As = As * c[None, :, :]
        bs = b * r[:, None, :]
        x = solve(As, bs)
        return x * c[:, None, :]
    return wrapped


def _lu_solve_lanes(A, b):
    """XLA LU on batch-minor operands (relayout both ways)."""
    x = jnp.linalg.solve(jnp.moveaxis(A, -1, 0), jnp.moveaxis(b, -1, 0))
    return jnp.moveaxis(x, 0, -1)


_LANE_ROUTES = {
    "lu": _lu_solve_lanes,
    "lu_equilibrated": equilibrated_lanes(_lu_solve_lanes),
    "gj_triton": equilibrated_lanes(gj_solve_triton_lanes),
}


def batched_solve_lanes(A, b):
    """Batch-minor twin of :func:`batched_solve`: A (n, n, B), b (n, R, B)
    -> x (n, R, B).  Operands stay lane-minor end to end; the route is
    :func:`hpfx.ops.dispatch.solve_route` of the traced backend, dtype
    and dim."""
    route = solve_route(jax.default_backend(), A.dtype, A.shape[0])
    return _LANE_ROUTES[route](A, b)


@jax.custom_batching.custom_vmap
def solve_blocks(D, rhs):
    """Uniform multi-RHS block solves: D (H, k, k), rhs (H, k, R).

    This is the arrow solver's inner primitive (hpfx/arrow.py): one small
    dense factorization per harmonic block, shared by the mismatch RHS and
    the Woodbury U columns.  Under ``vmap`` — the scenario sweep — the
    rule below flattens the (scenario, harmonic) axes into one big batch
    for :func:`batched_solve` (the (B·H, 2n) batch at small k beats one
    (B,) batch at dimension 2·H·n by ~H² in flops).  A single scenario's
    (H, k, k) blocks are already a batch and use the same dispatcher
    (with equilibration) for f32; f64 keeps the raw LU for reference
    parity.
    """
    if D.dtype == jnp.float64:
        return jnp.linalg.solve(D, rhs)
    return batched_solve(D, rhs)


@solve_blocks.def_vmap
def _solve_blocks_vmap(axis_size, in_batched, D, rhs):
    D_b, r_b = in_batched
    if not D_b:
        D = jnp.broadcast_to(D, (axis_size,) + D.shape)
    if not r_b:
        rhs = jnp.broadcast_to(rhs, (axis_size,) + rhs.shape)
    B, H, k, _ = D.shape
    R = rhs.shape[-1]
    out = batched_solve(D.reshape(B * H, k, k), rhs.reshape(B * H, k, R))
    return out.reshape(B, H, k, R), True


@jax.custom_batching.custom_vmap
def nr_solve(J, f):
    """The Newton-Raphson linear solve J·dx = f.

    Under ``vmap`` — the scenario sweep — the custom batching rule below
    routes the whole batch through one :func:`batched_solve` call.
    Single f32 solves go through the same dispatcher as a batch of one,
    so they get the same equilibration the swept path relies on; f64
    keeps the raw LU the reference-parity gates were tuned on.
    """
    if J.dtype == jnp.float64:
        return jnp.linalg.solve(J, f)
    return batched_solve(J[None], f[None])[0]


@nr_solve.def_vmap
def _nr_solve_vmap(axis_size, in_batched, J, f):
    J_b, f_b = in_batched
    if not J_b:
        J = jnp.broadcast_to(J, (axis_size,) + J.shape)
    if not f_b:
        f = jnp.broadcast_to(f, (axis_size,) + f.shape)
    return batched_solve(J, f), True
