"""Pallas kernel through Triton: batched Gauss-Jordan for small systems.

One program eliminates a group of ``G`` systems whose padded (N, N)
matrices stay in registers for the whole elimination; the grid runs over
the groups in parallel.  N, G and the padded RHS count are powers of two.
Pivoting is *virtual*: rather than swapping rows, each step k selects,
per system, the not-yet-used row with the largest |A[r, k]| as the pivot
row, eliminates column k from every other row and normalizes the pivot
row in place; a ``used`` mask replaces the permutation.  After n steps A
is a per-system permutation matrix, so the solution is one contraction
x[k] = sum_r A[r, k]·b[r] — no gather.  This is LU with partial pivoting
in exact arithmetic.

Operands are lane-minor, A (n, n, B), b (n, R, B), the layout of
hpfx.lanes, so a block is an (N, N, G) slab of the batch.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

#: largest system dim the kernel takes, and the largest
#: hpfx.ops.dispatch routes here on the GPU: the kernel beats XLA's
#: batched LU per solve at dim 8 and end to end on the net2 sweep, and
#: loses per solve at dims 26 and 64 (PERF.md)
MAX_DIM = 16

#: (padded dim N, systems per program, warps per program): at N=8 the
#: fastest configuration timed on an H100 (PERF.md); at N=16 the same
#: number of matrix elements per program
_CONFIGS = ((8, 8, 1), (MAX_DIM, 2, 1))


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _gj_kernel(a_ref, b_ref, x_ref, *, n: int):
    A = a_ref[...]                                            # (N, N, G)
    b = b_ref[...]                                            # (N, R, G)
    N, _, G = A.shape
    row = jax.lax.broadcasted_iota(jnp.int32, (N, G), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (N, N, G), 1)

    def step(k, carry):
        A, b, used = carry
        colk = jnp.sum(jnp.where(col == k, A, 0.0), axis=1)   # (N, G)
        score = jnp.abs(colk) - 1e30 * used
        p = jnp.argmax(score, axis=0)                          # (G,)
        on_p = (row == p[None, :]).astype(A.dtype)             # (N, G)
        rowp = jnp.sum(on_p[:, None, :] * A, axis=0)           # (N, G)
        bp = jnp.sum(on_p[:, None, :] * b, axis=0)             # (R, G)
        pivot = jnp.sum(on_p * colk, axis=0)                   # (G,)
        inv_piv = 1.0 / pivot
        w = (1.0 - on_p) * colk * inv_piv[None, :] + \
            on_p * (1.0 - inv_piv[None, :])
        A = A - w[:, None, :] * rowp[None, :, :]
        b = b - w[:, None, :] * bp[None, :, :]
        return A, b, jnp.maximum(used, on_p)

    # padded rows (r >= n) are all-zero: marked used up front
    used0 = (row >= n).astype(A.dtype)
    A, b, _ = jax.lax.fori_loop(0, n, step, (A, b, used0))
    # A is now a per-system permutation: x[k] = sum_r A[r, k]·b[r]
    x_ref[...] = jnp.sum(A[:, :, None, :] * b[:, None, :, :], axis=0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def gj_solve_triton_lanes(A, b, interpret: bool = False):
    """Solve A[..., i] x = b[..., i] for lane-minor f32 systems
    A (n, n, B), b (n, R, B) -> x (n, R, B), n <= :data:`MAX_DIM`.

    The batch is padded up to a multiple of the group size of the padded
    dim's configuration.  ``interpret`` runs the kernel in the Pallas
    interpreter (CPU tests only)."""
    n, _, B = A.shape
    R = b.shape[1]
    if n > MAX_DIM:
        raise ValueError(f"dim {n} exceeds the kernel's {MAX_DIM}")
    N, RP = _pow2(n), _pow2(R)
    _, G, num_warps = next(c for c in _CONFIGS if N <= c[0])
    Bp = -(-B // G) * G
    Ap = jnp.zeros((N, N, Bp), jnp.float32).at[:n, :n, :B].set(A)
    bp = jnp.zeros((N, RP, Bp), jnp.float32).at[:n, :R, :B].set(b)
    x = pl.pallas_call(
        functools.partial(_gj_kernel, n=n),
        grid=(Bp // G,),
        in_specs=[pl.BlockSpec((N, N, G), lambda i: (0, 0, i)),
                  pl.BlockSpec((N, RP, G), lambda i: (0, 0, i))],
        out_specs=pl.BlockSpec((N, RP, G), lambda i: (0, 0, i)),
        out_shape=jax.ShapeDtypeStruct((N, RP, Bp), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name="gj_solve_triton",
    )(Ap, bp)
    return x[:n, :R, :B].astype(A.dtype)
