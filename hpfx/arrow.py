"""Structure-exploiting Newton-step solver: block-diagonal + Woodbury.

The harmonic Jacobian (hcne_generalized.py:401-473) has *arrow* sparsity
(SURVEY §5.7): after grouping rows/columns by harmonic it is block-diagonal
— one (2n-1-c) fundamental block and K blocks of size 2n — except for the
Norton-equivalent coupling, which touches only the *diagonal entries of
nonlinear buses* for each harmonic pair (h, p) (:425-435).  That coupling
is a rank-structured correction supported on r = 2·H·n_nl coordinates (the
angle/magnitude states of the nonlinear buses at every harmonic).

This module solves J·dx = f via the Woodbury identity:

    J_pi = D + U·C·V^T                    (pi = harmonic-grouped permutation)
    J^{-1}f = z - D^{-1}U · (I_r + C·G)^{-1} · C·(V^T z),
    z = D^{-1}f,  G = V^T D^{-1} U        (block-diagonal over harmonics)

Costs O(H·(2n)^3 + r^3) instead of O((2Hn)^3): for net1 at H<=25 that is
~20x fewer flops, and every operation is a *batched small dense* op
(batched contractions and batched LU) — the batched answer to the
reference's scipy.sparse LU.  For uncoupled devices C = 0 and the solve is
purely block-diagonal.

The dense path remains the default; ``Settings.solver = "arrow"`` enables
this one.  Both compute the exact same Newton step (verified to fp noise in
tests/test_arrow.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from . import cx
from .cx import Cx
from .devices import AnalyticDeviceSet, DeviceSet
from .fundamental import _power_jacobian_blocks
from .ops.batched_solve import nr_solve, solve_blocks


class ArrowIndex(NamedTuple):
    """Static index maps between the reference's state/mismatch layout
    (hcne_generalized.py:393-398, 469-472) and the harmonic-grouped
    block layout.  All arrays are host-side numpy constants."""

    H: int
    n: int
    m: int
    c: int
    d0: int                 # fundamental block size (2n-1-c)
    f_perm: np.ndarray      # (dim,) original row -> grouped position
    x_perm: np.ndarray      # (dim,) original col -> grouped position
    cpl0: np.ndarray        # (2*n_nl,) coupling coords in block-0 (local)
    cplh: np.ndarray        # (2*n_nl,) coupling coords in blocks h>=1


def make_arrow_index(H: int, n: int, m: int, c: int) -> ArrowIndex:
    n_nl = n - m
    dim = 2 * H * n - 1 - c

    # original row layout offsets (hcne_generalized.py:469-472)
    oP = 0
    oRe = m - 1
    oQ = oRe + (H * n - m)
    oIm = oQ + (m - c)
    # original column layout (angles flat[1:], magnitudes flat[c:])
    oMag = H * n - 1

    f_perm = np.zeros(dim, np.int64)
    x_perm = np.zeros(dim, np.int64)

    # grouped layout: block 0 = [P rows, ReI(0), Q rows, ImI(0)] then per
    # harmonic h: [ReI(h), ImI(h)]; columns analogous
    d0 = 2 * n - 1 - c
    # --- rows, block 0
    pos = 0
    for j in range(1, m):                      # P rows
        f_perm[oP + (j - 1)] = pos; pos += 1
    for j in range(m, n):                      # ReI at h=0
        f_perm[oRe + (0 * n + j - m)] = pos; pos += 1
    for j in range(c, m):                      # Q rows
        f_perm[oQ + (j - c)] = pos; pos += 1
    for j in range(m, n):                      # ImI at h=0
        f_perm[oIm + (0 * n + j - m)] = pos; pos += 1
    # --- rows, blocks h >= 1
    for h in range(1, H):
        for j in range(n):
            f_perm[oRe + (h * n + j - m)] = pos; pos += 1
        for j in range(n):
            f_perm[oIm + (h * n + j - m)] = pos; pos += 1

    # --- cols, block 0
    pos = 0
    for j in range(1, n):                      # angles h=0
        x_perm[(0 * n + j) - 1] = pos; pos += 1
    for j in range(c, n):                      # magnitudes h=0
        x_perm[oMag + (0 * n + j - c)] = pos; pos += 1
    for h in range(1, H):
        for j in range(n):
            x_perm[(h * n + j) - 1] = pos; pos += 1
        for j in range(n):
            x_perm[oMag + (h * n + j - c)] = pos; pos += 1

    # coupling coordinates (angle, magnitude of each nonlinear bus) in
    # block-local column numbering
    cpl0 = np.concatenate([
        np.arange(m, n) - 1,                       # angles: local j-1
        (n - 1) + (np.arange(m, n) - c)])          # magnitudes
    cplh = np.concatenate([np.arange(m, n), n + np.arange(m, n)])
    return ArrowIndex(H=H, n=n, m=m, c=c, d0=d0,
                      f_perm=f_perm, x_perm=x_perm, cpl0=cpl0, cplh=cplh)


class ArrowPieces(NamedTuple):
    D0: jnp.ndarray       # (d0, d0) fundamental block
    Dh: jnp.ndarray       # (K, 2n, 2n) harmonic blocks
    C: jnp.ndarray        # (r, r) coupling matrix (zeros if uncoupled)


def _coupling_cx(V_m, V_a, devices: DeviceSet, m: int):
    """K_V/K_A (H, H, n_nl): the value added to the Jacobian's
    (h·n+i, p·n+i) entries (NE convention, hcne_generalized.py:425-443)."""
    if not isinstance(devices, DeviceSet):  # analytic-style device
        # same autodiff coupling blocks the dense path uses
        # (hpfx/harmonic.py build_harmonic_jacobian): for Norton
        # equivalents these reduce to the closed forms below
        JV, JA = devices.injection_jacobians(V_m[:, m:], V_a[:, m:])
        return JV.transpose(1, 2, 0), JA.transpose(1, 2, 0)
    Vn_nl = cx.expj(V_a)[:, m:]
    V_nl = cx.polar(V_m, V_a)[:, m:]
    if devices.coupled:
        K_V = -cx.einsum("dhp,pd->hpd", devices.Y_N, Vn_nl)
        K_A = -cx.einsum("dhp,pd->hpd", devices.Y_N, V_nl).jmul()
    else:
        H, n_nl = V_m.shape[0], V_m.shape[1] - m
        diag_V = -(devices.Y_N.T * Vn_nl)                  # (H, n_nl)
        diag_A = -(devices.Y_N.T * V_nl).jmul()
        hh = jnp.arange(H)
        K_V = cx.zeros((H, H, n_nl), V_m.dtype).at_set((hh, hh), diag_V)
        K_A = cx.zeros((H, H, n_nl), V_m.dtype).at_set((hh, hh), diag_A)
    return K_V, K_A


def build_arrow_pieces(V_m, V_a, Y: Cx, devices: DeviceSet,
                       idx: ArrowIndex) -> ArrowPieces:
    """Assemble the block-diagonal and coupling parts of the Jacobian."""
    H, n, m, c = idx.H, idx.n, idx.m, idx.c
    n_nl = n - m
    V_c = cx.polar(V_m, V_a)
    Vn = cx.expj(V_a)

    blocks_V = Y * Vn[:, None, :]                       # (H, n, n)
    blocks_A = (Y * V_c[:, None, :]).jmul()
    K_V, K_A = _coupling_cx(V_m, V_a, devices, m)

    # fold the h == p coupling into the diagonal blocks
    nl = jnp.arange(m, n)
    hh = jnp.arange(H)
    diag_KV = K_V[hh, hh]                               # (H, n_nl)
    diag_KA = K_A[hh, hh]
    M_V = blocks_V.at_add((slice(None), nl, nl), diag_KV)
    M_A = blocks_A.at_add((slice(None), nl, nl), diag_KA)

    # fundamental power rows
    dS1dA1, dS1dV1 = _power_jacobian_blocks(V_c[0], Vn[0], Y[0], n)

    D0 = jnp.block([
        [dS1dA1.re[1:m, 1:], dS1dV1.re[1:m, c:]],
        [M_A.re[0, m:, 1:], M_V.re[0, m:, c:]],
        [dS1dA1.im[c:m, 1:], dS1dV1.im[c:m, c:]],
        [M_A.im[0, m:, 1:], M_V.im[0, m:, c:]],
    ])
    Dh = jnp.concatenate([
        jnp.concatenate([M_A.re[1:], M_V.re[1:]], axis=2),
        jnp.concatenate([M_A.im[1:], M_V.im[1:]], axis=2),
    ], axis=1)                                          # (K, 2n, 2n)

    # dense coupling matrix C (r x r), r = 2*H*n_nl; coordinate order
    # u = (h, d, [0=angle/Re, 1=magnitude/Im])... rows use (Re, Im), cols
    # use (angle, magnitude).  Only h != p and d == d' entries are nonzero.
    r = 2 * H * n_nl
    off = ~jnp.eye(H, dtype=bool)[:, :, None]           # (H, H, 1)
    zero = jnp.zeros_like(K_V.re)
    KVr = jnp.where(off, K_V.re, zero)
    KVi = jnp.where(off, K_V.im, zero)
    KAr = jnp.where(off, K_A.re, zero)
    KAi = jnp.where(off, K_A.im, zero)
    # coordinate order within a harmonic block: [angles/Re for every
    # nonlinear bus, then magnitudes/Im] — u = h·(2·n_nl) + t·n_nl + d,
    # matching the U/V coordinate lists in arrow_solve
    eye_d = jnp.eye(n_nl, dtype=K_V.re.dtype)
    Cfull = jnp.stack([
        jnp.stack([KAr, KVr], axis=-1),                 # rc=0 (Re row)
        jnp.stack([KAi, KVi], axis=-1),                 # rc=1 (Im row)
    ], axis=-2)                                         # (H, H, n_nl, 2, 2)
    # expand the d-diagonal: (H, 2, n_nl, H, 2, n_nl)
    Cexp = jnp.einsum("hpdrc,de->hrdpce", Cfull, eye_d)
    C = Cexp.reshape(r, r)
    return ArrowPieces(D0=D0, Dh=Dh, C=C)


def arrow_solve(pieces: ArrowPieces, f, idx: ArrowIndex):
    """Solve J dx = f using the block + Woodbury structure."""
    H, n, m, c = idx.H, idx.n, idx.m, idx.c
    n_nl = n - m
    K = H - 1
    d0 = idx.d0
    r = 2 * H * n_nl
    r_blk = 2 * n_nl

    # f_perm maps original->grouped, so grouped[f_perm[i]] = f[i]
    fp = jnp.zeros_like(f).at[jnp.asarray(idx.f_perm)].set(f)

    f0 = fp[:d0]
    fh = fp[d0:].reshape(K, 2 * n)

    # unit columns of U in block-local row numbering: current rows of the
    # nonlinear buses.  block 0: ReI local = (m-1)+(i-m), ImI local =
    # (m-1)+n_nl+(m-c)+(i-m); blocks h>=1: i and n+i.
    rows0 = np.concatenate([
        (m - 1) + np.arange(n_nl),
        (m - 1) + n_nl + (m - c) + np.arange(n_nl)])
    rowsh = np.concatenate([np.arange(m, n), n + np.arange(m, n)])

    E0 = jnp.zeros((d0, r_blk), pieces.D0.dtype).at[
        jnp.asarray(rows0), jnp.arange(r_blk)].set(1.0)
    Eh = jnp.zeros((2 * n, r_blk), pieces.D0.dtype).at[
        jnp.asarray(rowsh), jnp.arange(r_blk)].set(1.0)

    # one factorization per block, shared by f and the U columns.  The
    # fundamental block (size d0 = 2n-1-c) is identity-padded to 2n so all
    # H blocks go through a single uniform (H, 2n, 2n) batched solve).
    pad = 2 * n - d0
    D0p = jnp.eye(2 * n, dtype=pieces.D0.dtype).at[:d0, :d0].set(pieces.D0)
    rhs0 = jnp.concatenate([f0[:, None], E0], axis=1)
    rhs0p = jnp.zeros((2 * n, 1 + r_blk), rhs0.dtype).at[:d0].set(rhs0)
    rhsh = jnp.concatenate([fh[..., None],
                            jnp.broadcast_to(Eh, (K,) + Eh.shape)], axis=2)
    D_all = jnp.concatenate([D0p[None], pieces.Dh], axis=0)
    rhs_all = jnp.concatenate([rhs0p[None], rhsh], axis=0)
    # one multi-RHS factorization per harmonic block; under the scenario
    # vmap this routes the flattened (B·H, 2n, 2n) batch through the Pallas
    # lane-parallel Gauss-Jordan kernel (hpfx/ops/batched_solve.py)
    sol_all = solve_blocks(D_all, rhs_all)

    z0, X0 = sol_all[0, :d0, 0], sol_all[0, :d0, 1:]
    zh, Xh = sol_all[1:, :, 0], sol_all[1:, :, 1:]

    # V^T picks the coupling coordinates of a grouped vector
    cpl0 = jnp.asarray(idx.cpl0)
    cplh = jnp.asarray(idx.cplh)
    Vz = jnp.concatenate([z0[cpl0][None], zh[:, cplh]], axis=0)  # (H, r_blk)
    Vz = Vz.reshape(r)

    # G = V^T D^{-1} U: block-diagonal over harmonics
    G0 = X0[cpl0]                                   # (r_blk, r_blk)
    Gh = Xh[:, cplh, :]                             # (K, r_blk, r_blk)
    Gblocks = jnp.concatenate([G0[None], Gh], axis=0)

    # S = I + C G (G block-diag): S[:, p-block] = C[:, p-block] @ G_p
    Cb = pieces.C.reshape(r, H, r_blk)
    CG = jnp.einsum("rpb,pbs->rps", Cb.transpose(0, 1, 2), Gblocks)
    S = jnp.eye(r, dtype=f.dtype) + CG.reshape(r, r)
    # the Woodbury capacitance solve (dim r = 2·H·n_nl); batched through
    # the Pallas kernel under the scenario vmap, XLA LU when oversized
    y = nr_solve(S, pieces.C @ Vz)

    # dx = z - D^{-1} U y
    yb = y.reshape(H, r_blk)
    corr0 = X0 @ yb[0]
    corrh = jnp.einsum("kds,ks->kd", Xh, yb[1:])
    x0 = z0 - corr0
    xh = zh - corrh

    xp = jnp.concatenate([x0, xh.reshape(-1)])
    # map grouped solution back to original column ordering
    return xp[jnp.asarray(idx.x_perm)]
