"""Harmonically-coupled Norton-equivalent (HCNE) power flow — the core solver.

Batched JAX re-design of the reference harmonic solver
(``hcne_generalized.py:313-560``: current_injections, current_balance,
harmonic_mismatch, harmonic_state_vector, build_harmonic_jacobian,
update_harmonic_*, hpf).  The math is identical; the implementation is not:

- Voltages are a dense (H, n) split-complex tensor (harmonic-major; see
  hpfx.cx for why complex is carried as re/im real pairs), never a
  pandas MultiIndex.  Flattening row-major reproduces the reference's
  (harmonic, bus) state ordering exactly, so states/Jacobians compare
  element-for-element against the oracle fixtures.
- Current injections for all nonlinear buses and all harmonic pairs are one
  batched einsum over the stacked ``DeviceSet`` arrays instead of the
  reference's O((K+1)^2 · n_nl) Python scatter loop
  (hcne_generalized.py:426-435) — the reference's dominant assembly cost,
  and a regular diagonal pattern that batches for free.
- The Jacobian is assembled in a (H, H, n, n) block layout and reshaped once
  to its dense (2·H·n-1-c)^2 real form; the NR step is a dense LU solve.
  The harmonic-block coupling is *only* through nonlinear-bus diagonal
  entries (arrow sparsity), which a block-structured Pallas solver can
  exploit; dense is already fast at reference problem sizes.
- The NR iteration is a single ``lax.while_loop`` (one XLA compilation),
  vmap-safe for batched scenario sweeps.

Sign conventions (hcne_generalized.py:195-198, 320-322, 351-354):
mismatch adds +S for loads; injections are I_N - Y_N·V and are *added* to the
line currents Y·V.  Voltage normalization inside the harmonic Jacobian uses
the *signed* magnitude (V/V_m = e^{j·theta}), matching :405 and :455 —
harmonic magnitudes can legitimately go negative mid-iteration and the
reference only cleans them up after the loop (:546-549), which is
load-bearing for trajectory parity.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
from jax import lax

from . import cx
from .config import Settings
from .cx import Cx
from .devices import AnalyticDeviceSet, DeviceSet
from .fundamental import (FundResult, _power_jacobian_blocks,
                          solve_fundamental)
from .network import Network
from .ops.batched_solve import nr_solve
from .utils.precision import highest_precision
from .ybus import build_ybus, line_ybus_pair, stable_matvec

_all = slice(None)


class HPFState(NamedTuple):
    """Carry of the harmonic NR loop."""
    V_m: jnp.ndarray   # (H, n)
    V_a: jnp.ndarray   # (H, n)
    x: jnp.ndarray     # (2*H*n - 1 - c,)
    f: jnp.ndarray     # mismatch residual, same length
    err: jnp.ndarray
    n_iter: jnp.ndarray
    err_hist: jnp.ndarray
    traj: Optional[jnp.ndarray] = None  # (max_iter+1, 2, H, n) V per iter


class HPFResult(NamedTuple):
    V_m: jnp.ndarray          # (H, n) cleaned magnitudes
    V_a: jnp.ndarray          # (H, n) angles in [0, 2pi)
    err: jnp.ndarray
    n_iter: jnp.ndarray
    err_hist: jnp.ndarray     # (max_iter_h,), NaN-padded
    converged: jnp.ndarray
    fund: Optional[FundResult] = None
    #: optional per-iteration raw (V_m, V_a) trace — the V_log.json
    #: capability (hcne_based_on_fuchs.py:186, 370); NaN-padded past n_iter
    trajectory: Optional[jnp.ndarray] = None


def current_injections(V_c: Cx, devices, m: int,
                       V_m=None, V_a=None) -> Cx:
    """Harmonic current injections of every nonlinear bus, batched.

    Reference: per-bus loop at hcne_generalized.py:313-323 computing
    I_inj = I_N - Y_N · V_h(bus).  Here: one einsum over the stacked device
    arrays (Norton equivalents), or the device's own differentiable
    injection function (AnalyticDeviceSet).  Returns (n_nl, H)
    split-complex.
    """
    if not isinstance(devices, DeviceSet):  # analytic-style device
        return devices.injections(V_m[:, m:], V_a[:, m:])
    V_nl = V_c[:, m:]                                   # (H, n_nl)
    if devices.coupled:
        return devices.I_N - cx.einsum("dhp,pd->dh", devices.Y_N, V_nl)
    return devices.I_N - devices.Y_N * V_nl.T


def current_balance(V_c: Cx, Y: Cx, devices, m: int, n: int,
                    V_m=None, V_a=None, YV: Optional[Cx] = None,
                    I_bg: Optional[Cx] = None) -> Cx:
    """Current balance vector (hcne_generalized.py:326-357).

    Fundamental balance at nonlinear buses (n-m+1 entries), then harmonic
    balance at all buses for each harmonic above the fundamental (n·K),
    injections added at the nonlinear-bus positions.  ``YV``: optional
    precomputed (H, n) Y·V (the stable_mismatch path).  ``I_bg``: optional
    constant (H, n) background injections (hpfx.background; fundamental
    row must be zero) — added like the device Norton currents, on every
    bus's harmonic rows.
    """
    I_inj = current_injections(V_c, devices, m, V_m, V_a)  # (n_nl, H)
    if YV is None:
        dI_f = cx.matvec(Y[0, m:, :], V_c[0]) + I_inj[:, 0]
        dI_h = cx.einsum("hij,hj->hi", Y[1:], V_c[1:])      # (K, n)
    else:
        dI_f = YV[0, m:] + I_inj[:, 0]
        dI_h = YV[1:]
    dI_h = dI_h.at_add((_all, slice(m, None)), I_inj[:, 1:].T)
    if I_bg is not None:
        dI_h = dI_h + I_bg[1:]
    return cx.concatenate([dI_f, dI_h.reshape(-1)])


def harmonic_mismatch(V_m, V_a, Y: Cx, S: Cx, devices,
                      m: int, n: int, c: int, lineY=None,
                      I_bg: Optional[Cx] = None):
    """Harmonic mismatch f and residual err (hcne_generalized.py:360-390).

    f_c = [dS (power, linear non-slack buses), dI (current balance)];
    f = [Re f_c, Im f_c[c-1:]] — the PV bus contributes a P-row but no
    Q-row.  err is the infinity norm.

    ``lineY``: optional ``hpfx.ybus.LineYbus``; when given, every Y·V is
    evaluated in the cancellation-free line-difference form
    (Settings.stable_mismatch) — algebraically identical, but with an f32
    residual floor ~two orders of magnitude lower.
    """
    V_c = cx.polar(V_m, V_a)
    YV = None if lineY is None else stable_matvec(lineY, V_m, V_a)
    I1 = cx.matvec(Y[0, 1:m, :], V_c[0]) if YV is None else YV[0, 1:m]
    Sl = V_c[0, 1:m] * I1.conj()
    dS = S[1:m] + Sl
    dI = current_balance(V_c, Y, devices, m, n, V_m, V_a, YV=YV, I_bg=I_bg)
    f_c = cx.concatenate([dS, dI])
    f = jnp.concatenate([f_c.re, f_c[c - 1:].im])
    return f, jnp.max(jnp.abs(f))


def harmonic_state_vector(V_m, V_a, c: int):
    """x = [angles.flat[1:], magnitudes.flat[c:]] over the (harmonic, bus)
    row-major layout (hcne_generalized.py:393-398)."""
    return jnp.concatenate([V_a.reshape(-1)[1:], V_m.reshape(-1)[c:]])


def update_harmonic_voltages(V_m, V_a, x, H: int, n: int, c: int):
    """Write the state vector back into the voltage tensors
    (hcne_generalized.py:482-485).  No angle/sign cleanup here — the
    reference applies it only after the loop (:546-549) and its absence
    during iterations is load-bearing."""
    D = H * n
    V_a = V_a.reshape(-1).at[1:].set(x[: D - 1]).reshape(H, n)
    V_m = V_m.reshape(-1).at[c:].set(x[D - 1:]).reshape(H, n)
    return V_m, V_a


def build_harmonic_jacobian(V_m, V_a, Y: Cx, devices,
                            m: int, n: int, c: int):
    """Dense real harmonic Jacobian (hcne_generalized.py:401-473).

    Assembled in a (H, H, n, n) harmonic-block layout:
    - diagonal blocks:  dI/dV|_hh = Y_h · diag(Vn_h),
                        dI/dA|_hh = j·Y_h · diag(V_h)       (:410-411)
    - NE coupling: for each nonlinear bus i and harmonic pair (h,p), the
      (h·n+i, p·n+i) entry gets -Y_N[h,p]·Vn[p,i] (resp. -j·Y_N[h,p]·V[p,i]);
      uncoupled devices touch only h == p                    (:425-443)
    then reshaped to dense, rows cropped to the current-balance equations
    (m:) and columns to the state layout (angles 1:, magnitudes c:), and
    stacked with the zero-padded fundamental power rows      (:444-472).
    """
    H = V_m.shape[0]
    D = H * n
    rd = V_m.dtype
    V_c = cx.polar(V_m, V_a)
    Vn = cx.expj(V_a)                  # V/V_m: signed normalization (:405)

    # Assembly is pure broadcast arithmetic against constant masks — no
    # runtime scatters under vmap.  Layout
    # (H, n, H, n): entry [h, i, p, j] of the big block matrix.
    eye_H = jnp.eye(H, dtype=rd)[:, None, :, None]      # δ_hp
    eye_n = jnp.eye(n, dtype=rd)                        # δ_ij
    # diagonal blocks: δ_hp · Y[h,i,j] · Vn/V[p,j]
    blocks_V = Y * Vn[:, None, :]                       # (H, n, n)
    blocks_A = (Y * V_c[:, None, :]).jmul()

    def embed_diag(blocks: Cx) -> Cx:
        exp = lambda a: eye_H * a[:, :, None, :]        # (H,n,H,n)
        return Cx(exp(blocks.re), exp(blocks.im))

    E_V = embed_diag(blocks_V)
    E_A = embed_diag(blocks_A)

    # Norton-equivalent coupling at nonlinear-bus diagonal entries:
    # [h, i, p, j] += K[h, p, i]·δ_ij·(i nonlinear), K padded over buses
    Vn_nl = Vn[:, m:]                                    # (H, n_nl)
    V_nl = V_c[:, m:]
    if not isinstance(devices, DeviceSet):  # analytic-style device
        # coupling blocks from autodiff of the injection: the current
        # balance is dI = Y·V + I_inj, so the (h·n+i, p·n+i) entries get
        # +∂I_inj[i,h]/∂V_m[p,i] and +∂I_inj[i,h]/∂V_a[p,i] (for Norton
        # equivalents these reduce to -Y_N·Vn / -j·Y_N·V, :425-435)
        JV, JA = devices.injection_jacobians(V_m[:, m:], V_a[:, m:])
        K_V, K_A = JV.transpose(1, 2, 0), JA.transpose(1, 2, 0)
    elif devices.coupled:
        K_V = -cx.einsum("dhp,pd->hpd", devices.Y_N, Vn_nl)  # (H, H, n_nl)
        K_A = -cx.einsum("dhp,pd->hpd", devices.Y_N, V_nl).jmul()
    else:
        diag_V = -(devices.Y_N.T * Vn_nl)                # (H, n_nl)
        diag_A = -(devices.Y_N.T * V_nl).jmul()
        eyeH2 = jnp.eye(H, dtype=rd)[:, :, None]
        K_V = Cx(eyeH2 * diag_V.re[:, None, :], eyeH2 * diag_V.im[:, None, :])
        K_A = Cx(eyeH2 * diag_A.re[:, None, :], eyeH2 * diag_A.im[:, None, :])

    # δ_ij restricted to nonlinear buses, (n, n_nl): M[i, d] = δ(i == m+d)
    nl_mask = eye_n[:, m:]

    def embed_coupling(K: Cx) -> Cx:
        add = lambda k: jnp.einsum("hpd,id,jd->hipj", k, nl_mask, nl_mask)
        return Cx(add(K.re), add(K.im))

    E_V = E_V + embed_coupling(K_V)
    E_A = E_A + embed_coupling(K_A)

    dIdV = E_V.reshape(D, D)[m:, c:]
    dIdA = E_A.reshape(D, D)[m:, 1:]

    # fundamental power rows, zero-padded across harmonic columns (:449-467);
    # note the signed-magnitude normalization (:455), unlike pf's |V| (:210)
    dS1dA1, dS1dV1 = _power_jacobian_blocks(V_c[0], Vn[0], Y[0], n)
    zpad = cx.zeros((n, D - n), rd)
    dSdA = cx.concatenate([dS1dA1, zpad], axis=1)
    dSdV = cx.concatenate([dS1dV1, zpad], axis=1)

    return jnp.block([
        [dSdA.re[1:m, 1:], dSdV.re[1:m, c:]],
        [dIdA.re, dIdV.re],
        [dSdA.im[c:m, 1:], dSdV.im[c:m, c:]],
        [dIdA.im, dIdV.im],
    ])


def mismatch_floor(V_m, Y: Cx, devices, m: int, settings: Settings,
                   I_bg: Optional[Cx] = None):
    """Evaluation-accuracy floor of the harmonic mismatch: eps·scale with
    scale = the largest row sensitivity max_{h,i} [sum_j |Y[h,i,j]|·|V_j|
    (+ sum_p |Y_N[·,h,p]|·|V_p| on nonlinear rows, + |S| on power rows)].

    This is what the computed residual can physically resolve given the
    state stored in ``settings.real_dtype``: any f stored below eps·scale
    is indistinguishable from rounding of the large cancelling terms
    (line flows obeying Kirchhoff, Norton fundamental-column couplings).
    Used by the floor-aware convergence test (Settings.floor_kappa).
    """
    eps = jnp.finfo(settings.real_dtype).eps
    vmax = jnp.abs(V_m)                                    # (H, n) proxy
    rows = jnp.einsum("hij,hj->hi", Y.abs(), vmax)         # current rows
    scale = jnp.max(rows)
    if isinstance(devices, DeviceSet) and devices.n_devices > 0:
        v_nl = vmax[:, m:]                                 # (H, n_nl)
        if devices.coupled:
            inj = jnp.einsum("dhp,pd->dh", devices.Y_N.abs(), v_nl)
        else:
            inj = (devices.Y_N.abs() * v_nl.T)
        scale = jnp.maximum(scale, jnp.max(inj))
    if I_bg is not None:   # constant background rows (hpfx.background)
        scale = jnp.maximum(scale, jnp.max(I_bg.abs()))
    return eps * scale


def init_harmonic_voltages(fund: FundResult, net: Network, settings: Settings):
    """Flat-start harmonic voltages seeded with the fundamental solution
    (hcne_generalized.py:174-184 + the warm start at :525)."""
    H, n = settings.n_harmonics, net.n
    rd = settings.real_dtype
    V_m = jnp.full((H, n), settings.v_init_h, rd).at[0].set(fund.V_m)
    V_a = jnp.full((H, n), settings.a_init_h, rd).at[0].set(fund.V_a)
    return V_m, V_a


def cleanup_voltages(V_m, V_a):
    """Post-loop sign/angle normalization (hcne_generalized.py:546-549):
    add pi to angles of negative magnitudes, wrap angles to [0, 2pi), flip
    magnitude signs."""
    neg = V_m < 0
    V_a = jnp.where(neg, V_a + jnp.pi, V_a) % (2 * jnp.pi)
    V_m = jnp.where(neg, -V_m, V_m)
    return V_m, V_a


@highest_precision
def solve_harmonic(Y: Cx, fund: FundResult, net: Network, devices: DeviceSet,
                   settings: Settings, V0=None,
                   record_trajectory: bool = False, lineY=None,
                   vsharding=None, I_bg: Optional[Cx] = None) -> HPFResult:
    """The harmonic NR hot loop (hcne_generalized.py:530-549) as one
    ``lax.while_loop``.

    ``V0``: optional (V_m, V_a) warm start, e.g. from a checkpointed or
    previously converged solution (hpfx.checkpoint) — replaces the flat
    start while keeping the fundamental row from ``fund``.

    ``vsharding``: optional ``jax.sharding.NamedSharding`` for the (H, n)
    voltage state — the harmonic-axis model-parallel hook
    (hpfx.parallel.hpf_single_hsharded).  Applied as a
    ``with_sharding_constraint`` to the while-loop carry so GSPMD keeps
    every per-harmonic op (Ybus matvecs, block Jacobians, the arrow block
    solves) partitioned over the mesh's harmonic axis and inserts the
    collectives only where harmonics actually couple (the Norton
    cross-harmonic einsum and the Woodbury capacitance reduction).
    Requires being called under ``jit``; ``None`` = no constraint.

    ``lineY``: optional ``hpfx.ybus.LineYbus`` enabling the stable
    mismatch.  Supplied by entry points that built ``Y`` from the network
    (hpf/hpf_single/hpf_sweep when Settings.stable_mismatch is on) — it
    must describe the SAME system as ``Y``, so callers that override Y
    (e.g. the Kron-reduced path, whose reduced blocks have no line
    structure) leave it None and get the reference-form dense mismatch.

    ``I_bg``: optional (H, n) split-complex constant background injections
    (hpfx.background) — a distorted upstream grid.  Enters only the
    mismatch (the Jacobian sees a constant), so both Newton paths
    (``Settings.solver`` dense/arrow) support it unchanged.
    """
    H, n, m, c = settings.n_harmonics, net.n, net.m, net.c
    S = Cx(net.bus_P, net.bus_Q)

    cold_V_m, cold_V_a = init_harmonic_voltages(fund, net, settings)
    if V0 is None:
        V_m, V_a = cold_V_m, cold_V_a
    else:
        V_m, V_a = V0

    def _vc(V_m, V_a):
        if vsharding is None:
            return V_m, V_a
        return (lax.with_sharding_constraint(V_m, vsharding),
                lax.with_sharding_constraint(V_a, vsharding))

    V_m, V_a = _vc(V_m, V_a)
    f0, err0 = harmonic_mismatch(V_m, V_a, Y, S, devices, m, n, c, lineY,
                                 I_bg=I_bg)
    # floor-aware effective threshold (see mismatch_floor); reduces to the
    # plain absolute thresh_h in f64 where the floor is ~1e-12.  The floor
    # is evaluated at the COLD flat-start state even for warm starts: a
    # warm V0 near the solution has ~10x smaller harmonic |V| (hence a
    # stricter floor), which would hold knife-edge re-solves to a tighter
    # criterion than the cold solve used (the lanes continuation twin does
    # the same — see hpfx.lanes.hpf_sweep_continuation_lanes).
    thresh_eff = jnp.maximum(
        jnp.asarray(settings.thresh_h, settings.real_dtype),
        settings.floor_kappa
        * mismatch_floor(cold_V_m, Y, devices, m, settings, I_bg=I_bg))
    x0 = harmonic_state_vector(V_m, V_a, c)
    hist0 = jnp.full((settings.max_iter_h,), jnp.nan, settings.real_dtype)
    traj0 = None
    if record_trajectory:
        traj0 = jnp.full((settings.max_iter_h + 1, 2, H, n), jnp.nan,
                         settings.real_dtype)
        traj0 = traj0.at[0].set(jnp.stack([V_m, V_a]))

    def cond(state: HPFState):
        return (state.err > thresh_eff) & \
            (state.n_iter < settings.max_iter_h)

    if settings.solver == "arrow":
        from .arrow import arrow_solve, build_arrow_pieces, make_arrow_index
        arrow_idx = make_arrow_index(H, n, m, c)

    def _newton_step(V_m, V_a, f):
        if settings.solver == "arrow":
            pieces = build_arrow_pieces(V_m, V_a, Y, devices, arrow_idx)
            return arrow_solve(pieces, f, arrow_idx)
        J = build_harmonic_jacobian(V_m, V_a, Y, devices, m, n, c)
        return nr_solve(J, f)

    def body(state: HPFState) -> HPFState:
        x = state.x - _newton_step(state.V_m, state.V_a, state.f)
        V_m, V_a = update_harmonic_voltages(state.V_m, state.V_a, x, H, n, c)
        V_m, V_a = _vc(V_m, V_a)
        f, err = harmonic_mismatch(V_m, V_a, Y, S, devices, m, n, c, lineY,
                                   I_bg=I_bg)
        hist = state.err_hist.at[state.n_iter].set(err)
        traj = state.traj
        if traj is not None:
            traj = traj.at[state.n_iter + 1].set(jnp.stack([V_m, V_a]))
        return HPFState(V_m, V_a, x, f, err, state.n_iter + 1, hist, traj)

    final = lax.while_loop(
        cond, body,
        HPFState(V_m, V_a, x0, f0, err0, jnp.int32(0), hist0, traj0))

    V_m, V_a = cleanup_voltages(final.V_m, final.V_a)
    return HPFResult(V_m, V_a, final.err, final.n_iter, final.err_hist,
                     final.err <= thresh_eff, fund, final.traj)


def hpf(net: Network, devices: DeviceSet, settings: Settings,
        Y: Optional[Cx] = None, V0=None,
        record_trajectory: bool = False,
        I_bg: Optional[Cx] = None,
        Y_diag: Optional[Cx] = None) -> HPFResult:
    """Full harmonic power flow (hcne_generalized.py:511-560): Ybus assembly
    -> fundamental NR warm start -> harmonic NR.  Jit this (settings and the
    network's structural metadata are static).  ``V0`` resumes from a
    previous harmonic solution (see hpfx.checkpoint).

    When ``Y`` is overridden with a dense ``Cx`` the stable mismatch is
    disabled (the line structure belongs to the network Y was NOT built
    from); a ``(Y, lineY, lineY_f)`` triple — the contract of
    :func:`hpfx.sequence.sequence_structures` — carries its own
    consistent structures and keeps it.

    ``I_bg``: optional background-distortion injections (hpfx.background).

    ``Y_diag``: optional per-bus shunt admittances (H, n) folded into the
    built Ybus diagonal AND the stable-mismatch line structure's diagonal
    term — frequency-dependent linear-load damping models
    (hpfx.loadmodel) ride this without giving up the cancellation-free
    residual.  Ignored when ``Y`` is overridden (fold it yourself via
    :func:`hpfx.ybus.fold_ydiag`)."""
    if Y is None:
        Y = build_ybus(net, settings)
        lineY, lineY_f = line_ybus_pair(net, settings)
        if Y_diag is not None:
            from .ybus import fold_ydiag
            Y = fold_ydiag(Y, Y_diag)
            if lineY is not None:
                lineY = lineY._replace(d=lineY.d + Y_diag)
                lineY_f = lineY_f._replace(d=lineY_f.d + Y_diag[:1])
    else:
        # dense Cx → no line structure; (Y, lineY, lineY_f) triple
        # (hpfx.sequence.sequence_structures) → consistent structures
        from .ybus import resolve_ybus
        Y, lineY, lineY_f = resolve_ybus(net, settings, Y)
    fund = solve_fundamental(Y[0], net, settings, lineY=lineY_f)
    return solve_harmonic(Y, fund, net, devices, settings, V0=V0,
                          record_trajectory=record_trajectory, lineY=lineY,
                          I_bg=I_bg)
