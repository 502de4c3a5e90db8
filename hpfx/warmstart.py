"""Exact-linear Norton warm starts for the coupled harmonic sweep.

Given the fundamental power-flow solution, the harmonic current balance
(hcne_generalized.py:326-357) is LINEAR in the harmonic voltages in
rectangular (split-complex) coordinates: the network side is
``Y_h·V_h`` and every Norton device's injection ``I_N − Y_N·V`` is
affine in V — including the cross-harmonic coupling of the HCNE model.
The reference's flat 0.1∠0 start (hcne_generalized.py:174-184)
therefore discards an exactly-solvable subproblem.  Solving the
(H−1)·n coupled block system once per scenario seeds Newton at the
true harmonic solution *given the fundamental*, and NR only has to
polish the harmonic→fundamental feedback (the fundamental rows are the
only nonlinear ones the seed leaves unsatisfied).

This is the coupled generalization of
:func:`hpfx.converters.converter_warm_start` (exact for Y_N = 0, where
NR collapses to ~2 trips); here the seed is exact for the harmonic
rows of ANY DeviceSet, coupled or uncoupled, and the measured effect
on the adaptive sweep is a lower max-trip count across the batch.

The block system, with ``E`` the nl-bus scatter (bus m+d ← device d)
and harmonic indices h,p ≥ 1 (0 = fundamental):

    Σ_p [δ_hp·Y_h − E·diag_d(Y_N[d,h,p])·Eᵀ] V_p
        = −E·I_N[:,h] + E·(Y_N[:,h,0] ⊙ V₁,nl) − I_bg[h]

One dense split-complex factorization of dimension (H−1)·n per
scenario (Y_N scales with the scenario's injection level, so the
matrix is per-scenario); at the bench shapes this costs about one NR
trip's linear algebra and saves several.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from . import cx
from .config import Settings
from .cx import Cx
from .devices import DeviceSet
from .fundamental import solve_fundamental
from .network import Network
from .utils.precision import highest_precision
from .ybus import resolve_ybus

__all__ = ["harmonic_linear_seed", "norton_warm_start"]


def _floor_seed_mag(V_m_h, settings: Settings):
    """Floor seeded harmonic magnitudes away from the polar singularity.

    A harmonic order with no source (e.g. triplen rows of a spectrum
    with zeros) has the exact linear solution V_h = 0 — a polar-singular
    NR start: the angle-Jacobian column scales with V_m and vanishes,
    risking inf/NaN steps (CLAUDE.md #12/#17).  Only rows that solved to
    ~exact fp zero are lifted (a zero RHS block solves to exactly 0);
    legitimately-small sourced magnitudes are untouched, so the seed
    stays exact on every sourced row (test_seed_zeroes_harmonic_rows).
    """
    eps = jnp.asarray(1e-2 * settings.v_init_h, V_m_h.dtype)
    return jnp.where(V_m_h < 1e-20, eps, V_m_h)


def harmonic_linear_seed(Y: Cx, net: Network, settings: Settings,
                         devices: DeviceSet, V1: Cx,
                         I_bg: Cx | None = None) -> Cx:
    """Solve the coupled-linear harmonic subsystem for one scenario.

    ``Y``: (H, n, n) admittance tensor; ``V1``: (n,) fundamental
    voltage phasors (the solved fundamental PF); ``devices``: the
    already-scenario-scaled DeviceSet.  Returns the (H−1, n) harmonic
    voltages that zero the harmonic current-balance rows exactly (in
    exact arithmetic) at this fundamental.
    """
    H, n, m = settings.n_harmonics, net.n, net.m
    K = H - 1
    rd = settings.real_dtype
    eyeK = jnp.eye(K, dtype=rd)
    eyeN = jnp.eye(n, dtype=rd)

    # network block diagonal: δ_hp·Y_h → (h, i, p, j)
    def blockdiag(Yh):
        return eyeK[:, None, :, None] * Yh[:, :, None, :]

    # device coupling folded onto the bus diagonal: D[h, p, i] holds
    # Y_N[i−m, h+1, p+1] on nonlinear buses, 0 elsewhere
    def coupling(YN):
        if devices.coupled:
            C = jnp.moveaxis(YN[:, 1:, 1:], 0, -1)      # (K, K, n_nl)
            D = jnp.zeros((K, K, n), rd).at[:, :, m:].set(C)
        else:
            i = jnp.arange(K)
            D = jnp.zeros((K, K, n), rd).at[i, i, m:].set(YN[:, 1:].T)
        # term[h, i, p, j] = δ_ij · D[h, p, i]
        return jnp.moveaxis(D, 2, 1)[:, :, :, None] * eyeN[None, :, None, :]

    A_re = blockdiag(Y.re[1:]) - coupling(devices.Y_N.re)
    A_im = blockdiag(Y.im[1:]) - coupling(devices.Y_N.im)
    A = Cx(A_re.reshape(K * n, K * n), A_im.reshape(K * n, K * n))

    rhs = cx.zeros((K, n), rd)
    nl = (slice(None), slice(m, None))
    rhs = rhs.at_add(nl, -(devices.I_N[:, 1:].T))
    if devices.coupled:
        # the p = 0 (fundamental) coupling column moves to the RHS
        fold = devices.Y_N[:, 1:, 0] * V1[m:, None]      # (n_nl, K)
        rhs = rhs.at_add(nl, fold.T)
    if I_bg is not None:
        rhs = rhs - I_bg[1:]
    return cx.solve(A, rhs.reshape(K * n)).reshape(K, n)


@partial(jax.jit, static_argnames=("settings",))
@highest_precision
def norton_warm_start(net: Network, devices: DeviceSet, settings: Settings,
                      scenarios, Y=None, I_bg: Cx | None = None):
    """Batched exact-linear harmonic seed — pass as ``V0`` to
    :func:`hpfx.solve.hpf_sweep` / ``hpf_sweep_adaptive`` /
    ``hpf_sweep_device``.

    Runs the batched fundamental PF (identical scaling to the sweep's
    own, solve.py `_solve_scenario`), then one coupled-linear harmonic
    solve per scenario.  Returns ``(V_m, V_a)`` of shape (B, H, n).
    ``scenarios``: :class:`hpfx.solve.Scenarios` (device_mix not
    supported — the per-bus blend changes Y_N per scenario in a way the
    caller should pre-mix).  For analytic constant-current devices use
    :func:`hpfx.converters.converter_warm_start` instead.
    """
    if not isinstance(devices, DeviceSet):
        raise TypeError(
            "norton_warm_start expects a DeviceSet; for analytic "
            "constant-current devices use converters.converter_warm_start")
    if getattr(scenarios, "device_mix", None) is not None:
        raise ValueError("norton_warm_start does not support device_mix "
                         "scenarios — pre-mix the DeviceLibrary instead")
    Yd, _, lineY_f = resolve_ybus(net, settings, Y)

    q = scenarios.q_scale if scenarios.q_scale is not None \
        else scenarios.p_scale
    inj = scenarios.injection_scale if scenarios.injection_scale is not None \
        else jnp.ones((scenarios.batch,), scenarios.p_scale.dtype)

    def _expand(scale, like):
        s = jnp.asarray(scale, like.dtype)
        return s if s.ndim else s[None]

    def one(p_s, q_s, i_s):
        net_s = dataclasses.replace(
            net,
            bus_P=net.bus_P * _expand(p_s, net.bus_P),
            bus_Q=net.bus_Q * _expand(q_s, net.bus_Q))
        fund = solve_fundamental(Yd[0], net_s, settings, lineY=lineY_f)
        dev_s = devices.scale(i_s)
        V1 = cx.polar(fund.V_m, fund.V_a)
        Vh = harmonic_linear_seed(Yd, net, settings, dev_s, V1, I_bg=I_bg)
        V_m = jnp.concatenate([fund.V_m[None],
                               _floor_seed_mag(Vh.abs(), settings)])
        V_a = jnp.concatenate([fund.V_a[None], Vh.angle()])
        return V_m, V_a

    # chunk the vmap when the per-scenario (K·n)² block matrices would
    # blow past ~2 GiB at once (net1 h51 B=2048 is ~8 GB unchunked);
    # no-op at the bench shapes
    B = scenarios.p_scale.shape[0]
    Kn = (settings.n_harmonics - 1) * net.n
    per = 8 * Kn * Kn * jnp.dtype(settings.real_dtype).itemsize
    from .lanes import SEED_CHUNK_BYTES
    bs = int(max(1, min(B, SEED_CHUNK_BYTES // per)))
    if bs >= B:
        return jax.vmap(one)(scenarios.p_scale, q, inj)
    return jax.lax.map(lambda t: one(*t), (scenarios.p_scale, q, inj),
                       batch_size=bs)
