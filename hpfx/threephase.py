"""Unbalanced three-phase harmonic penetration.

The solver (like the reference, hcne_generalized.py's single-phase
equivalent) and the sequence-aware layer (:mod:`hpfx.sequence`) both
assume BALANCED operation, where each harmonic order lives in exactly
one symmetrical-component network (the h-mod-3 rule).  Real feeders are
not balanced: single-phase chargers cluster on one phase, delta/wye
device mixes differ per phase, and an unbalanced injection excites ALL
THREE sequence networks at once — triplen currents appear in phases at
orders the balanced theory says cancel, and characteristic harmonics
acquire zero-sequence components that flow in neutrals.

This module solves that propagation problem in the phase (abc) frame:

- **abc admittance assembly** (:func:`abc_admittance`): for a network
  whose every element is described by its sequence admittances (the
  standard balanced-construction assumption), the 3n×3n phase-frame
  nodal matrix follows from the Fortescue projection identity

      Y_abc = Y1 ⊗ (I − M0) + Y0 ⊗ M0,      M0 = ones(3,3)/3,

  where ``Y1``/``Y0`` are the positive/zero-sequence n×n matrices the
  library already assembles (:func:`hpfx.ybus.build_ybus`,
  :func:`hpfx.sequence.zero_sequence_network`) — including transformer
  taps/shifts, zero-sequence blocking of delta windings (``blocked``)
  and grounded-neutral paths (``bus_Xg``).  (M_s = A e_s e_sᵀ A⁻¹ are
  the per-sequence projectors; with Y2 = Y1 — true for static
  equipment — their sum telescopes to the identity above, so the kron
  needs only the REAL matrix M0.)
- **per-phase device injections** (:func:`phase_injections`): each
  Norton device's spectrum is expanded to its three phase conductors
  with the balanced rotation ``e^{∓j·h·2π/3}`` per order, then made
  unbalanced by per-device-phase magnitude/angle factors; delta /
  3-wire devices get their zero-sequence component projected out
  (``I − M0`` — no neutral path to inject it).
- **linear penetration solve** (:func:`solve_unbalanced`): per order,
  ``(Y_abc − Y_N,abc)·V = −I_N,abc`` with the slack's three phase
  nodes grounded (the stiff-grid short of
  :func:`hpfx.impedance.impedance_scan`) — one H-batched split-complex
  block solve.  For the uncoupled device model this is EXACT (the
  harmonic balance is linear in the injections); for coupled NEs the
  h-diagonal first-order picture applies, as in the impedance layer.

Identities gated in tests/test_threephase.py: a balanced case on a
balanced network reproduces :func:`hpfx.hpf`'s harmonic voltages phase
by phase (rotations per :func:`hpfx.sequence.balanced_phases`); with a
distinct zero-sequence network and balanced injections it reproduces
:func:`hpfx.sequence.hpf_sequence`'s h-mod-3 physics (triplens on the
zero-sequence network) exactly; random unbalanced cases match an
independent numpy complex assembly+solve.

Everything is split-complex, statically shaped and jittable; the
per-order solves batch over H.
"""
from typing import NamedTuple, Optional, Mapping, Sequence, Tuple

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import cx
from .config import Settings
from .cx import Cx
from .devices import DeviceSet
from .network import Network
from .sequence import (_dense_from_line, _grounding_diag,
                       zero_sequence_network)
from .ybus import LineYbus, build_line_ybus, build_ybus

__all__ = ["abc_admittance", "phase_injections", "solve_unbalanced",
           "sequence_voltages", "unbalance_factors", "allocation_study",
           "line_phase_flows", "ThreePhaseResult", "AllocationStudy",
           "PhaseFlows"]

#: real zero-sequence projector M0 = A e0 e0^T A^{-1} = ones/3
_M0 = np.full((3, 3), 1.0 / 3.0)


def _zero_sequence_dense(net: Network, settings: Settings, net0, *,
                         blocked: Sequence[int],
                         bus_Xg: Optional[Mapping[int, float]],
                         **zero_kw) -> Cx:
    """Dense (H, n, n) ZERO-sequence admittance at every order — the
    all-orders generalization of the triplen-row blend in
    :func:`hpfx.sequence.sequence_structures` (an unbalanced injection
    excites the zero-sequence network at ANY order, not just triplens).
    """
    if net0 is None:
        net0 = zero_sequence_network(net, **zero_kw)
    elif zero_kw:
        raise ValueError("pass either net0 or zero-sequence parameters")
    if jnp.shape(net0.line_tau) != jnp.shape(net.line_tau):
        raise ValueError("net0 must share net's line topology")
    keep = np.ones(net.n_lines)
    for k in blocked:
        keep[int(k)] = 0.0
    keep_j = jnp.asarray(keep, settings.real_dtype)
    net0 = dataclasses.replace(net0, line_G=net0.line_G * keep_j,
                               line_B=net0.line_B * keep_j)
    lineY0 = build_line_ybus(net0, settings)
    d0 = lineY0.d
    g = _grounding_diag(settings, bus_Xg, net.n)
    if g is not None:
        d0 = d0 + g
    masked = LineYbus(Ys=lineY0.Ys * keep_j, a_ff=lineY0.a_ff,
                      inv_tau=lineY0.inv_tau, shift=lineY0.shift, d=d0,
                      f_idx=lineY0.f_idx, t_idx=lineY0.t_idx)
    return _dense_from_line(masked, net.n)


def _kron3(Y: Cx, M: np.ndarray) -> Cx:
    """(H, n, n) ⊗ (3, 3 real) -> (H, 3n, 3n), phase-within-bus node
    ordering (bus k's phases occupy rows 3k..3k+2)."""
    H, n = Y.shape[0], Y.shape[1]
    M = jnp.asarray(M, Y.re.dtype)
    k = lambda a: jnp.einsum("hjk,pq->hjpkq", a, M).reshape(H, 3 * n, 3 * n)
    return Cx(k(Y.re), k(Y.im))


def abc_admittance(net: Network, settings: Settings, net0=None, *,
                   blocked: Sequence[int] = (),
                   bus_Xg: Optional[Mapping[int, float]] = None,
                   **zero_kw) -> Cx:
    """Phase-frame nodal admittance, (H, 3n, 3n) split-complex.

    ``Y_abc = Y1 ⊗ (I − M0) + Y0 ⊗ M0`` with ``Y1`` the network's own
    per-order assembly (:func:`hpfx.ybus.build_ybus` — taps and phase
    shifts included) and ``Y0`` the zero-sequence companion
    (``net0`` or :func:`hpfx.sequence.zero_sequence_network` built from
    ``zero_kw``; ``blocked`` lines lose series AND pi shunt — the delta
    winding; ``bus_Xg`` adds grounded-neutral shunt paths).  With
    ``net0 = net`` and no blocking/grounding, ``Y0 = Y1`` and the kron
    collapses to the balanced replication ``Y1 ⊗ I`` — the decoupled-
    phases sanity case.
    """
    Y1 = build_ybus(net, settings)
    Y0 = _zero_sequence_dense(net, settings, net0, blocked=blocked,
                              bus_Xg=bus_Xg, **zero_kw)
    eye_m0 = np.eye(3) - _M0
    return _kron3(Y1, eye_m0) + _kron3(Y0, _M0)


def phase_injections(devices: DeviceSet, settings: Settings, *,
                     delta: Sequence[int] = (),
                     mag=None, ang=None) -> Cx:
    """Per-phase Norton current spectra, (H, n_nl, 3) split-complex.

    Phase a carries the device's tabulated ``I_N`` as-is; phases b/c are
    rotated by ``∓ h·120°`` per order (the waveform-level balanced law,
    :func:`hpfx.sequence.balanced_phases`).  ``mag``/``ang`` make it
    unbalanced: (n_nl, 3) (or broadcastable) per-device-phase magnitude
    factors and angle offsets [rad], applied uniformly over orders — the
    per-phase loading model (a phase at 1.2x rating injects 1.2x its
    spectrum).  Devices listed in ``delta`` are 3-wire: their
    zero-sequence component is projected out per order (``I − M0``),
    since a delta/ungrounded device has no path to inject it.
    """
    rd = settings.real_dtype
    h = jnp.asarray(settings.harmonics, rd)[:, None]             # (H, 1)
    n_nl = devices.n_devices
    rot = (2.0 * jnp.pi / 3.0) * h                               # (H, 1)
    # (H, n_nl, 3) balanced phase rotations e^{-j·h·rot·[0,1,2]}
    phase_ang = -rot[..., None] * jnp.asarray([0.0, 1.0, 2.0], rd)
    base = cx.expj(phase_ang)                                    # (H, 1, 3)
    I = Cx(devices.I_N.re.T[:, :, None], devices.I_N.im.T[:, :, None])
    I = I * base                                                 # (H,n_nl,3)
    if mag is not None:
        I = I * jnp.broadcast_to(jnp.asarray(mag, rd), (n_nl, 3))[None]
    if ang is not None:
        I = I * cx.expj(jnp.broadcast_to(jnp.asarray(ang, rd),
                                         (n_nl, 3))[None])
    if delta:
        dmask = np.zeros(n_nl)
        for k in delta:
            dmask[int(k)] = 1.0
        dm = jnp.asarray(dmask, rd)[None, :, None]
        # zero-sequence removal: I <- I - mean_over_phases(I) per device
        mean = Cx(jnp.mean(I.re, axis=-1, keepdims=True),
                  jnp.mean(I.im, axis=-1, keepdims=True))
        I = Cx(I.re - dm * mean.re, I.im - dm * mean.im)
    return I


def _norton_phase_diag(devices: DeviceSet) -> Cx:
    """Per-device per-order Norton admittance, (n_nl, H) — the h-diagonal
    for coupled NEs (cross-order terms cannot enter a per-order solve;
    same first-order picture as hpfx.impedance._norton_diag)."""
    yn = devices.Y_N
    if devices.coupled:
        yn = Cx(jnp.diagonal(yn.re, axis1=-2, axis2=-1),
                jnp.diagonal(yn.im, axis1=-2, axis2=-1))
    return yn


class ThreePhaseResult(NamedTuple):
    """Solved phase-frame harmonic voltages.

    ``V``: (H, n, 3) split-complex phase voltages (slack rows zero — its
    phases are grounded for harmonics).  ``I``: the (H, n_nl, 3)
    injections used.  ``orders``: (H,) the solved harmonic orders.
    """
    V: Cx
    I: Cx
    orders: jnp.ndarray


def solve_unbalanced(net: Network, devices: DeviceSet,
                     settings: Settings, *, net0=None,
                     blocked: Sequence[int] = (),
                     bus_Xg: Optional[Mapping[int, float]] = None,
                     delta: Sequence[int] = (),
                     mag=None, ang=None, I_abc: Optional[Cx] = None,
                     Yabc: Optional[Cx] = None,
                     ground_slack: bool = True,
                     **zero_kw) -> ThreePhaseResult:
    """Unbalanced three-phase harmonic penetration solve.

    Assembles ``Y_abc`` (see :func:`abc_admittance`; ``zero_kw``
    forwards to :func:`hpfx.sequence.zero_sequence_network`), folds
    each device's Norton admittance into its bus's 3×3 phase block
    (wye devices as ``y·I``; ``delta`` devices as ``y·(I − M0)`` — no
    zero-sequence response), and solves
    ``(Y_abc − Y_N,abc)·V(h) = −I(h)`` for every order in one H-batched
    block solve.  ``I_abc`` overrides the injections
    (:func:`phase_injections` is the default, with ``mag``/``ang``/
    ``delta`` forwarded); ``Yabc`` overrides the assembly (e.g. with a
    filter installed via :func:`hpfx.install_shunt` on the 3n frame).

    ``ground_slack`` (default) treats the slack's three phase nodes as
    an ideal (stiff, balanced) source — shorts for harmonic currents,
    the :func:`hpfx.impedance.impedance_scan` convention.  With
    ``ground_slack=False`` the raw balance is solved instead, which is
    the solver's own convention — for uncoupled NEs on a balanced
    network the result reproduces :func:`hpfx.hpf`'s harmonic voltages
    EXACTLY, phase by phase (gated in tests); only valid on harmonic
    rows tied to ground (bus ``X_sh`` shunts exist only for h != 1, so
    an h=1 row is singular there and its result must be ignored — the
    fundamental is a power-flow problem, not a linear one).

    Sign convention: the solver's harmonic fixed point satisfies
    ``(Y − Y_N)·V(h) = −I_N(h)`` (hcne_generalized.py:313-357, see
    hpfx.impedance.impedance_scan); this is its phase-frame
    generalization, exact for uncoupled NEs and first-order
    (h-diagonal) for coupled ones.
    """
    if Yabc is None:
        Yabc = abc_admittance(net, settings, net0, blocked=blocked,
                              bus_Xg=bus_Xg, **zero_kw)
    elif net0 is not None or zero_kw:
        raise ValueError("pass either Yabc or assembly parameters")
    rd = settings.real_dtype
    H = len(settings.harmonics)
    n, n_nl = net.n, devices.n_devices
    if I_abc is None:
        I_abc = phase_injections(devices, settings, delta=delta,
                                 mag=mag, ang=ang)
    # fold Norton admittances: wye -> y per phase diagonal; delta ->
    # y·(I − M0) 3x3 block (no zero-sequence response)
    yn = _norton_phase_diag(devices)                          # (n_nl, H)
    dmask = np.zeros(n_nl)
    for k in delta:
        dmask[int(k)] = 1.0
    wye = jnp.asarray(1.0 - dmask, rd)
    dlt = jnp.asarray(dmask, rd)
    buses = np.asarray(net.m + np.arange(n_nl))
    # 3x3 per-device block: wye·y·I + delta·y·(I − M0)
    eye3 = jnp.asarray(np.eye(3), rd)
    proj = jnp.asarray(np.eye(3) - _M0, rd)
    blk = (wye[:, None, None] * eye3 + dlt[:, None, None] * proj)
    yn_blk_re = -yn.re.T[:, :, None, None] * blk              # (H,n_nl,3,3)
    yn_blk_im = -yn.im.T[:, :, None, None] * blk
    Y = Yabc.reshape(H, n, 3, n, 3)
    Yre = Y.re.at[:, buses, :, buses, :].add(
        jnp.moveaxis(yn_blk_re, 1, 0))
    Yim = Y.im.at[:, buses, :, buses, :].add(
        jnp.moveaxis(yn_blk_im, 1, 0))
    Yf = Cx(Yre, Yim).reshape(H, 3 * n, 3 * n)
    rhs = cx.zeros((H, n, 3), rd)
    rhs = rhs.at_add((slice(None), buses, slice(None)), -I_abc)
    b = rhs.reshape(H, 3 * n)
    if ground_slack:
        # slack's three phase nodes are shorts for harmonics: reduce,
        # solve, re-embed zeros
        Vr = cx.solve(Yf[:, 3:, 3:], b[:, 3:])
        V = cx.zeros((H, 3 * n), rd)
        V = V.at_set((slice(None), slice(3, None)), Vr)
    else:
        V = cx.solve(Yf, b)
    return ThreePhaseResult(V=V.reshape(H, n, 3), I=I_abc,
                            orders=jnp.asarray(settings.harmonics, rd))


def sequence_voltages(res: ThreePhaseResult) -> Tuple[Cx, Cx, Cx]:
    """Fortescue components (V0, V1, V2), each (H, n), of a solved
    phase-frame result (:func:`hpfx.sequence.sequence_components`
    applied per bus/order)."""
    from .sequence import sequence_components
    va = res.V[:, :, 0]
    vb = res.V[:, :, 1]
    vc = res.V[:, :, 2]
    seq = sequence_components(va, vb, vc)
    return seq.zero, seq.positive, seq.negative


def unbalance_factors(res: ThreePhaseResult, eps: float = 1e-30,
                      harmonics: Optional[Sequence[float]] = None
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-order, per-bus sequence-leakage fractions of the harmonic
    voltages.

    Classifies each order by its balanced sequence (h mod 3) and
    returns the two FOREIGN-sequence magnitude fractions, normalized by
    the total ``sqrt(|V0|² + |V1|² + |V2|²)`` (bounded in [0, 1] and
    well-defined even when an order's own class carries no voltage —
    e.g. triplens with every zero-sequence source delta-blocked).  The
    first output is the class-following neighbor (cls+1 mod 3), the
    second the other (cls+2 mod 3); both are identically zero for a
    balanced case, and quantify how much of each order leaked out of
    its classical sequence network.  Buses with no voltage at an order
    report 0.

    ``harmonics``: pass ``settings.harmonics`` when calling under jit /
    vmap (the order classification is static; ``res.orders`` is a
    tracer there).
    """
    v0, v1, v2 = sequence_voltages(res)
    m2 = jnp.stack([v0.abs2(), v1.abs2(), v2.abs2()])      # (3, H, n)
    hs = (np.asarray(res.orders) if harmonics is None
          else np.asarray(harmonics, float))
    cls = np.asarray([int(h) % 3 for h in hs])
    rows = np.arange(len(cls))
    total = jnp.sqrt(jnp.maximum(jnp.sum(m2, axis=0), eps))
    a = jnp.sqrt(m2[(cls + 1) % 3, rows])
    b = jnp.sqrt(m2[(cls + 2) % 3, rows])
    nz = jnp.sum(m2, axis=0) > eps
    return jnp.where(nz, a / total, 0.0), jnp.where(nz, b / total, 0.0)


class AllocationStudy(NamedTuple):
    """Monte-Carlo phase-allocation result (:func:`allocation_study`).

    ``q``: (Q,) the requested quantiles.  ``u0_q``/``u2_q``: (Q, H, n)
    quantiles of the two foreign-sequence leakage fractions over draws.
    ``vmag_q``: (Q, H, n) quantiles of the worst PHASE voltage magnitude
    per bus/order (the quantity a per-phase limit applies to).
    ``orders``: (H,).
    """
    q: jnp.ndarray
    u0_q: jnp.ndarray
    u2_q: jnp.ndarray
    vmag_q: jnp.ndarray
    orders: jnp.ndarray


def allocation_study(net: Network, devices: DeviceSet,
                     settings: Settings, *, n_draws: int = 256,
                     sigma_mag: float = 0.2, sigma_ang: float = 0.1,
                     seed: int = 0, q: Sequence[float] = (0.5, 0.95),
                     net0=None, blocked: Sequence[int] = (),
                     bus_Xg: Optional[Mapping[int, float]] = None,
                     delta: Sequence[int] = (),
                     **zero_kw) -> AllocationStudy:
    """Monte-Carlo study of random per-phase device allocation.

    Planning rarely knows which phase each single-phase converter lands
    on; this draws ``n_draws`` random per-device-phase loading patterns
    (lognormal magnitude factors with spread ``sigma_mag``, normal angle
    offsets with ``sigma_ang`` rad — mean-1 / mean-0, so the balanced
    case is the ensemble center), solves every draw as one vmapped
    batched program, and reduces to quantiles of the sequence-leakage
    fractions and of the worst per-phase voltage magnitude.  The 95th
    percentile row is the IEC-style assessment quantity
    (cf. :func:`hpfx.studies.assess_quantiles` for the balanced axes).

    The admittance is assembled ONCE (it does not depend on the draws);
    only the injection expansion and the H-batched solves vmap over
    draws.
    """
    rng = np.random.default_rng(seed)
    rd = settings.real_dtype
    n_nl = devices.n_devices
    mag = jnp.asarray(rng.lognormal(
        -0.5 * sigma_mag ** 2, sigma_mag, (n_draws, n_nl, 3)), rd)
    ang = jnp.asarray(rng.normal(0.0, sigma_ang, (n_draws, n_nl, 3)), rd)
    Yabc = abc_admittance(net, settings, net0, blocked=blocked,
                          bus_Xg=bus_Xg, **zero_kw)

    def one(m, a):
        res = solve_unbalanced(net, devices, settings, Yabc=Yabc,
                               delta=delta, mag=m, ang=a)
        u0, u2 = unbalance_factors(res, harmonics=settings.harmonics)
        vmag = jnp.max(res.V.abs(), axis=-1)          # worst phase, (H, n)
        return u0, u2, vmag

    u0, u2, vmag = jax.jit(jax.vmap(one))(mag, ang)
    qs = jnp.asarray(q, rd)
    return AllocationStudy(
        q=qs,
        u0_q=jnp.quantile(u0, qs, axis=0),
        u2_q=jnp.quantile(u2, qs, axis=0),
        vmag_q=jnp.quantile(vmag, qs, axis=0),
        orders=jnp.asarray(settings.harmonics, rd))


class PhaseFlows(NamedTuple):
    """Per-line, per-phase branch currents of a solved abc case.

    ``I_f``/``I_t``: (H, L, 3) split-complex terminal currents (into the
    line at each end, same orientation as :func:`hpfx.flows.line_flows`).
    ``residual_f``: (H, L) magnitude of the from-end residual current
    ``|I_a + I_b + I_c| = 3·|I0|`` — the current the neutral/earth
    return of that line carries (the neutral-sizing quantity per line).
    ``residual_rms``: (L,) its RMS aggregate over the solved orders.
    """
    I_f: Cx
    I_t: Cx
    residual_f: jnp.ndarray
    residual_rms: jnp.ndarray


def _blend_apply(y1: Cx, y0: Cx, v: Cx) -> Cx:
    """Apply the per-line sequence blend ``y1·(I − M0) + y0·M0`` to a
    (H, L, 3) phase vector: ``(I − M0)v`` is the phase deviation from
    the line's phase mean, ``M0 v`` the mean itself."""
    mean = Cx(jnp.mean(v.re, axis=-1, keepdims=True),
              jnp.mean(v.im, axis=-1, keepdims=True))
    dev_ = Cx(v.re - mean.re, v.im - mean.im)
    y1e = Cx(y1.re[..., None], y1.im[..., None])
    y0e = Cx(y0.re[..., None], y0.im[..., None])
    return y1e * dev_ + y0e * mean


def _series_shunt(net: Network, settings: Settings):
    """Per-line series admittance Ys(h) and pi-shunt Ysh(h), (H, L) —
    the same per-element algebra flows.py:72-82 reconstructs."""
    rd = settings.real_dtype
    h = jnp.asarray(settings.harmonics, dtype=rd)[:, None]
    R, X = net.line_R, net.line_X
    Xh = X * h
    d = R * R + Xh * Xh
    Ys = Cx(R / d, -Xh / d)
    Ysh = Cx(jnp.broadcast_to(net.line_G / 2.0, Xh.shape),
             h * net.line_B / 2.0)
    return Ys, Ysh


def line_phase_flows(net: Network, settings: Settings,
                     res: ThreePhaseResult, net0=None, *,
                     blocked: Sequence[int] = (),
                     **zero_kw) -> PhaseFlows:
    """Per-phase branch currents and neutral (residual) flows.

    Reconstructs each line's terminal currents with the per-element
    series/tap/pi-shunt algebra of :func:`hpfx.flows.line_flows`, each
    coefficient blended between its positive- and zero-sequence values
    per the same Fortescue projection the assembly used — pass the SAME
    ``net0``/``blocked``/``zero_kw`` as the solve.  A ``blocked`` line
    carries no zero-sequence (residual) current by construction.
    """
    if net0 is None:
        net0 = zero_sequence_network(net, **zero_kw)
    elif zero_kw:
        raise ValueError("pass either net0 or zero-sequence parameters")
    rd = settings.real_dtype
    keep = np.ones(net.n_lines)
    for k in blocked:
        keep[int(k)] = 0.0
    keep_j = jnp.asarray(keep, rd)
    net0 = dataclasses.replace(net0, line_G=net0.line_G * keep_j,
                               line_B=net0.line_B * keep_j)
    Ys1, Ysh1 = _series_shunt(net, settings)
    Ys0, Ysh0 = _series_shunt(net0, settings)
    Ys0 = Ys0 * keep_j

    tau = net.line_tau
    inv_t_ft = cx.expj(net.line_shift) * (1.0 / tau)
    inv_t_tf = cx.expj(-net.line_shift) * (1.0 / tau)
    a_ff = 1.0 / (tau * tau)

    f, t = net.line_from, net.line_to
    V_f = res.V[:, f, :]                                     # (H, L, 3)
    V_t = res.V[:, t, :]

    c1_ff = (Ys1 + Ysh1) * a_ff
    c0_ff = (Ys0 + Ysh0) * a_ff
    d1_ft = Ys1 * inv_t_ft
    d0_ft = Ys0 * inv_t_ft
    I_f = _blend_apply(c1_ff, c0_ff, V_f) - _blend_apply(d1_ft, d0_ft, V_t)
    c1_tt = Ys1 + Ysh1
    c0_tt = Ys0 + Ysh0
    d1_tf = Ys1 * inv_t_tf
    d0_tf = Ys0 * inv_t_tf
    I_t = _blend_apply(c1_tt, c0_tt, V_t) - _blend_apply(d1_tf, d0_tf, V_f)

    resid = Cx(jnp.sum(I_f.re, axis=-1), jnp.sum(I_f.im, axis=-1))
    rmag = resid.abs()
    return PhaseFlows(I_f=I_f, I_t=I_t, residual_f=rmag,
                      residual_rms=jnp.sqrt(jnp.sum(rmag * rmag, axis=0)))
