"""Sequence-domain analysis of balanced-system harmonic spectra.

The solver (like the reference, hcne_generalized.py's single-phase
equivalent) models the balanced positive-sequence network.  Under
balanced conditions each harmonic order still maps to a definite
symmetrical-component sequence — phase b/c waveforms lag/lead by
h·120° — giving the classic classification

    h mod 3 == 1  ->  positive sequence   (1, 7, 13, ...)
    h mod 3 == 2  ->  negative sequence   (5, 11, 17, ...)
    h mod 3 == 0  ->  zero sequence       (3, 9, 15, ... — the triplens)

Three phase-domain consequences matter for equipment even in a balanced
study, and this module computes them as post-processing on solved
spectra:

- **Neutral current** (:func:`neutral_current`): zero-sequence harmonics
  add in the neutral of a 4-wire system instead of cancelling —
  ``I_N(h) = 3·I_phase(h)`` for triplens, 0 otherwise.  The neutral RMS
  of a rectifier-heavy feeder routinely exceeds the phase RMS; this is
  the number that sizes the neutral conductor.
- **Delta-winding blocking** (:func:`delta_blocked`): balanced triplen
  currents circulate inside a delta winding and never reach the far
  side; the transferred spectrum has its zero-sequence orders removed.
- **Fortescue transform** (:func:`sequence_components` /
  :func:`phase_components`): the general (a, b, c) <-> (0, 1, 2) map for
  *measured* unbalanced phasor sets, split-complex like everything else
  in hpfx.

References: Fortescue decomposition and the h-mod-3 rule are textbook
(e.g. Arrillaga & Watson, "Power System Harmonics", ch. 2); the
balanced-spectrum neutral law is IEEE Std 1100 / C57.110 context.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from . import cx
from .cx import Cx

POSITIVE, NEGATIVE, ZERO = 1, 2, 0


def classify_orders(harmonics: Sequence[int]) -> np.ndarray:
    """Per-order sequence class under balanced conditions: ``h % 3``
    with the module constants ``POSITIVE`` (1), ``NEGATIVE`` (2),
    ``ZERO`` (0, the triplens)."""
    return np.asarray([int(h) % 3 for h in harmonics], np.int32)


def triplen_mask(harmonics: Sequence[int]) -> np.ndarray:
    """(H,) bool — True on zero-sequence (triplen) orders."""
    return classify_orders(harmonics) == ZERO


def neutral_current(I_m: jnp.ndarray, harmonics: Sequence[int],
                    axis: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Neutral-conductor harmonic currents of a balanced 4-wire system.

    ``I_m``: per-phase harmonic current magnitudes with the harmonic
    axis at ``axis`` (e.g. a column of :func:`hpfx.flows.line_flows`'
    ``I_f.abs()``).  Returns ``(I_neutral, rms)``: the per-order neutral
    magnitudes (``3·I_h`` on triplens, 0 elsewhere — positive/negative
    sequence sets cancel in the neutral) and their RMS aggregate along
    the harmonic axis.  Compare the RMS against the phase RMS to size
    the neutral.
    """
    mask = jnp.asarray(triplen_mask(harmonics), I_m.dtype)
    shape = [1] * I_m.ndim
    shape[axis] = -1
    i_n = 3.0 * I_m * mask.reshape(shape)
    return i_n, jnp.sqrt(jnp.sum(i_n * i_n, axis=axis))


def delta_blocked(spectrum: jnp.ndarray, harmonics: Sequence[int],
                  axis: int = 0) -> jnp.ndarray:
    """The spectrum transferred through a delta winding: balanced
    zero-sequence (triplen) orders circulate in the delta and are
    removed; positive/negative-sequence orders pass unchanged."""
    keep = jnp.asarray(~triplen_mask(harmonics), spectrum.dtype)
    shape = [1] * spectrum.ndim
    shape[axis] = -1
    return spectrum * keep.reshape(shape)


class SequenceSet(NamedTuple):
    """Symmetrical components of a three-phase phasor set (split-complex,
    same leading shape as the inputs): ``zero``/``positive``/``negative``."""
    zero: Cx
    positive: Cx
    negative: Cx


def _alpha(settings_dtype=None) -> Cx:
    """The Fortescue rotation a = e^{j 2pi/3} as a split-complex scalar."""
    return Cx(jnp.asarray(-0.5), jnp.asarray(np.sqrt(3.0) / 2.0))


def sequence_components(va: Cx, vb: Cx, vc: Cx) -> SequenceSet:
    """Fortescue transform of measured phase phasors:

        V0 = (Va + Vb + Vc) / 3
        V1 = (Va + a·Vb + a²·Vc) / 3
        V2 = (Va + a²·Vb + a·Vc) / 3

    Inputs are split-complex ``Cx`` of any (broadcastable) shape — e.g.
    per-harmonic meter phasors ``(H, n)``.
    """
    a = _alpha()
    a2 = a * a
    third = 1.0 / 3.0
    return SequenceSet(
        zero=(va + vb + vc) * third,
        positive=(va + a * vb + a2 * vc) * third,
        negative=(va + a2 * vb + a * vc) * third)


def phase_components(seq: SequenceSet) -> Tuple[Cx, Cx, Cx]:
    """Inverse Fortescue: phase phasors (Va, Vb, Vc) from a
    :class:`SequenceSet` (exact inverse of
    :func:`sequence_components`)."""
    a = _alpha()
    a2 = a * a
    v0, v1, v2 = seq.zero, seq.positive, seq.negative
    va = v0 + v1 + v2
    vb = v0 + a2 * v1 + a * v2
    vc = v0 + a * v1 + a2 * v2
    return va, vb, vc


def balanced_phases(V_m: jnp.ndarray, V_a: jnp.ndarray,
                    harmonics: Sequence[int]) -> Tuple[Cx, Cx, Cx]:
    """Expand a balanced positive-sequence harmonic solution (the
    solver's (H, ...) magnitudes/angles) into the three phase spectra:
    phase a as solved, phases b/c rotated by ``∓ h·120°`` per order —
    the waveform-level meaning of the h-mod-3 rule (a triplen lands in
    phase on all three phases; a 5th lands in reverse rotation)."""
    h = jnp.asarray(np.asarray(harmonics, float))
    shape = [1] * V_m.ndim
    shape[0] = -1
    rot = (2.0 * jnp.pi / 3.0) * h.reshape(shape)
    va = cx.polar(V_m, V_a)
    vb = cx.polar(V_m, V_a - rot)
    vc = cx.polar(V_m, V_a + rot)
    return va, vb, vc


# ---------------------------------------------------------------------------
# Sequence-aware harmonic networks
#
# The laws above post-process a solution computed on ONE network.  The
# stronger statement of the h-mod-3 rule is that in a balanced system each
# harmonic order propagates through the network of ITS OWN sequence:
# non-triplen orders see the positive/negative-sequence impedances (equal
# for static equipment), while the triplens see the ZERO-sequence network —
# different line impedances (z0 of an overhead line is typically 2-3.5x z1),
# open circuits across delta / ungrounded-wye transformer paths, and shunt
# paths through grounded neutrals.  Standard harmonic-penetration practice
# (Arrillaga & Watson ch. 9) therefore assembles a per-order admittance that
# switches networks by sequence class.  The reference solves every order on
# the one positive-sequence network (hcne_generalized.py:132-171 builds Y(h)
# from a single line table); this section supplies the sequence-aware
# assembly and a solver entry that is bit-compatible with :func:`hpfx.hpf`
# when the two sequence networks coincide.
#
# Everything below is assembly-level: the NR solver, device models and
# mismatch structure are untouched — the blend produces a dense ``Y`` plus
# the matching stable-mismatch ``LineYbus`` structures, exactly the
# contract of :func:`hpfx.ybus.build_ybus` / ``line_ybus_pair``.


def zero_sequence_network(net, *, r0_scale: float = 2.5,
                          x0_scale: float = 3.0,
                          b0_scale: float = 1.0,
                          R0=None, X0=None,
                          ungrounded_shunts: Sequence[int] = ()):
    """The zero-sequence companion of ``net`` (same topology and tap/shift
    arrays — only impedances change).

    ``r0_scale``/``x0_scale`` default to the classic overhead-line rule of
    thumb (z0 ≈ 2.5-3·z1); they are STUDY PARAMETERS, not physics — pass
    explicit per-line ``R0``/``X0`` arrays when the line data carries them.
    ``b0_scale`` scales the pi-model charging susceptance (C0/C1 ≈ 0.6 for
    overhead lines; left at 1 by default).  ``ungrounded_shunts`` lists
    buses whose shunt bank (``X_sh``) is delta-connected or ungrounded-wye
    and therefore provides NO zero-sequence path (its X_sh is dropped from
    the companion network).
    """
    R0 = net.line_R * r0_scale if R0 is None else jnp.asarray(R0)
    X0 = net.line_X * x0_scale if X0 is None else jnp.asarray(X0)
    # static 0/1 mask so the edit stays traceable under jit (bus_Xsh may be
    # a tracer); X_sh == 0 means "no shunt" throughout ybus.py
    keep = np.ones(net.n)
    for b in ungrounded_shunts:
        keep[int(b)] = 0.0
    return dataclasses.replace(
        net, line_R=R0, line_X=X0, line_B=net.line_B * b0_scale,
        bus_Xsh=net.bus_Xsh * keep)


def _grounding_diag(settings, bus_Xg: Optional[Mapping[int, float]],
                    n: int) -> Optional[Cx]:
    """(H, n) zero-sequence grounding shunts: a grounded neutral at bus k
    with total zero-sequence reactance Xg (transformer Xt + 3·Xn) admits
    y0(h) = 1/(j·h·Xg) = -j/(h·Xg) — the same frequency law as the bus
    shunt reactances of hcne_generalized.py:158-159.  Rows for ALL orders;
    the triplen mask in the blend keeps it out of the non-triplen rows."""
    if not bus_Xg:
        return None
    rd = settings.real_dtype
    h = np.asarray(settings.harmonics, float)[:, None]          # (H, 1)
    g = np.zeros((len(settings.harmonics), n))
    b = np.zeros_like(g)
    for bus, xg in bus_Xg.items():
        if xg <= 0.0:
            raise ValueError(f"bus_Xg[{bus}] must be a positive reactance")
        b[:, int(bus)] = (-1.0 / (h * xg))[:, 0]
    return Cx(jnp.asarray(g, rd), jnp.asarray(b, rd))


def _dense_from_line(lineY, n: int) -> Cx:
    """Dense (H, n, n) admittance from a ``LineYbus`` structure — the same
    scatter as ``build_ybus`` (ybus.py:64-92) driven from the un-summed
    ingredients, so the blended dense and line-structured forms describe
    the same system by construction."""
    Ys, f, t = lineY.Ys, lineY.f_idx, lineY.t_idx
    H = Ys.shape[0]
    rd = Ys.re.dtype
    inv_t_ft = cx.expj(lineY.shift) * lineY.inv_tau
    inv_t_tf = cx.expj(-lineY.shift) * lineY.inv_tau
    _all = slice(None)
    Y = cx.zeros((H, n, n), rd)
    Y = Y.at_add((_all, f, t), -(Ys * inv_t_ft))
    Y = Y.at_add((_all, t, f), -(Ys * inv_t_tf))
    Y = Y.at_add((_all, f, f), Ys * lineY.a_ff)
    Y = Y.at_add((_all, t, t), Ys)
    idx = jnp.arange(n)
    return Y.at_add((_all, idx, idx), lineY.d)


def sequence_structures(net, settings, net0=None, *,
                        blocked: Sequence[int] = (),
                        bus_Xg: Optional[Mapping[int, float]] = None,
                        Y_diag: Optional[Cx] = None, **zero_kw):
    """Per-order blended admittance structures: ``(Y, lineY, lineY_f)``.

    Triplen rows are assembled from the zero-sequence companion network
    (``net0``, or :func:`zero_sequence_network` built with ``zero_kw``),
    all other rows from ``net`` — the sequence-aware counterpart of
    ``build_ybus`` + ``line_ybus_pair``.  ``blocked`` lists line indices
    with no zero-sequence path (delta or ungrounded-wye transformer
    winding): their series element AND pi shunt vanish from the triplen
    rows.  ``bus_Xg`` adds grounded-neutral shunt paths (see
    ``_grounding_diag``).  ``lineY``/``lineY_f`` are ``None`` when
    ``settings.stable_mismatch`` is off, mirroring ``line_ybus_pair``.
    """
    from .ybus import LineYbus, build_line_ybus
    if net0 is None:
        net0 = zero_sequence_network(net, **zero_kw)
    elif zero_kw:
        raise ValueError("pass either net0 or zero-sequence parameters")
    if jnp.shape(net0.line_tau) != jnp.shape(net.line_tau):
        raise ValueError("net0 must share net's line topology")

    L = net.n_lines
    keep = np.ones(L)
    for k in blocked:
        keep[int(k)] = 0.0
    keep_j = jnp.asarray(keep, settings.real_dtype)

    lineY1 = build_line_ybus(net, settings)
    # blocked lines: zero the pi shunt at the source (host-side G/B edit)
    # and the series admittance below — both vanish from the triplen rows.
    net0 = dataclasses.replace(net0, line_G=net0.line_G * keep_j,
                               line_B=net0.line_B * keep_j)
    lineY0 = build_line_ybus(net0, settings)
    Ys0 = lineY0.Ys * keep_j
    d0 = lineY0.d
    g = _grounding_diag(settings, bus_Xg, net.n)
    if g is not None:
        d0 = d0 + g

    tri = jnp.asarray(triplen_mask(settings.harmonics))          # (H,)
    Ys = cx.where(tri[:, None], Ys0, lineY1.Ys)
    d = cx.where(tri[:, None], d0, lineY1.d)
    if Y_diag is not None:
        d = d + Y_diag
    blended = LineYbus(Ys=Ys, a_ff=lineY1.a_ff, inv_tau=lineY1.inv_tau,
                       shift=lineY1.shift, d=d,
                       f_idx=lineY1.f_idx, t_idx=lineY1.t_idx)
    Y = _dense_from_line(blended, net.n)
    if not settings.stable_mismatch:
        return Y, None, None
    fund = LineYbus(Ys=blended.Ys[:1], a_ff=blended.a_ff,
                    inv_tau=blended.inv_tau, shift=blended.shift,
                    d=blended.d[:1], f_idx=blended.f_idx,
                    t_idx=blended.t_idx)
    return Y, blended, fund


def delta_device_set(devices, settings, delta: Sequence[int]):
    """Norton equivalents of delta-connected converters: a device with no
    neutral connection injects NO zero-sequence current and never sees the
    zero-sequence bus voltage — its triplen I_N rows vanish, and for a
    coupled NE both the triplen ROWS (no triplen current response) and
    COLUMNS (no response TO triplen voltage) of Y_N vanish.  ``delta``
    lists device indices (0 = first nonlinear bus).

    Caution (CLAUDE.md #13 physics): if EVERY triplen source is removed
    and nothing else excites those orders, the exact solution V_h = 0 is
    singular in the polar state and NR honestly reports non-convergence —
    keep at least one wye device or a background source per triplen order.
    """
    n_nl = devices.n_devices
    dmask = np.zeros(n_nl)
    for k in delta:
        dmask[int(k)] = 1.0
    rd = settings.real_dtype
    dm = jnp.asarray(dmask, rd)
    tri = jnp.asarray(triplen_mask(settings.harmonics), rd)
    keep_i = 1.0 - dm[:, None] * tri[None, :]                    # (n_nl, H)
    I_N = devices.I_N * keep_i
    if devices.coupled:
        blk = jnp.maximum(tri[:, None], tri[None, :])            # row OR col
        keep_y = 1.0 - dm[:, None, None] * blk[None, :, :]
        Y_N = devices.Y_N * keep_y
    else:
        Y_N = devices.Y_N * keep_i
    return dataclasses.replace(devices, I_N=I_N, Y_N=Y_N)


def hpf_sequence(net, devices, settings, *, net0=None,
                 blocked: Sequence[int] = (),
                 bus_Xg: Optional[Mapping[int, float]] = None,
                 delta_devices: Sequence[int] = (),
                 V0=None, I_bg: Optional[Cx] = None,
                 Y_diag: Optional[Cx] = None,
                 record_trajectory: bool = False, **zero_kw):
    """Sequence-aware harmonic power flow: :func:`hpfx.hpf` with the
    triplen orders solved on the zero-sequence network.

    Identical to ``hpf`` when the sequence networks coincide
    (``r0_scale=x0_scale=b0_scale=1`` and no blocking/grounding) — the
    identity is gated in tests/test_sequence.py.  The fundamental solve
    always runs on the positive-sequence row (h=1 is never triplen).
    Jittable: the sequence parameters shape the traced assembly, the
    blocking/grounding patterns are static.

    Keyword groups: ``zero_kw`` forwards to
    :func:`zero_sequence_network` (``r0_scale``, ``x0_scale``,
    ``b0_scale``, ``R0``, ``X0``, ``ungrounded_shunts``) unless an
    explicit ``net0`` is given; ``blocked``/``bus_Xg`` shape the
    zero-sequence topology; ``delta_devices`` masks converter NEs via
    :func:`delta_device_set`; ``V0``/``I_bg``/``Y_diag``/
    ``record_trajectory`` mean what they do on ``hpf``.
    """
    from .harmonic import hpf
    structs = sequence_structures(
        net, settings, net0, blocked=blocked, bus_Xg=bus_Xg, Y_diag=Y_diag,
        **zero_kw)
    if delta_devices:
        devices = delta_device_set(devices, settings, delta_devices)
    return hpf(net, devices, settings, Y=structs, V0=V0,
               record_trajectory=record_trajectory, I_bg=I_bg)
