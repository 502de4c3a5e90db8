"""Per-harmonic admittance (Ybus) assembly — split-complex, batched.

Vectorized replacement for the reference's nested Python loops
(``hcne_generalized.py:132-171`` build_admittance_matrices): one vectorized
scatter-add over the line arrays builds all harmonics at once into a dense
``(H, n, n)`` split-complex tensor (``hpfx.cx.Cx``: separate re/im real
arrays).  For grid sizes in scope (n up to a few hundred) dense
per-harmonic blocks are the layout; the global block-diagonal structure
across harmonics stays implicit.

Physics (identical to the reference at tau=1, shift=0):
- series element per line: Ys(h) = 1/(R + j·X·h)        (:151-155)
- off-diagonals: Y[h,f,t] = Y[h,t,f] = -Ys(h)           (:151-155, symmetric)
- diagonals: sum of incident Ys(h) plus, for h != 1 and X_sh != 0, the bus
  shunt 1/(j·X_sh·h)                                     (:157-161)
- pi-model line shunt (G + j·h·B)/2 added at each end   (:162-168)

Transformer extension (capability of ``pi_trafo_pf_test.py:117-145``): lines
may carry a tap ratio ``tau`` and a phase shift.  The reference's formulas
are marked FIXME/unresolved there; this implementation uses the standard
pi-model transformer (tap on the from/HV side, PyPSA convention), which
reduces exactly to the reference equations for tau=1, shift=0:

    Y[h,f,t] = -Ys / (tau·e^{-j·shift})
    Y[h,t,f] = -Ys / (tau·e^{+j·shift})
    Y[h,f,f] += (Ys + Ysh/2) / tau**2
    Y[h,t,t] +=  Ys + Ysh/2

``Settings.compat_shunt_bug`` reproduces the reference's line-shunt indexing
quirk (G/B shunts attributed to the bus whose *index* equals the endpoint's
1-based ID; hcne_generalized.py:166) for bug-compatible validation on nets
with nonzero G/B.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network


def build_ybus(net: Network, settings: Settings, Rh=None, *,
               Ys: Cx = None, Ysh: Cx = None) -> Cx:
    """Return the dense (H, n, n) split-complex admittance tensor, one block
    per harmonic order in ``settings.harmonics``.

    ``Rh`` (optional, (H, L)) overrides the series resistance per harmonic
    and line — the hook for frequency-dependent conductor models
    (skin/proximity effect, :mod:`hpfx.lineskin`).  ``None`` keeps the
    reference's frequency-flat ``net.line_R`` (hcne_generalized.py:151-155).

    ``Ys`` / ``Ysh`` (optional, split-complex (H, L)) replace the computed
    per-line SERIES admittance and per-END pi shunt ``(G + j·h·B)/2``
    outright — the hook for fully frequency-shaped branch models
    (distributed-parameter long lines, :mod:`hpfx.longline`).  Tap/shift
    couplings and bus shunts still apply on top.
    """
    rd = settings.real_dtype
    h = jnp.asarray(settings.harmonics, dtype=rd)[:, None]        # (H, 1)
    n = net.n
    _all = slice(None)

    Xh = net.line_X * h                                            # (H, L)
    if Ys is None:
        R = net.line_R if Rh is None else jnp.asarray(Rh, rd)
        d = R * R + Xh * Xh
        Ys = Cx(R / d, -Xh / d)                                    # 1/(R+jXh)
    tau = net.line_tau
    inv_t_ft = cx.expj(net.line_shift) * (1.0 / tau)   # 1/(tau·e^{-j·shift})
    inv_t_tf = cx.expj(-net.line_shift) * (1.0 / tau)

    f, t = net.line_from, net.line_to
    Y = cx.zeros((len(settings.harmonics), n, n), rd)
    Y = Y.at_add((_all, f, t), -(Ys * inv_t_ft))
    Y = Y.at_add((_all, t, f), -(Ys * inv_t_tf))

    # series contribution to diagonals
    Y = Y.at_add((_all, f, f), Ys * (1.0 / (tau * tau)))
    Y = Y.at_add((_all, t, t), Ys)

    # pi-line shunt (G + j·h·B)/2 at each end
    if Ysh is None:
        Ysh = Cx(jnp.broadcast_to(net.line_G / 2.0, Xh.shape),
                 h * net.line_B / 2.0)
    if settings.compat_shunt_bug:
        # reference quirk: shunt lands on bus *index* == endpoint 1-based ID;
        # endpoints whose ID exceeds the last index drop out (scatter 'drop')
        f_sh = jnp.where(f + 1 < n, f + 1, n)
        t_sh = jnp.where(t + 1 < n, t + 1, n)
        Y = Y.at_add((_all, f_sh, f_sh), Ysh, mode="drop")
        Y = Y.at_add((_all, t_sh, t_sh), Ysh, mode="drop")
    else:
        Y = Y.at_add((_all, f, f), Ysh * (1.0 / (tau * tau)))
        Y = Y.at_add((_all, t, t), Ysh)

    # bus shunt reactance, harmonics only (hcne_generalized.py:158-159):
    # 1/(j·X_sh·h) = -j/(X_sh·h)
    xsh = net.bus_Xsh[None, :]                                     # (1, n)
    apply = (h != 1.0) & (xsh != 0.0)
    safe = jnp.where(xsh != 0.0, xsh, 1.0)
    y_sh_im = jnp.where(apply, -1.0 / (safe * h), 0.0)
    idx = jnp.arange(n)
    Y = Y.at_add((_all, idx, idx), Cx(jnp.zeros_like(y_sh_im), y_sh_im))
    return Y

def resolve_ybus(net: Network, settings: Settings, Y):
    """Normalize a solver entry's ``Y`` argument to ``(Y, lineY, lineY_f)``.

    ``None`` builds both forms from the network (the default path);
    a dense ``Cx`` override comes with NO line structure (the stable
    mismatch belongs to the network Y was not built from — e.g. the
    Kron-reduced blocks); a 3-tuple ``(Y, lineY, lineY_f)`` — the
    contract of :func:`hpfx.sequence.sequence_structures` — carries its
    own consistent structures (``lineY`` may be None when
    ``settings.stable_mismatch`` is off)."""
    if Y is None:
        return build_ybus(net, settings), *line_ybus_pair(net, settings)
    if isinstance(Y, Cx):
        return Y, None, None
    Yd, lineY, lineY_f = Y
    if not isinstance(Yd, Cx):
        raise TypeError("Y must be None, a dense Cx, or a "
                        "(Y, lineY, lineY_f) triple")
    return Yd, lineY, lineY_f


def fold_ydiag(Y: Cx, Y_diag: Cx) -> Cx:
    """Add per-bus shunt admittances ``Y_diag`` (H, n) to the diagonal of
    the dense (H, n, n) admittance tensor (frequency-dependent load
    models, hpfx.loadmodel; tuned filters use
    :func:`hpfx.impedance.install_shunt` for single buses)."""
    n = Y.shape[-1]
    idx = jnp.arange(n)
    return Cx(Y.re.at[:, idx, idx].add(Y_diag.re),
              Y.im.at[:, idx, idx].add(Y_diag.im))


class LineYbus(NamedTuple):
    """Line-structured admittance: the ingredients of ``build_ybus`` kept
    un-summed, for the numerically stable matvec below.

    ``Ys`` (H, L) series admittances; ``a_ff``/``inv_tau``/``shift`` (L,)
    O(1) tap/phase couplings (precomputed once — the matvec runs inside
    the Newton while-loop); ``d`` (H, n) every diagonal-only term (pi-line
    shunts, bus shunt reactances); ``f_idx``/``t_idx`` (L,) endpoints.
    """

    Ys: Cx
    a_ff: jnp.ndarray     # (L,) real 1/tau^2
    inv_tau: jnp.ndarray  # (L,) real 1/tau
    shift: jnp.ndarray    # (L,) phase shift [rad]
    d: Cx                 # (H, n)
    f_idx: jnp.ndarray
    t_idx: jnp.ndarray


def build_line_ybus(net: Network, settings: Settings, Rh=None, *,
                    Ys: Cx = None, Ysh: Cx = None) -> LineYbus:
    """Assemble the line-structured form of the same physics as
    ``build_ybus`` (identical in exact arithmetic; see ``stable_matvec``).
    ``Rh``/``Ys``/``Ysh`` as in :func:`build_ybus`."""
    rd = settings.real_dtype
    h = jnp.asarray(settings.harmonics, dtype=rd)[:, None]
    n = net.n
    H = len(settings.harmonics)
    _all = slice(None)

    Xh = net.line_X * h
    if Ys is None:
        R = net.line_R if Rh is None else jnp.asarray(Rh, rd)
        den = R * R + Xh * Xh
        Ys = Cx(R / den, -Xh / den)
    tau = net.line_tau
    a_ff = 1.0 / (tau * tau)
    inv_tau = 1.0 / tau
    shift = jnp.asarray(net.line_shift, rd)

    f, t = net.line_from, net.line_to
    d = cx.zeros((H, n), rd)
    if Ysh is None:
        Ysh = Cx(jnp.broadcast_to(net.line_G / 2.0, Xh.shape),
                 h * net.line_B / 2.0)
    if settings.compat_shunt_bug:
        f_sh = jnp.where(f + 1 < n, f + 1, n)
        t_sh = jnp.where(t + 1 < n, t + 1, n)
        d = d.at_add((_all, f_sh), Ysh, mode="drop")
        d = d.at_add((_all, t_sh), Ysh, mode="drop")
    else:
        d = d.at_add((_all, f), Ysh * a_ff)
        d = d.at_add((_all, t), Ysh)

    xsh = net.bus_Xsh[None, :]
    apply = (h != 1.0) & (xsh != 0.0)
    safe = jnp.where(xsh != 0.0, xsh, 1.0)
    y_sh_im = jnp.where(apply, -1.0 / (safe * h), 0.0)
    d = d + Cx(jnp.zeros_like(y_sh_im), y_sh_im)
    return LineYbus(Ys=Ys, a_ff=a_ff, inv_tau=inv_tau, shift=shift, d=d,
                    f_idx=f, t_idx=t)


def _polar_diff(mu_a, th_a, mu_b, th_b) -> Cx:
    """mu_a·e^{j th_a} - mu_b·e^{j th_b}, computed cancellation-free.

    Rectangular evaluation first converts each operand with ~eps·|mu|
    absolute noise, so the difference of nearby phasors (fundamental-row
    line flows: |diff| ~ 1e-2·|V|) carries eps·|V|, which the series
    admittance then amplifies by |Ys| (~4e2 on net1) — an f32 floor of
    ~1e-4, above the reference's thresh_h.  Factoring the difference in
    polar form instead,

        e^{j th_a}·[ (mu_a - mu_b) + 2·mu_b·sin²(Δ/2) - j·mu_b·sin Δ ],
        Δ = th_b - th_a,

    every bracket term is individually small: mu_a - mu_b is exact for
    nearby magnitudes (Sterbenz), Δ is exact for nearby angles, and
    1 - cos Δ is evaluated as 2 sin²(Δ/2) without cancellation.  The error
    becomes relative to the *difference*, not to |V|.  Valid for any
    magnitudes/angles (incl. the solver's signed mid-iteration magnitudes);
    when the operands aren't close the rounding is relative anyway.
    """
    dmu = mu_a - mu_b
    delta = th_b - th_a
    s_half = jnp.sin(0.5 * delta)
    re_local = dmu + 2.0 * mu_b * s_half * s_half
    im_local = -mu_b * jnp.sin(delta)
    return cx.expj(th_a) * Cx(re_local, im_local)


def stable_matvec(lineY: LineYbus, V_m, V_a) -> Cx:
    """Cancellation-free Y·V for (H, n) voltage spectra given in polar form.

    The dense matvec sums O(|Ys|·|V|) products that cancel to a near-zero
    mismatch, flooring the f32 residual at |Ys|·eps·|V| (~1e-4 for stiff
    grids like net1 — above the reference's thresh_h, so f32 Newton
    stalls).  Algebraically identical regrouping using Ybus's own structure
    (diagonal = -sum of off-diagonals + shunts):

        (Y·V)_f = sum_lines Ys·(V_f/tau^2 - V_t·e^{j s}/tau) + d_f·V_f

    with each line's voltage difference evaluated by :func:`_polar_diff`,
    so every flow term carries rounding relative to the flow itself.  The
    f32 residual floor drops ~two orders of magnitude, which is what makes
    reference-threshold convergence attainable in f32 (measured on net1
    H<=25: dense-form floor 7.9e-5, this form ~1e-6).
    """
    f, t = lineY.f_idx, lineY.t_idx
    mu_f = V_m[:, f] * lineY.a_ff          # a_ff real: 1/tau^2
    th_f = V_a[:, f]
    # the tap/shift couplings e^{+-j shift}/tau are unit-modulus up to the
    # real tap: fold the phase into the angle, the modulus into the
    # magnitude (exact polar representation of V_t·e^{j shift}/tau)
    shift = lineY.shift
    inv_tau = lineY.inv_tau
    mu_t = V_m[:, t] * inv_tau
    th_t = V_a[:, t] + shift
    flow_f = lineY.Ys * _polar_diff(mu_f, th_f, mu_t, th_t)
    mu_t2 = V_m[:, t]
    th_t2 = V_a[:, t]
    mu_f2 = V_m[:, f] * inv_tau
    th_f2 = V_a[:, f] - shift
    flow_t = lineY.Ys * _polar_diff(mu_t2, th_t2, mu_f2, th_f2)
    out = lineY.d * cx.polar(V_m, V_a)
    out = out.at_add((slice(None), f), flow_f)
    out = out.at_add((slice(None), t), flow_t)
    return out

def line_ybus_pair(net: Network, settings: Settings, Rh=None, *,
                   Ys: Cx = None, Ysh: Cx = None):
    """(full, fundamental-sliced) LineYbus pair for the stable mismatch,
    or (None, None) when Settings.stable_mismatch is off.  Built by the
    solver entry points alongside ``build_ybus`` so the two always
    describe the same system (a caller-overridden Y never gets a stale
    line structure).  ``Rh``/``Ys``/``Ysh`` as in :func:`build_ybus`."""
    if not settings.stable_mismatch:
        return None, None
    full = build_line_ybus(net, settings, Rh=Rh, Ys=Ys, Ysh=Ysh)
    fund = LineYbus(Ys=full.Ys[:1], a_ff=full.a_ff, inv_tau=full.inv_tau,
                    shift=full.shift, d=full.d[:1],
                    f_idx=full.f_idx, t_idx=full.t_idx)
    return full, fund
