"""Distributed-parameter (long-line) branch model per harmonic order.

The reference — and the library's default path — stamps every line as a
NOMINAL pi: total series impedance ``Z(h) = R + j·h·X`` and total charging
``Y(h) = G + j·h·B`` split half-half across the ends
(``hcne_generalized.py:151-168``).  That is a short-line approximation:
it is accurate while the line is electrically short, i.e. while
``|θ| = |sqrt(Z·Y)| << 1``.  Harmonic studies break this premise by
construction — electrical length scales with the harmonic ORDER, so a
50 Hz-short 100 km line is electrically LONG at the 25th/49th harmonic
(θ grows ~h for a lossless line).  The nominal pi then misplaces the
line's internal resonances, which is exactly what a penetration study is
trying to locate.

This module applies the EXACT correction.  The distributed telegrapher
solution of a uniform line collapses to an equivalent pi with

    Z_pi   = Z · sinh(θ)/θ,            θ² = Z·Y  (θ the propagation
    Y_pi/2 = (Y/2) · tanh(θ/2)/(θ/2),             constant × length)

(Grainger & Stevenson eq. 5.28; Arrillaga & Watson, *Power System
Harmonics*, long-line modeling) — the equivalent pi reproduces the exact
two-port ABCD = [cosh θ, Z_c·sinh θ; sinh θ/Z_c, cosh θ] at the
terminals, so the external network sees the distributed line exactly;
only the (unmodeled) internal voltage profile is abstracted away.

Everything is split-complex (:mod:`hpfx.cx`) and elementwise over the (H, L) grid, so the correction
is XLA-fusion-friendly and costs nothing measurable next to the solves.
``sinh(θ)/θ`` and ``tanh(θ/2)/(θ/2)`` are even in θ; near θ = 0 (lines
with no charging — e.g. every net1/net2/net3 line has B = 0) they are
evaluated by their θ²-series so zero-charging lines reproduce the
nominal pi EXACTLY and gradients stay finite.

Convention: like :mod:`hpfx.lineskin` and :mod:`hpfx.loadmodel`, the
fundamental row is pinned to the nominal pi by default so the h = 1
solve stays the conventional power flow; pass
``include_fundamental=True`` for the textbook exact pi at 50 Hz too.

Composability: :func:`longline_structures` returns the
``(Y, lineY, lineY_f)`` triple of :func:`hpfx.ybus.resolve_ybus`, so
long-line systems ride ``hpf`` / ``hpf_sweep`` / ``hpf_sweep_adaptive``
(both batch layouts) unchanged, and accepts the :mod:`hpfx.lineskin`
``Rh`` table — skin effect shapes Z(h) before the long-line correction.
Note :func:`hpfx.flows.line_flows` reconstructs branch currents from the
NOMINAL branch algebra and does not see admittance overrides.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network
from .ybus import build_ybus, fold_ydiag, line_ybus_pair

#: |θ²| below which the even θ²-series replaces the transcendental form.
#: Truncation error of the 3-term series is O(|θ²|³/5040) ≈ 2e-13 at the
#: crossover — below f64 roundoff of the transcendental branch itself.
_SERIES_CUTOFF = 1e-3


def _sinhc(theta2: Cx) -> Cx:
    """sinh(θ)/θ as a function of w = θ² (even in θ, so single-valued in
    w — no branch issue from the square root).  Series inside the
    cutoff, sinh(√w)/√w outside; both branches are evaluated under
    ``where`` so the guarded denominator keeps the unused branch finite.
    """
    small = theta2.abs2() < _SERIES_CUTOFF * _SERIES_CUTOFF
    series = 1.0 + theta2 * (1.0 / 6.0) + (theta2 * theta2) * (1.0 / 120.0)
    guard = Cx(jnp.where(small, 1.0, theta2.re),
               jnp.where(small, 0.0, theta2.im))
    th = cx.sqrt(guard)
    full = cx.sinh(th) / th
    return cx.where(small, series, full)


def _tanhc_half(theta2: Cx) -> Cx:
    """tanh(θ/2)/(θ/2) as a function of w = θ²: series
    1 − w/12 + w²/120 inside the cutoff (tanh x/x = 1 − x²/3 + 2x⁴/15
    at x = θ/2), sinh/(cosh·θ/2) outside."""
    small = theta2.abs2() < _SERIES_CUTOFF * _SERIES_CUTOFF
    series = (1.0 - theta2 * (1.0 / 12.0)
              + (theta2 * theta2) * (1.0 / 120.0))
    guard = Cx(jnp.where(small, 1.0, theta2.re),
               jnp.where(small, 0.0, theta2.im))
    th_half = cx.sqrt(guard) * 0.5
    full = cx.sinh(th_half) / (cx.cosh(th_half) * th_half)
    return cx.where(small, series, full)


def _branch_totals(net: Network, settings: Settings, Rh=None):
    """Total series impedance Z(h) and charging Y(h), both (H, L)."""
    rd = settings.real_dtype
    h = jnp.asarray(settings.harmonics, dtype=rd)[:, None]
    R = net.line_R if Rh is None else jnp.asarray(Rh, rd)
    Z = Cx(jnp.broadcast_to(R, (len(settings.harmonics),
                                net.n_lines)).astype(rd),
           net.line_X * h)
    Y = Cx(jnp.broadcast_to(net.line_G, Z.shape).astype(rd),
           net.line_B * h)
    return Z, Y


def longline_factors(net: Network, settings: Settings, Rh=None, *,
                     include_fundamental: bool = False):
    """Per-line, per-harmonic long-line correction factors ``(Ks, Kp)``,
    both split-complex (H, L): ``Z_pi = Z·Ks`` (series) and
    ``Y_pi/2 = (Y/2)·Kp`` (each end).  ``Rh`` as in
    :func:`hpfx.ybus.build_ybus` (skin-effect tables compose).  With
    ``include_fundamental=False`` (default) the h = 1 row is pinned to
    (1, 1) — the nominal pi — matching the library's fundamental-solve
    convention."""
    Z, Y = _branch_totals(net, settings, Rh)
    theta2 = Z * Y
    Ks = _sinhc(theta2)
    Kp = _tanhc_half(theta2)
    if not include_fundamental:
        one = jnp.ones_like(Ks.re[:1])
        zero = jnp.zeros_like(one)
        Ks = Cx(jnp.concatenate([one, Ks.re[1:]]),
                jnp.concatenate([zero, Ks.im[1:]]))
        Kp = Cx(jnp.concatenate([one, Kp.re[1:]]),
                jnp.concatenate([zero, Kp.im[1:]]))
    return Ks, Kp


def electrical_length(net: Network, settings: Settings, Rh=None):
    """|θ(h)| = |sqrt(Z·Y)| per line and harmonic ((H, L) real) — the
    screening quantity: the nominal pi's series/shunt error is
    O(|θ|²/6), so |θ| > ~0.5 rad flags orders where the long-line
    correction is material (>4 % branch error)."""
    Z, Y = _branch_totals(net, settings, Rh)
    return jnp.sqrt((Z * Y).abs2()) ** 0.5


def longline_structures(net: Network, settings: Settings, Rh=None, *,
                        include_fundamental: bool = False,
                        Y_diag: Optional[Cx] = None):
    """``(Y, lineY, lineY_f)`` triple with the exact-pi long-line
    branches folded into BOTH the dense tensor and the stable-mismatch
    line structure — pass as the ``Y`` argument of ``hpf`` /
    ``hpf_sweep`` / ``hpf_sweep_adaptive`` (either layout).  ``Rh``
    composes skin effect underneath; ``Y_diag`` folds a
    :mod:`hpfx.loadmodel` table on top, mirroring
    :func:`hpfx.lineskin.skin_structures`."""
    Z, Yc = _branch_totals(net, settings, Rh)
    Ks, Kp = longline_factors(net, settings, Rh,
                              include_fundamental=include_fundamental)
    Ys = (Z * Ks).reciprocal()
    Ysh = (Yc * 0.5) * Kp
    Y = build_ybus(net, settings, Ys=Ys, Ysh=Ysh)
    lineY, lineY_f = line_ybus_pair(net, settings, Ys=Ys, Ysh=Ysh)
    if Y_diag is not None:
        Y = fold_ydiag(Y, Y_diag)
        if lineY is not None:
            lineY = lineY._replace(d=lineY.d + Y_diag)
            lineY_f = lineY_f._replace(d=lineY_f.d + Y_diag[:1])
    return Y, lineY, lineY_f
