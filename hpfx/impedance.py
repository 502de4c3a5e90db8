"""Per-harmonic network impedance analysis (frequency / impedance scan).

Capability addition beyond the reference (which stops at HPF solves —
hcne_generalized.py builds Y per harmonic at :154-176 but never inverts
it): the standard harmonic-resonance companion to a harmonic power flow
study.  ``impedance_scan`` computes the nodal impedance matrices
``Z(h) = Y(h)^-1`` for every harmonic in ``settings.harmonics`` from the
same vectorized Ybus assembly the solver uses (:func:`hpfx.ybus.
build_ybus`), and ``resonance_peaks`` locates the parallel-resonance
candidates (local maxima of the driving-point magnitude over harmonic
order) that tell a planner which injection orders a bus amplifies.

Implementation: split-complex throughout (hpfx.cx); the per-harmonic
inversion is one H-batched real block solve (:func:`hpfx.cx.solve`), a
single batched LU.  Everything is
jittable with static shapes.
"""
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network
from .ybus import build_ybus

__all__ = ["impedance_scan", "driving_point_impedance", "resonance_peaks",
           "tuned_filter_admittance", "install_shunt", "install_shunts",
           "frequency_scan", "grid_ybus", "distortion_contributions"]


def _norton_diag(devices) -> Cx:
    """Per-device Norton admittance h-diagonal, (n_nl, H) split-complex.

    For the coupled model this takes the diagonal of the (H, H) coupling
    matrix — cross-harmonic terms cannot enter a per-harmonic ``Z(h)``.
    """
    yn = devices.Y_N
    if getattr(devices, "coupled", False):
        yn = Cx(jnp.diagonal(yn.re, axis1=-2, axis2=-1),
                jnp.diagonal(yn.im, axis1=-2, axis2=-1))
    return yn


def _fold_norton(Y: Cx, net: Network, yn: Cx) -> Cx:
    """Subtract per-device Norton diagonals ``yn`` (n_nl, K) from the
    nonlinear buses' diagonal of the (K, n, n) admittance tensor."""
    buses = net.m + jnp.arange(yn.shape[0])
    return Cx(Y.re.at[:, buses, buses].add(-yn.re.T),
              Y.im.at[:, buses, buses].add(-yn.im.T))


def impedance_scan(net: Network, settings: Settings,
                   Y: Optional[Cx] = None, devices=None,
                   ground_slack: bool = True) -> Cx:
    """Nodal impedance matrices ``Z(h)``, shape ``(H, n, n)``.

    ``Z[h, k, k]`` is the driving-point impedance a harmonic current
    source injected at bus ``k`` sees at order ``settings.harmonics[h]``;
    ``Z[h, j, k]`` the transfer impedance to bus ``j`` (the voltage
    distortion a remote injection causes).

    ``devices``: optional :class:`hpfx.devices.DeviceSet` whose Norton
    admittances are folded into the nonlinear buses — the OPERATIONAL
    scan.  The passive scan (devices=None) characterizes the wires
    alone; in service the installed converters' ``Y_N(h)`` typically
    damp or shift the passive peaks.  Sign convention: the reference's
    injection is ``I_inj = I_N − Y_N·V`` with balance ``Y·V + I_inj = 0``
    (hcne_generalized.py:313-357), so the harmonic fixed point satisfies
    ``(Y − Y_N)·V(h) = −I_N(h)`` — the scan SUBTRACTS ``Y_N`` to match,
    and for the uncoupled device model ``−Z(h)·I_N(h)`` (with
    ``ground_slack=False``) reproduces the solved HPF harmonic voltages
    to the NR tolerance (tests/test_impedance.py).  For coupled devices
    the ``h``-diagonal of ``Y_N`` is used (cross-harmonic couplings
    cannot enter a per-harmonic ``Z(h)``): a first-order operational
    picture.

    ``ground_slack`` (default): the slack bus is treated as an ideal
    voltage source — a short to ground for harmonic currents — so its
    row/column are removed before inversion and re-embedded as zeros.
    This is the physically meaningful scan for a feeder fed from a stiff
    grid, and it keeps ``Y`` nonsingular on networks with no shunt
    elements (whose raw nodal ``Y`` has zero row sums).  With
    ``ground_slack=False`` the raw ``Y(h)`` is inverted as-is (only
    valid when shunts tie the network to ground).

    ``Y``: optional precomputed ``build_ybus(net, settings)`` override
    (e.g. to scan a Kron-reduced or modified network).
    """
    if Y is None:
        Y = build_ybus(net, settings)
    if devices is not None and devices.n_devices:
        Y = _fold_norton(Y, net, _norton_diag(devices))
    H, n = Y.shape[0], Y.shape[1]
    rd = settings.real_dtype
    if ground_slack:
        Yr = Y[:, 1:, 1:]
        eye = jnp.broadcast_to(jnp.eye(n - 1, dtype=rd), (H, n - 1, n - 1))
        Zr = cx.solve(Yr, Cx(eye, jnp.zeros_like(eye)))
        Z = Cx(jnp.zeros((H, n, n), rd), jnp.zeros((H, n, n), rd))
        return Cx(Z.re.at[:, 1:, 1:].set(Zr.re),
                  Z.im.at[:, 1:, 1:].set(Zr.im))
    eye = jnp.broadcast_to(jnp.eye(n, dtype=rd), (H, n, n))
    return cx.solve(Y, Cx(eye, jnp.zeros_like(eye)))


def driving_point_impedance(net: Network, settings: Settings,
                            Y: Optional[Cx] = None, devices=None,
                            ground_slack: bool = True) -> jnp.ndarray:
    """Driving-point impedance magnitudes ``|Z_kk(h)|``, shape (H, n)."""
    Z = impedance_scan(net, settings, Y=Y, devices=devices,
                       ground_slack=ground_slack)
    d = jnp.diagonal(Z.re, axis1=-2, axis2=-1), \
        jnp.diagonal(Z.im, axis1=-2, axis2=-1)
    return jnp.sqrt(d[0] * d[0] + d[1] * d[1])


def resonance_peaks(zmag: jnp.ndarray,
                    settings: Settings) -> Tuple[jnp.ndarray, jnp.ndarray,
                                                 jnp.ndarray]:
    """Parallel-resonance candidates from a driving-point scan.

    ``zmag``: (H, n) magnitudes from :func:`driving_point_impedance`.

    Returns ``(is_peak, worst_h, worst_z)``:

    - ``is_peak`` (H, n) bool — strict local maxima over harmonic order
      (endpoints count when they dominate their single neighbor);
    - ``worst_h`` (n,) — the harmonic ORDER (from ``settings.harmonics``)
      of each bus's global maximum — the order a capacitor/line-inductance
      pair amplifies hardest at that bus;
    - ``worst_z`` (n,) — the magnitude there.

    The slack row of a grounded scan is identically zero and never
    flagged.
    """
    up = jnp.concatenate([jnp.ones_like(zmag[:1], bool),
                          zmag[1:] > zmag[:-1]], axis=0)
    down = jnp.concatenate([zmag[:-1] > zmag[1:],
                            jnp.ones_like(zmag[:1], bool)], axis=0)
    is_peak = up & down & (zmag > 0)
    hs = jnp.asarray(settings.harmonics)
    k = jnp.argmax(zmag, axis=0)
    return is_peak, hs[k], jnp.take_along_axis(zmag, k[None], axis=0)[0]


def tuned_filter_admittance(settings: Settings, h_tune: float,
                            x_cap: float, quality: float = 30.0) -> Cx:
    """Admittance ``Y_f(h)``, shape (H,), of a single-tuned shunt filter.

    A series R-L-C branch sized the textbook way: capacitive reactance
    ``x_cap`` at fundamental (sets the var contribution), inductor tuned
    so the branch resonates at order ``h_tune`` (``X_L = x_cap /
    h_tune²``), damping from the quality factor (``R = sqrt(X_L·x_cap) /
    quality``).  At ``h_tune`` the branch is purely resistive with
    conductance ``quality / sqrt(X_L·x_cap)`` — a low-impedance sink
    that collapses the parallel-resonance peak :func:`resonance_peaks`
    found; away from it the branch is nearly transparent.

    Use with :func:`install_shunt` and the solvers' ``Y=`` override to
    re-run the scan or the full HPF with the filter in service.

    Vectorizes over leading parameter shape: ``h_tune``/``x_cap`` of
    shape (K,) give a (K, H) bank (one branch per row) for
    :func:`install_shunts`.
    """
    rd = settings.real_dtype
    h = jnp.asarray(settings.harmonics, rd)
    h_tune = jnp.asarray(h_tune, rd)
    x_cap = jnp.asarray(x_cap, rd)
    lead = jnp.broadcast_shapes(h_tune.shape, x_cap.shape)
    x_l = x_cap / (h_tune * h_tune)
    r = (jnp.sqrt(x_l * x_cap) / quality)[..., None]
    x = x_l[..., None] * h - x_cap[..., None] / h
    d = r * r + x * x
    return Cx(jnp.broadcast_to(r / d, (*lead, h.shape[0])),
              jnp.broadcast_to(-x / d, (*lead, h.shape[0])))


def highpass_filter_admittance(settings: Settings, h_corner: float,
                               x_cap: float, m: float = 1.0) -> Cx:
    """Admittance ``Y_f(h)``, shape (H,), of a second-order damped
    high-pass shunt filter: series capacitor (reactance ``x_cap`` at
    fundamental) into R parallel L.

    ``X_L = x_cap / h_corner²`` places the corner at ``h_corner``;
    ``m = R / (h_corner·X_L)`` is the damping factor (0.5-2 typical —
    larger m = flatter, more resistive above the corner).  Unlike the
    single-tuned branch the damped response sinks a broad band above the
    corner (the classic choice for the 17th-and-up remainder a tuned
    bank leaves), at the cost of fundamental losses through R.

    Same conventions as :func:`tuned_filter_admittance`: vectorizes over
    leading parameter shape for banks, feeds :func:`install_shunt` /
    ``install_shunts`` and every ``Y=`` override.
    """
    rd = settings.real_dtype
    h = jnp.asarray(settings.harmonics, rd)
    h_corner = jnp.asarray(h_corner, rd)
    x_cap = jnp.asarray(x_cap, rd)
    lead = jnp.broadcast_shapes(h_corner.shape, x_cap.shape)
    x_l = x_cap / (h_corner * h_corner)
    R = (m * h_corner * x_l)[..., None]
    X = x_l[..., None] * h                           # inductor at order h
    d = R * R + X * X
    # Z = -j·x_cap/h  +  (R·X² + j·R²·X) / (R² + X²)
    z_re = R * X * X / d
    z_im = R * R * X / d - x_cap[..., None] / h
    dz = z_re * z_re + z_im * z_im
    return Cx(jnp.broadcast_to(z_re / dz, (*lead, h.shape[0])),
              jnp.broadcast_to(-z_im / dz, (*lead, h.shape[0])))


def ctype_filter_admittance(settings: Settings, h_tune: float,
                            x_cap: float, quality: float = 2.0) -> Cx:
    """Admittance ``Y_f(h)``, shape (H,), of a C-type damped shunt
    filter: main capacitor (reactance ``x_cap`` at fundamental) in
    series with [R parallel (L series C₂)], the auxiliary L-C₂ tuned to
    the FUNDAMENTAL (``x_l = x_c2``, so the branch shorts R at h = 1 —
    zero fundamental losses, the C-type's reason to exist) and the
    whole filter series-resonant at ``h_tune``
    (``x_l = x_cap / (h_tune² − 1)``).

    ``quality`` scales the damping resistor ``R = quality ·
    h_tune · x_l`` — larger = sharper (closer to a pure tuned branch),
    smaller = broader damped response for low-order harmonics (the
    classic 3rd-harmonic filter on transmission SVCs).

    Same conventions as :func:`tuned_filter_admittance` (leading
    parameter shapes give banks).
    """
    rd = settings.real_dtype
    h = jnp.asarray(settings.harmonics, rd)
    h_tune = jnp.asarray(h_tune, rd)
    x_cap = jnp.asarray(x_cap, rd)
    lead = jnp.broadcast_shapes(h_tune.shape, x_cap.shape)
    x_l = x_cap / (h_tune * h_tune - 1.0)
    R = (quality * h_tune * x_l)[..., None]
    X_aux = x_l[..., None] * (h - 1.0 / h)           # j(h·x_l − x_c2/h)
    d = R * R + X_aux * X_aux
    z_re = R * X_aux * X_aux / d
    z_im = R * R * X_aux / d - x_cap[..., None] / h
    dz = z_re * z_re + z_im * z_im
    return Cx(jnp.broadcast_to(z_re / dz, (*lead, h.shape[0])),
              jnp.broadcast_to(-z_im / dz, (*lead, h.shape[0])))


def install_shunt(Y: Cx, bus: int, y_shunt: Cx) -> Cx:
    """Return ``Y`` with a shunt admittance added at ``bus``'s diagonal.

    ``y_shunt``: (H,) split-complex per-harmonic admittance (e.g. from
    :func:`tuned_filter_admittance`).  The result feeds any entry point
    with a ``Y=`` override (``hpf``, ``hpf_sweep``,
    :func:`impedance_scan`) — note an overridden ``Y`` routes the solver
    to the reference-form dense mismatch (hpfx.solve), which is exactly
    the safe choice for a modified network.
    """
    return Cx(Y.re.at[:, bus, bus].add(y_shunt.re),
              Y.im.at[:, bus, bus].add(y_shunt.im))


def install_shunts(Y: Cx, buses, y_shunts: Cx) -> Cx:
    """:func:`install_shunt` for a bank: ``y_shunts`` (K, H) rows are
    added at ``buses`` (length-K static index sequence; repeated buses
    accumulate).  One scatter-add on the diagonal."""
    b = jnp.asarray(buses)
    return Cx(Y.re.at[:, b, b].add(y_shunts.re.T),
              Y.im.at[:, b, b].add(y_shunts.im.T))


def grid_ybus(net: Network, settings: Settings, h_grid: Sequence[float],
              devices=None) -> Tuple[Settings, Cx]:
    """(dense_settings, Y) on an arbitrary (float) order grid.

    The shared assembly behind :func:`frequency_scan` and
    :func:`hpfx.modes.modal_scan`: re-evaluates the vectorized Ybus
    construction (linear ``X``/``B`` scaling in ``h``, ybus.py — the
    reference's per-harmonic law, hcne_generalized.py:154-176) at the
    off-grid orders, and folds in the Norton h-diagonal of ``devices``
    (linearly interpolated from ``settings.harmonics`` onto the grid)
    for the operational picture.  Grid values are static.
    """
    hs = tuple(float(h) for h in h_grid)
    dense = settings.with_(harmonics=hs)
    Y = build_ybus(net, dense)
    if devices is not None and devices.n_devices:
        yn = _norton_diag(devices)
        h0 = jnp.asarray(settings.harmonics, settings.real_dtype)
        hq = jnp.asarray(hs, settings.real_dtype)
        yn = Cx(jax.vmap(lambda y: jnp.interp(hq, h0, y))(yn.re),
                jax.vmap(lambda y: jnp.interp(hq, h0, y))(yn.im))
        Y = _fold_norton(Y, net, yn)
    return dense, Y


def frequency_scan(net: Network, settings: Settings,
                   h_grid: Sequence[float], devices=None,
                   ground_slack: bool = True) -> jnp.ndarray:
    """Driving-point ``|Z_kk|`` on a dense (float) order grid, (K, n).

    The integer-order scan (:func:`driving_point_impedance`) can miss a
    resonance sitting BETWEEN harmonic orders — the classic detuned
    capacitor-bank case — because it samples ``|Z|`` only at the orders
    the HPF solves.  This re-assembles the Ybus at arbitrary fractional
    orders (the assembly scales ``X``/``B`` linearly in ``h``, ybus.py —
    exactly the reference's per-harmonic construction,
    hcne_generalized.py:154-176, evaluated off-grid) and returns the
    magnitudes.  Grid values are static (one compile per grid).

    ``devices``: as in :func:`impedance_scan` (operational scan); the
    Norton h-diagonal, tabulated at ``settings.harmonics``, is linearly
    interpolated onto ``h_grid`` — at integer grid points this equals
    the operational integer scan exactly.
    """
    dense, Y = grid_ybus(net, settings, h_grid, devices=devices)
    Z = impedance_scan(net, dense, Y=Y, ground_slack=ground_slack)
    re = jnp.diagonal(Z.re, axis1=-2, axis2=-1)
    im = jnp.diagonal(Z.im, axis1=-2, axis2=-1)
    return jnp.sqrt(re * re + im * im)


def distortion_contributions(net: Network, devices, settings: Settings,
                             Y: Optional[Cx] = None) -> Cx:
    """Per-device harmonic voltage contributions, (H, n, n_nl).

    ``contrib[h, j, d] = −Z_op(h)[j, bus_d] · I_N[d](h)`` — the voltage
    distortion device ``d`` alone would cause at bus ``j``, through the
    operational network (every OTHER device present as its Norton
    admittance).  Because the uncoupled harmonic balance is linear in
    the injections (``(Y − Y_N)·V(h) = −I_N(h)``, sign convention per
    :func:`impedance_scan`), the contributions superpose EXACTLY: their
    device-sum reproduces the solved HPF harmonic voltages to NR
    tolerance (tests/test_impedance.py).  For coupled devices the same
    first-order (h-diagonal) picture applies.

    This is the emission-allocation question (IEC 61000-3-6 style):
    which converter is responsible for the distortion at bus ``j``.
    Uses ``ground_slack=False`` (the solver's own balance), so the
    network must be tied to ground (shunts / X_sh), as in any HPF run.

    ``Y``: optional Ybus override (e.g. with a filter installed).
    """
    Z = impedance_scan(net, settings, Y=Y, devices=devices,
                       ground_slack=False)
    buses = net.m + jnp.arange(devices.n_devices)
    Zc = Z[:, :, buses]                            # (H, n, n_nl)
    IN = devices.I_N                               # (n_nl, H)
    re_d, im_d = IN.re.T[:, None, :], IN.im.T[:, None, :]
    return Cx(-(Zc.re * re_d - Zc.im * im_d),
              -(Zc.re * im_d + Zc.im * re_d))
