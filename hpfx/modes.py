"""Harmonic resonance mode analysis (RMA).

Capability addition beyond the reference (which stops at HPF solves;
its Ybus assembly is hcne_generalized.py:154-176): the modal companion
of the impedance scan.  A parallel resonance is a near-singularity of
``Y(h)`` — the driving-point scan (:mod:`hpfx.impedance`) shows its
*symptom* (a |Z_kk| peak at some buses), while the eigenstructure of
``Y(h)`` exposes its *mechanism*:

- the **critical mode** is the eigenvalue of smallest magnitude; its
  reciprocal ``z_modal = 1/|lambda_min|`` is the modal impedance, which
  peaks exactly at the resonant order;
- the **participation factor** ``PF_b = (v_b * w_b) / (w^T v)`` of bus
  ``b`` (right/left eigenvectors ``v``/``w``) says where the resonance
  is both *excitable* and *observable* — the buses that amplify an
  injection and the buses where the distortion appears;
- the **eigenvalue sensitivity** ``d lambda / d p = w^T (dY/dp) v /
  (w^T v)`` ranks which physical component (a line reactance, a shunt
  capacitor) to retune to move the resonance.

This is the method of Xu, Huang & Cui, "Harmonic resonance mode
analysis", IEEE Trans. Power Delivery 20(2), 2005.

Batched design: the full eigendecomposition is LAPACK-shaped (XLA lowers
nonsymmetric ``eig`` on the CPU only), but RMA only needs the
*smallest* eigenpair — computed here by **batched inverse iteration**:
``v <- normalize(solve(Y, v))`` converges to the smallest-|lambda| mode
at ratio ``|lambda_1/lambda_2|`` per step, and each step is one
H-batched split-complex block solve (:func:`hpfx.cx.solve`).
A fixed, static trip count keeps the whole scan one jittable program;
the returned residual certifies convergence.  The host-side full
spectrum (:func:`modal_spectrum`) is provided for offline study and is
the test oracle (tests/test_modes.py).

Everything is split-complex (no complex dtypes on this backend) and
f64-clean under the tests' x64 config.
"""
from typing import NamedTuple, Optional, Sequence, Tuple

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import cx
from .config import Settings
from .cx import Cx
from .impedance import grid_ybus, _fold_norton, _norton_diag
from .network import Network
from .ybus import build_ybus

__all__ = ["critical_mode", "modal_scan", "modal_peaks",
           "eigen_sensitivity", "modal_spectrum", "ModalScan",
           "CriticalMode"]


class CriticalMode(NamedTuple):
    """Smallest-|lambda| eigenpair of a (batch of) admittance matrices.

    ``lam``: the critical eigenvalue(s), split-complex, leading shape of
    the input batch.  ``v``/``w``: right/left eigenvectors (unit 2-norm,
    phase-fixed so each vector's largest entry is real-positive).
    ``participation``: ``(v ⊙ w) / (w^T v)`` — sums to 1 over the bus
    axis by the eigen-expansion identity.  ``residual``: relative
    defect ``‖Y v − lam v‖ / ‖lam v‖`` certifying the iteration
    converged (well-separated modes reach fp noise in a few steps).
    """
    lam: Cx
    v: Cx
    w: Cx
    participation: Cx
    residual: jnp.ndarray

    @property
    def z_modal(self) -> jnp.ndarray:
        """Modal impedance ``1/|lambda|`` — the RMA resonance indicator."""
        return 1.0 / self.lam.abs()


def _normalize(v: Cx) -> Cx:
    n2 = jnp.sum(v.abs2(), axis=-1, keepdims=True)
    return v * (1.0 / jnp.sqrt(n2))


def _fix_phase(v: Cx) -> Cx:
    """Rotate each vector so its largest-magnitude entry is real-positive
    (a deterministic gauge — eigenvectors are defined up to phase)."""
    k = jnp.argmax(v.abs2(), axis=-1, keepdims=True)
    re = jnp.take_along_axis(v.re, k, axis=-1)
    im = jnp.take_along_axis(v.im, k, axis=-1)
    return v * Cx(re, -im) * (1.0 / jnp.sqrt(re * re + im * im))


def _dot(a: Cx, b: Cx) -> Cx:
    """Bilinear (transpose, NOT conjugate) inner product ``a^T b`` over the
    last axis — the pairing under which left/right eigenvectors of a
    general complex matrix are orthogonal."""
    return Cx(jnp.sum(a.re * b.re - a.im * b.im, axis=-1),
              jnp.sum(a.re * b.im + a.im * b.re, axis=-1))


def _inverse_iteration(Y: Cx, iters: int) -> Cx:
    """``iters`` steps of v <- normalize(Y^{-1} v) from a flat start,
    batched over the leading axes of ``Y`` (..., n, n)."""
    n = Y.shape[-1]
    lead = Y.shape[:-2]
    rd = Y.re.dtype
    # flat start with a small index ramp in the imaginary part so the
    # start is never bilinearly self-orthogonal nor exactly orthogonal
    # to a real eigenvector
    v0 = Cx(jnp.broadcast_to(jnp.ones(n, rd), (*lead, n)),
            jnp.broadcast_to(jnp.linspace(0.0, 0.1, n).astype(rd),
                             (*lead, n)))
    v0 = _normalize(v0)

    def step(_, v):
        return _normalize(cx.solve(Y, v))

    return jax.lax.fori_loop(0, iters, step, v0)


def _rayleigh(Y: Cx, v: Cx) -> Cx:
    """Rayleigh quotient ``v^H Y v / v^H v`` (exact at an eigenvector of
    any matrix, so valid for the nonsymmetric case too)."""
    Yv = cx.einsum("...ij,...j->...i", Y, v)
    return _dot(v.conj(), Yv) / _dot(v.conj(), v)


def _shift_solve(Y: Cx, lam: Cx, v: Cx, relax: float = 1e-9) -> Cx:
    """One step of SHIFTED inverse iteration,
    ``v <- normalize((Y − (1+relax)·lam·I)⁻¹ v)``.

    The ``relax`` backoff keeps the shifted matrix safely nonsingular
    once ``lam`` is exact to fp (an exactly singular LU can produce
    inf/nan and silently lose the step) while the target mode is still
    amplified ~``1/relax`` per step over its neighbors; a non-finite
    fallback keeps the batch safe regardless.
    """
    n = Y.shape[-1]
    idx = jnp.arange(n)
    sh = lam * (1.0 + relax)
    Ys = Cx(Y.re.at[..., idx, idx].add(-sh.re[..., None]),
            Y.im.at[..., idx, idx].add(-sh.im[..., None]))
    u = _normalize(cx.solve(Ys, v))
    ok = (jnp.isfinite(u.re).all(-1, keepdims=True)
          & jnp.isfinite(u.im).all(-1, keepdims=True))
    return cx.where(ok, u, v)


def critical_mode(Y: Cx, iters: int = 24, refine: int = 2,
                  symmetric: bool = False) -> CriticalMode:
    """Smallest-|lambda| eigenpair of ``Y`` (..., n, n) by batched inverse
    iteration (one split-complex block solve per step) plus ``refine``
    Rayleigh-shifted refinement steps.

    The plain phase converges at ratio |lambda_1/lambda_2| per step —
    fast exactly where RMA matters (near a resonance the critical mode
    is far smaller than the rest); the shifted steps then polish even
    closely spaced modes to fp noise.  ``symmetric=True`` skips the
    left-eigenvector solve and sets ``w = v`` — exact for reciprocal
    networks (no phase-shifting transformer in service), whose ``Y(h)``
    is symmetric.  A large ``residual`` flags the one failure mode
    (|lambda_1| = |lambda_2| exactly, e.g. two identical decoupled
    resonant circuits) that no iteration count separates.
    """
    v = _inverse_iteration(Y, iters)
    lam = _rayleigh(Y, v)
    for _ in range(refine):
        v = _shift_solve(Y, lam, v)
        lam = _rayleigh(Y, v)
    v = _fix_phase(v)
    if symmetric:
        w = v
    else:
        # the shifted solve targets lam's mode from any non-orthogonal
        # start, so the left vector needs no long unshifted phase
        Yt = Y.transpose(*range(Y.ndim - 2), Y.ndim - 1, Y.ndim - 2)
        w = v.conj()
        for _ in range(max(refine, 2)):
            w = _shift_solve(Yt, lam, w)
        w = _fix_phase(w)
    Yv = cx.einsum("...ij,...j->...i", Y, v)
    res = Yv - v * lam[..., None]
    residual = jnp.sqrt(jnp.sum(res.abs2(), axis=-1)) / lam.abs()
    wv = _dot(w, v)
    participation = (v * w) / wv[..., None]
    return CriticalMode(lam=lam, v=v, w=w, participation=participation,
                        residual=residual)


class ModalScan(NamedTuple):
    """Result of :func:`modal_scan` over ``K`` grid orders on an ``n``-bus
    network: the per-order critical mode of the (slack-grounded) ``Y``.

    ``order``: (K,) the scanned harmonic orders.  ``z_modal``: (K,) modal
    impedance ``1/|lambda_min|``.  ``lam``: (K,) critical eigenvalues.
    ``participation``: (K, n) |PF| per bus, slack row re-embedded as 0
    when the scan grounded it.  ``critical_bus``: (K,) argmax-|PF| bus.
    ``residual``: (K,) eigen-residuals (see :class:`CriticalMode`).
    """
    order: jnp.ndarray
    z_modal: jnp.ndarray
    lam: Cx
    participation: jnp.ndarray
    critical_bus: jnp.ndarray
    residual: jnp.ndarray


def modal_scan(net: Network, settings: Settings,
               h_grid: Optional[Sequence[float]] = None, devices=None,
               ground_slack: bool = True, iters: int = 24,
               symmetric: Optional[bool] = None) -> ModalScan:
    """Resonance-mode scan: the critical eigenpair of ``Y(h)`` over a
    dense order grid (default: ``settings.harmonics``).

    The modal twin of :func:`hpfx.impedance.frequency_scan`: peaks of
    ``z_modal`` over the grid are the parallel resonances, and unlike
    the driving-point scan each peak comes with the bus participation
    vector that localizes it.  ``devices`` folds the installed
    converters' Norton h-diagonal in for the operational picture
    (interpolated onto off-grid orders, as in ``frequency_scan``).

    ``ground_slack`` removes the slack row/column before the
    eigensolve (the stiff-grid short, :func:`hpfx.impedance.
    impedance_scan` convention) and re-embeds zeros in the returned
    participation.  ``symmetric`` defaults to auto: True when no line
    carries a phase shift (reciprocal ``Y``), halving the solve count.
    One jittable program; grid values static.
    """
    if h_grid is None:
        h_grid = settings.harmonics
    if symmetric is None:
        symmetric = bool(np.all(np.asarray(net.line_shift) == 0.0))
    _, Y = grid_ybus(net, settings, h_grid, devices=devices)
    if ground_slack:
        Y = Y[:, 1:, 1:]
    mode = critical_mode(Y, iters=iters, symmetric=symmetric)
    pf = mode.participation.abs()
    if ground_slack:
        pf = jnp.pad(pf, ((0, 0), (1, 0)))
    rd = settings.real_dtype
    return ModalScan(order=jnp.asarray([float(h) for h in h_grid], rd),
                     z_modal=mode.z_modal, lam=mode.lam,
                     participation=pf,
                     critical_bus=jnp.argmax(pf, axis=-1),
                     residual=mode.residual)


def modal_peaks(scan: ModalScan) -> Tuple[jnp.ndarray, jnp.ndarray,
                                          jnp.ndarray]:
    """Resonant orders from a :func:`modal_scan`.

    Returns ``(is_peak, h_res, bus_res)``: the (K,) strict-local-maximum
    mask of ``z_modal`` over the grid (endpoints count when they
    dominate their single neighbor), the order of the global maximum,
    and the critical (max-participation) bus there.
    """
    z = scan.z_modal
    up = jnp.concatenate([jnp.ones_like(z[:1], bool), z[1:] > z[:-1]])
    down = jnp.concatenate([z[:-1] > z[1:], jnp.ones_like(z[:1], bool)])
    k = jnp.argmax(z)
    return up & down, scan.order[k], scan.critical_bus[k]


def eigen_sensitivity(net: Network, settings: Settings, order: float,
                      devices=None, ground_slack: bool = True,
                      iters: int = 24, symmetric: Optional[bool] = None):
    """First-order sensitivities of the critical eigenvalue at ``order``
    to every line/shunt parameter: ``d lambda / d p = w^T (dY/dp) v /
    (w^T v)`` with the eigenvectors frozen (exact at the evaluation
    point for a simple eigenvalue — standard eigenvalue perturbation).

    Returns ``(lam, sens)`` where ``sens`` maps parameter name
    (``line_R``, ``line_X``, ``line_B``, ``bus_Xsh``) to a dict with
    ``dlam`` (split-complex per-element sensitivity, shaped like the
    parameter) and ``dz_modal`` (the induced change of the modal
    impedance ``1/|lambda|`` per unit parameter change — the planner's
    ranking: most-negative entries are the knobs that damp/move the
    resonance hardest).

    The gradient flows through the same vectorized assembly the solver
    uses (:func:`hpfx.ybus.build_ybus`), evaluated at the single
    ``order``; ``devices``' Norton diagonal (a constant wrt network
    parameters) is folded in before the eigensolve so the sensitivities
    describe the operational mode.
    """
    one = settings.with_(harmonics=(float(order),))
    if symmetric is None:
        symmetric = bool(np.all(np.asarray(net.line_shift) == 0.0))

    yn = None
    if devices is not None and devices.n_devices:
        yn0 = _norton_diag(devices)
        h0 = jnp.asarray(settings.harmonics, settings.real_dtype)
        hq = jnp.asarray([float(order)], settings.real_dtype)
        yn = Cx(jax.vmap(lambda y: jnp.interp(hq, h0, y))(yn0.re),
                jax.vmap(lambda y: jnp.interp(hq, h0, y))(yn0.im))

    def assemble(params):
        n2 = dataclasses.replace(net, **params)
        Y = build_ybus(n2, one)
        if yn is not None:
            Y = _fold_norton(Y, n2, yn)
        if ground_slack:
            Y = Y[:, 1:, 1:]
        return Y[0]

    params0 = {k: getattr(net, k)
               for k in ("line_R", "line_X", "line_B", "bus_Xsh")}
    Y0 = assemble(params0)
    mode = critical_mode(Y0, iters=iters, symmetric=symmetric)
    v, w = mode.v, mode.w
    wv = _dot(w, v)

    def lam_fn(params):
        Yp = assemble(params)
        lam = _dot(w, cx.einsum("...ij,...j->...i", Yp, v)) / wv
        return lam.re, lam.im

    (dre, dim) = jax.jacrev(lam_fn)(params0)
    lam = mode.lam
    a2 = lam.abs2()
    sens = {}
    for k in params0:
        dlam = Cx(dre[k], dim[k])
        # d(1/|lam|)/dp = -(lam_re·dre + lam_im·dim) / |lam|^3
        dz = -(lam.re * dlam.re + lam.im * dlam.im) / (a2 * jnp.sqrt(a2))
        sens[k] = {"dlam": dlam, "dz_modal": dz}
    return lam, sens


def modal_spectrum(Y) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side FULL modal decomposition of one admittance matrix (the
    offline-study companion and the test oracle for the device-path
    :func:`critical_mode`).

    ``Y``: (n, n) split-complex ``Cx`` or numpy complex array.  Returns
    ``(lam, V, PF)`` sorted by ascending |lambda|: eigenvalues (n,),
    right eigenvectors as columns (n, n), and the participation matrix
    ``PF[b, m]`` of bus b in mode m (columns sum to 1).  numpy LAPACK —
    do not call inside jit.
    """
    if isinstance(Y, Cx):
        Y = np.asarray(Y.re) + 1j * np.asarray(Y.im)
    lam, V = np.linalg.eig(Y)
    # left eigenvectors from the inverse: Y = V diag(lam) V^{-1}
    # => rows of V^{-1} are the (bilinearly normalized) left vectors
    W = np.linalg.inv(V)
    order = np.argsort(np.abs(lam))
    lam, V, W = lam[order], V[:, order], W[order, :]
    PF = V * W.T                       # (v ⊙ w)/(w^T v) with w^T v = 1
    return lam, V, PF
