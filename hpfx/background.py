"""Background (upstream) harmonic distortion at the grid connection.

The reference models the external grid as an ideally sinusoidal slack:
the slack bus fixes only the FUNDAMENTAL voltage (state cropping at
hcne_generalized.py:393-398), while its harmonic rows are ordinary
current-balance equations fed by the grid short-circuit reactance
``X_sh`` that the bus CSV carries (net2_buses.csv row 1) and
``build_ybus`` folds into the harmonic diagonals as 1/(j·X_sh·h)
(hcne_generalized.py:157-161).  Real grids are never clean — utility
planning studies (IEC 61000-3-6 style) superpose a measured *background
spectrum* on top of the installation's own emissions.

This module adds that study axis without touching the solver math: a
background Thevenin voltage ``V_bg(h)`` behind the already-modeled grid
impedance is, by source transformation, a constant Norton current

    I_bg(h) = V_bg(h) · Y_sh(h),      Y_sh(h) = 1/(j·X_sh·h)

injected at the connection bus.  Constant injections enter the harmonic
current balance as an additive term (``hpfx.harmonic.current_balance``)
and leave the Jacobian untouched, so the dense and arrow Newton paths,
warm starts, and convergence accounting all work unchanged.  Pass the
returned ``(H, n)`` split-complex array as ``I_bg=`` to
:func:`hpfx.harmonic.hpf` / :func:`hpfx.solve.hpf_single`.

Conventions:

- the fundamental row (h index 0) must stay ZERO — the fundamental
  boundary condition belongs to the slack equations, not to an
  injection; constructors here enforce it;
- positive ``I_bg`` injects current INTO the bus, the same sign as the
  device Norton currents ``I_N`` (hcne_generalized.py:320-322);
- magnitudes are per-unit on the same base as the network; a "2% fifth
  harmonic background" is ``{5: (0.02, angle)}``.

Batched background studies ride :func:`background_sweep` (the adaptive
schedule + deterministic rescue; on the lane-major fast path the
(B, H, n) injection batch is carried (H, n, B) like the voltage state,
and ``warm="linear"`` folds it into the in-program exact-linear seed),
or pass ``I_bg=`` to ``hpf_sweep`` / ``hpf_sweep_adaptive`` /
``hpf_sweep_device`` directly.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network


def current_source(settings: Settings, n: int, i_bg: Cx,
                   bus: int = 0) -> Cx:
    """Embed a per-harmonic Norton current spectrum at one bus.

    ``i_bg``: (H,) split-complex injected current (fundamental entry must
    be zero).  Returns the dense (H, n) injection tensor the solver takes.
    """
    H = settings.n_harmonics
    rd = settings.real_dtype
    if i_bg.shape != (H,):
        raise ValueError(f"i_bg must have shape ({H},), got {i_bg.shape}")
    f0 = np.hypot(float(i_bg.re[0]), float(i_bg.im[0]))
    if f0 != 0.0:
        raise ValueError("background injection at the fundamental is not "
                         "supported: the fundamental boundary condition "
                         "belongs to the slack equations (set row 0 to 0)")
    out = cx.zeros((H, n), rd)
    return out.at_add((slice(None), bus), i_bg.astype(rd))


def shunt_admittance(net: Network, settings: Settings, bus: int = 0) -> Cx:
    """Grid shunt admittance spectrum Y_sh(h) = 1/(j·X_sh·h) at ``bus``.

    The same law ``build_ybus`` applies to the bus-shunt reactance column
    (hcne_generalized.py:157-161; fundamental entry excluded there and
    zero here).  Raises if the bus carries no shunt — a Thevenin source
    needs the impedance it stands behind.
    """
    x_sh = float(np.asarray(net.bus_Xsh)[bus])
    if x_sh == 0.0:
        raise ValueError(f"bus {bus} has X_sh = 0: no grid impedance to "
                         "transform a Thevenin background source through "
                         "(use current_source with a measured spectrum)")
    rd = settings.real_dtype
    h = jnp.asarray(settings.harmonics, rd)           # (H,) orders, h[0]=1
    im = (-1.0 / (x_sh * h)).at[0].set(0.0)           # 1/(jX) = -j/X
    return Cx(jnp.zeros_like(im), im)


def grid_source(net: Network, settings: Settings, v_bg_m, v_bg_a,
                bus: int = 0) -> Cx:
    """Thevenin background voltage behind the grid impedance, as the
    solver's Norton injection tensor.

    ``v_bg_m``/``v_bg_a``: (H,) per-unit background voltage magnitudes and
    angles (fundamental entries ignored — must be zero in ``v_bg_m``).
    ``bus``: the grid connection (the slack, index 0, in the shipped
    networks).  Returns (H, n) split-complex ``I_bg`` with
    I_bg[h, bus] = V_bg(h) / (j·X_sh(bus)·h).
    """
    rd = settings.real_dtype
    v_m = jnp.asarray(v_bg_m, rd)
    v_a = jnp.asarray(v_bg_a, rd)
    i_bg = cx.polar(v_m, v_a) * shunt_admittance(net, settings, bus)
    return current_source(settings, net.n, i_bg, bus)


def background_from_harmonics(net: Network, settings: Settings,
                              spectrum: Dict[int, Tuple[float, float]],
                              bus: int = 0,
                              as_current: bool = False) -> Cx:
    """Convenience: build a background source from ``{order: (mag, ang)}``.

    ``spectrum`` maps harmonic orders (e.g. 5, 7) to per-unit (magnitude,
    angle) pairs — voltages behind the grid impedance by default, or
    injected currents directly with ``as_current=True``.  Orders not in
    ``settings.harmonics`` raise (a silent drop would understate THD).
    """
    H = settings.n_harmonics
    orders = [int(h) for h in settings.harmonics]
    mag = np.zeros(H)
    ang = np.zeros(H)
    for h, (m_h, a_h) in spectrum.items():
        if int(h) == 1:
            raise ValueError("order 1 is the fundamental — background "
                             "sources are harmonic-only")
        if int(h) not in orders:
            raise ValueError(f"order {h} is not in settings.harmonics "
                             f"(max {orders[-1]})")
        k = orders.index(int(h))
        mag[k], ang[k] = float(m_h), float(a_h)
    if as_current:
        i_bg = cx.polar(jnp.asarray(mag, settings.real_dtype),
                        jnp.asarray(ang, settings.real_dtype))
        return current_source(settings, net.n, i_bg, bus)
    return grid_source(net, settings, mag, ang, bus)


def background_sweep(net: Network, devices, settings: Settings, I_bg: Cx,
                     scenarios=None, phase_iters: int = 16,
                     rescue: bool = True, warm: str = "cold",
                     schedule: str = "auto"):
    """Batched background-distortion study with the full adaptive
    schedule and deterministic straggler rescue.

    ``I_bg``: per-scenario (B, H, n) split-complex Norton injections
    (fundamental rows zero — see the module conventions).  ``scenarios``:
    optional :class:`hpfx.solve.Scenarios` load/injection scales riding
    the same batch axis (defaults to all-ones).  Every phase and rescue
    pass — self-warm-start, cold restart, and the f64 knife-edge
    fallback — threads the matching ``I_bg`` rows, so the study carries
    the same deterministic-convergence contract as the plain sweeps
    (without the rescue, f32 batches of this study leave a few
    knife-edge scenarios unconverged that converge in f64).

    ``schedule``: "device" runs the single-program lane-major schedule
    (:func:`hpfx.solve.hpf_sweep_device` — the background term rides
    the (H, n, B) lane layout and, with ``warm="linear"``, enters the
    in-program exact-linear seed's RHS); "host" the host-driven
    :func:`hpfx.solve.hpf_sweep_adaptive`; "auto" picks device where
    the lanes configuration is supported.
    """
    from .solve import (Scenarios, hpf_sweep_adaptive,  # noqa: PLC0415
                        hpf_sweep_device, uses_lanes)
    B = I_bg.re.shape[0]
    if scenarios is None:
        scenarios = Scenarios.uniform(B, settings.real_dtype)
    use_device = schedule == "device"
    if schedule == "auto":
        use_device = uses_lanes(devices, settings, net)
    if use_device:
        return hpf_sweep_device(net, devices, settings, scenarios,
                                phase_iters=phase_iters, rescue=rescue,
                                warm=warm, I_bg=I_bg)
    return hpf_sweep_adaptive(net, devices, settings, scenarios,
                              phase_iters=phase_iters, rescue=rescue,
                              I_bg=I_bg)
