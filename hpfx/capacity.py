"""Hosting-capacity search: the largest device penetration a feeder can
host while staying harmonic-compliant.

The reference computes single HPF solutions and leaves "how many devices
fit" to the user (its driver prints THD for one hand-edited configuration,
hcne_generalized.py:596-623).  hpfx already carries the two building
blocks — Monte-Carlo batched sweeps (hpfx.solve) and compliance screens
(``solve.summarize_thd``, ``flows.ieee519_screen``) — and this module adds
the study on top: a bisection search over a scalar penetration multiplier
applied to a FIXED set of scenario draws (common random numbers), with the
capacity defined as the largest level at which at least ``confidence`` of
the Monte-Carlo scenarios remain compliant.

Design notes:

- every bisection probe re-enters the SAME jitted sweep program — the
  level only changes ``Scenarios.injection_scale`` *values*, never shapes
  or statics, so the whole search compiles exactly once and each probe is
  a single batched device dispatch;
- probes are cold solves: warm-starting one level from another can track
  a solution branch that cold energization never reaches (CLAUDE.md #15,
  filter-design acceptance) and would bias capacity upward;
- a non-converged scenario counts as NON-compliant — capacity claims are
  made only on solved cases;
- common random numbers (one draw set, scaled per level) make the
  compliance fraction a deterministic function of the level; bisection
  assumes it crosses the confidence threshold ONCE inside the bracket
  (the full probe trace is returned so the assumption can be audited).

Dose-response physics (measured, tests/test_capacity.py): the level
scales I_N and Y_N together (``DeviceSet.scale`` — adding identical
devices in parallel).  For uncoupled NEs the worst-bus THD grows
monotonically with the level, but for coupled NEs it is U-SHAPED: at low
levels the device's own admittance no longer damps the bus, and THD
*rises* as the level drops below nominal (net2: THD 0.66 at 0.25x vs
0.31 at 1x, confirmed a true NR fixed point by warm/cold agreement).
Hence the default bracket anchors at ``lo=1.0`` — "how much can today's
penetration grow" — where compliance at lo certifies the present system.
Exactly level 0.0 is SINGULAR: all-zero harmonic phasors have undefined
angles, the NR Jacobian's dI/dA columns vanish, and the sweep honestly
reports non-convergence (counts as non-compliant); never probe it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import jax.numpy as jnp
import numpy as np

from .config import Settings
from .flows import IEEE519Summary, ieee519_screen
from .network import Network
from .solve import Scenarios, SweepSummary, hpf_sweep, summarize_thd


def monte_carlo_scenarios(seed: int, batch: int, net: Network,
                          settings: Settings, *,
                          p_spread: float = 0.2,
                          inj_spread: float = 0.2,
                          per_device: bool = True) -> Scenarios:
    """Draw a reusable Monte-Carlo scenario set around the nominal case.

    ``p_spread``/``inj_spread``: half-widths of uniform multiplier bands
    around 1.0 for the bus loads and the device injections.  With
    ``per_device`` each nonlinear bus draws its own injection level
    (shape ``(batch, n_nonlinear)``) — the realistic hosting-capacity
    axis; otherwise one scalar per scenario.

    The same draw set should be reused across levels/designs being
    compared (common random numbers): pass it to
    :func:`find_hosting_capacity`, which scales it per probe.
    """
    rng = np.random.default_rng(seed)
    rd = settings.real_dtype
    p = rng.uniform(1.0 - p_spread, 1.0 + p_spread, batch)
    shape = (batch, net.n_nonlinear) if per_device else (batch,)
    inj = rng.uniform(1.0 - inj_spread, 1.0 + inj_spread, shape)
    return Scenarios(p_scale=jnp.asarray(p, rd),
                     q_scale=jnp.asarray(p, rd),
                     injection_scale=jnp.asarray(inj, rd))


def scale_scenarios(scenarios: Scenarios, level,
                    device_mask=None) -> Scenarios:
    """Scenario set at penetration ``level``: the base draws with their
    injection multipliers scaled by ``level``.

    ``device_mask`` (optional, shape ``(n_nonlinear,)``, 0/1 or weights):
    restrict the scaling to a subset of devices — masked devices scale by
    ``level``, unmasked ones keep their base draw.  Answers per-bus
    questions like "how much can the chargers at bus 14 grow while the
    rest of the feeder stays at today's levels".
    """
    inj = scenarios.injection_scale
    if inj is None:
        inj = jnp.ones((scenarios.batch,), scenarios.p_scale.dtype)
    lvl = jnp.asarray(level, inj.dtype)
    if device_mask is None:
        new = inj * lvl
    else:
        mask = jnp.asarray(device_mask, inj.dtype)
        if inj.ndim == 1:
            inj = inj[:, None] * jnp.ones_like(mask)[None, :]
        new = inj * (1.0 + (lvl - 1.0) * mask)
    return scenarios._replace(injection_scale=new)


def compliance_fraction(net: Network, devices, settings: Settings,
                        scenarios: Scenarios, *,
                        criterion: str = "thd",
                        thd_limit: float = 0.08,
                        v_kv: Optional[float] = None,
                        sweep=None):
    """Solve the scenario batch and return ``(frac, summary)`` where
    ``frac`` is the fraction of scenarios that are BOTH converged and
    compliant under the chosen criterion.

    ``criterion``: ``"thd"`` (worst-bus THD_F against ``thd_limit``, the
    screen of ``solve.summarize_thd``) or ``"ieee519"`` (the standard's
    individual-harmonic + THD table limits via ``flows.ieee519_screen``;
    ``v_kv`` selects the voltage class).  ``sweep``: any callable with the
    ``hpf_sweep(net, devices, settings, scenarios)`` signature —
    ``hpf_sweep_adaptive``, ``hpf_sweep_device`` or a mesh-sharded wrapper
    from ``hpfx.parallel`` drop in.
    """
    run = sweep if sweep is not None else hpf_sweep
    res = run(net, devices, settings, scenarios)
    if criterion == "thd":
        summary = summarize_thd(res, thd_limit)
        ok = np.asarray(summary.converged) \
            & (np.asarray(summary.max_thd_f) <= thd_limit)
        frac = float(np.mean(ok))
    elif criterion == "ieee519":
        summary = ieee519_screen(res, settings, v_kv)
        frac = float(np.mean(np.asarray(summary.compliant)))
    else:
        raise ValueError(f"unknown criterion {criterion!r} "
                         "(use 'thd' or 'ieee519')")
    return frac, summary


class HostingCapacityResult(NamedTuple):
    """Outcome of :func:`find_hosting_capacity`.

    ``feasible``: the base system (``lo`` level) meets the confidence
    target at all — when False, ``level`` is NaN and only the endpoint
    probes populate the trace.  ``bracket_open``: the search hit the
    ``hi`` end still compliant, so the true capacity is ``>= level`` and
    a larger ``hi`` would refine it.  ``levels``/``fracs``: every probed
    level and its compliance fraction, in probe order (the Monte-Carlo
    dose-response curve comes for free).  ``summary``: the screen at the
    returned ``level`` (:class:`~hpfx.solve.SweepSummary` for ``"thd"``,
    :class:`~hpfx.flows.IEEE519Summary` for ``"ieee519"``).
    """
    feasible: bool
    level: float
    frac_at_level: float
    levels: Sequence[float]
    fracs: Sequence[float]
    summary: Union[SweepSummary, IEEE519Summary, None]
    bracket_open: bool = False


def find_hosting_capacity(net: Network, devices, settings: Settings,
                          scenarios: Scenarios, *,
                          confidence: float = 0.95,
                          criterion: str = "thd",
                          thd_limit: float = 0.08,
                          v_kv: Optional[float] = None,
                          lo: float = 1.0, hi: float = 4.0,
                          tol: float = 0.01,
                          max_probes: int = 32,
                          device_mask=None,
                          sweep=None) -> HostingCapacityResult:
    """Bisect for the largest penetration level whose compliance fraction
    stays at or above ``confidence``.

    The level multiplies the base draws' injection scaling (see
    :func:`scale_scenarios`; ``device_mask`` restricts it to a device
    subset).  ``[lo, hi]`` brackets the search; probing stops when the
    bracket is narrower than ``tol`` or after ``max_probes`` bisection
    steps.  The returned ``level`` is the largest level actually probed
    compliant (the conservative end of the final bracket).

    ``lo`` defaults to 1.0 (today's penetration) and must stay above
    0.0: the zero-injection system is singular, and for coupled NEs the
    sub-nominal range can be LESS compliant than nominal (the U-shaped
    dose-response in the module docstring), which would break the
    single-crossing assumption if bracketed in.
    """
    levels, fracs = [], []

    def probe(lvl):
        frac, summary = compliance_fraction(
            net, devices, settings,
            scale_scenarios(scenarios, lvl, device_mask),
            criterion=criterion, thd_limit=thd_limit, v_kv=v_kv,
            sweep=sweep)
        levels.append(float(lvl))
        fracs.append(frac)
        return frac, summary

    f_lo, s_lo = probe(lo)
    if f_lo < confidence:
        return HostingCapacityResult(False, float("nan"), f_lo,
                                     levels, fracs, s_lo)
    f_hi, s_hi = probe(hi)
    if f_hi >= confidence:
        return HostingCapacityResult(True, hi, f_hi, levels, fracs, s_hi,
                                     bracket_open=True)
    best, f_best, s_best = lo, f_lo, s_lo
    a, b = lo, hi
    for _ in range(max_probes):
        if b - a <= tol:
            break
        mid = 0.5 * (a + b)
        f, s = probe(mid)
        if f >= confidence:
            a, best, f_best, s_best = mid, mid, f, s
        else:
            b = mid
    return HostingCapacityResult(True, best, f_best, levels, fracs, s_best)
