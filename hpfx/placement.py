"""Shunt-filter placement screening and greedy bank planning.

The reference stops at analyzing a fixed network (hcne_generalized.py
solves one topology; its only mitigation knob is editing the CSV).  The
planning question practitioners actually face is *where* to put a filter
and *which* standard design to use — a discrete grid of (bus, tuned
order, capacitor size, topology) candidates, each of which requires a
full harmonic power flow to evaluate honestly (a filter detunes every
resonance and re-routes harmonic current through the feeder; see
CLAUDE.md #15).

Batched shape: the candidate grid IS a batch axis.  A shunt filter
only touches the Ybus *diagonal*, so every candidate rides the solvers'
``Y_diag`` threading (hpfx.loadmodel's channel — the stable line-
structured mismatch stays exactly valid) as a one-hot outer product,
and the whole screen is ONE ``jax.vmap`` of the full :func:`hpfx.
harmonic.hpf` over the candidate axis — the same pattern as
hpfx.contingency's N-1 screen.  Combinatorial placement becomes a
single compiled program instead of the serial re-solve loop a
CPU/pandas design forces.

Complements :func:`hpfx.optimize.optimize_filter`: the screen ranks the
*discrete* design space (standard sizes, catalogue topologies, any bus);
the optimizer then polishes the winner's continuous parameters.
:func:`plan_filter_bank` chains screens greedily — install the best
candidate, re-screen the remainder — which is how multi-filter schemes
are actually staged (each installation shifts every resonance, so
re-screening matters; a one-shot top-K pick is wrong).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .config import Settings
from .cx import Cx
from .harmonic import hpf
from .impedance import (ctype_filter_admittance, highpass_filter_admittance,
                        tuned_filter_admittance)
from .network import Network
from .results import get_thd

__all__ = ["PlacementReport", "FilterPlan", "dominant_orders",
           "screen_filter_placement", "plan_filter_bank",
           "filter_ydiag"]

_TOPOLOGIES = {
    "tuned": tuned_filter_admittance,
    "highpass": highpass_filter_admittance,
    "ctype": ctype_filter_admittance,
}


class PlacementReport(NamedTuple):
    """Ranked outcome of :func:`screen_filter_placement` (K candidates).

    ``order`` ranks candidates best-first: accepted candidates sorted by
    ``objective`` ascending, then rejected ones (non-converged or outside
    the fundamental-voltage window) in original order.  ``q_fund`` is the
    fundamental reactive power the branch *supplies* (positive =
    capacitive var injection, the usual filter side-benefit);
    ``i_rms_ratio`` = branch I_rms/I_1 — the harmonic current duty that
    sizes the capacitor (the C57.110 concern, hpfx.flows.k_factor)."""
    bus: np.ndarray            # (K,) int
    h_tune: np.ndarray         # (K,) tuned/corner order
    x_cap: np.ndarray          # (K,) fundamental capacitive reactance [pu]
    topology: str
    converged: np.ndarray      # (K,) bool
    accepted: np.ndarray       # (K,) bool: converged AND v-window
    objective: np.ndarray      # (K,) screened objective (default worst THD)
    thd_worst: np.ndarray      # (K,) worst-bus THD_F with the filter
    thd_at_bus: np.ndarray     # (K,) THD_F at the filter bus
    base_objective: float
    base_thd_worst: float
    v1_bus: np.ndarray         # (K,) fundamental |V| at the filter bus
    q_fund: np.ndarray         # (K,) fundamental vars supplied [pu]
    i_rms_ratio: np.ndarray    # (K,) branch I_rms / I_fund
    order: np.ndarray          # (K,) candidate indices, best first

    @property
    def best(self) -> int:
        """Index of the best *accepted* candidate (raises if none)."""
        i = int(self.order[0])
        if not bool(self.accepted[i]):
            raise ValueError("no accepted candidate in this screen")
        return i


def filter_ydiag(net: Network, settings: Settings, bus, h_tune, x_cap,
                 quality: float = 30.0, topology: str = "tuned") -> Cx:
    """Per-bus diagonal admittance (H, n) of shunt filter branch(es) —
    the ``Y_diag`` override installing them into any solver entry point.
    Scalars give one branch; length-K arrays a bank (summed per bus)."""
    fn = _TOPOLOGIES[topology]
    bus = jnp.atleast_1d(jnp.asarray(bus, jnp.int32))
    y = fn(settings, jnp.atleast_1d(jnp.asarray(h_tune)),
           jnp.atleast_1d(jnp.asarray(x_cap)), quality)     # (K, H)
    onehot = jax.nn.one_hot(bus, net.n, dtype=y.re.dtype)   # (K, n)
    return Cx(jnp.einsum("kh,kn->hn", y.re, onehot),
              jnp.einsum("kh,kn->hn", y.im, onehot))


def dominant_orders(net: Network, devices, settings: Settings,
                    k: int = 3, base=None) -> np.ndarray:
    """The ``k`` harmonic orders with the largest base-case voltage
    distortion (max over buses of |V_h|) — the natural tuning targets.
    ``base``: a pre-solved base-case :class:`hpfx.harmonic.HPFResult`."""
    if base is None:
        base = jax.jit(lambda: hpf(net, devices, settings))()
    vm = np.asarray(base.V_m)                   # (H, n)
    worst = vm[1:].max(axis=1)                  # skip the fundamental
    orders = np.asarray(settings.harmonics[1:])
    top = np.argsort(worst)[::-1][:k]
    return np.sort(orders[top])


def screen_filter_placement(
    net: Network, devices, settings: Settings, *,
    buses: Optional[Sequence[int]] = None,
    h_tunes: Optional[Sequence[float]] = None,
    x_caps: Sequence[float] = (0.5, 1.0, 2.0),
    quality: float = 30.0, topology: str = "tuned", detune: float = 0.97,
    objective: Optional[Callable] = None,
    v_limits=(0.5, 2.0), Y_diag: Optional[Cx] = None,
) -> PlacementReport:
    """Screen every (bus, h_tune, x_cap) candidate with ONE vmapped full
    HPF and rank by ``objective`` (default: worst-bus THD_F).

    Defaults: ``buses`` = every non-slack bus; ``h_tunes`` = the three
    :func:`dominant_orders` of the base case times ``detune`` (real
    designs tune slightly below the harmonic to protect the capacitor
    from detuning drift — the classic 4.85 "fifth-harmonic" filter).

    ``objective(V_m, V_a) -> scalar`` is evaluated host-side on the
    solved (H, n) state of each candidate.  ``v_limits`` is the same
    collapse guard as :func:`hpfx.optimize.optimize_filter`: a candidate
    whose fundamental voltage leaves the window at ANY bus is rejected,
    because a pure-THD objective has a degenerate minimum at voltage
    collapse (measured, CLAUDE.md #15).

    ``Y_diag``: pre-existing per-bus diagonal admittance (H, n) — prior
    filters from :func:`plan_filter_bank` and/or a hpfx.loadmodel damping
    model — added to every candidate AND the base case.
    """
    if topology not in _TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}: "
                         f"use one of {sorted(_TOPOLOGIES)}")
    rd = settings.real_dtype
    base = jax.jit(lambda: hpf(net, devices, settings, Y_diag=Y_diag))()
    if buses is None:
        buses = list(range(1, net.n))
    if h_tunes is None:
        h_tunes = detune * dominant_orders(net, devices, settings,
                                           base=base)
    bus_g, ht_g, xc_g = (a.ravel() for a in np.meshgrid(
        np.asarray(buses, np.int32), np.asarray(h_tunes, np.float64),
        np.asarray(x_caps, np.float64), indexing="ij"))
    K = bus_g.size

    y_f = _TOPOLOGIES[topology](settings, jnp.asarray(ht_g, rd),
                                jnp.asarray(xc_g, rd), quality)  # (K, H)
    onehot = jax.nn.one_hot(jnp.asarray(bus_g), net.n, dtype=rd)  # (K, n)
    yd = Cx(y_f.re[:, :, None] * onehot[:, None, :],
            y_f.im[:, :, None] * onehot[:, None, :])             # (K, H, n)
    if Y_diag is not None:
        yd = Cx(yd.re + Y_diag.re, yd.im + Y_diag.im)

    def one(yd_re, yd_im):
        res = hpf(net, devices, settings, Y_diag=Cx(yd_re, yd_im))
        return res.converged, res.V_m, res.V_a

    conv, V_m, V_a = jax.jit(jax.vmap(one))(yd.re, yd.im)
    conv = np.asarray(conv)
    V_m, V_a = np.asarray(V_m), np.asarray(V_a)       # (K, H, n)

    # duty at the branch: I(h) = y_f(h) · V(h, bus)
    vm_bus = V_m[np.arange(K), :, bus_g]              # (K, H)
    i_mag = np.asarray(y_f.abs()) * vm_bus
    i1 = np.maximum(i_mag[:, 0], 1e-30)
    i_rms_ratio = np.sqrt((i_mag ** 2).sum(axis=1)) / i1
    q_fund = vm_bus[:, 0] ** 2 * np.asarray(y_f.im[:, 0])

    if objective is None:
        def objective(V_m, V_a):
            return float(np.max(np.asarray(get_thd(jnp.asarray(V_m)).THD_F)))
    obj = np.array([objective(V_m[k], V_a[k]) for k in range(K)])
    thd = np.stack([np.asarray(get_thd(jnp.asarray(V_m[k])).THD_F)
                    for k in range(K)])               # (K, n)
    accepted = conv.copy()
    if v_limits is not None:
        v1 = V_m[:, 0, :]                             # (K, n)
        accepted &= (v1 >= v_limits[0]).all(axis=1) \
            & (v1 <= v_limits[1]).all(axis=1)

    # rank: accepted by objective ascending, then the rejects
    key = np.where(accepted, obj, np.inf)
    order = np.argsort(key, kind="stable")
    base_thd = np.asarray(get_thd(base.V_m).THD_F)
    return PlacementReport(
        bus=bus_g, h_tune=ht_g, x_cap=xc_g, topology=topology,
        converged=conv, accepted=accepted, objective=obj,
        thd_worst=thd.max(axis=1), thd_at_bus=thd[np.arange(K), bus_g],
        base_objective=objective(np.asarray(base.V_m),
                                 np.asarray(base.V_a)),
        base_thd_worst=float(base_thd.max()),
        v1_bus=V_m[np.arange(K), 0, bus_g],
        q_fund=q_fund, i_rms_ratio=i_rms_ratio, order=order)


class FilterPlan(NamedTuple):
    """Outcome of :func:`plan_filter_bank`: the greedily chosen branches
    (parallel arrays, one entry per installed filter), the objective
    trajectory (``history[0]`` = unmitigated), the cumulative ``Y_diag``
    installing the whole bank (feed to any solver entry point), and the
    per-stage :class:`PlacementReport`\\ s."""
    buses: np.ndarray
    h_tunes: np.ndarray
    x_caps: np.ndarray
    topology: str
    history: np.ndarray        # (n_installed + 1,)
    Y_diag: Optional[Cx]
    reports: tuple


def plan_filter_bank(net: Network, devices, settings: Settings, *,
                     n_filters: int = 2, target: Optional[float] = None,
                     Y_diag: Optional[Cx] = None,
                     **screen_kw) -> FilterPlan:
    """Greedy multi-filter placement: screen, install the winner, rescreen.

    Stops early once ``objective <= target`` (e.g. a THD planning level)
    or when no accepted candidate improves on the current state.  Each
    stage's screen sees every previously installed branch through the
    cumulative ``Y_diag`` — resonances shift with each installation, so
    the k-th winner is chosen against the (k-1)-filter network, not the
    base case.  ``screen_kw`` is forwarded to
    :func:`screen_filter_placement` (grids, topology, objective, ...).
    """
    topology = screen_kw.get("topology", "tuned")
    quality = screen_kw.get("quality", 30.0)
    sel_b, sel_h, sel_x, reports = [], [], [], []
    history = None
    for _ in range(n_filters):
        rep = screen_filter_placement(net, devices, settings,
                                      Y_diag=Y_diag, **screen_kw)
        if history is None:
            history = [rep.base_objective]
        if target is not None and history[-1] <= target:
            break
        i = int(rep.order[0])
        if not bool(rep.accepted[i]) or rep.objective[i] >= history[-1]:
            break                     # nothing accepted improves
        reports.append(rep)
        sel_b.append(int(rep.bus[i]))
        sel_h.append(float(rep.h_tune[i]))
        sel_x.append(float(rep.x_cap[i]))
        history.append(float(rep.objective[i]))
        branch = filter_ydiag(net, settings, rep.bus[i], rep.h_tune[i],
                              rep.x_cap[i], quality, topology)
        Y_diag = branch if Y_diag is None else Cx(Y_diag.re + branch.re,
                                                  Y_diag.im + branch.im)
    if history is None:               # n_filters == 0
        rep = screen_filter_placement(net, devices, settings,
                                      Y_diag=Y_diag, **screen_kw)
        history = [rep.base_objective]
    return FilterPlan(buses=np.asarray(sel_b, np.int32),
                      h_tunes=np.asarray(sel_h), x_caps=np.asarray(sel_x),
                      topology=topology, history=np.asarray(history),
                      Y_diag=Y_diag, reports=tuple(reports))
