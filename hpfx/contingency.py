"""Harmonic N-1 contingency screening: line / shunt / device outages.

The reference solves one fixed topology (its Ybus is built once from the
line frame, hcne_generalized.py:132-171, and never varied).  Real
harmonic planning asks the N-1 question: which single outage detunes the
network into a resonance and how far does distortion move?  Losing a
line or a shunt shifts every parallel-resonance frequency; losing a
converter drops injections (and its Norton admittance's damping).

Batched shape: an outage batch IS a batch axis.  Every single-line
outage network has exactly ``L-1`` lines, so the per-outage line arrays
stack into ``(K, L-1)`` tensors and one ``jax.vmap`` of the full
:func:`hpfx.harmonic.hpf` solve (Ybus assembly inside the vmap — the
numerically stable line-structured mismatch stays exactly valid per
outage) runs the whole screen as a single compiled program.  Shunt and
device outages batch the same way over ``bus_Xsh`` rows / injection
scales.

Islanding is decided host-side (union-find over the surviving edges)
before anything is solved: an outage that splits the grid is reported
``islanded`` and excluded from the solve batch — a singular Ybus would
otherwise poison NR honestly but uninformatively.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Settings
from .devices import DeviceSet
from .harmonic import hpf
from .network import Network
from .results import get_thd
from .solve import Scenarios, hpf_sweep


_LINE_FIELDS = ("line_from", "line_to", "line_R", "line_X",
                "line_G", "line_B", "line_tau", "line_shift")


def islanded_lines(net: Network) -> np.ndarray:
    """(L,) bool — True where removing that single line disconnects the
    grid (union-find over the surviving edges; any multi-component
    remainder counts, the slack can no longer reach every bus)."""
    f = np.asarray(net.line_from)
    t = np.asarray(net.line_to)
    L, n = len(f), net.n
    out = np.zeros(L, bool)
    for k in range(L):
        parent = list(range(n))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for j in range(L):
            if j != k:
                ra, rb = find(int(f[j])), find(int(t[j]))
                if ra != rb:
                    parent[ra] = rb
        root = find(0)
        out[k] = any(find(i) != root for i in range(n))
    return out


def _stacked_outage_lines(net: Network, outages: Sequence[int]):
    """Per-field (K, L-1) stacks of the surviving-line arrays."""
    stacks = []
    for name in _LINE_FIELDS:
        arr = np.asarray(getattr(net, name))
        stacks.append(jnp.asarray(np.stack(
            [np.delete(arr, k) for k in outages])))
    return tuple(stacks)


@partial(jax.jit, static_argnames=("settings",))
def _solve_line_outages(net: Network, devices, settings: Settings, stacks):
    def one(*lines):
        net_k = dataclasses.replace(net, **dict(zip(_LINE_FIELDS, lines)))
        res = hpf(net_k, devices, settings)
        thd = get_thd(res.V_m).THD_F
        return res.converged, res.n_iter, thd, res.V_m[0]

    return jax.vmap(one)(*stacks)


class ContingencyReport(NamedTuple):
    """Outcome of an N-1 screen, ranked axes all (K,) unless noted.

    ``outages``: screened element indices (line index / bus index /
    nonlinear-device index).  ``islanded``: outage splits the grid —
    not solved, its rows below are NaN/False.  ``converged``: HPF
    converged on the surviving network.  ``thd`` (K, n): per-bus THD_F
    under each outage; ``base_thd`` (n,): intact-network THD.
    ``worst_thd``: worst-bus THD per outage; ``delta_thd``: increase of
    the worst-bus THD over the intact network (the ranking axis —
    positive means the outage makes distortion worse).  ``v1_min``:
    lowest fundamental magnitude (loading/voltage sanity per outage).
    ``ranking``: outage positions sorted by descending ``delta_thd``
    (islanded/non-converged rows last).
    """
    outages: Tuple[int, ...]
    islanded: np.ndarray
    converged: np.ndarray
    n_iter: np.ndarray
    thd: np.ndarray
    base_thd: np.ndarray
    worst_thd: np.ndarray
    delta_thd: np.ndarray
    v1_min: np.ndarray
    ranking: np.ndarray


def _assemble_report(outages, islanded, conv, n_iter, thd, base_thd,
                     v1_min) -> ContingencyReport:
    K, worst_base = len(outages), float(np.max(base_thd))
    solved = ~np.all(np.isnan(thd), axis=1)
    worst = np.full(K, np.nan)
    if solved.any():
        worst[solved] = np.nanmax(thd[solved], axis=1)
    delta = worst - worst_base
    order = np.argsort(np.where(islanded | ~conv, -np.inf, delta))[::-1]
    return ContingencyReport(
        outages=tuple(int(o) for o in outages), islanded=islanded,
        converged=conv, n_iter=n_iter, thd=thd, base_thd=base_thd,
        worst_thd=worst, delta_thd=delta, v1_min=v1_min,
        ranking=order)


def _base_case(net, devices, settings, base=None):
    res = base if base is not None else hpf(net, devices, settings)
    if not bool(np.asarray(res.converged)):
        raise ValueError("intact-network HPF did not converge — "
                         "contingency deltas would be meaningless")
    return np.asarray(get_thd(res.V_m).THD_F)


def screen_line_outages(net: Network, devices, settings: Settings, *,
                        outages: Optional[Sequence[int]] = None,
                        base=None) -> ContingencyReport:
    """N-1 line-outage screen: solve the full HPF on every surviving
    topology (one vmapped program; Ybus + stable-mismatch structure
    rebuilt per outage inside the batch) and rank outages by how far
    they push the worst-bus THD.

    ``outages``: line indices to screen (default: all L).  ``base``: an
    already-solved intact-network :class:`~hpfx.harmonic.HPFResult` to
    compare against (solved here when omitted).
    """
    sel = list(range(net.n_lines)) if outages is None else \
        [int(k) for k in outages]
    bad = [k for k in sel if not 0 <= k < net.n_lines]
    if bad:
        raise ValueError(f"line indices {bad} out of range "
                         f"(0..{net.n_lines - 1})")
    base_thd = _base_case(net, devices, settings, base)
    isl_all = islanded_lines(net)
    islanded = np.asarray([isl_all[k] for k in sel])
    solvable = [k for k, isl in zip(sel, islanded) if not isl]

    K, n = len(sel), net.n
    conv = np.zeros(K, bool)
    n_iter = np.zeros(K, np.int32)
    thd = np.full((K, n), np.nan)
    v1_min = np.full(K, np.nan)
    if solvable:
        stacks = _stacked_outage_lines(net, solvable)
        c, it, t, v1 = _solve_line_outages(net, devices, settings, stacks)
        pos = [sel.index(k) for k in solvable]
        conv[pos] = np.asarray(c)
        n_iter[pos] = np.asarray(it)
        thd[pos] = np.asarray(t)
        v1_min[pos] = np.asarray(jnp.min(v1, axis=1))
    return _assemble_report(sel, islanded, conv, n_iter, thd, base_thd,
                            v1_min)


@partial(jax.jit, static_argnames=("settings",))
def _solve_shunt_outages(net: Network, devices, settings: Settings,
                         xsh_rows):
    def one(xsh):
        res = hpf(dataclasses.replace(net, bus_Xsh=xsh), devices, settings)
        return (res.converged, res.n_iter, get_thd(res.V_m).THD_F,
                res.V_m[0])

    return jax.vmap(one)(xsh_rows)


def screen_shunt_outages(net: Network, devices, settings: Settings, *,
                         buses: Optional[Sequence[int]] = None,
                         base=None) -> ContingencyReport:
    """N-1 shunt-outage screen: for each bus carrying a shunt reactance
    (``X_sh != 0`` — the reference's harmonic-frequency bus shunts,
    hcne_generalized.py:157-161), solve with that shunt removed.

    Losing a compensation shunt is the classic resonance-shift
    contingency: the parallel-resonant order moves and a previously
    quiet harmonic can land on it.  ``buses`` defaults to every bus with
    a nonzero ``X_sh``.  Shunt removal never islands anything.
    """
    xsh = np.asarray(net.bus_Xsh)
    sel = [int(b) for b in (buses if buses is not None
                            else np.flatnonzero(xsh != 0.0))]
    bad = [b for b in sel if not 0 <= b < net.n]
    if bad:
        raise ValueError(f"bus indices {bad} out of range (0..{net.n - 1})")
    off = [b for b in sel if xsh[b] == 0.0]
    if off:
        raise ValueError(f"buses {off} carry no shunt (X_sh == 0) — "
                         "nothing to outage")
    base_thd = _base_case(net, devices, settings, base)
    rows = np.tile(xsh, (len(sel), 1))
    rows[np.arange(len(sel)), sel] = 0.0
    c, it, t, v1 = _solve_shunt_outages(net, devices, settings,
                                        jnp.asarray(rows))
    return _assemble_report(
        sel, np.zeros(len(sel), bool), np.asarray(c), np.asarray(it),
        np.asarray(t), base_thd, np.asarray(jnp.min(v1, axis=1)))


def device_outage_scenarios(net: Network, settings: Settings, *,
                            devices_out: Optional[Sequence[int]] = None
                            ) -> Tuple[Scenarios, Tuple[int, ...]]:
    """Scenario set whose k-th row trips nonlinear device k (its
    injection scale 0, everyone else 1) — feed to any sweep
    (:func:`hpfx.solve.hpf_sweep` and friends) for the device-outage
    screen with all the usual batching machinery.

    Tripping a converter removes its injections AND its Norton
    admittance's damping contribution at once (``DeviceSet.scale``
    scales the whole equivalent).  Caveat: on a single-device network
    the outage leaves every harmonic sourceless, whose exact solution
    ``V_h = 0`` is singular in polar coordinates (the hosting-capacity
    level-0 physics) — NR honestly reports
    non-convergence there; this requires >= 2 devices to be meaningful.
    """
    n_nl = net.n_nonlinear
    sel = list(range(n_nl)) if devices_out is None \
        else [int(d) for d in devices_out]
    bad = [d for d in sel if not 0 <= d < n_nl]
    if bad:
        raise ValueError(f"device indices {bad} out of range "
                         f"(0..{n_nl - 1})")
    rd = settings.real_dtype
    inj = np.ones((len(sel), n_nl), dtype=np.dtype(rd))
    inj[np.arange(len(sel)), sel] = 0.0
    scen = Scenarios(p_scale=jnp.ones((len(sel),), rd),
                     q_scale=jnp.ones((len(sel),), rd),
                     injection_scale=jnp.asarray(inj))
    return scen, tuple(sel)


@partial(jax.jit, static_argnames=("settings", "operational"))
def _scan_line_outages(net: Network, devices, settings: Settings,
                       stacks, operational: bool):
    from .impedance import driving_point_impedance

    def one(*lines):
        net_k = dataclasses.replace(net, **dict(zip(_LINE_FIELDS, lines)))
        return driving_point_impedance(
            net_k, settings, devices=devices if operational else None)

    return jax.vmap(one)(*stacks)


class ResonanceShiftReport(NamedTuple):
    """Impedance-scan view of an N-1 line screen (axes (K,) unless noted).

    ``zmag`` (K, H, n): per-outage driving-point |Z| scans;
    ``base_zmag`` (H, n): the intact network's.  ``amplification``: the
    largest ``|Z_outage| / |Z_base|`` over all harmonic orders > 1 and
    buses — how much MORE impedance some injection order sees after the
    outage (the resonance-shift severity; NaN on islanded rows);
    ``shift_order`` / ``shift_bus``: where that worst amplification
    lands.  ``ranking``: outage positions by descending amplification.
    """
    outages: Tuple[int, ...]
    islanded: np.ndarray
    zmag: np.ndarray
    base_zmag: np.ndarray
    amplification: np.ndarray
    shift_order: np.ndarray
    shift_bus: np.ndarray
    ranking: np.ndarray


def outage_impedance_shift(net: Network, devices, settings: Settings, *,
                           outages: Optional[Sequence[int]] = None,
                           operational: bool = True
                           ) -> ResonanceShiftReport:
    """Resonance-shift screen: driving-point impedance scans
    (:func:`hpfx.impedance.driving_point_impedance`) under every N-1
    line outage, ranked by how much an outage amplifies the impedance
    some harmonic injection sees.

    The THD screen (:func:`screen_line_outages`) answers "how bad did it
    get for TODAY's devices"; this answers the planning question "which
    outage moves a parallel resonance toward an injection order" —
    independent of the current device spectra.  ``operational`` folds
    the installed Norton admittances into the scans (their damping is
    part of the in-service resonance picture); slack grounded as usual.
    """
    sel = list(range(net.n_lines)) if outages is None else \
        [int(k) for k in outages]
    bad = [k for k in sel if not 0 <= k < net.n_lines]
    if bad:
        raise ValueError(f"line indices {bad} out of range "
                         f"(0..{net.n_lines - 1})")
    from .impedance import driving_point_impedance
    base = np.asarray(driving_point_impedance(
        net, settings, devices=devices if operational else None))
    isl_all = islanded_lines(net)
    islanded = np.asarray([isl_all[k] for k in sel])
    solvable = [k for k, isl in zip(sel, islanded) if not isl]

    K, (H, n) = len(sel), base.shape
    zmag = np.full((K, H, n), np.nan)
    if solvable:
        stacks = _stacked_outage_lines(net, solvable)
        z = _scan_line_outages(net, devices, settings, stacks,
                               bool(operational))
        zmag[[sel.index(k) for k in solvable]] = np.asarray(z)

    # slack column is grounded (|Z| = 0); guard the ratio there and at h=1
    safe = np.where(base > 0.0, base, np.inf)
    ratio = zmag / safe[None]
    ratio[:, 0, :] = -np.inf                     # fundamental excluded
    flat = np.where(np.isnan(ratio), -np.inf, ratio).reshape(K, -1)
    amp = flat.max(axis=1)
    pos = flat.argmax(axis=1)
    orders = np.asarray(settings.harmonics)
    shift_order = orders[pos // n]
    shift_bus = pos % n
    amp = np.where(islanded, np.nan, amp)
    order_rank = np.argsort(np.where(islanded, -np.inf, amp))[::-1]
    return ResonanceShiftReport(
        outages=tuple(int(o) for o in sel), islanded=islanded,
        zmag=zmag, base_zmag=base, amplification=amp,
        shift_order=shift_order.astype(np.int32),
        shift_bus=shift_bus.astype(np.int32), ranking=order_rank)


def screen_device_outages(net: Network, devices, settings: Settings, *,
                          devices_out: Optional[Sequence[int]] = None,
                          base=None, sweep=None) -> ContingencyReport:
    """N-1 converter-outage screen (see
    :func:`device_outage_scenarios`); ``sweep`` defaults to
    :func:`hpfx.solve.hpf_sweep`."""
    base_thd = _base_case(net, devices, settings, base)
    scen, sel = device_outage_scenarios(net, settings,
                                        devices_out=devices_out)
    run = sweep if sweep is not None else hpf_sweep
    res = run(net, devices, settings, scen)
    thd = np.asarray(jax.vmap(lambda v: get_thd(v).THD_F)(res.V_m))
    return _assemble_report(
        sel, np.zeros(len(sel), bool), np.asarray(res.converged),
        np.asarray(res.n_iter, np.int32), thd, base_thd,
        np.asarray(jnp.min(res.V_m[:, 0, :], axis=1)))


@partial(jax.jit, static_argnames=("settings",))
def _solve_line_outage_sweep(net: Network, devices, settings: Settings,
                             stacks, p_scale, q_scale, inj_scale):
    """(outage × scenario) cross as ONE compiled program: outer vmap
    over the stacked surviving-line arrays, inner vmap over the
    load/injection draws — a K·S-wide batch instead of the K-wide screen
    that leaves an accelerator mostly idle."""

    def one_outage(*lines):
        net_k = dataclasses.replace(net, **dict(zip(_LINE_FIELDS, lines)))

        def one_scen(p, q, i):
            net_s = dataclasses.replace(
                net_k,
                bus_P=net_k.bus_P * p,
                bus_Q=net_k.bus_Q * q)
            res = hpf(net_s, devices.scale(i), settings)
            thd = get_thd(res.V_m).THD_F
            return (res.converged, res.n_iter, jnp.max(thd),
                    jnp.min(res.V_m[0]))

        return jax.vmap(one_scen)(p_scale, q_scale, inj_scale)

    return jax.vmap(one_outage)(*stacks)


class ContingencySweepReport(NamedTuple):
    """(outage × scenario) screen outcome; K outages, S scenarios.

    ``converged`` (K, S); ``worst_thd`` (K, S): worst-bus THD_F per
    (outage, draw); ``base_worst`` (S,): intact network under the same
    draws; ``delta_q`` (K,): the ``quantile`` over draws of the
    worst-bus THD increase (the planning-level ranking axis — "under
    this outage, distortion rises by at least this much in q of load
    situations"); ``conv_frac`` (K,); islanded rows NaN/False.
    ``ranking``: outage positions by descending ``delta_q``.

    ``infeasible`` (K, S): only populated by
    ``verify_infeasible=True`` — unconverged pairs re-solved cold in
    float64 on the default device; True where even f64 finds no solution
    (a genuine power-flow infeasibility of the weakened topology, the
    screen's strongest signal), False where the f64 pass recovered the
    pair (its row is merged back as converged).  All-False otherwise.
    """
    outages: Tuple[int, ...]
    islanded: np.ndarray
    converged: np.ndarray
    n_iter: np.ndarray
    worst_thd: np.ndarray
    base_worst: np.ndarray
    delta_q: np.ndarray
    conv_frac: np.ndarray
    ranking: np.ndarray
    infeasible: np.ndarray


def _verify_infeasible_pairs(net: Network, devices, settings: Settings,
                             sel, p, q, inj, conv, islanded, worst,
                             n_iter):
    """Re-solve every unconverged non-islanded (outage, draw) pair cold
    in f64 on the default device.  Pairs that converge there are merged
    back (the f32 knife-edge class); pairs that fail even in f64 are a
    genuine power-flow infeasibility of the weakened topology.  One
    compiled f64 program serves every outage (the surviving-line arrays
    are data, not shapes).  Returns the updated (conv, worst, n_iter,
    infeasible)."""
    import jax

    from .results import get_thd as _thd
    from .solve import _to64

    infeasible = np.zeros_like(conv)
    bad = np.argwhere(~conv & ~islanded[:, None])
    if bad.size == 0:
        return conv, worst, n_iter, infeasible
    s64 = settings.with_(dtype="float64")
    with jax.enable_x64():
        net64 = _to64(net)
        dev64 = _to64(devices)
        p64 = np.asarray(p, np.float64)
        q64 = np.asarray(q, np.float64)
        i64 = np.asarray(inj, np.float64)
        for k_idx, s_idx in bad:
            keep = np.delete(np.arange(net.n_lines), sel[int(k_idx)])
            net_k = dataclasses.replace(
                net64,
                **{f: jnp.asarray(np.asarray(getattr(net64, f))[keep])
                   for f in _LINE_FIELDS},
                bus_P=net64.bus_P * p64[s_idx],
                bus_Q=net64.bus_Q * q64[s_idx])
            res = hpf(net_k, dev64.scale(jnp.asarray(i64[s_idx])), s64)
            if bool(np.asarray(res.converged)):
                conv[k_idx, s_idx] = True
                worst[k_idx, s_idx] = float(
                    np.max(np.asarray(_thd(res.V_m).THD_F)))
                n_iter[k_idx, s_idx] += int(np.asarray(res.n_iter))
            else:
                infeasible[k_idx, s_idx] = True
    return conv, worst, n_iter, infeasible


def screen_line_outages_sweep(net: Network, devices, settings: Settings,
                              scenarios: Scenarios, *,
                              outages: Optional[Sequence[int]] = None,
                              quantile: float = 0.95,
                              verify_infeasible: bool = False
                              ) -> ContingencySweepReport:
    """N-1 line screen crossed with a scenario sweep: every (outage,
    load/injection draw) pair solves in one vmapped full-HPF program.

    The single-case screen answers "does outage k worsen distortion at
    nominal load"; planning needs "in what fraction of operating points"
    — and the K·S-wide batch is also what makes the screen an
    accelerator workload (the reference has no topology variation at all: its Ybus
    is built once, hcne_generalized.py:132-171).  ``scenarios``: the
    (S,) load/injection draws (hpfx.solve.Scenarios; device_mix not
    supported here).  ``quantile``: ranking quantile over draws.
    ``verify_infeasible``: re-solve unconverged pairs cold in f64 on
    the default device — recovered pairs merge back as converged (the f32
    knife-edge class), the rest are reported ``infeasible`` (genuine
    power-flow infeasibility of the weakened topology, f64-confirmed).
    """
    if scenarios.device_mix is not None:
        raise ValueError("screen_line_outages_sweep does not support "
                         "device_mix scenarios")
    sel = list(range(net.n_lines)) if outages is None else \
        [int(k) for k in outages]
    bad = [k for k in sel if not 0 <= k < net.n_lines]
    if bad:
        raise ValueError(f"line indices {bad} out of range "
                         f"(0..{net.n_lines - 1})")
    q = scenarios.q_scale if scenarios.q_scale is not None \
        else scenarios.p_scale
    inj = scenarios.injection_scale if scenarios.injection_scale \
        is not None else jnp.ones_like(scenarios.p_scale)
    S = scenarios.p_scale.shape[0]

    # intact network under the same draws (the delta baseline)
    base = hpf_sweep(net, devices, settings, scenarios)
    base_thd = get_thd(jnp.moveaxis(base.V_m, 0, -1)).THD_F  # (n, S)
    base_worst = np.asarray(jnp.max(base_thd, axis=0))       # (S,)

    isl_all = islanded_lines(net)
    islanded = np.asarray([isl_all[k] for k in sel])
    solvable = [k for k, isl in zip(sel, islanded) if not isl]

    K = len(sel)
    conv = np.zeros((K, S), bool)
    n_iter = np.zeros((K, S), np.int32)
    worst = np.full((K, S), np.nan)
    if solvable:
        stacks = _stacked_outage_lines(net, solvable)
        c, it, w, _ = _solve_line_outage_sweep(
            net, devices, settings, stacks, scenarios.p_scale, q, inj)
        pos = [sel.index(k) for k in solvable]
        conv[pos] = np.asarray(c)
        n_iter[pos] = np.asarray(it)
        worst[pos] = np.asarray(w)

    infeasible = np.zeros((K, S), bool)
    if verify_infeasible:
        conv, worst, n_iter, infeasible = _verify_infeasible_pairs(
            net, devices, settings, sel, scenarios.p_scale, q, inj,
            conv, islanded, worst, n_iter)

    with np.errstate(invalid="ignore"):
        delta = worst - base_worst[None, :]
        delta_q = np.nanquantile(
            np.where(conv, delta, np.nan), float(quantile), axis=1)
    conv_frac = conv.mean(axis=1)
    order = np.argsort(np.where(islanded | (conv_frac == 0),
                                -np.inf, delta_q))[::-1]
    return ContingencySweepReport(
        outages=tuple(int(o) for o in sel), islanded=islanded,
        converged=conv, n_iter=n_iter, worst_thd=worst,
        base_worst=base_worst, delta_q=delta_q, conv_frac=conv_frac,
        ranking=order, infeasible=infeasible)
