"""Gradient-based network design optimization on top of the HPF solver.

The reference stops at *analysis* (solve, THD); its only design aid is
manual re-runs.  Because every hpfx solve is differentiable (the
implicit-function-theorem machinery in :mod:`hpfx.sensitivity`), design
questions become first-order optimization:

  - **tap optimization**: set transformer taps / phase shifts to
    minimize distortion (the classical use of
    :func:`hpfx.sensitivity.line_sensitivity` gradients);
  - **reinforcement screening**: how much series-impedance reduction on
    which line buys how much THD.

:func:`optimize_line_params` runs a host-driven first-order loop
(optax optimizer, default adam): solve the full coupled HPF at the
current parameters (warm-started from the previous solution), take the
exact IFT gradient of the objective, update, project onto bounds.  The
two jitted programs (solve, gradient) are traced once — network line
arrays are pytree leaves, so parameter changes never retrace.

This is an offline design tool: the loop is Python (tens of solves),
each solve/gradient is a compiled program.  For very many
design variables the same gradients batch through
:func:`hpfx.sensitivity.sweep_sensitivity` instead.
"""
import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Settings
from .harmonic import hpf
from .network import Network
from .results import get_thd
from .sensitivity import LineParams, line_sensitivity
from .ybus import build_ybus

__all__ = ["OptimizeResult", "optimize_line_params", "apply_line_params",
           "FilterOptResult", "optimize_filter"]

#: default box bounds per LineParams leaf (projection after each step)
DEFAULT_BOUNDS = {
    "z_scale": (0.25, 4.0),     # relative to the network as loaded
    "tau": (0.85, 1.15),        # off-nominal tap range
    "shift_rad": (-np.pi / 3, np.pi / 3),
}


class OptimizeResult(NamedTuple):
    """Outcome of :func:`optimize_line_params`.

    ``params``: the best-found :class:`LineParams` (z_scale relative to
    the INPUT network).  ``net``: the input network with those
    parameters applied — solve it directly to reproduce ``value``.
    ``value``/``value0``: objective at the optimum / at the start.
    ``history``: objective after each accepted step (NaN = solver did
    not converge there, step rejected).  ``n_solves``: HPF solves spent.
    """
    params: LineParams
    net: Network
    value: float
    value0: float
    history: np.ndarray
    n_solves: int


def apply_line_params(net: Network, params: LineParams) -> Network:
    """The input network with ``params`` applied (z_scale multiplies the
    series R and X; tau/shift replace the per-line transformer values)."""
    z = jnp.asarray(params.z_scale)
    return dataclasses.replace(
        net,
        line_R=net.line_R * z, line_X=net.line_X * z,
        line_tau=jnp.asarray(params.tau),
        line_shift=jnp.asarray(params.shift_rad))


def _project(params: LineParams, bounds, masks) -> LineParams:
    """Clip each leaf onto its box, but only where the entry is actually
    optimized (varied leaf AND free line) — frozen values are never
    moved, even if they sit outside the box."""
    return LineParams(*(
        jnp.where(masks[name] > 0, jnp.clip(leaf, *bounds[name]), leaf)
        for name, leaf in zip(LineParams._fields, params)))


def optimize_line_params(
    net: Network, devices, settings: Settings, *,
    vary: Sequence[str] = ("tau",),
    steps: int = 25,
    learning_rate: float = 0.02,
    optimizer=None,
    bounds: Optional[dict] = None,
    functional: Callable = None,
    fixed_lines: Optional[Sequence[int]] = None,
) -> OptimizeResult:
    """Minimize ``functional(V_m, V_a)`` over line/transformer parameters.

    ``vary``: which :class:`LineParams` leaves to optimize — any of
    ``"tau"``, ``"shift_rad"``, ``"z_scale"``; the others stay at the
    network's values.  ``fixed_lines``: per-line freeze mask (indices
    whose parameters must not move — e.g. plain lines when optimizing
    taps).  ``bounds``: ``{leaf: (lo, hi)}`` overrides of
    ``DEFAULT_BOUNDS``.  ``optimizer``: any optax gradient transform
    (default ``optax.adam(learning_rate)``).

    Steps whose warm-started solve does not converge retry cold; if the
    cold solve also fails the step is rejected (parameters halved back
    toward the previous iterate) — the returned optimum is always a
    CONVERGED operating point.  Returns :class:`OptimizeResult`.
    """
    import optax

    if functional is None:
        def functional(V_m, V_a):
            return jnp.max(get_thd(V_m).THD_F)
    if optimizer is None:
        optimizer = optax.adam(learning_rate)
    b = dict(DEFAULT_BOUNDS)
    b.update(bounds or {})
    unknown = set(vary) - set(LineParams._fields)
    if unknown:
        raise ValueError(f"vary contains unknown leaves {sorted(unknown)}; "
                         f"valid: {LineParams._fields}")
    rd = settings.real_dtype
    L = net.n_lines
    free = jnp.ones((L,), rd)
    if fixed_lines is not None:
        free = free.at[jnp.asarray(fixed_lines)].set(0.0)
    masks = {name: free * float(name in vary)
             for name in LineParams._fields}

    # parameters are ABSOLUTE (z relative to the input net): the solve
    # and the gradient are both taken at the applied network, so the
    # returned grad.z_scale is d/d(local scale) at the current point —
    # chain-ruled below onto the absolute z
    params = _project(LineParams(
        z_scale=jnp.ones((L,), rd),
        tau=jnp.asarray(net.line_tau, rd),
        shift_rad=jnp.asarray(net.line_shift, rd)), b, masks)

    lp_template = LineParams(z_scale=jnp.ones((L,), rd))  # per-line grads

    @jax.jit
    def solve(net_k, V0):
        return hpf(net_k, devices, settings, V0=V0)

    @jax.jit
    def solve_cold(net_k):
        return hpf(net_k, devices, settings)

    @jax.jit
    def grad_at(net_k, res):
        sens = line_sensitivity(net_k, devices, settings, res,
                                line_params=lp_template,
                                functional=functional)
        return sens.value, sens.grad

    opt_state = optimizer.init(params)
    res = solve_cold(apply_line_params(net, params))
    if not bool(np.asarray(res.converged)):
        raise RuntimeError("HPF does not converge at the initial "
                           "parameters — nothing to optimize from")
    n_solves = 1
    value0, g = grad_at(apply_line_params(net, params), res)
    value0 = float(np.asarray(value0))
    best_params, best_value, best_res = params, value0, res
    history = []

    for _ in range(steps):
        # local z grad -> absolute z grad (R_abs = R0 * z_abs, local
        # scale multiplies R_abs: df/dz_abs = df/dz_local / z_abs)
        g_abs = LineParams(
            z_scale=(g.z_scale / params.z_scale) * masks["z_scale"],
            tau=g.tau * masks["tau"],
            shift_rad=g.shift_rad * masks["shift_rad"])
        updates, opt_state = optimizer.update(g_abs, opt_state, params)
        proposal = _project(
            LineParams(*(p + u for p, u in zip(params, updates))), b, masks)

        res_new = solve(apply_line_params(net, proposal),
                        (best_res.V_m, best_res.V_a))
        n_solves += 1
        if not bool(np.asarray(res_new.converged)):
            res_new = solve_cold(apply_line_params(net, proposal))
            n_solves += 1
        if not bool(np.asarray(res_new.converged)):
            # reject: halve back toward the last accepted iterate
            params = LineParams(*(0.5 * (p + q) for p, q
                                  in zip(proposal, params)))
            history.append(float("nan"))
            continue
        params = proposal
        value, g = grad_at(apply_line_params(net, params), res_new)
        value = float(np.asarray(value))
        history.append(value)
        if value < best_value:
            best_params, best_value, best_res = params, value, res_new

    return OptimizeResult(
        params=best_params, net=apply_line_params(net, best_params),
        value=best_value, value0=value0,
        history=np.asarray(history, dtype=np.float64),
        n_solves=n_solves)


DEFAULT_FILTER_BOUNDS = {
    "h_tune": (2.0, None),      # upper bound filled from the harmonic set
    "x_cap": (1e-3, 10.0),
}


class FilterOptResult(NamedTuple):
    """Outcome of :func:`optimize_filter`.  ``Y``: the network admittance
    with the optimized filter installed — solve with ``hpf(..., Y=Y)`` to
    reproduce ``value``."""
    params: object            # FilterParams at the optimum
    Y: object                 # Cx (H, n, n) with the filter installed
    value: float
    value0: float
    history: np.ndarray
    n_solves: int


def optimize_filter(
    net: Network, devices, settings: Settings, bus: int, *,
    h_tune0: float = None, x_cap0: float = 1.0, quality: float = 30.0,
    steps: int = 25, learning_rate: float = 0.05,
    optimizer=None, bounds: Optional[dict] = None,
    functional: Callable = None,
    scenarios=None, reduce: str = "mean",
    v_limits: Optional[Tuple[float, float]] = (0.5, 2.0),
    v_penalty: float = 100.0,
) -> FilterOptResult:
    """Tune a single-tuned shunt filter at ``bus`` by gradient descent on
    the full coupled HPF: minimize ``functional(V_m, V_a)`` (default
    worst-bus THD_F) over the filter's resonant order and capacitor size,
    using the exact IFT gradients of
    :func:`hpfx.sensitivity.filter_sensitivity`.

    ``h_tune0`` defaults to the worst OPERATIONAL resonance order at
    ``bus`` (:func:`hpfx.impedance.resonance_peaks` over the
    device-inclusive scan — the converter's Norton admittance damps the
    passive peak, so the passive worst order can be the wrong target;
    see test_impedance.py's operational-vs-passive story).  The gradient
    loop then detunes optimally from there (real designs tune slightly
    BELOW the resonance; the gradient finds how much).  Unlike
    :func:`optimize_line_params`, every evaluation is a COLD solve
    (rejected steps halve back): the returned design is always an
    operating point a cold energization reaches, not a warm-tracked
    solution branch (see the loop comment).

    **Robust design**: pass ``scenarios`` (a :class:`hpfx.solve.Scenarios`
    batch) to tune ONE filter against every scenario at once — each step
    re-solves the whole sweep cold (``hpf_sweep`` with the filter's
    ``Y=`` override) and descends the aggregate of the
    per-scenario IFT gradients from
    :func:`hpfx.sensitivity.sweep_filter_sensitivity`:
    ``reduce="mean"`` for the expected value, ``reduce="max"`` for the
    worst case (the argmax scenario's gradient — a valid subgradient).
    A proposal is accepted only if EVERY scenario converges; ``value``
    is the aggregate objective.

    **Filter banks**: pass a length-K ``bus`` sequence to co-optimize K
    branches jointly (one per bus entry; repeat a bus for a multi-branch
    bank there).  ``h_tune0``/``x_cap0`` may be scalars (broadcast) or
    length-K; the default start tunes each branch to its own bus's worst
    operational resonance.  Composes with ``scenarios``.

    ``v_limits`` / ``v_penalty``: fundamental-voltage window enforced
    two ways — a smooth quadratic barrier ``v_penalty * sum(relu(v1 -
    vmax)^2 + relu(vmin - v1)^2)`` ADDED to the optimized objective
    (differentiated through the same IFT, so the gradient can slide
    along the constraint instead of banging into a reject wall), and a
    hard acceptance guard (same rejection path as non-convergence) as
    backstop.  This is load-bearing, not cosmetic: pure-THD objectives
    have a degenerate minimum where ``x_cap -> 0`` turns the filter into
    a bus short (|V| collapses, THD becomes 0/0 noise, and NR happily
    "converges" to the collapsed point) — a measured failure on net2
    banks, not a hypothetical; capacitive voltage boost is also a real
    (bounded) THD-denominator effect the limits keep honest.  The wide
    default only excludes collapse/runaway; tighten to your planning
    limits (e.g. (0.9, 1.1)) for real designs.  ``None`` disables both.
    ``value``/``history`` are the penalized objective — identical to
    ``functional`` whenever the limits are respected.
    """
    import optax

    from .harmonic import hpf
    from .impedance import driving_point_impedance, resonance_peaks
    from .sensitivity import (FilterParams, filter_sensitivity,
                              sweep_filter_sensitivity)

    if reduce not in ("mean", "max"):
        raise ValueError(f"unknown reduce {reduce!r}: use 'mean' or 'max'")
    if functional is None:
        def functional(V_m, V_a):
            return jnp.max(get_thd(V_m).THD_F)
    if v_limits is None or v_penalty == 0.0:
        objective = functional
    else:
        def objective(V_m, V_a):
            v1 = V_m[0]
            over = jnp.maximum(v1 - v_limits[1], 0.0)
            under = jnp.maximum(v_limits[0] - v1, 0.0)
            return functional(V_m, V_a) + v_penalty * jnp.sum(
                over * over + under * under)
    if optimizer is None:
        optimizer = optax.adam(learning_rate)
    b = dict(DEFAULT_FILTER_BOUNDS)
    b.update(bounds or {})
    if b["h_tune"][1] is None:
        b["h_tune"] = (b["h_tune"][0], float(settings.harmonics[-1]))
    rd = settings.real_dtype
    multi = isinstance(bus, (list, tuple, np.ndarray))
    if multi:
        bus = tuple(int(x) for x in bus)
    if h_tune0 is None:
        zmag = driving_point_impedance(net, settings, devices=devices)
        _, worst_h, _ = resonance_peaks(zmag, settings)
        h_tune0 = (np.asarray(worst_h, float)[list(bus)] if multi
                   else float(np.asarray(worst_h)[bus]))
    if multi:
        h_tune0 = jnp.broadcast_to(jnp.asarray(h_tune0, rd), (len(bus),))
        x_cap0 = jnp.broadcast_to(jnp.asarray(x_cap0, rd), (len(bus),))

    def project(p):
        return FilterParams(h_tune=jnp.clip(p.h_tune, *b["h_tune"]),
                            x_cap=jnp.clip(p.x_cap, *b["x_cap"]))

    params = project(FilterParams(h_tune=jnp.asarray(h_tune0, rd),
                                  x_cap=jnp.asarray(x_cap0, rd)))
    Y0 = build_ybus(net, settings)

    def Y_of(p):
        from .sensitivity import _filter_Y
        return _filter_Y(Y0, settings, bus, p, quality)

    if scenarios is None:
        @jax.jit
        def solve_cold(p):
            return hpf(net, devices, settings, Y=Y_of(p))

        @jax.jit
        def grad_at(p, res):
            sens = filter_sensitivity(net, devices, settings, res, bus, p,
                                      quality=quality,
                                      functional=objective)
            return sens.value, sens.grad
    else:
        from .solve import hpf_sweep

        def solve_cold(p):
            return hpf_sweep(net, devices, settings, scenarios, Y=Y_of(p))

        @jax.jit
        def grad_at(p, res):
            sens = sweep_filter_sensitivity(
                net, devices, settings, res, scenarios, bus, p,
                quality=quality, functional=objective)
            if reduce == "mean":
                return (jnp.mean(sens.value),
                        FilterParams(*(jnp.mean(g, axis=0)
                                       for g in sens.grad)))
            worst = jnp.argmax(sens.value)
            return (sens.value[worst],
                    FilterParams(*(g[worst] for g in sens.grad)))

    def _acceptable(res) -> bool:
        if not bool(np.asarray(res.converged).all()):
            return False
        if v_limits is None:
            return True
        v1 = np.asarray(res.V_m)[..., 0, :]     # fundamental, every bus
        return bool((v1 >= v_limits[0]).all() and (v1 <= v_limits[1]).all())

    opt_state = optimizer.init(params)
    res = solve_cold(params)
    if not _acceptable(res):
        raise RuntimeError(
            "HPF does not converge (or violates v_limits) with the initial "
            "filter — start from different (h_tune0, x_cap0)")
    n_solves = 1
    value0, g = grad_at(params, res)
    value0 = float(np.asarray(value0))
    best_params, best_value = params, value0
    history = []

    dead_iters = 0
    for _ in range(steps):
        updates, opt_state = optimizer.update(g, opt_state, params)
        # COLD solves only — filter design changes the network, and
        # warm-tracking can follow a solution branch a cold energization
        # never reaches (measured on net2 banks: warm chain converged,
        # cold re-solve of the returned design diverged).  Every accepted
        # point is therefore cold-reproducible by construction.  An
        # unacceptable proposal backtracks the STEP (not the parameters:
        # the optimizer state would keep pushing a frozen update into the
        # infeasible region forever) so a feasible descent step near the
        # current point is always found if one exists.
        scale, res_new = 1.0, None
        for _try in range(6):
            proposal = project(FilterParams(
                *(p + scale * u for p, u in zip(params, updates))))
            cand = solve_cold(proposal)
            n_solves += 1
            if _acceptable(cand):
                res_new = cand
                break
            scale *= 0.5
        if res_new is None:
            history.append(float("nan"))
            dead_iters += 1
            if dead_iters >= 3:
                break               # the gradient keeps pointing into an
            continue                # infeasible region; stop burning solves
        dead_iters = 0
        params = proposal
        value, g = grad_at(params, res_new)
        value = float(np.asarray(value))
        history.append(value)
        if value < best_value:
            best_params, best_value = params, value

    return FilterOptResult(
        params=best_params, Y=Y_of(best_params),
        value=best_value, value0=value0,
        history=np.asarray(history, dtype=np.float64), n_solves=n_solves)
