"""Differentiable sensitivities of the harmonic power flow solution.

The capability SURVEY §7.2 (M7) calls "free from JAX": derivatives of any
solution functional (THD, voltage magnitudes) with respect to scenario
parameters (load scaling, device penetration).  The reference has nothing
comparable.

The NR loop itself is a ``lax.while_loop`` (not reverse-differentiable), so
sensitivities come from the implicit function theorem at the converged
fixed point x*:

    f(x*, theta) = 0   =>   dx*/dtheta = -J(x*)^{-1} · ∂f/∂theta

with J the same harmonic Jacobian the solver already builds (which *is*
∂f/∂x — verified against jacfwd in the test suite) and ∂f/∂theta obtained
by forward-mode autodiff of the mismatch.  One extra linear solve per
parameter column; exact at the fixed point, no unrolling.

Parameters: :class:`ScenarioParams` carries every scenario-axis knob of
``hpfx.solve.Scenarios`` — active/reactive load scales (scalar or per-bus)
and the device injection scale (scalar or per-device) — so a single call
yields the full gradient of e.g. worst-bus THD wrt each bus's load and
each device's penetration.  With ``Settings.solver = "arrow"`` the column
solves go through the structured arrow factorization (hpfx.arrow) instead
of the dense LU, which is what makes net1-scale (H<=25, dim 518+)
sensitivities affordable.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .config import Settings
from .cx import Cx
from .devices import DeviceSet
from .harmonic import (HPFResult, build_harmonic_jacobian, harmonic_mismatch,
                       harmonic_state_vector, update_harmonic_voltages)
from .network import Network
from .results import get_thd
from .utils.precision import highest_precision
from .ybus import build_ybus


class ScenarioParams(NamedTuple):
    """Differentiation point for :func:`scenario_sensitivity`: the scales
    at which ``result`` was solved.  Each leaf is a scalar or a vector —
    ``p_scale``/``q_scale`` scalar or (n,), ``injection_scale`` scalar or
    (n_nl,) (the per-device penetration axis)."""
    p_scale: object = 1.0
    q_scale: object = 1.0
    injection_scale: object = 1.0


class Sensitivity(NamedTuple):
    value: jnp.ndarray       # g(x*) at the solution
    grad: object             # dg/dtheta: ScenarioParams-shaped pytree
                             # (or a scalar from injection_sensitivity)
    dx: jnp.ndarray          # dx*/dtheta (state sensitivity), stacked cols


def _scaled_mismatch(net: Network, devices, settings: Settings, Y,
                     V_m0, V_a0):
    """f(x, params): the harmonic mismatch with loads and injections scaled
    by the (differentiable) ScenarioParams."""
    m, n, c = net.m, net.n, net.c

    def f(x, params: ScenarioParams):
        V_m, V_a = update_harmonic_voltages(
            V_m0, V_a0, x, settings.n_harmonics, n, c)
        dev_t = devices.scale(params.injection_scale)
        S = Cx(net.bus_P * params.p_scale, net.bus_Q * params.q_scale)
        return harmonic_mismatch(V_m, V_a, Y, S, dev_t, m, n, c)[0]

    return f


def _solve_columns(V_m, V_a, Y, dev_t, net: Network, settings: Settings,
                   rhs_cols):
    """J(x*)^{-1} @ rhs_cols (dim, P) with the solver the settings select:
    the structured arrow factorization (one pieces-build, vmapped column
    solves) or the dense Jacobian LU."""
    m, n, c = net.m, net.n, net.c
    if settings.solver == "arrow":
        from .arrow import arrow_solve, build_arrow_pieces, make_arrow_index
        idx = make_arrow_index(settings.n_harmonics, n, m, c)
        pieces = build_arrow_pieces(V_m, V_a, Y, dev_t, idx)
        return jax.vmap(lambda col: arrow_solve(pieces, col, idx),
                        in_axes=1, out_axes=1)(rhs_cols)
    J = build_harmonic_jacobian(V_m, V_a, Y, dev_t, m, n, c)
    return jnp.linalg.solve(J, rhs_cols)


def _ift_grad(f_theta, x_star, params, V_m, V_a, Y, dev_t,
              net: Network, settings: Settings, functional, H, n, c):
    """The IFT gradient core shared by every sensitivity entry point:
    forward-mode ∂f/∂θ over the ``params`` pytree, one batched column
    solve against J(x*), and the chain rule onto ``functional`` — with
    the gradient unflattened back into the ``params`` structure.

    Returns ``(value, grad_pytree, dx_cols)``.  ``f_theta(params)`` must
    evaluate the mismatch at ``x_star`` as a function of ``params``
    alone; ``Y``/``dev_t`` are the operating-point values J is built at.
    """
    leaves, treedef = jax.tree_util.tree_flatten(params)
    df = jax.jacfwd(f_theta)(params)
    dim = x_star.shape[0]
    cols = jnp.concatenate(
        [leaf.reshape(dim, -1) for leaf in jax.tree_util.tree_leaves(df)],
        axis=1)                                            # (dim, P)
    dx_cols = -_solve_columns(V_m, V_a, Y, dev_t, net, settings, cols)

    def g_of_x(x):
        Vm2, Va2 = update_harmonic_voltages(V_m, V_a, x, H, n, c)
        return functional(Vm2, Va2)

    value, dg = jax.value_and_grad(g_of_x)(x_star)
    grad_flat = dg @ dx_cols                               # (P,)
    out, off = [], 0
    for leaf in leaves:
        k = max(1, leaf.size)
        out.append(grad_flat[off:off + k].reshape(jnp.shape(leaf)))
        off += k
    return value, jax.tree_util.tree_unflatten(treedef, out), dx_cols


@highest_precision
def scenario_sensitivity(
    net: Network, devices, settings: Settings,
    result: HPFResult, params: Optional[ScenarioParams] = None,
    functional: Callable = None,
) -> Sensitivity:
    """Gradient of ``functional(V_m, V_a)`` wrt every scenario parameter at
    a converged solution, via implicit differentiation.

    ``params``: the :class:`ScenarioParams` at which ``result`` was solved
    (defaults to all-ones); vector leaves yield per-bus / per-device
    gradient components.  ``functional`` defaults to the worst-bus THD_F.
    Returns ``grad`` as a ScenarioParams pytree with leaves shaped like
    the inputs.
    """
    if functional is None:
        def functional(V_m, V_a):
            return jnp.max(get_thd(V_m).THD_F)
    if params is None:
        params = ScenarioParams()
    rd = settings.real_dtype
    params = ScenarioParams(*(jnp.asarray(p, rd) for p in params))

    H, n, c = settings.n_harmonics, net.n, net.c
    Y = build_ybus(net, settings)
    V_m, V_a = result.V_m, result.V_a
    x_star = harmonic_state_vector(V_m, V_a, c)
    f = _scaled_mismatch(net, devices, settings, Y, V_m, V_a)

    dev_t = devices.scale(params.injection_scale)
    value, grad, dx_cols = _ift_grad(
        lambda p: f(x_star, p), x_star, params, V_m, V_a, Y, dev_t,
        net, settings, functional, H, n, c)
    return Sensitivity(value=value, grad=grad, dx=dx_cols)


@highest_precision
def mix_sensitivity(
    net: Network, library, settings: Settings,
    result: HPFResult, w,
    params: Optional[ScenarioParams] = None,
    functional: Callable = None,
) -> Sensitivity:
    """Gradient of ``functional`` wrt the device-mix weights ``w``
    (n_nl, T) at a converged mix solve — the marginal impact of one more
    device of type t at bus d, the decision quantity of a
    hosting-capacity study.

    ``library``: the :class:`hpfx.devices.DeviceLibrary` the sweep used;
    ``w``: the scenario's mix weights (one scenario's slice of
    ``Scenarios.device_mix``); ``params``: the scenario's p/q/injection
    scales (``result`` must have been solved at exactly these — mix first,
    then scale, matching the sweep's composition; defaults to all-ones).
    Returns ``grad`` shaped (n_nl, T).  Since Norton parameters are linear
    in ``w``, ∂f/∂w is exact and cheap (forward-mode through the blend +
    mismatch).
    """
    if functional is None:
        def functional(V_m, V_a):
            return jnp.max(get_thd(V_m).THD_F)
    if params is None:
        params = ScenarioParams()
    rd = settings.real_dtype
    params = ScenarioParams(*(jnp.asarray(p, rd) for p in params))
    w = jnp.asarray(w, rd)
    H, n, c = settings.n_harmonics, net.n, net.c
    m = net.m
    Y = build_ybus(net, settings)
    V_m, V_a = result.V_m, result.V_a
    x_star = harmonic_state_vector(V_m, V_a, c)
    S = Cx(net.bus_P * params.p_scale, net.bus_Q * params.q_scale)

    def f(x, w_):
        Vm2, Va2 = update_harmonic_voltages(V_m, V_a, x, H, n, c)
        dev_ = library.mixed(w_).scale(params.injection_scale)
        return harmonic_mismatch(Vm2, Va2, Y, S, dev_, m, n, c)[0]

    dev_t = library.mixed(w).scale(params.injection_scale)
    value, grad, dx_cols = _ift_grad(
        lambda w_: f(x_star, w_), x_star, w, V_m, V_a, Y, dev_t,
        net, settings, functional, H, n, c)
    return Sensitivity(value=value, grad=grad, dx=dx_cols)


@highest_precision
def sweep_sensitivity(
    net: Network, devices, settings: Settings,
    sweep_result, scenarios,
    functional: Callable = None,
) -> Sensitivity:
    """Per-scenario gradients for a whole sweep in ONE vmapped program:
    the batched counterpart of :func:`scenario_sensitivity`, giving every
    scenario of a :func:`hpfx.solve.hpf_sweep` its own (p, q, injection)
    gradient of ``functional`` — the "distortion headroom per knob"
    surface of a hosting-capacity Monte-Carlo.  The reference has no
    derivative capability at all; here the whole (B,)-batch of implicit
    -function-theorem solves shares one traced program (the
    arrow column solves batch through the same custom-vmap path the sweep
    itself uses).

    ``sweep_result``: the batched result of ``hpf_sweep`` (leaves with
    leading B).  ``scenarios``: the :class:`hpfx.solve.Scenarios` the sweep
    ran (``device_mix`` is carried through the blend but not differentiated
    — use :func:`mix_sensitivity` for mix-weight gradients).  Gradients at
    non-converged scenarios are meaningless; mask with
    ``sweep_result.converged``.  Returns value (B,), grad ScenarioParams
    with leading B, dx (B, dim, P).
    """
    if functional is None:
        def functional(V_m, V_a):
            return jnp.max(get_thd(V_m).THD_F)
    rd = settings.real_dtype
    B = scenarios.batch
    p = jnp.asarray(scenarios.p_scale, rd)
    # None defaults must mirror hpf_sweep's (solve.py): q follows p,
    # injections default to one — else gradients are taken at the wrong
    # operating point
    q = p if scenarios.q_scale is None else jnp.asarray(scenarios.q_scale, rd)
    inj = (jnp.ones((B,), rd) if scenarios.injection_scale is None
           else jnp.asarray(scenarios.injection_scale, rd))
    mix = scenarios.device_mix
    H, n, c, m = settings.n_harmonics, net.n, net.c, net.m
    Y = build_ybus(net, settings)

    def one(V_m, V_a, p_s, q_s, i_s, w):
        base = devices.mixed(w) if w is not None else devices
        params = ScenarioParams(p_s, q_s, i_s)
        x_star = harmonic_state_vector(V_m, V_a, c)

        def f(x, pr: ScenarioParams):
            Vm2, Va2 = update_harmonic_voltages(V_m, V_a, x, H, n, c)
            S = Cx(net.bus_P * pr.p_scale, net.bus_Q * pr.q_scale)
            return harmonic_mismatch(Vm2, Va2, Y, S,
                                     base.scale(pr.injection_scale),
                                     m, n, c)[0]

        value, grad, dx_cols = _ift_grad(
            lambda pr: f(x_star, pr), x_star, params, V_m, V_a, Y,
            base.scale(i_s), net, settings, functional, H, n, c)
        return value, grad, dx_cols

    in_axes = (0, 0, 0, 0, 0, None if mix is None else 0)
    value, grad, dx = jax.vmap(one, in_axes=in_axes)(
        sweep_result.V_m, sweep_result.V_a, p, q, inj, mix)
    return Sensitivity(value=value, grad=grad, dx=dx)


class LineParams(NamedTuple):
    """Differentiation point for :func:`line_sensitivity`: the network
    (line/branch) parameters.  ``z_scale`` is a scalar or (L,) scale applied
    to both series R and X of each line; ``tau``/``shift_rad`` are the
    per-line tap ratios and phase shifts (radians) the transformer Ybus
    extension uses (``ybus.build_ybus``; pi_trafo_pf_test.py:117-145).
    ``tau``/``shift_rad`` default to the network's own values, so the
    default LineParams reproduces the network exactly."""
    z_scale: object = 1.0
    tau: object = None
    shift_rad: object = None


@highest_precision
def line_sensitivity(
    net: Network, devices, settings: Settings,
    result: HPFResult, line_params: Optional[LineParams] = None,
    scenario_params: Optional[ScenarioParams] = None,
    functional: Callable = None,
) -> Sensitivity:
    """Gradient of ``functional(V_m, V_a)`` wrt line/branch parameters at a
    converged solution — per-line series-impedance scaling and transformer
    tap/phase-shift — via the same implicit-function-theorem machinery as
    :func:`scenario_sensitivity`, with ∂f/∂θ obtained by forward-mode
    autodiff *through the Ybus assembly* (``build_ybus`` is pure JAX over
    the line arrays).  The reference has nothing comparable; the classical
    use case is tap optimization / network-reinforcement screening.

    ``line_params``: the :class:`LineParams` at which ``result`` was solved
    (defaults: ``z_scale=1``, ``tau``/``shift_rad`` from ``net`` — i.e. the
    network as loaded).  ``scenario_params``: the scenario scales of the
    solve (defaults to all-ones).  Returns ``grad`` as a LineParams pytree
    with leaves shaped like the (normalized, per-line) inputs.
    """
    if functional is None:
        def functional(V_m, V_a):
            return jnp.max(get_thd(V_m).THD_F)
    if line_params is None:
        line_params = LineParams()
    if scenario_params is None:
        scenario_params = ScenarioParams()
    rd = settings.real_dtype
    sp = ScenarioParams(*(jnp.asarray(p, rd) for p in scenario_params))
    lp = LineParams(
        z_scale=jnp.asarray(line_params.z_scale, rd),
        tau=jnp.asarray(net.line_tau if line_params.tau is None
                        else line_params.tau, rd),
        shift_rad=jnp.asarray(net.line_shift if line_params.shift_rad is None
                              else line_params.shift_rad, rd))

    H, n, c = settings.n_harmonics, net.n, net.c
    m = net.m
    V_m, V_a = result.V_m, result.V_a
    x_star = harmonic_state_vector(V_m, V_a, c)
    S = Cx(net.bus_P * sp.p_scale, net.bus_Q * sp.q_scale)
    dev_t = devices.scale(sp.injection_scale)

    def f(x, p: LineParams):
        Vm2, Va2 = update_harmonic_voltages(V_m, V_a, x, H, n, c)
        net_p = dataclasses.replace(
            net,
            line_R=net.line_R * p.z_scale,
            line_X=net.line_X * p.z_scale,
            line_tau=p.tau, line_shift=p.shift_rad)
        Yp = build_ybus(net_p, settings)
        return harmonic_mismatch(Vm2, Va2, Yp, S, dev_t, m, n, c)[0]

    # J at the solved point: the default lp reproduces net's Ybus exactly
    Y = build_ybus(net, settings)
    value, grad, dx_cols = _ift_grad(
        lambda p: f(x_star, p), x_star, lp, V_m, V_a, Y, dev_t,
        net, settings, functional, H, n, c)
    return Sensitivity(value=value, grad=grad, dx=dx_cols)


@highest_precision
def injection_sensitivity(
    net: Network, devices: DeviceSet, settings: Settings,
    result: HPFResult, theta: float = 1.0,
    functional: Callable = None,
) -> Sensitivity:
    """d(functional)/d(injection scale) at a converged solution — the
    single-parameter special case of :func:`scenario_sensitivity`
    (``theta`` scalar, or (n_nl,) for per-device gradients).

    ``functional(V_m, V_a) -> scalar`` defaults to the worst-bus THD_F.
    ``theta`` is the injection scale at which ``result`` was solved.
    """
    params = ScenarioParams(injection_scale=theta)
    sens = scenario_sensitivity(
        net, devices, settings, result, params=params,
        functional=functional)
    grad = sens.grad.injection_scale
    # dx columns are laid out leaf-by-leaf in ScenarioParams order (the
    # unflatten loop in scenario_sensitivity); derive the injection-scale
    # column offset from the leading leaves' sizes rather than assuming
    # one column each
    rd = settings.real_dtype
    off = sum(max(1, jnp.asarray(p, rd).size)
              for p in (params.p_scale, params.q_scale))
    dx = sens.dx[:, off:]
    if jnp.ndim(theta) == 0:
        grad = grad.reshape(())
        dx = dx[:, 0]
    return Sensitivity(value=sens.value, grad=grad, dx=dx)


class FilterParams(NamedTuple):
    """Differentiation point for :func:`filter_sensitivity`: the
    single-tuned shunt filter's design parameters (see
    :func:`hpfx.impedance.tuned_filter_admittance` — ``h_tune`` is the
    series-resonant order, ``x_cap`` the fundamental capacitive
    reactance).  The quality factor is carried statically.  Scalar
    leaves describe one filter; (K,) leaves a K-branch bank (paired with
    a length-K ``bus`` sequence)."""
    h_tune: object = 7.0
    x_cap: object = 1.0


def _filter_Y(Y0, settings, bus, p: "FilterParams", quality):
    """``Y0`` with the filter (scalar leaves, ``bus`` int) or bank
    ((K,) leaves, ``bus`` length-K sequence) installed."""
    from .impedance import (install_shunt, install_shunts,
                            tuned_filter_admittance)
    yf = tuned_filter_admittance(settings, p.h_tune, p.x_cap, quality)
    if jnp.ndim(p.h_tune) == 0 and jnp.ndim(p.x_cap) == 0:
        return install_shunt(Y0, bus, yf)
    return install_shunts(Y0, bus, yf)


@highest_precision
def filter_sensitivity(
    net: Network, devices, settings: Settings,
    result: HPFResult, bus: int, filter_params: FilterParams,
    quality: float = 30.0,
    scenario_params: Optional[ScenarioParams] = None,
    functional: Callable = None,
) -> Sensitivity:
    """Gradient of ``functional(V_m, V_a)`` wrt the tuned-filter design
    parameters at a converged solution — the same implicit-function-
    theorem machinery as :func:`scenario_sensitivity`, with ∂f/∂θ taken
    by forward-mode autodiff *through the filter admittance and the Ybus
    diagonal fold* (:func:`hpfx.impedance.tuned_filter_admittance` +
    ``install_shunt`` are pure JAX in ``h_tune``/``x_cap``).

    ``result`` must be solved WITH the filter in service, i.e. via the
    ``Y=`` override::

        Yf = install_shunt(build_ybus(net, s), bus,
                           tuned_filter_admittance(s, h_tune, x_cap, q))
        res = hpf(net, dev, s, Y=Yf)

    (the ``Y=`` override disables the stable mismatch, matching the
    plain ``harmonic_mismatch`` differentiated here).  Closes the
    filter-design loop: scan -> detect -> size -> *optimize*
    (:func:`hpfx.optimize.optimize_filter`).

    **Filter banks**: pass (K,)-shaped ``filter_params`` leaves and a
    length-K ``bus`` sequence to differentiate K branches jointly (e.g.
    a 5th/7th/11th bank at one bus, or filters at several buses) —
    ``grad`` leaves come back (K,)-shaped.
    """
    if functional is None:
        def functional(V_m, V_a):
            return jnp.max(get_thd(V_m).THD_F)
    if scenario_params is None:
        scenario_params = ScenarioParams()
    rd = settings.real_dtype
    sp = ScenarioParams(*(jnp.asarray(p, rd) for p in scenario_params))
    fp = FilterParams(*(jnp.asarray(p, rd) for p in filter_params))

    H, n, c, m = settings.n_harmonics, net.n, net.c, net.m
    V_m, V_a = result.V_m, result.V_a
    x_star = harmonic_state_vector(V_m, V_a, c)
    S = Cx(net.bus_P * sp.p_scale, net.bus_Q * sp.q_scale)
    dev_t = devices.scale(sp.injection_scale)
    Y0 = build_ybus(net, settings)

    def Y_of(p: FilterParams):
        return _filter_Y(Y0, settings, bus, p, quality)

    def f(x, p: FilterParams):
        Vm2, Va2 = update_harmonic_voltages(V_m, V_a, x, H, n, c)
        return harmonic_mismatch(Vm2, Va2, Y_of(p), S, dev_t, m, n, c)[0]

    # J at the solved point: the filter IS part of the operating point
    value, grad, dx_cols = _ift_grad(
        lambda p: f(x_star, p), x_star, fp, V_m, V_a, Y_of(fp), dev_t,
        net, settings, functional, H, n, c)
    return Sensitivity(value=value, grad=grad, dx=dx_cols)


@highest_precision
def sweep_filter_sensitivity(
    net: Network, devices, settings: Settings,
    sweep_result, scenarios, bus: int, filter_params: FilterParams,
    quality: float = 30.0,
    functional: Callable = None,
) -> Sensitivity:
    """Per-scenario gradients of ``functional`` wrt ONE shared tuned
    filter's design parameters, over a whole sweep in one vmapped
    program — the robust-design counterpart of :func:`filter_sensitivity`
    (same IFT machinery, batched like :func:`sweep_sensitivity`).

    ``sweep_result`` must come from ``hpf_sweep(..., Y=Yf)`` with the
    filter installed via :func:`hpfx.impedance.install_shunt` at the SAME
    ``filter_params`` (the ``Y=`` override routes every scenario through
    the plain dense mismatch differentiated here).  The filter is a
    single design shared by all B scenarios; aggregate the returned (B,)
    leaves (mean for expected-value designs, the argmax row for worst-
    case) — that is exactly what :func:`hpfx.optimize.optimize_filter`
    does when given ``scenarios``.

    Returns value (B,), grad FilterParams with (B,)-leading leaves,
    dx (B, dim, 2).  Gradients at non-converged scenarios are
    meaningless; mask with ``sweep_result.converged``.
    """

    if functional is None:
        def functional(V_m, V_a):
            return jnp.max(get_thd(V_m).THD_F)
    rd = settings.real_dtype
    fp = FilterParams(*(jnp.asarray(p, rd) for p in filter_params))
    B = scenarios.batch
    p = jnp.asarray(scenarios.p_scale, rd)
    # None defaults mirror hpf_sweep's: q follows p, injections one
    q = p if scenarios.q_scale is None else jnp.asarray(scenarios.q_scale, rd)
    inj = (jnp.ones((B,), rd) if scenarios.injection_scale is None
           else jnp.asarray(scenarios.injection_scale, rd))
    mix = scenarios.device_mix
    H, n, c, m = settings.n_harmonics, net.n, net.c, net.m
    Y0 = build_ybus(net, settings)

    def Y_of(p_: FilterParams):
        return _filter_Y(Y0, settings, bus, p_, quality)

    def one(V_m, V_a, p_s, q_s, i_s, w):
        base = devices.mixed(w) if w is not None else devices
        x_star = harmonic_state_vector(V_m, V_a, c)
        S = Cx(net.bus_P * p_s, net.bus_Q * q_s)
        dev_t = base.scale(i_s)

        def f(x, fp2: FilterParams):
            Vm2, Va2 = update_harmonic_voltages(V_m, V_a, x, H, n, c)
            return harmonic_mismatch(Vm2, Va2, Y_of(fp2), S, dev_t,
                                     m, n, c)[0]

        value, grad, dx_cols = _ift_grad(
            lambda fp2: f(x_star, fp2), x_star, fp, V_m, V_a, Y_of(fp),
            dev_t, net, settings, functional, H, n, c)
        return value, grad, dx_cols

    in_axes = (0, 0, 0, 0, 0, None if mix is None else 0)
    value, grad, dx = jax.vmap(one, in_axes=in_axes)(
        sweep_result.V_m, sweep_result.V_a, p, q, inj, mix)
    return Sensitivity(value=value, grad=grad, dx=dx)
