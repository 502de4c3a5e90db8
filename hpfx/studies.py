"""Production harmonic studies: percentile assessment + quasi-static time
series on top of the batched sweeps.

The reference solves one case at a time (hcne_generalized.py:511-560 is a
single-case driver); real compatibility-level work is statistical — IEC
61000-3-6 assesses the 95th percentile of each harmonic against planning
levels, and IEEE 519-2014 applies its Table 1 limits to the 95th
percentile of measured 10-min values over a week.  Both reduce to the
same batched shape: a big batched sweep (scenario draws, or time-step
profiles) followed by quantile reductions over the batch axis — one
compiled program end to end, riding the exact solver shapes the bench
already validates.

Two entry points:

- :func:`assess_quantiles` — Monte-Carlo percentile assessment of a
  scenario distribution (compose with
  :func:`hpfx.capacity.monte_carlo_scenarios` for the standard draws).
- :func:`run_timeseries` / :func:`percentile_compliance` — quasi-static
  profile study (time steps ARE the batch axis; chunked for long
  profiles) and the 95th-percentile IEEE-519 screen over the window.

Non-converged rows are excluded from every statistic via NaN-masking
(``nanquantile``), and the converged fraction is always reported — a
diverged scenario never silently shifts a percentile.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Settings
from .flows import _distortion_pct, _limits_for
from .network import Network
from .results import get_thd
from .solve import HPFResult, Scenarios, hpf_sweep


def _masked_rows(values: jnp.ndarray, converged: jnp.ndarray) -> jnp.ndarray:
    """NaN out batch rows where the solve did not converge (values (B, ...),
    converged (B,)) so nanquantile statistics skip them."""
    mask = jnp.asarray(converged, bool).reshape(
        (-1,) + (1,) * (values.ndim - 1))
    return jnp.where(mask, values, jnp.nan)


class QuantileAssessment(NamedTuple):
    """Percentile summary of a batched harmonic study.

    All statistics are over CONVERGED scenarios only.  ``quantiles`` is
    the probed probability vector (Q,); leading axis Q below.

    - ``thd_q`` (Q, n): per-bus THD_F quantiles (fractional, as
      :func:`hpfx.results.get_thd` returns it),
    - ``vh_pct_q`` (Q, H-1, n): per-bus individual-harmonic quantiles in
      % of the fundamental (orders ``harmonics``),
    - ``v1_q`` (Q, n): fundamental-magnitude quantiles (pu),
    - ``exceed_prob`` (n,): P(THD_F > thd_limit | converged) per bus,
    - ``worst_bus``: bus index with the largest 95th-percentile THD (the
      highest requested quantile if 0.95 is not among them),
    - ``converged_frac`` / ``n_samples``: honesty bookkeeping.
    """
    quantiles: Tuple[float, ...]
    harmonics: Tuple[int, ...]
    thd_q: jnp.ndarray
    vh_pct_q: jnp.ndarray
    v1_q: jnp.ndarray
    exceed_prob: jnp.ndarray
    worst_bus: int
    converged_frac: float
    n_samples: int


def assess_quantiles(net: Network, devices, settings: Settings,
                     scenarios: Scenarios, *,
                     quantiles: Sequence[float] = (0.5, 0.95, 0.99),
                     thd_limit: float = 0.08,
                     sweep=None) -> QuantileAssessment:
    """Monte-Carlo percentile assessment of a scenario distribution.

    Solves the batch (``sweep`` defaults to :func:`hpfx.solve.hpf_sweep`;
    ``hpf_sweep_adaptive``/``hpf_sweep_device``/sharded wrappers drop in)
    and reduces THD, individual-harmonic ratios and the fundamental to
    the requested quantiles per bus — the IEC 61000-3-6 assessment shape,
    where the 95th percentile of each harmonic is compared against
    planning levels (use :func:`check_planning_levels` on ``vh_pct_q``).
    """
    run = sweep if sweep is not None else hpf_sweep
    res = run(net, devices, settings, scenarios)
    return summarize_quantiles(res, settings, quantiles=quantiles,
                               thd_limit=thd_limit)


def summarize_quantiles(result: HPFResult, settings: Settings, *,
                        quantiles: Sequence[float] = (0.5, 0.95, 0.99),
                        thd_limit: float = 0.08) -> QuantileAssessment:
    """Quantile reduction of an already-solved batched result (the
    offline half of :func:`assess_quantiles`)."""
    q = jnp.asarray(quantiles, jnp.float64
                    if jax.config.jax_enable_x64 else jnp.float32)
    ratio_pct, thd_pct = jax.vmap(_distortion_pct)(result.V_m)  # (B,H-1,n),(B,n)
    thd = thd_pct / 100.0
    conv = jnp.asarray(result.converged, bool)

    thd_m = _masked_rows(thd, conv)
    ratio_m = _masked_rows(ratio_pct, conv)
    v1_m = _masked_rows(result.V_m[:, 0, :], conv)

    thd_q = jnp.nanquantile(thd_m, q, axis=0)
    vh_q = jnp.nanquantile(ratio_m, q, axis=0)
    v1_q = jnp.nanquantile(v1_m, q, axis=0)

    n_conv = jnp.maximum(jnp.sum(conv.astype(thd.dtype)), 1.0)
    exceed = jnp.sum(((thd > thd_limit) & conv[:, None]).astype(thd.dtype),
                     axis=0) / n_conv

    qs = tuple(float(v) for v in np.asarray(quantiles))
    pick = qs.index(0.95) if 0.95 in qs else len(qs) - 1
    worst_bus = int(jnp.argmax(thd_q[pick]))
    return QuantileAssessment(
        quantiles=qs, harmonics=tuple(settings.harmonics[1:]),
        thd_q=thd_q, vh_pct_q=vh_q, v1_q=v1_q, exceed_prob=exceed,
        worst_bus=worst_bus,
        converged_frac=float(jnp.mean(conv.astype(thd.dtype))),
        n_samples=int(conv.shape[0]))


def metric_quantiles(result: HPFResult, settings: Settings, metric, *,
                     quantiles: Sequence[float] = (0.5, 0.95, 0.99)):
    """Quantiles of ANY per-scenario metric over a solved batched sweep
    — the generic companion of :func:`summarize_quantiles` for
    quantities beyond THD (crest factor, IEEE 1459 power factors,
    line-flow quantities...).

    ``metric(V_m (H, n), V_a (H, n)) -> array`` is vmapped over the
    batch; non-converged scenarios are masked out of the statistics.
    Returns ``(Q, ...)`` with the quantile axis first.  Example::

        crest_q = metric_quantiles(
            sweep, s, lambda m, a: waveform_metrics(m, a, s.harmonics).crest)
    """
    q = jnp.asarray(quantiles, jnp.float64
                    if jax.config.jax_enable_x64 else jnp.float32)
    vals = jax.vmap(metric)(result.V_m, result.V_a)
    conv = jnp.asarray(result.converged, bool)
    return jnp.nanquantile(_masked_rows(vals, conv), q, axis=0)


class PlanningLevelReport(NamedTuple):
    """Per-order planning-level check of a percentile assessment.

    ``levels_pct``: the applied per-order limits (%), ``margin_pct``:
    limit minus the assessed percentile per order and bus (H-1, n) —
    negative means exceeded, ``compliant``: all orders within limits on
    every bus, ``binding_order``/``binding_bus``: the tightest margin.
    """
    harmonics: Tuple[int, ...]
    levels_pct: jnp.ndarray
    margin_pct: jnp.ndarray
    compliant: bool
    binding_order: int
    binding_bus: int


def check_planning_levels(assessment: QuantileAssessment,
                          levels: Optional[Dict[int, float]] = None, *,
                          quantile: float = 0.95,
                          default_pct: float = 3.0) -> PlanningLevelReport:
    """Compare an assessed harmonic percentile against per-order planning
    levels (IEC 61000-3-6 assessment procedure: the 95th percentile of
    each individual harmonic must stay below the order's planning level).

    ``levels``: ``{order: limit_pct}``; orders not listed fall back to
    ``default_pct`` (planning levels are grid-operator data — supply the
    table applicable to the voltage class under study).  ``quantile``
    must be one of the assessment's probed quantiles.
    """
    qs = assessment.quantiles
    if quantile not in qs:
        raise ValueError(f"quantile {quantile} not among the assessed "
                         f"quantiles {qs} — re-run assess_quantiles with it")
    vh = assessment.vh_pct_q[qs.index(quantile)]          # (H-1, n)
    orders = assessment.harmonics
    lv = np.full(len(orders), float(default_pct))
    for h, pct in (levels or {}).items():
        if int(h) not in orders:
            raise ValueError(f"planning level for order {h} but the "
                             f"assessment covers {orders}")
        lv[orders.index(int(h))] = float(pct)
    lv = jnp.asarray(lv, vh.dtype)
    margin = lv[:, None] - vh                              # (H-1, n)
    flat = int(jnp.argmin(margin))
    bind_o, bind_b = divmod(flat, margin.shape[1])
    return PlanningLevelReport(
        harmonics=orders, levels_pct=lv, margin_pct=margin,
        compliant=bool(jnp.all(margin >= 0.0)),
        binding_order=orders[bind_o], binding_bus=int(bind_b))


def profile_scenarios(settings: Settings, p_profile, *, q_profile=None,
                      inj_profile=None) -> Scenarios:
    """Scenario set whose batch axis is TIME: step t carries the load /
    injection multipliers of ``*_profile[t]`` ((T,) scalars or (T, n) /
    (T, n_nl) per-bus rows).  ``q_profile`` defaults to ``p_profile``
    (constant power factor); ``inj_profile`` defaults to 1."""
    rd = settings.real_dtype
    p = jnp.asarray(p_profile, rd)
    q = p if q_profile is None else jnp.asarray(q_profile, rd)
    inj = None if inj_profile is None else jnp.asarray(inj_profile, rd)
    if q.shape[0] != p.shape[0] or (inj is not None
                                    and inj.shape[0] != p.shape[0]):
        raise ValueError("profiles disagree on the number of time steps")
    return Scenarios(p_scale=p, q_scale=q, injection_scale=inj)


def run_timeseries(net: Network, devices, settings: Settings,
                   p_profile, *, q_profile=None, inj_profile=None,
                   chunk: Optional[int] = None, sweep=None) -> HPFResult:
    """Quasi-static time-series study: one full HPF solve per profile
    step, batched over time (the time axis IS the sweep batch axis — T
    independent steady states, solved as one compiled program per chunk).

    ``chunk`` bounds the per-program batch for long profiles (e.g. a
    week of 10-min values, T=1008); chunks reuse one jit cache entry
    when T divides evenly.  The returned :class:`HPFResult` leaves carry
    the time axis first, directly consumable by
    :func:`percentile_compliance` and :func:`summarize_quantiles`.
    """
    scen = profile_scenarios(settings, p_profile, q_profile=q_profile,
                             inj_profile=inj_profile)
    run = sweep if sweep is not None else hpf_sweep
    T = scen.batch
    if chunk is None or chunk >= T:
        return run(net, devices, settings, scen)
    parts = []
    for t0 in range(0, T, chunk):
        sub = Scenarios(*(None if x is None else x[t0:t0 + chunk]
                          for x in scen))
        parts.append(run(net, devices, settings, sub))
    return jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *parts)


class PercentileComplianceReport(NamedTuple):
    """IEEE-519-style screen of the ``percentile``-th values over a
    window (per bus unless noted).

    IEEE Std 519-2014 applies Table 1 to the 95th percentile of the
    measured short-time (10-min) values over one week; this is the
    computed-study equivalent over a :func:`run_timeseries` window.
    ``vh_p``/``thd_p``: the percentile values ((H-1, n) % and (n,) %),
    ``compliant``: both limits pass on every bus,
    ``frac_steps_over`` (n,): fraction of converged steps where the bus
    instantaneously violates either limit (locating WHEN, not just
    whether), ``converged_frac``: honesty bookkeeping.
    """
    harmonics: Tuple[int, ...]
    vh_p: jnp.ndarray
    thd_p: jnp.ndarray
    limit_individual: float
    limit_thd: float
    compliant: bool
    frac_steps_over: jnp.ndarray
    converged_frac: float


def percentile_compliance(result: HPFResult, settings: Settings, *,
                          percentile: float = 95.0,
                          v_kv: Optional[float] = None
                          ) -> PercentileComplianceReport:
    """Check the ``percentile``-th per-bus distortion values of a
    time-series (or any batched) result against IEEE 519-2014 Table 1
    (limits via :data:`hpfx.flows.IEEE519_LIMITS`, class from ``v_kv``).
    Non-converged steps are excluded from the percentile and reported
    via ``converged_frac``."""
    ind, thd_lim = _limits_for(v_kv, settings)
    ratio_pct, thd_pct = jax.vmap(_distortion_pct)(result.V_m)
    conv = jnp.asarray(result.converged, bool)

    p = percentile / 100.0
    vh_p = jnp.nanquantile(_masked_rows(ratio_pct, conv), p, axis=0)
    thd_p = jnp.nanquantile(_masked_rows(thd_pct, conv), p, axis=0)

    over = ((jnp.max(ratio_pct, axis=1) > ind) | (thd_pct > thd_lim))
    n_conv = jnp.maximum(jnp.sum(conv.astype(thd_pct.dtype)), 1.0)
    frac_over = jnp.sum((over & conv[:, None]).astype(thd_pct.dtype),
                        axis=0) / n_conv
    return PercentileComplianceReport(
        harmonics=tuple(settings.harmonics[1:]),
        vh_p=vh_p, thd_p=thd_p,
        limit_individual=ind, limit_thd=thd_lim,
        compliant=bool(jnp.all(vh_p <= ind) & jnp.all(thd_p <= thd_lim)),
        frac_steps_over=frac_over,
        converged_frac=float(jnp.mean(conv.astype(thd_pct.dtype))))


def daily_profile(T: int = 96, *, base: float = 0.7, peak: float = 1.15,
                  peak_hour: float = 19.0, width_h: float = 3.5,
                  dtype=None) -> np.ndarray:
    """Synthetic daily load profile (T steps over 24 h): a ``base``
    plateau with a Gaussian evening peak — a standing stand-in where no
    measured profile is available (tests, demos, CLI default)."""
    t_h = np.arange(T) * (24.0 / T)
    prof = base + (peak - base) * np.exp(
        -0.5 * ((t_h - peak_hour) / width_h) ** 2)
    return prof.astype(dtype or np.float64)
