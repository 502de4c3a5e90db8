"""Post-processing: distortion metrics and structured results.

Reference: get_THD (hcne_generalized.py:563-572; the Julia twin at
hcne.jl:482-489 forgets its return value — bug not reproduced).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class THD(NamedTuple):
    THD_F: jnp.ndarray  # (n,) relative to fundamental
    THD_R: jnp.ndarray  # (n,) relative to RMS


def get_thd(V_m: jnp.ndarray) -> THD:
    """Total harmonic distortion per bus from the (H, n) magnitude tensor.

    THD_F = sqrt(sum_{h>=3} V_m^2) / V_m(h=1)
    THD_R = sqrt(sum_{h>=3} V_m^2) / sqrt(sum_all V_m^2)
    (hcne_generalized.py:563-572)
    """
    harm = jnp.sqrt(jnp.sum(V_m[1:] ** 2, axis=0))
    total = jnp.sqrt(jnp.sum(V_m ** 2, axis=0))
    return THD(THD_F=harm / V_m[0], THD_R=harm / total)


def voltage_phasors(V_m: jnp.ndarray, V_a: jnp.ndarray) -> jnp.ndarray:
    """Complex phasors V_m·e^{j·V_a} (P2A, hcne_generalized.py:36-37).
    Host-side (numpy complex) — device code stays split-complex."""
    import numpy as np
    return np.asarray(V_m) * np.exp(1j * np.asarray(V_a))


def waveform(V_m, V_a, harmonics, n_samples: int = 1024):
    """One-period time reconstruction ``(theta, v)`` of an (H, ...) polar
    spectrum: ``v(θ) = √2·Σ_h V_h·cos(hθ + φ_h)`` — pu magnitudes are RMS
    phasors, so a clean 1.0 pu fundamental peaks at √2.

    ``v`` has shape (n_samples, ...).  Implemented as two (T, H)·(H, ...)
    contractions (cos(hθ+φ) expanded), so it is jit/vmap-safe and
    matmul-shaped; use it device-side for batched waveform screens.
    """
    V_m, V_a = jnp.asarray(V_m), jnp.asarray(V_a)
    h = jnp.asarray(harmonics, V_m.dtype)
    theta = jnp.linspace(0.0, 2.0 * jnp.pi, n_samples, endpoint=False,
                         dtype=V_m.dtype)
    c, s = jnp.cos(jnp.outer(theta, h)), jnp.sin(jnp.outer(theta, h))
    sq2 = jnp.sqrt(jnp.asarray(2.0, V_m.dtype))
    v = sq2 * (jnp.tensordot(c, V_m * jnp.cos(V_a), axes=1)
               - jnp.tensordot(s, V_m * jnp.sin(V_a), axes=1))
    return theta, v


class WaveformMetrics(NamedTuple):
    """Waveshape quantities a spectrum hides: ``rms`` (true, all
    harmonics), ``peak`` (max |v| over the period), ``crest`` = peak/rms
    (√2 for a clean sine — flat-topping pushes it below, peaking above),
    ``form`` = rms/mean|v| (π/(2√2) ≈ 1.111 for a sine)."""
    rms: jnp.ndarray
    peak: jnp.ndarray
    crest: jnp.ndarray
    form: jnp.ndarray


def waveform_metrics(V_m, V_a, harmonics,
                     n_samples: int = 2048) -> WaveformMetrics:
    """Crest/form factors and true RMS per bus (trailing dims of the
    (H, ...) inputs).  RMS comes from Parseval (exact); peak and mean|v|
    from the sampled reconstruction (error O(1/n_samples²) for the
    bandlimited signal)."""
    V_m = jnp.asarray(V_m)
    rms = jnp.sqrt(jnp.sum(V_m * V_m, axis=0))
    _, v = waveform(V_m, V_a, harmonics, n_samples)
    peak = jnp.max(jnp.abs(v), axis=0)
    mean_abs = jnp.mean(jnp.abs(v), axis=0)
    eps = jnp.finfo(rms.dtype).tiny
    return WaveformMetrics(rms=rms, peak=peak,
                           crest=peak / jnp.maximum(rms, eps),
                           form=rms / jnp.maximum(mean_abs, eps))


class HPFReport(NamedTuple):
    """Structured results object (SURVEY §5.5): the reference printed
    voltages/THD/timings to stdout (hcne_generalized.py:554, 609-623);
    here everything is data."""
    harmonics: tuple
    V_m: jnp.ndarray
    V_a: jnp.ndarray
    thd: THD
    n_iter_fund: int
    n_iter_harm: int
    err_fund: float
    err_harm: float
    converged: bool
    residual_history: jnp.ndarray  # (max_iter_h,), NaN-padded


def report(result, settings) -> HPFReport:
    """Summarize an HPFResult (single case)."""
    thd = get_thd(result.V_m)
    fund = result.fund
    return HPFReport(
        harmonics=tuple(settings.harmonics),
        V_m=result.V_m, V_a=result.V_a, thd=thd,
        n_iter_fund=int(fund.n_iter) if fund is not None else -1,
        n_iter_harm=int(result.n_iter),
        err_fund=float(fund.err) if fund is not None else float("nan"),
        err_harm=float(result.err),
        converged=bool(result.converged),
        residual_history=result.err_hist)
