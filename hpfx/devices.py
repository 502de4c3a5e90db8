"""Nonlinear device models: (harmonically-coupled) Norton equivalents.

Covers the reference's device layer end to end:
- CSV import of ``<device>_NE.csv`` tables with per-unit conversion
  (``hcne_generalized.py:278-310`` import_Norton_Equivalents), tolerant of
  the component-name case traps documented there (net1 says ``smps``,
  net2/net3 say ``SMPS``, the shipped file is ``smps_NE.csv``).
- NE *fitting* from measurement sets in JAX, both the uncoupled Thunberg-1999
  two-measurement scheme and the coupled Almeida-2010 (N+1)-measurement
  linear solve (``Circuit Simulation/NE_from_sim.py:86-173``), plus the
  round-trip self-test of ``NE_from_sim.py:116-135,182-193``.

A ``DeviceSet`` stacks the equivalents of every nonlinear bus into batched
arrays — ``I_N: (n_nl, H)`` and ``Y_N: (n_nl, H, H)`` (coupled) or
``(n_nl, H)`` (uncoupled) — so current injections and Jacobian couplings are
single batched einsums rather than per-bus Python loops.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network
from .utils.precision import highest_precision

# default on-disk location of the NE tables shipped with hpfx
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceSet:
    """Norton equivalents for all nonlinear buses of a network (stacked).

    ``I_N[k]``/``Y_N[k]`` belong to the k-th nonlinear bus (bus index m+k).
    ``coupled`` selects the (n_nl, H, H) full coupling matrix vs the
    (n_nl, H) diagonal model, mirroring hcne_generalized.py:301-308.
    Arrays are split-complex ``Cx`` pairs (see hpfx.cx).
    """

    I_N: Cx
    Y_N: Cx
    coupled: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def n_devices(self) -> int:
        return self.I_N.shape[0]

    def scale(self, factor) -> "DeviceSet":
        """Scale injections (penetration-sweep hook; vmap-able over factor).

        ``factor`` is a scalar (all devices in lockstep) or an (n_nl,)
        per-device vector (one penetration level per nonlinear bus — the
        hosting-capacity Monte-Carlo axis).  I_N and Y_N scale together,
        exactly the per-device Norton scaling of hcne_generalized.py:313-323
        (injections) and :425-435 (Jacobian couplings).
        """
        factor = jnp.asarray(factor, self.I_N.re.dtype)
        if factor.ndim == 0:
            return dataclasses.replace(
                self, I_N=self.I_N * factor, Y_N=self.Y_N * factor)
        if factor.ndim != 1:
            raise ValueError(
                f"scale factor must be scalar or (n_nl,), got {factor.shape}")
        fY = factor[:, None, None] if self.coupled else factor[:, None]
        return dataclasses.replace(
            self, I_N=self.I_N * factor[:, None], Y_N=self.Y_N * fY)


def _parse_complex(s: str) -> complex:
    return complex(s.strip().strip("()"))


def read_ne_csv(path: str) -> Dict:
    """Parse a ``<device>_NE.csv`` table into raw (SI-unit) numpy arrays.

    Returns dict with ``freqs`` (the file's frequency columns), ``Y_c``
    ((F, F), rows ordered by the Frequency index), ``I_c``, ``Y_uc``,
    ``I_uc`` (each (F,)).  Format produced by NE_from_sim.py:196-209.
    """
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    header = rows[0]
    freqs = [int(float(col)) for col in header[2:]]
    y_c: Dict[int, np.ndarray] = {}
    vecs: Dict[str, np.ndarray] = {}
    for row in rows[1:]:
        param, freq = row[0], int(float(row[1]))
        vals = np.array([_parse_complex(v) for v in row[2:]])
        if param == "Y_N_c":
            y_c[freq] = vals
        else:
            vecs[param] = vals
    Y_c = np.stack([y_c[f] for f in sorted(y_c)])
    return dict(freqs=freqs, y_row_freqs=sorted(y_c), Y_c=Y_c,
                I_c=vecs["I_N_c"], Y_uc=vecs["Y_N_uc"], I_uc=vecs["I_N_uc"])


def load_norton_equivalent(
    path: str, settings: Settings, coupled: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load one device's NE, sliced to the considered harmonics and converted
    to per-unit (hcne_generalized.py:296-308): I_N / base_current,
    Y_N / base_admittance.  Returns (I_N (H,), Y_N (H,H) or (H,))."""
    raw = read_ne_csv(path)
    want = [int(f) for f in settings.harmonics_freq]
    missing = [f for f in want if f not in raw["freqs"]]
    if missing:
        raise ValueError(
            f"{path} has no Norton data for frequencies {missing} "
            f"(available: {raw['freqs']})")
    cols = [raw["freqs"].index(f) for f in want]
    if coupled:
        rsel = [raw["y_row_freqs"].index(f) for f in want]
        Y = raw["Y_c"][np.ix_(rsel, cols)] / settings.base_admittance
        I = raw["I_c"][cols] / settings.base_current
    else:
        Y = raw["Y_uc"][cols] / settings.base_admittance
        I = raw["I_uc"][cols] / settings.base_current
    return I, Y


def resolve_ne_path(component: str, search_dirs: Sequence[str]) -> str:
    """Find ``<component>_NE.csv`` case-insensitively (normalizes the
    smps/SMPS naming trap; see SURVEY §2.5)."""
    target = f"{component}_NE.csv".lower()
    for d in search_dirs:
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            if fname.lower() == target:
                return os.path.join(d, fname)
    raise FileNotFoundError(
        f"no Norton-equivalent table {component}_NE.csv in {list(search_dirs)}")


def load_device_set(
    net: Network, settings: Settings,
    search_dirs: Sequence[str] = (DATA_DIR,),
) -> DeviceSet:
    """Load NEs for every nonlinear bus of ``net`` (one file read per unique
    component, as in import_Norton_Equivalents, hcne_generalized.py:284-310)."""
    coupled = settings.coupled
    H = settings.n_harmonics
    if net.n_nonlinear == 0:
        # purely linear grid: empty device stack (the harmonic solve
        # reduces to the linear network equations)
        shape_y = (0, H, H) if coupled else (0, H)
        return DeviceSet(I_N=cx.zeros((0, H), settings.real_dtype),
                         Y_N=cx.zeros(shape_y, settings.real_dtype),
                         coupled=coupled)
    unique: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for comp in set(net.nonlinear_components):
        path = resolve_ne_path(comp, search_dirs)
        unique[comp] = load_norton_equivalent(path, settings, coupled)
    I_N = np.stack([unique[c][0] for c in net.nonlinear_components])
    Y_N = np.stack([unique[c][1] for c in net.nonlinear_components])
    rd = settings.real_dtype
    return DeviceSet(I_N=cx.from_numpy(I_N, rd), Y_N=cx.from_numpy(Y_N, rd),
                     coupled=coupled)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceLibrary:
    """A palette of Norton-equivalent device *types* for device-mix sweeps.

    Where a ``DeviceSet`` fixes one equivalent per nonlinear bus, a library
    stacks the NEs of ``T`` device types — ``I_lib (T, H)``, ``Y_lib
    (T, H, H)`` coupled or ``(T, H)`` uncoupled — and :meth:`mixed` blends
    them into a per-bus DeviceSet with real weights ``w (n_nl, T)``:

        I_N[d] = sum_t w[d, t] · I_lib[t]     (same for Y_N)

    Since Norton parameters enter the mismatch and Jacobian *linearly*
    (hcne_generalized.py:313-323, 425-435), a weighted NE sum is exactly the
    physics of ``w[d, t]`` parallel devices of type ``t`` at bus ``d`` —
    one-hot rows select a type, fractional rows model partial penetration
    or co-located device blends.  The scenario-sweep hook is
    ``Scenarios.device_mix`` (B, n_nl, T), vmapped/lane-batched over B.
    """

    I_lib: Cx
    Y_lib: Cx
    coupled: bool = dataclasses.field(metadata=dict(static=True))
    names: Tuple[str, ...] = dataclasses.field(
        default=(), metadata=dict(static=True))

    @property
    def n_types(self) -> int:
        return self.I_lib.shape[0]

    def mixed(self, w) -> DeviceSet:
        """Blend the library into a DeviceSet with weights ``w (n_nl, T)``
        (vmap-able over a leading scenario axis)."""
        w = jnp.asarray(w, self.I_lib.re.dtype)
        es = lambda spec, arr: Cx(
            jnp.einsum(spec, w, arr.re, precision=cx._PREC),
            jnp.einsum(spec, w, arr.im, precision=cx._PREC))
        I_N = es("dt,th->dh", self.I_lib)
        Y_N = es("dt,thp->dhp" if self.coupled else "dt,th->dh", self.Y_lib)
        return DeviceSet(I_N=I_N, Y_N=Y_N, coupled=self.coupled)

    def index(self, name: str) -> int:
        return self.names.index(name)


def load_device_library(
    components: Sequence[str], settings: Settings,
    search_dirs: Sequence[str] = (DATA_DIR,),
) -> DeviceLibrary:
    """Load NE tables for ``components`` (unique device-type names) into a
    stacked :class:`DeviceLibrary` (same per-unit conversion and
    case-insensitive file resolution as :func:`load_device_set`)."""
    coupled = settings.coupled
    pairs = [load_norton_equivalent(resolve_ne_path(comp, search_dirs),
                                    settings, coupled)
             for comp in components]
    rd = settings.real_dtype
    I_lib = cx.from_numpy(np.stack([p[0] for p in pairs]), rd)
    Y_lib = cx.from_numpy(np.stack([p[1] for p in pairs]), rd)
    return DeviceLibrary(I_lib=I_lib, Y_lib=Y_lib, coupled=coupled,
                         names=tuple(components))


def device_set_from_arrays(I_N, Y_N, coupled: bool,
                           settings: Settings) -> DeviceSet:
    rd = settings.real_dtype
    I_N = I_N if isinstance(I_N, Cx) else cx.from_numpy(I_N, rd)
    Y_N = Y_N if isinstance(Y_N, Cx) else cx.from_numpy(Y_N, rd)
    if coupled and Y_N.ndim == 2:
        I_N, Y_N = I_N[None], Y_N[None]
    if not coupled and Y_N.ndim == 1:
        I_N, Y_N = I_N[None], Y_N[None]
    return DeviceSet(I_N=I_N.astype(rd), Y_N=Y_N.astype(rd), coupled=coupled)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AnalyticDeviceSet:
    """Nonlinear devices defined by an arbitrary differentiable injection.

    Generalizes the capability of the reference's textbook examples, where
    the device is an analytic current source g(V) with *hand-derived*
    injection Jacobians (example_hpf_fuchs.py:166-169, 265-381;
    hcne_based_on_fuchs.py:168-173, 266-324).  Here the solver obtains the
    Jacobian coupling blocks by forward-mode autodiff of ``inject`` — a
    capability the reference never had (SURVEY §7.1).

    ``inject(params_i, V_m (H,), V_a (H,)) -> Cx (H,)`` maps one device's
    bus-voltage spectrum (signed magnitudes and angles, exactly the solver's
    internal state) to its injected current spectrum.  ``params`` is any
    pytree whose leaves carry a leading n_nl axis (one slice per nonlinear
    bus).  Norton equivalents are the special case
    inject = I_N - Y_N · polar(V_m, V_a); they keep the dedicated
    ``DeviceSet`` fast path (batched einsum, no autodiff).
    """

    params: object
    inject: object = dataclasses.field(metadata=dict(static=True))
    n_nl: int = dataclasses.field(metadata=dict(static=True))
    #: injection multiplier (penetration-sweep hook; a *data* leaf so
    #: scenario sweeps can vmap over it): scalar (all devices) or (n_nl,)
    #: per-device — every device's injected current, and hence its Jacobian
    #: coupling, is scaled by it, matching DeviceSet.scale's I_N/Y_N
    #: scaling semantics exactly
    inj_scale: object = 1.0

    coupled = True  # treated as fully harmonic-coupled by the solver

    def scale(self, factor) -> "AnalyticDeviceSet":
        """Scale injections (penetration-sweep hook; vmap-able over factor;
        scalar or (n_nl,) per-device)."""
        return dataclasses.replace(
            self, inj_scale=jnp.asarray(self.inj_scale) * factor)

    def _s(self, extra_dims: int):
        """inj_scale broadcast against a (n_nl, ...) device-major array."""
        s = jnp.asarray(self.inj_scale)
        return s.reshape(s.shape + (1,) * extra_dims) if s.ndim else s

    def injections(self, V_m_nl, V_a_nl) -> Cx:
        """All devices' injections: V_*_nl (H, n_nl) -> (n_nl, H)."""
        return jax.vmap(self.inject, in_axes=(0, 1, 1))(
            self.params, V_m_nl, V_a_nl) * self._s(1)

    def injection_jacobians(self, V_m_nl, V_a_nl):
        """d I_inj / d(V_m, V_a) per device: two Cx of shape (n_nl, H, H),
        [d, h, p] = ∂I_inj[d, h] / ∂V_{m|a}[p, d]."""

        def per_bus(p, vm, va):
            JV = jax.jacfwd(lambda v: self.inject(p, v, va))(vm)
            JA = jax.jacfwd(lambda a: self.inject(p, vm, a))(va)
            return JV, JA

        JV, JA = jax.vmap(per_bus, in_axes=(0, 1, 1))(
            self.params, V_m_nl, V_a_nl)
        return JV * self._s(2), JA * self._s(2)


def norton_inject(params, V_m, V_a) -> Cx:
    """Norton-equivalent injection as an analytic device: params=(I_N, Y_N)
    with Y_N (H, H); I = I_N - Y_N·V (hcne_generalized.py:320-322).
    Useful for testing the autodiff path against the closed-form one."""
    I_N, Y_N = params
    return I_N - cx.matvec(Y_N, cx.polar(V_m, V_a))


# ---------------------------------------------------------------------------
# Norton-equivalent fitting (JAX, differentiable)
# ---------------------------------------------------------------------------

def _as_cx(x) -> Cx:
    return x if isinstance(x, Cx) else cx.from_numpy(np.asarray(x))


@highest_precision
def fit_coupled_ne(V_mes, I_mes):
    """Coupled HCNE fit (Almeida 2010; NE_from_sim.py:138-173).

    Given M = H+1 measurements of applied voltage spectra ``V_mes (M, H)``
    and injected current spectra ``I_mes (M, H)``, solve for each output
    harmonic j the linear system  I[k,j] = I_N[j] - sum_p Y_N[j,p] V[k,p],
    i.e.  [-V | 1] @ [Y_N[j,:] ; I_N[j]] = I[:,j].

    Accepts complex arrays or ``Cx``; returns (I_N (H,), Y_N (H,H)) as
    ``Cx``.  Fully differentiable; the reference's explicit matrix inverse
    is replaced by a (real-block) linear solve.
    """
    V_mes, I_mes = _as_cx(V_mes), _as_cx(I_mes)
    M, H = V_mes.shape
    if M != H + 1:
        raise ValueError(f"coupled fit needs H+1={H + 1} measurements, got {M}")
    ones = Cx(jnp.ones((M, 1), V_mes.dtype), jnp.zeros((M, 1), V_mes.dtype))
    A = cx.concatenate([-V_mes, ones], axis=1)
    X = cx.solve(A, I_mes)               # (H+1, H): rows = [Y_N^T ; I_N]
    Y_N = X[:-1].T
    I_N = X[-1]
    return I_N, Y_N


def fit_uncoupled_ne(V_m1, I_m1, V_m2, I_m2):
    """Uncoupled NE fit (Thunberg 1999; NE_from_sim.py:86-114).

    Per harmonic h, from two measurements (V1[h], I1[h]) and (V2[h], I2[h]):
        Y_N[h] = (I2[h] - I1[h]) / (V1[h] - V2[h])
        I_N[h] = Y_N[h] * V1[h] + I1[h]
    All arguments shape (H,).  Returns (I_N (H,), Y_N (H,)) as ``Cx``.
    """
    V_m1, I_m1 = _as_cx(V_m1), _as_cx(I_m1)
    V_m2, I_m2 = _as_cx(V_m2), _as_cx(I_m2)
    Y_N = (I_m2 - I_m1) / (V_m1 - V_m2)
    I_N = Y_N * V_m1 + I_m1
    return I_N, Y_N


def ne_injection(I_N, Y_N, V) -> Cx:
    """Model current injection I = I_N - Y_N·V (coupled or uncoupled),
    the sign convention of hcne_generalized.py:320-322."""
    I_N, Y_N, V = _as_cx(I_N), _as_cx(Y_N), _as_cx(V)
    if Y_N.ndim == 2:
        return I_N - cx.matvec(Y_N, V)
    return I_N - Y_N * V


def ne_selftest(I_N, Y_N, V_mes, I_mes):
    """Max |model - measurement| over a measurement set; the reference warns
    above 1e-6 (NE_from_sim.py:132-135, 190-193)."""
    I_N, Y_N = _as_cx(I_N), _as_cx(Y_N)
    V, I = _as_cx(V_mes), _as_cx(I_mes)
    if V.ndim == 1:
        V, I = V[None], I[None]
    if Y_N.ndim == 2:
        pred = I_N[None, :] - cx.einsum("hp,mp->mh", Y_N, V)
    else:
        pred = I_N[None, :] - Y_N[None, :] * V
    return jnp.max((pred - I).abs())
