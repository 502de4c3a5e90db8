"""Solver configuration.

Design follows the reference Julia ``Settings`` struct
(``Harmonic Power Flow/hcne.jl:49-90``), which is the best API sketch in the
reference repo: a single frozen config object holding the per-unit system,
considered harmonics, Newton-Raphson thresholds, and flat-start values.  The
Python reference keeps these as module globals
(``Harmonic Power Flow/hcne_generalized.py:578-593``).

``Settings`` is a frozen (hashable) dataclass so it can be passed as a
*static* argument through ``jax.jit`` — all shape-determining quantities
(number of harmonics, dtypes) are compile-time constants, as required for XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np


def default_harmonics(h_max: int) -> Tuple[int, ...]:
    """Odd harmonic orders 1, 3, ..., h_max (reference: hcne_generalized.py:584)."""
    return tuple(range(1, h_max + 1, 2))


@dataclasses.dataclass(frozen=True)
class Settings:
    """Frozen solver configuration (static under jit).

    Mirrors the capability set of ``hcne.jl:49-90`` (init_settings) and the
    module globals of ``hcne_generalized.py:578-593``.
    """

    # harmonic orders considered, fundamental first (multiples of net_freq)
    harmonics: Tuple[int, ...] = default_harmonics(51)
    coupled: bool = False

    # per-unit bases (hcne_generalized.py:578-579, hcne.jl:57-59)
    base_power: float = 1000.0      # W
    base_voltage: float = 400.0     # V
    net_freq: float = 50.0          # Hz

    # Newton-Raphson controls (hcne_generalized.py:244,511; hcne.jl:76-79)
    thresh_f: float = 1e-6
    max_iter_f: int = 30
    thresh_h: float = 1e-4
    max_iter_h: int = 50

    # flat-start voltages (hcne.jl:81-84; hcne_generalized.py:181-183)
    v_init_f: float = 1.0
    a_init_f: float = 0.0
    v_init_h: float = 0.1
    a_init_h: float = 0.0

    # numerics: None -> follow jax_enable_x64 (f64/c128 when enabled)
    dtype: Optional[str] = None

    # Newton-step linear solver: "dense" builds the full Jacobian and LU-
    # solves it (reference-equivalent); "arrow" exploits the harmonic-block
    # + Norton-coupling structure via Woodbury (hpfx.arrow) — same step to
    # fp noise, O(H·(2n)^3 + r^3) instead of O((2Hn)^3)
    solver: str = "dense"

    # reproduce the reference's line-shunt off-by-one (hcne_generalized.py:166
    # compares 1-based line endpoint IDs against the 0-based bus index).  Only
    # observable when line G/B != 0; all shipped nets have G = B = 0.
    compat_shunt_bug: bool = False

    # compute mismatch Y·V terms in the cancellation-free line-difference
    # form (hpfx.ybus.stable_matvec).  Algebraically identical; drops the
    # f32 residual floor from |Y|·eps (which exceeds thresh_h on stiff
    # grids like net1, stalling f32 Newton) to ~|flow|·eps.  Off by
    # default: the dense form matches the reference's arithmetic, which the
    # bit-level trajectory/iteration-count parity gates rely on.
    stable_mismatch: bool = False

    # Batch layout of hpf_sweep: "vmap" carries the scenario batch axis
    # FIRST (jax.vmap); "lanes" carries it LAST through the whole Newton
    # trip (hpfx.lanes).  Both compute the same iteration.  "auto" picks
    # hpfx.ops.auto_layout(platform) when the lane-major path supports the
    # configuration (arrow solver + stacked Norton devices), vmap
    # otherwise.
    layout: str = "auto"

    # Floor-aware convergence: the mismatch can only be *evaluated* to
    # ~eps·scale, scale = max_i sum_j |Y_ij|·|V_j| (+ Norton |Y_N|·|V|
    # sensitivities) — in f32 on stiff grids (net1: scale ~ 2e3) that
    # floor exceeds thresh_h, so an absolute test spins at max_iter while
    # the *state* is long converged (measured: residual stalls at 2.7e-4
    # with voltages already 6e-5 from the f64 golden).  The loop therefore
    # converges at err <= max(thresh, floor_kappa·eps·scale).  In f64 the
    # floor is ~1e-12, far below every reference threshold, so parity
    # (identical iteration counts vs the oracle) is unaffected.  Set
    # floor_kappa = 0 to force the raw absolute criterion.
    floor_kappa: float = 4.0

    # ---- derived quantities -------------------------------------------------
    @property
    def n_harmonics(self) -> int:
        """Number of harmonic orders incl. fundamental (K+1)."""
        return len(self.harmonics)

    @property
    def K(self) -> int:
        """Number of harmonics above the fundamental (hcne.jl:69)."""
        return len(self.harmonics) - 1

    @property
    def harmonics_freq(self) -> Tuple[float, ...]:
        """Harmonic frequencies in Hz (hcne_generalized.py:585)."""
        return tuple(self.net_freq * h for h in self.harmonics)

    @property
    def base_current(self) -> float:
        return self.base_power / self.base_voltage

    @property
    def base_admittance(self) -> float:
        return self.base_current / self.base_voltage

    @property
    def base_impedance(self) -> float:
        return 1.0 / self.base_admittance

    # ---- dtypes -------------------------------------------------------------
    @property
    def real_dtype(self):
        if self.dtype is not None:
            return jnp.dtype(self.dtype)
        import jax.dtypes
        return jax.dtypes.canonicalize_dtype(np.float64)  # f64 iff x64 on

    @property
    def complex_dtype(self):
        return jnp.dtype(np.result_type(self.real_dtype, np.complex64))

    def with_(self, **kwargs) -> "Settings":
        return dataclasses.replace(self, **kwargs)


def settings_for_hmax(h_max: int, **kwargs) -> Settings:
    return Settings(harmonics=default_harmonics(h_max), **kwargs)
