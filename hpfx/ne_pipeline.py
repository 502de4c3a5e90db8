"""Norton-equivalent production pipeline: simulation measurements -> NE
tables.

JAX equivalent of the reference's ``Circuit
Simulation/NE_from_sim.py`` (the L1 layer of SURVEY §1): ingest a
circuit-simulation measurement sweep (the ``<device>_<fmax>.mat`` structs
written by sim_FFT.m:327-329), assemble the measurement matrices, fit both
Norton-equivalent models, self-test them, and export the ``<device>_NE.csv``
table consumed by the solver (plus the OpenDSS-style spectrum CSV).

Measurement layout (NE_from_sim.py:21-28):
- ``results_f[c]``: fundamental-only sims varying (V_m_f, V_a_f),
- ``results_h[a, b]``: harmonic sims on a (frequency a, magnitude b) grid,
  fundamental held at the first fundamental measurement's voltage.

Fitting:
- uncoupled (Thunberg 1999, :86-114): per-harmonic 2-point difference
  quotient on the magnitude axis; fundamental from the two results_f sims,
- coupled (Almeida 2010, :138-173): one linear solve per output harmonic
  over the (N+1)-measurement voltage matrix [fund m1; harmonics m1; fund
  m2].  (Computed host-side in numpy f64; hpfx.devices.fit_coupled_ne /
  fit_uncoupled_ne are the equivalent on-device JAX implementations.)

Self-tests reconstruct the measured injections from the fitted NE and warn
above 1e-6 infinity-norm, mirroring :116-135 and :182-193.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeasurementSet:
    """A device-characterization sweep in frequency domain (host-side).

    ``spectrum`` are the FFT bin frequencies [Hz]; injections are complex
    current spectra.  ``harm_*`` have shape (n_freq, n_mag).
    """

    spectrum: np.ndarray           # (F,) Hz
    fund_V: np.ndarray             # (n_f,) complex applied fundamental
    fund_I: np.ndarray             # (n_f, F) complex injection spectra
    harm_freqs: np.ndarray         # (n_freq,) Hz of the applied harmonic
    harm_V: np.ndarray             # (n_freq, n_mag) complex applied voltage
    harm_I: np.ndarray             # (n_freq, n_mag, F) injection spectra
    net_freq: float = 50.0
    cycles: int = 1                # fundamental cycles per FFT window

    @property
    def harmonic_cols(self) -> np.ndarray:
        """Indices of the non-interharmonic odd-spectrum columns
        [net_freq :: cycles*2] (NE_from_sim.py:82-83)."""
        # spectrum bins carry FFT round-off (50.00000000000001 Hz etc.)
        start = int(np.argmin(np.abs(self.spectrum - self.net_freq)))
        return np.arange(start, len(self.spectrum), 2 * self.cycles)

    @property
    def freqs(self) -> np.ndarray:
        """All fitted frequencies: fundamental + applied harmonics."""
        return np.concatenate([[self.net_freq], self.harm_freqs])


def load_measurements_mat(path: str) -> MeasurementSet:
    """Load a ``<device>_<fmax>.mat`` sweep (sim_FFT.m output format)."""
    from scipy.io import loadmat

    data = loadmat(path, squeeze_me=True, struct_as_record=False)["all"]
    rf = np.atleast_1d(data.results_f)
    rh = np.atleast_2d(data.results_h)
    if rh.shape[1] < 2:
        raise ValueError("need >= 2 magnitude measurements per harmonic")
    if rh.shape[0] < 2:
        raise ValueError("need >= 2 harmonic frequencies")

    e0 = rh[0, 0]
    spectrum = np.asarray(e0.H, float)

    def inj(e):
        return np.asarray(e.I_inj) * np.exp(1j * np.asarray(e.I_inj_phase))

    fund_V = np.array([e.V_m_f * np.exp(1j * np.deg2rad(e.V_a_f))
                       for e in rf])
    fund_I = np.stack([inj(e) for e in rf])
    harm_freqs = np.array([float(rh[i, 0].f_h) for i in range(rh.shape[0])])
    harm_V = np.array([[e.V_m_h * np.exp(1j * np.deg2rad(e.V_a_h))
                        for e in row] for row in rh])
    harm_I = np.stack([[inj(e) for e in row] for row in rh])
    return MeasurementSet(
        spectrum=spectrum, fund_V=fund_V, fund_I=fund_I,
        harm_freqs=harm_freqs, harm_V=harm_V, harm_I=harm_I,
        cycles=int(e0.cycles))


@dataclasses.dataclass(frozen=True)
class NortonFit:
    """Fitted Norton equivalents in SI units + self-test residuals."""

    freqs: np.ndarray          # (N,) Hz, fundamental first
    Y_c: np.ndarray            # (N, N) coupled admittance
    I_c: np.ndarray            # (N,) coupled current source
    Y_uc: np.ndarray           # (N,) uncoupled admittance
    I_uc: np.ndarray           # (N,) uncoupled current source
    err_uncoupled: float       # max reconstruction error, both measurements
    err_coupled: float

    @property
    def passed(self) -> bool:
        """The reference warns above 1e-6 (NE_from_sim.py:132, 190)."""
        return max(self.err_uncoupled, self.err_coupled) < 1e-6


def fit_norton_from_measurements(ms: MeasurementSet) -> NortonFit:
    """Run both NE fits on a measurement sweep (NE_from_sim.py:86-193)."""
    cols = ms.harmonic_cols
    sel = ms.spectrum[cols]
    # column index (into `cols`) of each applied frequency
    fidx = np.array([int(np.argmin(np.abs(sel - f))) for f in ms.freqs])

    # --- uncoupled (Thunberg): per-harmonic difference quotient -----------
    # harmonic rows: injection at the applied frequency itself, m2 - m1
    hI1 = np.array([ms.harm_I[i, 0, cols[fidx[i + 1]]]
                    for i in range(len(ms.harm_freqs))])
    hI2 = np.array([ms.harm_I[i, 1, cols[fidx[i + 1]]]
                    for i in range(len(ms.harm_freqs))])
    hV1, hV2 = ms.harm_V[:, 0], ms.harm_V[:, 1]
    # host-side pipeline computes in numpy f64 (independent of the session's
    # jax_enable_x64 flag); the jax fit functions serve the on-device path
    Y_uc_h = (hI2 - hI1) / (hV1 - hV2)
    I_uc_h = Y_uc_h * hV1 + hI1
    # fundamental from the two results_f sims
    fI = ms.fund_I[:, cols[fidx[0]]]
    Y_uc_f = (fI[1] - fI[0]) / (ms.fund_V[0] - ms.fund_V[1])
    I_uc_f = Y_uc_f * ms.fund_V[0] + fI[0]
    I_uc = np.concatenate([[I_uc_f], I_uc_h])
    Y_uc = np.concatenate([[Y_uc_f], Y_uc_h])

    # uncoupled self-test against both measurements (:116-135)
    V1 = np.concatenate([[ms.fund_V[0]], hV1])
    V2 = np.concatenate([[ms.fund_V[1]], hV2])
    I1 = np.concatenate([[fI[0]], hI1])
    I2 = np.concatenate([[fI[1]], hI2])
    err_uc = max(np.abs(I_uc - Y_uc * V1 - I1).max(),
                 np.abs(I_uc - Y_uc * V2 - I2).max())

    # --- coupled (Almeida): (N+1)-measurement linear solve ----------------
    N = len(ms.freqs)
    V_mes = np.zeros((N + 1, N), complex)
    V_mes[:, 0] = ms.fund_V[0]
    V_mes[-1, 0] = ms.fund_V[1]
    for i in range(len(ms.harm_freqs)):
        V_mes[1 + i, 1 + i] = ms.harm_V[i, 0]
    I_mes = np.zeros((N + 1, N), complex)
    I_mes[0] = ms.fund_I[0, cols[fidx]]
    I_mes[-1] = ms.fund_I[1, cols[fidx]]
    for i in range(len(ms.harm_freqs)):
        I_mes[1 + i] = ms.harm_I[i, 0, cols[fidx]]
    A = np.concatenate([-V_mes, np.ones((N + 1, 1))], axis=1)
    X = np.linalg.solve(A, I_mes)
    Y_c, I_c = X[:-1].T, X[-1]

    # coupled self-test: reconstruct every measurement (:182-193)
    pred = I_c[None, :] - V_mes @ Y_c.T
    err_c = np.abs(pred - I_mes).max()

    return NortonFit(freqs=ms.freqs, Y_c=Y_c, I_c=I_c, Y_uc=Y_uc, I_uc=I_uc,
                     err_uncoupled=float(err_uc), err_coupled=float(err_c))


def device_set_from_fit(fit: NortonFit, settings, n_nl: int = 1):
    """Bridge a fresh fit straight into the solver: slice to the settings'
    harmonics, convert to per-unit (hcne_generalized.py:301-308), and stack
    for ``n_nl`` identical nonlinear buses."""
    from .devices import device_set_from_arrays

    want = [float(f) for f in settings.harmonics_freq]
    missing = [f for f in want if not np.any(np.isclose(fit.freqs, f))]
    if missing:
        raise ValueError(f"fit lacks frequencies {missing}")
    sel = np.array([int(np.argmin(np.abs(fit.freqs - f))) for f in want])
    if settings.coupled:
        I = fit.I_c[sel] / settings.base_current
        Y = fit.Y_c[np.ix_(sel, sel)] / settings.base_admittance
    else:
        I = fit.I_uc[sel] / settings.base_current
        Y = fit.Y_uc[sel] / settings.base_admittance
    I = np.broadcast_to(I, (n_nl,) + I.shape)
    Y = np.broadcast_to(Y, (n_nl,) + Y.shape)
    return device_set_from_arrays(I, Y, settings.coupled, settings)


def export_ne_csv(fit: NortonFit, path: str) -> None:
    """Write the ``<device>_NE.csv`` table (format of NE_from_sim.py:196-209;
    round-trips through hpfx.devices.read_ne_csv)."""
    freqs = [int(f) for f in fit.freqs]
    with open(path, "w", newline="") as fh:
        fh.write("Parameter,Frequency," +
                 ",".join(str(f) for f in freqs) + "\n")
        for i, f in enumerate(freqs):
            row = ",".join(_fmt(v) for v in fit.Y_c[i])
            fh.write(f"Y_N_c,{f},{row}\n")
        fh.write("I_N_c,0," + ",".join(_fmt(v) for v in fit.I_c) + "\n")
        fh.write("Y_N_uc,0," + ",".join(_fmt(v) for v in fit.Y_uc) + "\n")
        fh.write("I_N_uc,0," + ",".join(_fmt(v) for v in fit.I_uc) + "\n")


def _fmt(v: complex) -> str:
    return f"({v.real}{v.imag:+}j)"


def export_opendss_spectrum(ms: MeasurementSet, path: str) -> None:
    """OpenDSS-style normalized spectrum CSV (NE_from_sim.py:176-180,
    211-214): per fitted frequency, |I|/|I_fund| and the phase in degrees
    of the last harmonic measurement's injection."""
    cols = ms.harmonic_cols
    sel = ms.spectrum[cols]
    fidx = np.array([int(np.argmin(np.abs(sel - f))) for f in ms.freqs])
    I = ms.harm_I[-1, 0, cols[fidx]]
    mag = np.abs(I) / np.abs(I[0])
    ang = np.rad2deg(np.angle(I))
    with open(path, "w", newline="") as fh:
        for f, m, a in zip(ms.freqs, mag, ang):
            fh.write(f"{f / ms.net_freq},{m},{a}\n")
