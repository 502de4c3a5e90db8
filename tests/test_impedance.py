"""Per-harmonic impedance scan (hpfx.impedance).

Oracle: an independent numpy COMPLEX inversion of the same Ybus — the
split-complex block solve must match it to fp noise.  Physics gate: a
constructed line-L / pi-shunt-C feeder must place its parallel resonance
at the analytic order h* = sqrt(2/(X·B)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hpfx
from hpfx.impedance import (driving_point_impedance, impedance_scan,
                            resonance_peaks)
from hpfx.ybus import build_ybus

from conftest import DATA


def _np_complex(Y):
    return np.asarray(Y.re) + 1j * np.asarray(Y.im)


@pytest.mark.parametrize("net_name", ["net1", "net2", "net3"])
def test_scan_matches_numpy_inverse(net_name):
    s = hpfx.settings_for_hmax(25, coupled=True)
    net = hpfx.load_network(f"{DATA}/{net_name}_buses.csv",
                            f"{DATA}/{net_name}_lines.csv", s)
    Y = build_ybus(net, s)
    Z = jax.jit(lambda: impedance_scan(net, s))()
    Zc = _np_complex(Z)
    # grounded slack: rows/cols 1: are the inverse of the reduced Y
    ref = np.linalg.inv(_np_complex(Y)[:, 1:, 1:])
    np.testing.assert_allclose(Zc[:, 1:, 1:], ref, atol=1e-12)
    assert np.abs(Zc[:, 0, :]).max() == 0 and np.abs(Zc[:, :, 0]).max() == 0
    # no phase shifters in the fixture nets: Y symmetric => Z symmetric
    np.testing.assert_allclose(Zc, np.swapaxes(Zc, -1, -2), atol=1e-12)


def test_ungrounded_scan_harmonic_rows():
    """With ground_slack=False the raw Y(h) is inverted; valid on net2's
    harmonic rows, where bus shunt reactances tie the network to ground
    (the h=1 block has no shunts in the reference model and is singular,
    which is exactly why grounding is the default)."""
    s = hpfx.settings_for_hmax(25, coupled=True)
    net = hpfx.load_network(f"{DATA}/net2_buses.csv",
                            f"{DATA}/net2_lines.csv", s)
    Y = build_ybus(net, s)
    Z = impedance_scan(net, s, ground_slack=False)
    ref = np.linalg.inv(_np_complex(Y)[1:])
    np.testing.assert_allclose(_np_complex(Z)[1:], ref, atol=1e-10)


def test_lc_resonance_position(tmp_path):
    """A slack—(R,X_L)—bus feeder with pi-line charging B at the far end
    parallel-resonates where the inductive and capacitive branch
    susceptances cancel: h*^2 = 2/(X·B).  X=0.1, B=2/(0.1·49) puts h*=7;
    the scan must peak exactly there (odd harmonics 1..25)."""
    X, target_h = 0.1, 7
    B = 2.0 / (X * target_h ** 2)
    (tmp_path / "b.csv").write_text(
        "ID;type;component;S;P;Q;X_sh\n"
        "1;slack;generator;0;0;0;0\n"
        "2;PQ;nothing;0;0;0;0\n")
    (tmp_path / "l.csv").write_text(
        "ID;fromID;toID;R;X;G;B\n"
        f"1;1;2;0.001;{X};0;{B}\n")
    s = hpfx.settings_for_hmax(25, coupled=True)
    net = hpfx.load_network(str(tmp_path / "b.csv"),
                            str(tmp_path / "l.csv"), s)
    zmag = driving_point_impedance(net, s)
    is_peak, worst_h, worst_z = resonance_peaks(zmag, s)
    assert int(worst_h[1]) == target_h
    hi = list(s.harmonics).index(target_h)
    assert bool(is_peak[hi, 1])
    # resonance dominates the neighbors by the R-limited peak
    assert float(worst_z[1]) > 5 * float(zmag[hi - 1, 1])
    # slack row of a grounded scan is identically zero, never a peak
    assert float(worst_z[0]) == 0 and not bool(is_peak[:, 0].any())


def test_peaks_consistent_with_argmax():
    s = hpfx.settings_for_hmax(51, coupled=True)
    net = hpfx.load_network(f"{DATA}/net1_buses.csv",
                            f"{DATA}/net1_lines.csv", s)
    zmag = driving_point_impedance(net, s)
    is_peak, worst_h, worst_z = resonance_peaks(zmag, s)
    hs = np.asarray(s.harmonics)
    k = np.argmax(np.asarray(zmag), axis=0)
    np.testing.assert_array_equal(np.asarray(worst_h), hs[k])
    # every global max with nonzero magnitude is flagged as a local peak
    nz = np.asarray(worst_z) > 0
    assert all(bool(np.asarray(is_peak)[k[i], i]) for i in
               np.nonzero(nz)[0])


def test_tuned_filter_collapses_resonance(tmp_path):
    """Installing a single-tuned filter at the resonant bus, tuned to the
    detected order, collapses the driving-point peak there (>20x) while
    leaving far-away orders nearly untouched."""
    X, target_h = 0.1, 7
    B = 2.0 / (X * target_h ** 2)
    (tmp_path / "b.csv").write_text(
        "ID;type;component;S;P;Q;X_sh\n"
        "1;slack;generator;0;0;0;0\n"
        "2;PQ;nothing;0;0;0;0\n")
    (tmp_path / "l.csv").write_text(
        "ID;fromID;toID;R;X;G;B\n"
        f"1;1;2;0.001;{X};0;{B}\n")
    s = hpfx.settings_for_hmax(25, coupled=True)
    net = hpfx.load_network(str(tmp_path / "b.csv"),
                            str(tmp_path / "l.csv"), s)
    Y = build_ybus(net, s)
    zmag0 = driving_point_impedance(net, s, Y=Y)
    _, worst_h, _ = resonance_peaks(zmag0, s)
    h_star = int(worst_h[1])
    yf = hpfx.tuned_filter_admittance(s, h_star, x_cap=2.0, quality=30.0)
    # at the tuned order the branch is purely resistive: G = Q/sqrt(XL*XC)
    hi = list(s.harmonics).index(h_star)
    x_l = 2.0 / h_star ** 2
    np.testing.assert_allclose(float(yf.re[hi]),
                               30.0 / np.sqrt(x_l * 2.0), rtol=1e-6)
    np.testing.assert_allclose(float(yf.im[hi]), 0.0, atol=1e-6)
    Yf = hpfx.install_shunt(Y, 1, yf)
    zmag1 = driving_point_impedance(net, s, Y=Yf)
    assert float(zmag1[hi, 1]) < float(zmag0[hi, 1]) / 20
    # far from the tuned order the filter is nearly transparent
    assert float(zmag1[-1, 1]) > 0.5 * float(zmag0[-1, 1])


def _resonant_smps_feeder(tmp_path, s, target_h=7):
    """slack—(R, X_L, line-charging B)—SMPS feeder whose PASSIVE parallel
    resonance sits at target_h, right on a strong SMPS injection order."""
    X = 0.1
    B = 2.0 / (X * target_h ** 2)
    (tmp_path / "b.csv").write_text(
        "ID;type;component;S;P;Q;X_sh\n"
        "1;slack;generator;0;0;0;0\n"
        "2;nonlinear;SMPS;0;250;100;0\n")
    (tmp_path / "l.csv").write_text(
        "ID;fromID;toID;R;X;G;B\n"
        f"1;1;2;0.02;{X};0;{B}\n")
    net = hpfx.load_network(str(tmp_path / "b.csv"),
                            str(tmp_path / "l.csv"), s)
    return net, hpfx.load_device_set(net, s)


def test_operational_scan_predicts_uncoupled_fixed_point(tmp_path):
    """The device-inclusive (operational) scan is EXACT for the
    uncoupled Norton model: the reference's harmonic current balance is
    (Y − Y_N)·V(h) = −I_N(h) (hcne_generalized.py:313-357 sign
    convention), so −Z_op(h)·I_N(h) must equal the solved HPF harmonic
    voltages to the NR convergence tolerance — with and without a tuned
    filter installed through the Y= override.  Also gates the
    operational-vs-passive
    story: the converter's Norton admittance damps the passive parallel
    resonance by more than an order of magnitude."""
    from hpfx.harmonic import hpf

    s = hpfx.settings_for_hmax(25, coupled=False)
    net, dev = _resonant_smps_feeder(tmp_path, s)
    Y = build_ybus(net, s)
    hi = list(s.harmonics).index(7)

    for label, Yv in (("plain", Y),
                      ("filtered", hpfx.install_shunt(
                          Y, 1, hpfx.tuned_filter_admittance(
                              s, 7, x_cap=2.0)))):
        res = hpf(net, dev, s, Y=Yv)
        assert bool(res.converged), label
        V = np.asarray(res.V_m) * np.exp(1j * np.asarray(res.V_a))
        Z = impedance_scan(net, s, Y=Yv, devices=dev, ground_slack=False)
        Zc = _np_complex(Z)
        IN = np.asarray(dev.I_N.re[0]) + 1j * np.asarray(dev.I_N.im[0])
        pred = -Zc[1:, :, 1] * IN[1:, None]          # all buses, h > 1
        act = V[1:].T                                 # (n, K) -> transpose
        err = np.abs(pred - act.T).max() / np.abs(act).max()
        # the solved state carries the NR stopping tolerance (thresh
        # 1e-8 on mismatch), not fp noise
        assert err < 1e-7, (label, err)

    zp = driving_point_impedance(net, s, Y=Y)
    zo = driving_point_impedance(net, s, Y=Y, devices=dev)
    assert float(zo[hi, 1]) < float(zp[hi, 1]) / 10


def test_filter_suppresses_tuned_order_in_full_hpf(tmp_path):
    """scan -> detect -> size -> re-solve on the resonant SMPS feeder
    (coupled model): the passive scan flags h=7, and installing the
    single-tuned filter through the solver's Y= override suppresses the
    solved h=7 voltage by the ratio the OPERATIONAL scan predicts.  The
    converter's own Y_N (|Y_N(h7)| ~ 423 pu) already damps the passive
    peak ~1000x in the base case, so the honest yardstick is the
    operational-Z ratio, not the 20x passive collapse — and a filter
    must be sized against Y_N (x_cap=0.05 -> |Y_f(h7)| = 4200 pu) to
    bite at all; the textbook x_cap=2.0 branch measurably does NOT
    (operational gain 1.01).  That sizing insight is what the
    device-inclusive scan is for."""
    from hpfx.harmonic import hpf

    s = hpfx.settings_for_hmax(25, coupled=True)
    net, dev = _resonant_smps_feeder(tmp_path, s)
    Y = build_ybus(net, s)
    zmag = driving_point_impedance(net, s, Y=Y)
    _, worst_h, _ = resonance_peaks(zmag, s)
    h_star = int(worst_h[1])
    assert h_star == 7
    hi = list(s.harmonics).index(h_star)

    yf = hpfx.tuned_filter_admittance(s, h_star, x_cap=0.05)
    Yf = hpfx.install_shunt(Y, 1, yf)
    zo0 = driving_point_impedance(net, s, Y=Y, devices=dev,
                                  ground_slack=False)
    zo1 = driving_point_impedance(net, s, Y=Yf, devices=dev,
                                  ground_slack=False)
    gain = float(zo0[hi, 1]) / float(zo1[hi, 1])
    assert gain > 1.4                       # the filter must actually bite

    res0 = hpf(net, dev, s, Y=Y)
    res1 = hpf(net, dev, s, Y=Yf)
    assert bool(res0.converged) and bool(res1.converged)
    v7_0 = float(res0.V_m[hi, 1])
    v7_1 = float(res1.V_m[hi, 1])
    supp = v7_0 / v7_1
    # coupled cross-harmonic terms perturb the per-harmonic prediction,
    # but the realized suppression must track the operational-Z ratio
    # in both directions (measured supp/gain = 0.97-1.02 here)
    assert 0.7 * gain < supp < 1.5 * gain, (supp, gain)


def test_frequency_scan_finds_detuned_resonance(tmp_path):
    """An LC feeder tuned to h* = 7.4 — BETWEEN integer orders.  The
    integer scan can only report h=7 and badly underestimates the peak
    (R=0.001 makes it sharp); the dense frequency scan must localize the
    true resonance to grid resolution and expose its real magnitude."""
    X, h_star = 0.1, 7.4
    B = 2.0 / (X * h_star ** 2)
    (tmp_path / "b.csv").write_text(
        "ID;type;component;S;P;Q;X_sh\n"
        "1;slack;generator;0;0;0;0\n"
        "2;PQ;nothing;0;0;0;0\n")
    (tmp_path / "l.csv").write_text(
        "ID;fromID;toID;R;X;G;B\n"
        f"1;1;2;0.001;{X};0;{B}\n")
    s = hpfx.settings_for_hmax(25, coupled=True)
    net = hpfx.load_network(str(tmp_path / "b.csv"),
                            str(tmp_path / "l.csv"), s)
    zmag_int = driving_point_impedance(net, s)
    _, worst_h, worst_z = resonance_peaks(zmag_int, s)
    assert int(worst_h[1]) == 7          # best an integer scan can do
    grid = np.round(np.arange(6.0, 9.0001, 0.05), 4)
    zdense = hpfx.frequency_scan(net, s, grid)
    assert zdense.shape == (len(grid), 2)
    h_found = float(grid[int(np.argmax(np.asarray(zdense)[:, 1]))])
    assert abs(h_found - h_star) <= 0.0501, h_found
    # the detuned peak is far taller than anything the integer scan saw
    assert float(np.max(np.asarray(zdense)[:, 1])) > 5 * float(worst_z[1])
    # consistency: an integer grid reproduces the integer scan exactly
    zint = hpfx.frequency_scan(net, s, [float(h) for h in s.harmonics])
    np.testing.assert_allclose(np.asarray(zint), np.asarray(zmag_int),
                               rtol=1e-12)


def test_frequency_scan_operational_matches_at_nodes(tmp_path):
    """With devices=, the dense scan interpolates the Norton diagonals —
    at integer grid points it must equal the operational integer scan."""
    s = hpfx.settings_for_hmax(25, coupled=True)
    net, dev = _resonant_smps_feeder(tmp_path, s)
    zo = driving_point_impedance(net, s, devices=dev)
    zf = hpfx.frequency_scan(net, s, [float(h) for h in s.harmonics],
                             devices=dev)
    np.testing.assert_allclose(np.asarray(zf), np.asarray(zo), rtol=1e-12)
    # off-grid evaluation stays finite and positive at the load bus
    zq = hpfx.frequency_scan(net, s, np.arange(2.0, 25.0, 0.5),
                             devices=dev)
    assert np.isfinite(np.asarray(zq)).all() and (np.asarray(zq)[:, 1] > 0).all()


def test_distortion_contributions_superpose(tmp_path):
    """Two SMPS devices on a 3-bus feeder: the per-device contributions
    (through the operational Z) must sum EXACTLY to the solved uncoupled
    HPF harmonic voltages — the superposition the linear Norton balance
    guarantees — and each device's share must differ (different transfer
    impedances)."""
    from hpfx.harmonic import hpf

    (tmp_path / "b.csv").write_text(
        "ID;type;component;S;P;Q;X_sh\n"
        "1;slack;generator;0;0;0;0\n"
        "2;nonlinear;SMPS;0;150;50;0\n"
        "3;nonlinear;SMPS;0;250;100;0\n")
    (tmp_path / "l.csv").write_text(
        "ID;fromID;toID;R;X;G;B\n"
        "1;1;2;0.02;0.1;0;4.0\n"
        "2;2;3;0.05;0.2;0;2.0\n")
    s = hpfx.settings_for_hmax(25, coupled=False)
    net = hpfx.load_network(str(tmp_path / "b.csv"),
                            str(tmp_path / "l.csv"), s)
    dev = hpfx.load_device_set(net, s)
    assert dev.n_devices == 2

    res = hpf(net, dev, s)
    assert bool(res.converged)
    V = np.asarray(res.V_m) * np.exp(1j * np.asarray(res.V_a))

    contrib = hpfx.distortion_contributions(net, dev, s)
    assert contrib.shape == (len(s.harmonics), net.n, 2)
    C = _np_complex(contrib)
    total = C.sum(axis=-1)                        # (H, n)
    err = np.abs(total[1:] - V[1:]).max() / np.abs(V[1:]).max()
    assert err < 1e-7, err                        # NR-tolerance exact
    # the two devices see different transfer impedances: their shares at
    # the remote bus must not coincide
    assert np.abs(C[1:, 1, 0] - C[1:, 1, 1]).max() > 1e-6


def _np_highpass_z(h, x_cap, h_corner, m):
    x_l = x_cap / h_corner**2
    R = m * h_corner * x_l
    return (-1j * x_cap / h) + (R * 1j * h * x_l) / (R + 1j * h * x_l)


def _np_ctype_z(h, x_cap, h_tune, q):
    x_l = x_cap / (h_tune**2 - 1.0)
    R = q * h_tune * x_l
    z_aux = 1j * (h * x_l - x_l / h)       # L series C2, x_c2 = x_l
    return (-1j * x_cap / h) + (R * z_aux) / (R + z_aux)


def test_highpass_filter_vs_numpy_oracle():
    s = hpfx.settings_for_hmax(25, coupled=True)
    h = np.asarray(s.harmonics, float)
    yf = hpfx.highpass_filter_admittance(s, h_corner=11.0, x_cap=2.0,
                                         m=1.5)
    z_ref = _np_highpass_z(h, 2.0, 11.0, 1.5)
    np.testing.assert_allclose(_np_complex(yf), 1.0 / z_ref, rtol=1e-10)
    # broad-band: above the corner the filter stays a strong sink
    # (conductance within 3x of its best) instead of a narrow notch
    g = np.real(1.0 / z_ref)
    above = h >= 11
    assert g[above].min() > g.max() / 3
    # bank vectorization
    bank = hpfx.highpass_filter_admittance(
        s, h_corner=np.array([7.0, 13.0]), x_cap=np.array([2.0, 3.0]))
    assert bank.re.shape == (2, len(s.harmonics))
    np.testing.assert_allclose(
        _np_complex(bank)[1],
        _np_complex(hpfx.highpass_filter_admittance(s, 13.0, 3.0)),
        rtol=1e-12)


def test_ctype_filter_vs_numpy_oracle_and_lossless_fundamental():
    s = hpfx.settings_for_hmax(25, coupled=True)
    h = np.asarray(s.harmonics, float)
    yf = hpfx.ctype_filter_admittance(s, h_tune=3.0, x_cap=2.0,
                                      quality=2.0)
    z_ref = _np_ctype_z(h, 2.0, 3.0, 2.0)
    np.testing.assert_allclose(_np_complex(yf), 1.0 / z_ref, rtol=1e-10)
    # the C-type's defining property: the auxiliary L-C2 shorts R at the
    # fundamental — zero resistive part, pure capacitor (no fund losses)
    np.testing.assert_allclose(np.real(z_ref[0]), 0.0, atol=1e-14)
    np.testing.assert_allclose(np.imag(z_ref[0]), -2.0, rtol=1e-12)
    # series resonance lands at the design order: |Z| minimal at h_tune.
    # With finite R the exact Im-zero shifts by -x_c/h_t · X²/(R²+X²)
    # (the parallel R contributes); it vanishes in the R→∞ limit.
    hi = list(s.harmonics).index(3)
    assert np.argmin(np.abs(z_ref)) == hi
    np.testing.assert_allclose(np.imag(z_ref[hi]),
                               -(2.0 / 3.0) * (2.0 / 3.0) ** 2
                               / (1.5 ** 2 + (2.0 / 3.0) ** 2), rtol=1e-10)
    z_sharp = _np_ctype_z(h, 2.0, 3.0, 1e9)
    np.testing.assert_allclose(np.imag(z_sharp[hi]), 0.0, atol=1e-9)


def test_damped_filters_suppress_band_in_full_hpf(tmp_path):
    """Install each damped topology on the SMPS feeder (UNCOUPLED model,
    where orders decouple and the device-inclusive scan is exact) and
    re-solve: the realized per-order suppression must EQUAL the
    operational-Z gain at every order, with material broadband gains.

    Sizing note (same lesson as the tuned-filter test): the SMPS Norton
    admittance is hundreds of pu, so a biting filter needs x_cap ~0.01;
    broadband topologies spread their admittance across the band, which
    is why the coupled-model per-order tracking the tuned test does is
    meaningless here (coupled cross-harmonic re-emission redistributes
    the diverted current — CLAUDE.md #15 physics)."""
    from hpfx.harmonic import hpf

    s = hpfx.settings_for_hmax(25, coupled=False)
    net, dev = _resonant_smps_feeder(tmp_path, s, target_h=7)
    Y = build_ybus(net, s)
    base = hpf(net, dev, s, Y=Y)
    assert bool(base.converged)
    Vb = np.asarray(base.V_m)
    zo0 = np.asarray(driving_point_impedance(net, s, Y=Y, devices=dev,
                                             ground_slack=False))
    for name, yf in (
            ("highpass", hpfx.highpass_filter_admittance(
                s, h_corner=5.0, x_cap=0.01, m=1.0)),
            ("ctype", hpfx.ctype_filter_admittance(
                s, h_tune=5.0, x_cap=0.01, quality=3.0))):
        Yf = hpfx.install_shunt(Y, 1, yf)
        res = hpf(net, dev, s, Y=Yf)
        assert bool(res.converged), name
        zo1 = np.asarray(driving_point_impedance(net, s, Y=Yf,
                                                 devices=dev,
                                                 ground_slack=False))
        gain = zo0[1:, 1] / zo1[1:, 1]
        supp = Vb[1:, 1] / np.maximum(np.asarray(res.V_m)[1:, 1], 1e-15)
        np.testing.assert_allclose(supp, gain, rtol=1e-5, err_msg=name)
        assert float(gain.max()) > 2.0, (name, gain)   # it must bite
    # topology signatures at the fundamental: the C-type is loss-free
    # (aux L-C2 shorts R), the high-pass pays conduction losses
    assert float(hpfx.ctype_filter_admittance(s, 5.0, 0.01).re[0]) == 0.0
    assert float(hpfx.highpass_filter_admittance(s, 5.0, 0.01).re[0]) > 0.0
