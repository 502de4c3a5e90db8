"""Harmonic HPF parity against reference fixtures
(hpf, hcne_generalized.py:511-560) — the 1e-8 parity gate and beyond."""
import jax
import numpy as np

import hpfx
from hpfx.cx import Cx
from hpfx import harmonic

from conftest import (DIVERGED, LOOSE_ITERS, SHALLOW_STOP, load_golden,
                      make_setup)


def _first_iteration_pieces(s, net, dev):
    Y = hpfx.build_ybus(net, s)
    fund = hpfx.pf(Y, net, s)
    S = Cx(net.bus_P, net.bus_Q)
    V_m, V_a = harmonic.init_harmonic_voltages(fund, net, s)
    f0, err0 = harmonic.harmonic_mismatch(
        V_m, V_a, Y, S, dev, net.m, net.n, net.c)
    x0 = harmonic.harmonic_state_vector(V_m, V_a, net.c)
    J0 = harmonic.build_harmonic_jacobian(
        V_m, V_a, Y, dev, net.m, net.n, net.c)
    return f0, err0, x0, J0


def test_first_iteration_parity(config):
    """Mismatch vector, state vector and Jacobian at the warm-started first
    harmonic iteration match the reference element-for-element."""
    g = load_golden(config)
    s, net, dev = make_setup(config)
    f0, err0, x0, J0 = _first_iteration_pieces(s, net, dev)
    np.testing.assert_allclose(np.asarray(f0), g["f0"], atol=1e-10)
    np.testing.assert_allclose(np.asarray(x0), g["x0"], atol=1e-12)
    np.testing.assert_allclose(np.asarray(J0), g["J0"], atol=1e-9)
    np.testing.assert_allclose(float(err0), float(g["err_h0"]), rtol=1e-9)


def test_hpf_voltage_parity(config):
    """Final voltages/THD within 1e-8 of the reference (parity gate),
    with identical iteration counts."""
    g = load_golden(config)
    s, net, dev = make_setup(config)
    res = hpfx.hpf(net, dev, s)
    if config in DIVERGED:
        # reference hits max_iter with err ~ 78; assert we do the same
        assert int(res.n_iter) == int(g["n_iter_h"]) == s.max_iter_h
        assert not bool(res.converged)
        return
    if config in SHALLOW_STOP:
        # same fixed point, but the parity bound is the REFERENCE's
        # truncation at its shallow stop (see conftest.SHALLOW_STOP);
        # hpfx's own residual is ~500x deeper
        assert abs(int(res.n_iter) - int(g["n_iter_h"])) <= 6
        assert bool(res.converged)
        assert float(res.err) <= float(g["err_h"])
        np.testing.assert_allclose(np.asarray(res.V_m), g["V_m"],
                                   rtol=0, atol=2e-7)
        np.testing.assert_allclose(np.asarray(res.V_a), g["V_a"],
                                   rtol=0, atol=5e-6)
        thd = hpfx.get_thd(res.V_m)
        np.testing.assert_allclose(np.asarray(thd.THD_F), g["THD_F"],
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(thd.THD_R), g["THD_R"],
                                   atol=1e-6)
        return
    if config in LOOSE_ITERS:
        # iteration-count parity is chaotic-transient on this config
        # (CLAUDE.md parity contract: even replicating the reference's spsolve moves
        # the count); the tested invariant backing the loosened bound is
        # that the CONVERGED STATE is the same fixed point to ~fp noise
        # (far inside the 1e-8 parity gate below)
        assert abs(int(res.n_iter) - int(g["n_iter_h"])) <= 6
        np.testing.assert_allclose(np.asarray(res.V_m), g["V_m"],
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(res.V_a), g["V_a"],
                                   rtol=0, atol=1e-10)
    else:
        assert int(res.n_iter) == int(g["n_iter_h"])
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.V_m), g["V_m"],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(res.V_a), g["V_a"],
                               rtol=0, atol=1e-8)
    thd = hpfx.get_thd(res.V_m)
    np.testing.assert_allclose(np.asarray(thd.THD_F), g["THD_F"], atol=1e-8)
    np.testing.assert_allclose(np.asarray(thd.THD_R), g["THD_R"], atol=1e-8)


def test_harmonic_jacobian_matches_autodiff():
    """jacfwd of the harmonic mismatch wrt the state vector reproduces the
    hand-coded block Jacobian (coupled NE, PV-bus net)."""
    cfg = ("net3", 5, True)
    s, net, dev = make_setup(cfg)
    Y = hpfx.build_ybus(net, s)
    fund = hpfx.pf(Y, net, s)
    S = Cx(net.bus_P, net.bus_Q)
    V_m0, V_a0 = harmonic.init_harmonic_voltages(fund, net, s)
    H, n, m, c = s.n_harmonics, net.n, net.m, net.c

    def f_of_x(x):
        V_m, V_a = harmonic.update_harmonic_voltages(V_m0, V_a0, x, H, n, c)
        return harmonic.harmonic_mismatch(V_m, V_a, Y, S, dev, m, n, c)[0]

    x0 = harmonic.harmonic_state_vector(V_m0, V_a0, c)
    J_ad = np.asarray(jax.jacfwd(f_of_x)(x0))
    J_hand = np.asarray(harmonic.build_harmonic_jacobian(
        V_m0, V_a0, Y, dev, m, n, c))
    np.testing.assert_allclose(J_hand, J_ad, atol=1e-12)


def test_uncoupled_jacobian_matches_autodiff():
    cfg = ("net2", 5, False)
    s, net, dev = make_setup(cfg)
    Y = hpfx.build_ybus(net, s)
    fund = hpfx.pf(Y, net, s)
    S = Cx(net.bus_P, net.bus_Q)
    V_m0, V_a0 = harmonic.init_harmonic_voltages(fund, net, s)
    H, n, m, c = s.n_harmonics, net.n, net.m, net.c

    def f_of_x(x):
        V_m, V_a = harmonic.update_harmonic_voltages(V_m0, V_a0, x, H, n, c)
        return harmonic.harmonic_mismatch(V_m, V_a, Y, S, dev, m, n, c)[0]

    x0 = harmonic.harmonic_state_vector(V_m0, V_a0, c)
    J_ad = np.asarray(jax.jacfwd(f_of_x)(x0))
    J_hand = np.asarray(harmonic.build_harmonic_jacobian(
        V_m0, V_a0, Y, dev, m, n, c))
    np.testing.assert_allclose(J_hand, J_ad, atol=1e-12)


def test_cleanup_voltages():
    V_m = np.array([[1.0, -0.5], [0.1, -0.2]])
    V_a = np.array([[0.0, 1.0], [7.0, -1.0]])
    Vm2, Va2 = harmonic.cleanup_voltages(V_m, V_a)
    # phasors are preserved by the sign/angle normalization
    np.testing.assert_allclose(
        np.asarray(Vm2) * np.exp(1j * np.asarray(Va2)),
        V_m * np.exp(1j * V_a), atol=1e-12)
    assert np.all(np.asarray(Vm2) >= 0)
    assert np.all((np.asarray(Va2) >= 0) & (np.asarray(Va2) < 2 * np.pi))


def test_net1_h99_parity():
    """Full device-table depth (smps_NE.csv carries odd harmonics 1..99)
    at net1 scale: dim 2·50·20-1-c = 1998, the largest captured config.
    Kept out of the every-test ALL_CONFIGS matrix (each solve is ~10 s on
    CPU x64); this one test gates both couplings.  The coupled run is the
    LOOSE_ITERS/SHALLOW_STOP class: the reference stops at err 2.8e-6,
    hpfx contracts to 1.2e-9, so the voltage gate is bounded by the
    reference's truncation (|dVa| ~ 2e-8), not by hpfx."""
    # uncoupled: exact iteration count, fp-noise parity
    g = load_golden(("net1", 99, False))
    s, net, dev = make_setup(("net1", 99, False))
    res = hpfx.hpf(net, dev, s)
    assert bool(res.converged)
    assert int(res.n_iter) == int(g["n_iter_h"])
    np.testing.assert_allclose(np.asarray(res.V_m), g["V_m"],
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.V_a), g["V_a"],
                               rtol=0, atol=1e-10)

    # coupled: chaotic-transient count drift + reference-truncation gate
    g = load_golden(("net1", 99, True))
    s, net, dev = make_setup(("net1", 99, True))
    res = hpfx.hpf(net, dev, s)
    assert bool(res.converged)
    assert abs(int(res.n_iter) - int(g["n_iter_h"])) <= 6
    assert float(res.err) <= float(g["err_h"])
    np.testing.assert_allclose(np.asarray(res.V_m), g["V_m"],
                               rtol=0, atol=2e-9)
    np.testing.assert_allclose(np.asarray(res.V_a), g["V_a"],
                               rtol=0, atol=1e-7)
    thd = hpfx.get_thd(res.V_m)
    np.testing.assert_allclose(np.asarray(thd.THD_F), g["THD_F"], atol=1e-7)
