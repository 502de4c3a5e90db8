"""Randomized (seeded) consistency checks on generated networks: the
hand-coded Jacobians must equal jacfwd of the mismatch for arbitrary
topologies, device data, and voltage states — not just the fixture nets."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hpfx
from hpfx import harmonic
from hpfx.cx import Cx
from hpfx.devices import device_set_from_arrays
from hpfx.generators import synthetic_feeder


def _random_case(seed, h_max=9, n_buses=12, n_nl=3, coupled=True):
    s = hpfx.settings_for_hmax(h_max, coupled=coupled)
    net = synthetic_feeder(n_buses, n_nl, s, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    H = s.n_harmonics
    if coupled:
        Y_N = 0.2 * (rng.normal(size=(n_nl, H, H))
                     + 1j * rng.normal(size=(n_nl, H, H)))
    else:
        Y_N = 0.2 * (rng.normal(size=(n_nl, H))
                     + 1j * rng.normal(size=(n_nl, H)))
    I_N = 0.1 * (rng.normal(size=(n_nl, H)) + 1j * rng.normal(size=(n_nl, H)))
    dev = device_set_from_arrays(I_N, Y_N, coupled, s)
    # arbitrary (non-converged) state with signed magnitudes
    V_m = jnp.asarray(rng.uniform(-0.3, 1.2, (H, net.n)))
    V_a = jnp.asarray(rng.uniform(-4, 4, (H, net.n)))
    return s, net, dev, V_m, V_a


@pytest.mark.parametrize("seed,coupled", [(0, True), (1, True), (2, False),
                                          (3, False)])
def test_jacobian_is_exact_derivative(seed, coupled):
    s, net, dev, V_m, V_a = _random_case(seed, coupled=coupled)
    Y = hpfx.build_ybus(net, s)
    S = Cx(net.bus_P, net.bus_Q)
    H, n, m, c = s.n_harmonics, net.n, net.m, net.c

    def f_of_x(x):
        Vm2, Va2 = harmonic.update_harmonic_voltages(V_m, V_a, x, H, n, c)
        return harmonic.harmonic_mismatch(Vm2, Va2, Y, S, dev, m, n, c)[0]

    x0 = harmonic.harmonic_state_vector(V_m, V_a, c)
    # jit both evaluations: executing them eagerly compiles hundreds of
    # tiny ops per case, which sporadically segfaults XLA:CPU's
    # compiler in-suite (see CLAUDE.md #7)
    J_ad = np.asarray(jax.jit(jax.jacfwd(f_of_x))(x0))
    J_hand = np.asarray(jax.jit(
        harmonic.build_harmonic_jacobian,
        static_argnames=("m", "n", "c"))(V_m, V_a, Y, dev, m=m, n=n, c=c))
    np.testing.assert_allclose(J_hand, J_ad, atol=1e-11)


@pytest.mark.parametrize("seed", [0, 1])
def test_arrow_step_matches_dense_random(seed):
    from hpfx.arrow import arrow_solve, build_arrow_pieces, make_arrow_index
    s, net, dev, V_m, V_a = _random_case(seed, coupled=True)
    Y = hpfx.build_ybus(net, s)
    S = Cx(net.bus_P, net.bus_Q)
    m, n, c, H = net.m, net.n, net.c, s.n_harmonics
    f, _ = harmonic.harmonic_mismatch(V_m, V_a, Y, S, dev, m, n, c)
    J = np.asarray(harmonic.build_harmonic_jacobian(V_m, V_a, Y, dev, m, n, c))
    dx_dense = np.linalg.solve(J, np.asarray(f))
    idx = make_arrow_index(H, n, m, c)
    pieces = build_arrow_pieces(V_m, V_a, Y, dev, idx)
    dx_arrow = np.asarray(arrow_solve(pieces, jnp.asarray(f), idx))
    scale = max(1.0, np.abs(dx_dense).max())
    np.testing.assert_allclose(dx_arrow, dx_dense, atol=1e-8 * scale)


def test_ybus_row_sums_are_shunts():
    """Physics invariant on random nets: each Ybus row sums to the bus's
    total shunt admittance (series terms cancel) when taps are unity."""
    s = hpfx.settings_for_hmax(7)
    net = synthetic_feeder(15, 4, s, seed=5)
    Y = hpfx.build_ybus(net, s).to_numpy()
    for hi, h in enumerate(s.harmonics):
        rowsum = Y[hi].sum(axis=1)
        xsh = np.asarray(net.bus_Xsh)
        safe = np.where(xsh != 0, xsh, 1.0)
        expect = np.where((xsh != 0) & (h != 1), 1 / (1j * safe * h), 0)
        np.testing.assert_allclose(rowsum, expect, atol=1e-9)


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_postprocessing_invariants_random_state(seed):
    """Post-processing identities hold at ARBITRARY (even unconverged)
    states on random feeders: per-harmonic energy balance of line_flows,
    the IEEE 1459 S² resolution, waveform Parseval/crest bounds."""
    s, net, dev, V_m, V_a = _random_case(seed, h_max=13, n_buses=10)
    V_m = jnp.abs(V_m) + 0.05         # physical magnitudes for the checks

    # energy balance: bus injections (dense Y) == line losses, per h
    fl = hpfx.line_flows(net, s, V_m, V_a)
    Y = hpfx.build_ybus(net, s)
    V = np.asarray(V_m) * np.exp(1j * np.asarray(V_a))
    Yc = np.asarray(Y.re) + 1j * np.asarray(Y.im)
    inj = (V * np.einsum("hij,hj->hi", Yc, V).conj()).real.sum(axis=1)
    np.testing.assert_allclose(inj, np.asarray(fl.loss).sum(axis=1),
                               rtol=1e-9, atol=1e-12)

    # IEEE 1459: exact S² resolution and D_H ≥ 0 at every terminal
    pi = hpfx.line_power_indices(net, s, V_m, V_a)
    lhs = np.asarray(pi.S) ** 2
    rhs = (np.asarray(pi.S1) ** 2 + np.asarray(pi.D_I) ** 2
           + np.asarray(pi.D_V) ** 2 + np.asarray(pi.S_H) ** 2)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)
    assert (np.asarray(pi.N) >= -1e-12).all()
    assert (np.abs(np.asarray(pi.pf)) <= 1 + 1e-12).all()

    # waveform: Parseval rms; crest ≥ 1 with equality only for DC
    wm = hpfx.waveform_metrics(V_m, V_a, s.harmonics)
    np.testing.assert_allclose(np.asarray(wm.rms),
                               np.sqrt((np.asarray(V_m) ** 2).sum(0)),
                               rtol=1e-12)
    assert (np.asarray(wm.crest) >= 1.0 - 1e-9).all()
    # peak bound: peak <= sqrt(2) * sum |V_h| (triangle inequality)
    assert (np.asarray(wm.peak) <=
            np.sqrt(2) * np.abs(np.asarray(V_m)).sum(0) + 1e-12).all()
