"""Scaling beyond the reference's n=20: synthetic
feeders at n in {64, 128} with 12-30 nonlinear devices, gated by
self-consistency (autodiff-vs-hand Jacobian, residual convergence,
arrow-vs-dense equality) — no reference oracle exists at this size, so the
gates are the same internal-consistency contracts test_randomized.py
establishes on small nets."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import hpfx
from hpfx import harmonic
from hpfx.cx import Cx
from hpfx.generators import synthetic_feeder


def _setup(n, n_nl, h_max, seed=1, **kw):
    s = hpfx.settings_for_hmax(h_max, coupled=True, **kw)
    net = synthetic_feeder(n, n_nl, s, components=("SMPS", "ev_1", "ev_4"),
                          seed=seed)
    dev = hpfx.load_device_set(net, s)
    return s, net, dev


def test_n64_jacobian_is_exact_derivative():
    """Hand-coded harmonic Jacobian == jacfwd of the mismatch at n=64 with
    real mixed devices and an arbitrary signed state (the
    test_randomized.py:39 contract, at scale)."""
    s, net, dev = _setup(64, 12, 7)
    rng = np.random.default_rng(42)
    H, n, m, c = s.n_harmonics, net.n, net.m, net.c
    V_m = jnp.asarray(rng.uniform(-0.3, 1.2, (H, n)))
    V_a = jnp.asarray(rng.uniform(-4, 4, (H, n)))
    Y = hpfx.build_ybus(net, s)
    S = Cx(net.bus_P, net.bus_Q)

    def f_of_x(x):
        Vm2, Va2 = harmonic.update_harmonic_voltages(V_m, V_a, x, H, n, c)
        return harmonic.harmonic_mismatch(Vm2, Va2, Y, S, dev, m, n, c)[0]

    x0 = harmonic.harmonic_state_vector(V_m, V_a, c)
    J_ad = np.asarray(jax.jit(jax.jacfwd(f_of_x))(x0))
    J_hand = np.asarray(jax.jit(
        harmonic.build_harmonic_jacobian,
        static_argnames=("m", "n", "c"))(V_m, V_a, Y, dev, m=m, n=n, c=c))
    np.testing.assert_allclose(J_hand, J_ad, atol=1e-10)


def test_n64_converges_arrow_equals_dense():
    """64-bus, 12-device, H<=13 coupled solve: converged on both Newton
    solvers with identical iteration counts and matching fixed points."""
    s, net, dev = _setup(64, 12, 13)
    dense = hpfx.hpf_single(net, dev, settings=s)
    arrow = hpfx.hpf_single(net, dev, settings=s.with_(solver="arrow"))
    assert bool(dense.converged) and bool(arrow.converged)
    assert int(arrow.n_iter) == int(dense.n_iter)
    np.testing.assert_allclose(np.asarray(arrow.V_m),
                               np.asarray(dense.V_m), atol=1e-7)
    thd = np.asarray(hpfx.get_thd(dense.V_m).THD_F)
    assert np.all(np.isfinite(thd))


def test_n128_converges_with_independent_residual():
    """128-bus, 30-device solve on the arrow path; the solution is
    re-checked by evaluating the mismatch with an independent numpy
    complex computation (not the solver's own residual)."""
    s, net, dev = _setup(128, 30, 13, solver="arrow")
    res = hpfx.hpf_single(net, dev, settings=s)
    assert bool(res.converged), float(res.err)

    # independent residual: complex numpy evaluation of the balance
    V = np.asarray(res.V_m) * np.exp(1j * np.asarray(res.V_a))
    Y = hpfx.build_ybus(net, s).to_numpy()
    m, c = net.m, net.c
    I_N, Y_N = dev.I_N.to_numpy(), dev.Y_N.to_numpy()
    I_inj = np.stack([I_N[d] - Y_N[d] @ V[:, m + d]
                      for d in range(net.n_nonlinear)])
    S = np.asarray(net.bus_P) + 1j * np.asarray(net.bus_Q)
    dS = V[0, 1:m] * np.conj(Y[0, 1:m] @ V[0]) + S[1:m]
    dI_f = Y[0, m:] @ V[0] + I_inj[:, 0]
    dI_h = np.einsum("hij,hj->hi", Y[1:], V[1:])
    dI_h[:, m:] += I_inj[:, 1:].T
    f_c = np.concatenate([dS, dI_f, dI_h.reshape(-1)])
    f = np.concatenate([f_c.real, f_c[c - 1:].imag])
    assert np.max(np.abs(f)) < 5 * s.thresh_h


def test_n64_sweep_lanes_matches_vmap():
    """The lane-major layout (lanes) computes the identical n=64 sweep
    as the vmap path, per-device injection scales included."""
    from hpfx.solve import Scenarios, hpf_sweep
    s, net, dev = _setup(64, 12, 7, solver="arrow")
    B = 3
    rng = np.random.default_rng(2)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.95, 1.05, B)),
        q_scale=jnp.ones(B),
        injection_scale=jnp.asarray(
            rng.uniform(0.8, 1.2, (B, net.n_nonlinear))))
    r_v = hpf_sweep(net, dev, settings=s.with_(layout="vmap"),
                    scenarios=scen)
    r_l = hpf_sweep(net, dev, settings=s.with_(layout="lanes"),
                    scenarios=scen)
    assert np.asarray(r_v.converged).all()
    assert np.asarray(r_l.converged).all()
    # heavy-loading feeders at this size have wild NR transients (the net1
    # h51 LOOSE_ITERS class): fp-level layout differences can shift a
    # count by a trip or two; the fixed points must still agree
    np.testing.assert_allclose(np.asarray(r_l.n_iter),
                               np.asarray(r_v.n_iter), atol=2)
    np.testing.assert_allclose(np.asarray(r_l.V_m), np.asarray(r_v.V_m),
                               atol=1e-7)
