"""Background (upstream) grid distortion — hpfx/background.py.

Oracles, strongest first:

1. LINEAR FIXED POINT: with pure-admittance devices (I_N = 0) the
   harmonic subsystem is exactly linear, so the NR solution at every
   h >= 2 must equal the direct solve (Y_h - diag(Y_N_h)) V_h = -I_bg_h
   to fp accuracy — gates the injection's sign convention and placement
   against first principles rather than against the solver itself.
2. ZERO-BACKGROUND IDENTITY: I_bg of zeros must be bit-identical to the
   I_bg=None path (iteration counts included) — the parity contract
   with the reference is untouched by the new term.
3. Dense/arrow agreement and the Thevenin->Norton conversion law.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import hpfx
from conftest import make_setup
from hpfx import cx


def _spectrum():
    return {5: (0.02, 0.3), 7: (0.01, 1.0)}


def test_thevenin_conversion_law():
    """I_bg[h, bus] = V_bg(h) / (j * X_sh * h), other buses zero."""
    s, net, _ = make_setup(("net2", 25, True))
    x_sh = float(np.asarray(net.bus_Xsh)[0])
    I_bg = hpfx.background_from_harmonics(net, s, _spectrum(), bus=0)
    got = np.asarray(I_bg.re) + 1j * np.asarray(I_bg.im)
    orders = list(s.harmonics)
    want = np.zeros((s.n_harmonics, net.n), complex)
    for h, (m_h, a_h) in _spectrum().items():
        k = orders.index(h)
        want[k, 0] = m_h * np.exp(1j * a_h) / (1j * x_sh * h)
    np.testing.assert_allclose(got, want, atol=1e-12)
    # fundamental row zero by construction
    assert np.all(got[0] == 0)


def test_fundamental_background_rejected():
    s, net, _ = make_setup(("net2", 25, True))
    with pytest.raises(ValueError):
        hpfx.background_from_harmonics(net, s, {1: (0.1, 0.0)})
    with pytest.raises(ValueError):
        # order outside the considered harmonics must raise, not drop
        hpfx.background_from_harmonics(net, s, {27: (0.1, 0.0)})
    with pytest.raises(ValueError):
        # Thevenin source needs a grid impedance at the bus
        hpfx.grid_source(net, s, np.zeros(s.n_harmonics),
                         np.zeros(s.n_harmonics), bus=2)


def test_zero_background_is_identity():
    s, net, dev = make_setup(("net2", 25, True))
    res0 = hpfx.hpf(net, dev, s)
    resz = hpfx.hpf(net, dev, s,
                    I_bg=cx.zeros((s.n_harmonics, net.n), s.real_dtype))
    assert int(resz.n_iter) == int(res0.n_iter)
    assert np.array_equal(np.asarray(resz.V_m), np.asarray(res0.V_m))
    assert np.array_equal(np.asarray(resz.V_a), np.asarray(res0.V_a))


def test_linear_fixed_point_exact():
    """Pure-admittance devices make the harmonic system linear: the NR
    answer must match the direct per-harmonic solve to ~1e-12."""
    s, net, dev = make_setup(("net2", 25, False))   # uncoupled shapes
    s = s.with_(thresh_h=1e-11)   # drive the (linear) NR to fp accuracy
    rd = s.real_dtype
    H, n, m = s.n_harmonics, net.n, net.m
    n_nl = net.n_nonlinear
    rng = np.random.default_rng(7)
    # uncoupled Y_N (n_nl, H): admittance-only device, I_N = 0.  In the
    # solver's sign convention the injections I_N - Y_N·V are ADDED to
    # Y·V (hcne_generalized.py:320-322), so a PASSIVE device admittance
    # g + jb enters as Y_N = -(g + jb); positive-real Y_N would be
    # negative conductance and can make the harmonic system singular.
    Y_N = -(rng.uniform(0.5, 1.5, (n_nl, H))
            + 1j * rng.uniform(-1.0, 1.0, (n_nl, H)))
    devs = hpfx.device_set_from_arrays(np.zeros((n_nl, H), complex),
                                       Y_N, coupled=False, settings=s)
    # every order needs a source: any harmonic without one has the exact
    # solution V_h = 0, which is singular in the polar NR state (angles
    # undefined, dI/dA columns vanish — the same physics as CLAUDE.md's
    # zero-penetration note) and honestly reports non-convergence
    spectrum = {int(h): (0.01 + 0.002 * i, 0.1 * i)
                for i, h in enumerate(s.harmonics) if int(h) != 1}
    I_bg = hpfx.background_from_harmonics(net, s, spectrum, bus=0)
    res = hpfx.hpf(net, devs, s, I_bg=I_bg)
    assert bool(res.converged)

    Y = hpfx.build_ybus(net, s)
    Yc = np.asarray(Y.re) + 1j * np.asarray(Y.im)          # (H, n, n)
    Ibg = np.asarray(I_bg.re) + 1j * np.asarray(I_bg.im)   # (H, n)
    V = np.asarray(res.V_m) * np.exp(1j * np.asarray(res.V_a))
    for k in range(1, H):
        A = Yc[k].copy()
        A[np.arange(m, n), np.arange(m, n)] -= Y_N[:, k]
        expect = np.linalg.solve(A, -Ibg[k])
        np.testing.assert_allclose(V[k], expect, atol=5e-12)


@pytest.mark.parametrize("solver", ["dense", "arrow"])
def test_background_raises_thd_and_solver_agreement(solver):
    s, net, dev = make_setup(("net2", 25, True))
    s = s.with_(solver=solver)
    I_bg = hpfx.background_from_harmonics(net, s, _spectrum())
    res0 = hpfx.hpf(net, dev, s)
    res_b = hpfx.hpf(net, dev, s, I_bg=I_bg)
    assert bool(res_b.converged)
    thd0 = np.asarray(hpfx.get_thd(res0.V_m).THD_F)
    thdb = np.asarray(hpfx.get_thd(res_b.V_m).THD_F)
    assert np.all(thdb > thd0)      # background distorts every bus
    if solver == "arrow":
        sd = s.with_(solver="dense")
        res_d = hpfx.hpf(net, dev, sd, I_bg=I_bg)
        np.testing.assert_allclose(np.asarray(res_b.V_m),
                                   np.asarray(res_d.V_m), atol=1e-10)


def test_hpf_single_background():
    """The jitted entry takes I_bg as a plain pytree argument."""
    s, net, dev = make_setup(("net2", 25, True))
    I_bg = hpfx.background_from_harmonics(net, s, _spectrum())
    res = hpfx.hpf_single(net, dev, s, I_bg=I_bg)
    ref = hpfx.hpf(net, dev, s, I_bg=I_bg)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.V_m), np.asarray(ref.V_m),
                               atol=1e-12)


def test_direct_current_spectrum():
    """as_current=True bypasses the Thevenin transform (measured Norton
    spectra, or buses without a modeled grid impedance)."""
    s, net, dev = make_setup(("net2", 25, True))
    I_direct = hpfx.background_from_harmonics(
        net, s, {5: (0.5, -0.2)}, bus=2, as_current=True)
    got = np.asarray(I_direct.re) + 1j * np.asarray(I_direct.im)
    k = list(s.harmonics).index(5)
    assert got[k, 2] == pytest.approx(0.5 * np.exp(-0.2j), abs=1e-12)
    assert np.count_nonzero(got) == 1
    res = hpfx.hpf(net, dev, s, I_bg=I_direct)
    assert bool(res.converged)


def test_background_sweep_matches_vmapped_hpf():
    """background_sweep (the adaptive-schedule batched study) reaches the
    same fixed points as directly vmapping hpf over I_bg rows."""
    import jax
    from hpfx.harmonic import hpf

    s, net, dev = make_setup(("net2", 25, True))
    s = s.with_(solver="arrow", stable_mismatch=True)
    B, H, n = 4, s.n_harmonics, net.n
    rng = np.random.default_rng(7)
    full = np.zeros((B, H, n), complex)
    x_sh = float(np.asarray(net.bus_Xsh)[0])
    orders = np.asarray(s.harmonics, float)
    mag = rng.uniform(0, 0.02, (B, H))
    ang = rng.uniform(0, 2 * np.pi, (B, H))
    i = mag * np.exp(1j * ang) / (1j * x_sh * orders)
    i[:, 0] = 0.0
    full[:, :, 0] = i
    I_bg = cx.Cx(jnp.asarray(full.real, s.real_dtype),
                 jnp.asarray(full.imag, s.real_dtype))

    r = hpfx.background_sweep(net, dev, s, I_bg)
    assert bool(np.all(np.asarray(r.converged)))

    direct = jax.jit(jax.vmap(lambda ibg: hpf(net, dev, s, I_bg=ibg)))(I_bg)
    np.testing.assert_allclose(np.asarray(r.V_m), np.asarray(direct.V_m),
                               rtol=0, atol=1e-9)


def test_background_sweep_f64_knife_edge_rescue():
    """Rescue engagement: an f32 threshold below the f32 evaluation
    floor defeats both f32 rescue passes; the f64 fallback must still
    deliver conv 1.000 (the background study's knife-edge class,
    CLAUDE.md #3)."""
    import os

    from conftest import DATA
    s = hpfx.settings_for_hmax(25, coupled=True).with_(
        solver="arrow", stable_mismatch=True, dtype="float32",
        floor_kappa=0.0, thresh_h=3e-8)
    net = hpfx.load_network(os.path.join(DATA, "net2_buses.csv"),
                            os.path.join(DATA, "net2_lines.csv"), s)
    dev = hpfx.load_device_set(net, s)
    B, H, n = 4, s.n_harmonics, net.n
    full = np.zeros((B, H, n), complex)
    full[:, 2, 0] = 0.01 / (1j * float(np.asarray(net.bus_Xsh)[0]) * 5)
    I_bg = cx.Cx(jnp.asarray(full.real, jnp.float32),
                 jnp.asarray(full.imag, jnp.float32))
    r = hpfx.background_sweep(net, dev, s, I_bg)
    assert bool(np.all(np.asarray(r.converged)))
    assert r.V_m.dtype == jnp.float32
    # the f64 pass really ran: the achieved residual beats anything f32
    # evaluation can certify at this scale
    assert float(np.max(np.asarray(r.err))) < 3e-8


def test_background_lanes_layout_matches_vmap():
    """I_bg threaded through the lane-major fast path: identical
    fixed points (and iteration counts, f64) vs the vmap layout."""
    import jax
    from hpfx.solve import hpf_sweep

    s, net, dev = make_setup(("net2", 25, True))
    base = s.with_(solver="arrow", stable_mismatch=True)
    B, H, n = 5, s.n_harmonics, net.n
    rng = np.random.default_rng(11)
    full = np.zeros((B, H, n), complex)
    x_sh = float(np.asarray(net.bus_Xsh)[0])
    orders = np.asarray(s.harmonics, float)
    i = (rng.uniform(0, 0.02, (B, H))
         * np.exp(1j * rng.uniform(0, 2 * np.pi, (B, H)))
         / (1j * x_sh * orders))
    i[:, 0] = 0.0
    full[:, :, 0] = i
    I_bg = cx.Cx(jnp.asarray(full.real), jnp.asarray(full.imag))
    sc = hpfx.solve.Scenarios.uniform(B, s.real_dtype)
    r_v = hpf_sweep(net, dev, base.with_(layout="vmap"), sc, I_bg=I_bg)
    r_l = hpf_sweep(net, dev, base.with_(layout="lanes"), sc, I_bg=I_bg)
    assert bool(np.all(np.asarray(r_v.converged)))
    assert bool(np.all(np.asarray(r_l.converged)))
    np.testing.assert_allclose(np.asarray(r_l.V_m), np.asarray(r_v.V_m),
                               rtol=0, atol=1e-11)
    np.testing.assert_array_equal(np.asarray(r_l.n_iter),
                                  np.asarray(r_v.n_iter))


def test_background_device_schedule_with_warm_seed():
    """background_sweep(schedule='device', warm='linear'): the
    background term enters the in-program exact-linear seed's RHS, so
    NR collapses to ~3 trips at the same fixed point."""
    s, net, dev = make_setup(("net2", 25, True))
    s = s.with_(solver="arrow", stable_mismatch=True, layout="lanes")
    B, H, n = 4, s.n_harmonics, net.n
    full = np.zeros((B, H, n), complex)
    x_sh = float(np.asarray(net.bus_Xsh)[0])
    full[:, 2, 0] = 0.02 / (1j * x_sh * 5)
    full[:, 3, 0] = 0.01j / (1j * x_sh * 7)
    I_bg = cx.Cx(jnp.asarray(full.real), jnp.asarray(full.imag))
    r_host = hpfx.background_sweep(net, dev, s, I_bg, schedule="host")
    r_dev = hpfx.background_sweep(net, dev, s, I_bg, schedule="device",
                                  warm="linear")
    assert bool(np.all(np.asarray(r_host.converged)))
    assert bool(np.all(np.asarray(r_dev.converged)))
    # two truncation points of the same fixed point (warm stops at
    # trip 3): compare at the convergence level, not golden parity
    np.testing.assert_allclose(np.asarray(r_dev.V_m),
                               np.asarray(r_host.V_m), rtol=0, atol=1e-6)
    assert int(np.max(np.asarray(r_dev.n_iter))) <= 4
    # the warm seed actually engaged: strictly fewer trips than cold
    assert (float(np.mean(np.asarray(r_dev.n_iter)))
            < float(np.mean(np.asarray(r_host.n_iter))))
