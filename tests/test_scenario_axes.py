"""Per-device penetration and device-mix scenario axes (round-3 headline):

- ``Scenarios.injection_scale`` (B, n_nl): each nonlinear bus at its own
  penetration level, on both layout paths (vmap and lanes).
- ``Scenarios.device_mix`` (B, n_nl, T) + DeviceLibrary: per-bus blends of
  device types.  Since Norton parameters enter linearly
  (hcne_generalized.py:313-323, 425-435), a weighted NE sum is exactly the
  physics of w parallel devices — verified against manually-built
  DeviceSets and across layouts.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import hpfx
from hpfx import cx
from hpfx.devices import DeviceLibrary, DeviceSet, load_device_library
from hpfx.solve import Scenarios, hpf_single, hpf_sweep, hpf_sweep_adaptive

from conftest import DATA


def _setup(h_max=9, coupled=True, **kw):
    s = hpfx.settings_for_hmax(h_max, coupled=coupled, **kw)
    net = hpfx.load_network(f"{DATA}/net4_buses.csv",
                            f"{DATA}/net4_lines.csv", s)
    dev = hpfx.load_device_set(net, s)
    return s, net, dev


def _manual_scaled(dev: DeviceSet, vec) -> DeviceSet:
    """Independent (numpy) per-device scaling of a DeviceSet."""
    vec = np.asarray(vec)
    I = dev.I_N.to_numpy() * vec[:, None]
    Y = dev.Y_N.to_numpy() * (vec[:, None, None] if dev.coupled
                              else vec[:, None])
    return DeviceSet(I_N=cx.from_numpy(I, dev.I_N.dtype),
                     Y_N=cx.from_numpy(Y, dev.Y_N.dtype),
                     coupled=dev.coupled)


@pytest.mark.parametrize("coupled", [False, True])
def test_per_device_scale_matches_manual(coupled):
    """(B, n_nl) injection_scale on the vmap path == per-scenario single
    solves with independently (numpy-) scaled DeviceSets."""
    s, net, dev = _setup(coupled=coupled)
    scales = np.array([[1.0, 1.0, 1.0],
                       [1.4, 0.2, 0.9],
                       [0.0, 1.0, 2.0]])        # incl. a switched-off device
    scen = Scenarios(p_scale=jnp.ones(3), q_scale=jnp.ones(3),
                     injection_scale=jnp.asarray(scales))
    batch = hpf_sweep(net, dev, settings=s, scenarios=scen)
    for k in range(3):
        single = hpf_single(net, _manual_scaled(dev, scales[k]), settings=s)
        assert int(batch.n_iter[k]) == int(single.n_iter), k
        np.testing.assert_allclose(np.asarray(batch.V_m[k]),
                                   np.asarray(single.V_m), atol=1e-10)
        np.testing.assert_allclose(np.asarray(batch.V_a[k]),
                                   np.asarray(single.V_a), atol=1e-10)


@pytest.mark.parametrize("coupled", [False, True])
def test_per_device_scale_lanes_matches_vmap(coupled):
    """The lane-major path computes the identical per-device-scaled sweep."""
    s, net, dev = _setup(coupled=coupled, solver="arrow")
    B, n_nl = 5, net.n_nonlinear
    rng = np.random.default_rng(7)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.9, 1.1, B)),
        q_scale=jnp.asarray(rng.uniform(0.9, 1.1, B)),
        injection_scale=jnp.asarray(rng.uniform(0.3, 1.5, (B, n_nl))))
    r_v = hpf_sweep(net, dev, settings=s.with_(layout="vmap"),
                    scenarios=scen)
    r_l = hpf_sweep(net, dev, settings=s.with_(layout="lanes"),
                    scenarios=scen)
    np.testing.assert_array_equal(np.asarray(r_l.n_iter),
                                  np.asarray(r_v.n_iter))
    np.testing.assert_allclose(np.asarray(r_l.V_m), np.asarray(r_v.V_m),
                               atol=2e-9)
    np.testing.assert_allclose(np.asarray(r_l.V_a), np.asarray(r_v.V_a),
                               atol=2e-9)


def _library(s) -> DeviceLibrary:
    return load_device_library(("SMPS", "ev_1", "ev_4"), s)


@pytest.mark.parametrize("coupled", [False, True])
def test_one_hot_mix_matches_device_set(coupled):
    """A one-hot device_mix reproducing net4's natural type assignment
    equals the plain DeviceSet sweep exactly."""
    s, net, dev = _setup(coupled=coupled)
    lib = _library(s)
    assert lib.n_types == 3
    w = np.zeros((2, net.n_nonlinear, 3))
    w[:, 0, lib.index("SMPS")] = 1.0
    w[:, 1, lib.index("ev_1")] = 1.0
    w[:, 2, lib.index("ev_4")] = 1.0
    scen = Scenarios(p_scale=jnp.ones(2), q_scale=jnp.ones(2),
                     injection_scale=jnp.array([1.0, 0.8]),
                     device_mix=jnp.asarray(w))
    mixed = hpf_sweep(net, lib, settings=s, scenarios=scen)
    plain = hpf_sweep(net, dev, settings=s, scenarios=Scenarios(
        p_scale=jnp.ones(2), q_scale=jnp.ones(2),
        injection_scale=jnp.array([1.0, 0.8])))
    np.testing.assert_array_equal(np.asarray(mixed.n_iter),
                                  np.asarray(plain.n_iter))
    np.testing.assert_allclose(np.asarray(mixed.V_m),
                               np.asarray(plain.V_m), atol=1e-12)
    np.testing.assert_allclose(np.asarray(mixed.V_a),
                               np.asarray(plain.V_a), atol=1e-12)


def test_blend_mix_matches_manual_blend():
    """Fractional mixes == single solves with numpy-blended NEs
    (I_N[d] = sum_t w[d,t]·I_lib[t]; the parallel-devices physics)."""
    s, net, _ = _setup(coupled=True)
    lib = _library(s)
    rng = np.random.default_rng(3)
    w = rng.uniform(0.0, 1.0, (3, net.n_nonlinear, lib.n_types))
    scen = Scenarios(p_scale=jnp.ones(3), q_scale=jnp.ones(3),
                     device_mix=jnp.asarray(w))
    batch = hpf_sweep(net, lib, settings=s, scenarios=scen)
    I_lib, Y_lib = lib.I_lib.to_numpy(), lib.Y_lib.to_numpy()
    for k in range(3):
        dev_k = DeviceSet(
            I_N=cx.from_numpy(np.einsum("dt,th->dh", w[k], I_lib),
                              s.real_dtype),
            Y_N=cx.from_numpy(np.einsum("dt,thp->dhp", w[k], Y_lib),
                              s.real_dtype),
            coupled=True)
        single = hpf_single(net, dev_k, settings=s)
        assert int(batch.n_iter[k]) == int(single.n_iter), k
        np.testing.assert_allclose(np.asarray(batch.V_m[k]),
                                   np.asarray(single.V_m), atol=1e-10)


@pytest.mark.parametrize("coupled", [False, True])
def test_device_mix_lanes_matches_vmap(coupled):
    s, net, _ = _setup(coupled=coupled, solver="arrow")
    lib = _library(s)
    B, n_nl = 4, net.n_nonlinear
    rng = np.random.default_rng(11)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.9, 1.1, B)),
        q_scale=jnp.ones(B),
        injection_scale=jnp.asarray(rng.uniform(0.5, 1.2, (B, n_nl))),
        device_mix=jnp.asarray(
            rng.uniform(0.0, 1.0, (B, n_nl, lib.n_types))))
    r_v = hpf_sweep(net, lib, settings=s.with_(layout="vmap"),
                    scenarios=scen)
    r_l = hpf_sweep(net, lib, settings=s.with_(layout="lanes"),
                    scenarios=scen)
    np.testing.assert_array_equal(np.asarray(r_l.n_iter),
                                  np.asarray(r_v.n_iter))
    np.testing.assert_allclose(np.asarray(r_l.V_m), np.asarray(r_v.V_m),
                               atol=2e-9)
    np.testing.assert_allclose(np.asarray(r_l.V_a), np.asarray(r_v.V_a),
                               atol=2e-9)


def test_mix_requires_library_and_vice_versa():
    s, net, dev = _setup()
    lib = _library(s)
    n_nl = net.n_nonlinear
    mix = jnp.ones((2, n_nl, lib.n_types)) / lib.n_types
    with pytest.raises(ValueError, match="DeviceLibrary"):
        hpf_sweep(net, dev, settings=s, scenarios=Scenarios(
            p_scale=jnp.ones(2), device_mix=mix))
    with pytest.raises(ValueError, match="device_mix"):
        hpf_sweep(net, lib, settings=s, scenarios=Scenarios(
            p_scale=jnp.ones(2)))


def test_adaptive_sweep_with_device_axes():
    """hpf_sweep_adaptive's straggler re-solve indexes every scenario leaf
    on axis 0 — incl. (B, n_nl) scales and (B, n_nl, T) mixes."""
    s, net, _ = _setup(h_max=25, coupled=True)
    lib = _library(s)
    B, n_nl = 6, net.n_nonlinear
    rng = np.random.default_rng(5)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.8, 1.2, B)),
        q_scale=jnp.asarray(rng.uniform(0.8, 1.2, B)),
        injection_scale=jnp.asarray(rng.uniform(0.4, 1.6, (B, n_nl))),
        device_mix=jnp.asarray(rng.uniform(0.0, 1.0, (B, n_nl, 3))))
    plain = hpf_sweep(net, lib, settings=s, scenarios=scen)
    adaptive = hpf_sweep_adaptive(net, lib, s, scen, phase_iters=6)
    conv = np.asarray(plain.converged)
    assert conv.any()
    np.testing.assert_array_equal(np.asarray(adaptive.converged), conv)
    np.testing.assert_allclose(np.asarray(adaptive.V_m)[conv],
                               np.asarray(plain.V_m)[conv], atol=1e-9)


def test_hosting_capacity_with_mixes():
    """The Monte-Carlo aggregate runs over mixes (the hosting-capacity
    use case: which EV is at which bus, at what count)."""
    from hpfx.solve import hosting_capacity_sweep
    s, net, _ = _setup(h_max=25, coupled=True)
    lib = _library(s)
    B, n_nl = 8, net.n_nonlinear
    rng = np.random.default_rng(9)
    # counts: 0-2 devices of one random type per bus
    w = np.zeros((B, n_nl, 3))
    t = rng.integers(0, 3, (B, n_nl))
    cnt = rng.integers(0, 3, (B, n_nl)).astype(float)
    for b in range(B):
        for d in range(n_nl):
            w[b, d, t[b, d]] = cnt[b, d]
    scen = Scenarios(p_scale=jnp.ones(B), q_scale=jnp.ones(B),
                     device_mix=jnp.asarray(w))
    summary = hosting_capacity_sweep(net, lib, settings=s, scenarios=scen,
                                     thd_limit=0.08)
    assert summary.max_thd_f.shape == (B,)
    thd = np.asarray(summary.max_thd_f)
    assert np.all(np.isfinite(thd[np.asarray(summary.converged)]))


def test_per_bus_load_with_per_device_injection():
    """(B, n) load scales compose with (B, n_nl) injection scales."""
    s, net, dev = _setup(coupled=True)
    B = 3
    rng = np.random.default_rng(1)
    p = rng.uniform(0.8, 1.2, (B, net.n))
    inj = rng.uniform(0.5, 1.5, (B, net.n_nonlinear))
    scen = Scenarios(p_scale=jnp.asarray(p), q_scale=jnp.asarray(p),
                     injection_scale=jnp.asarray(inj))
    batch = hpf_sweep(net, dev, settings=s, scenarios=scen)
    for k in range(B):
        net_k = dataclasses.replace(
            net, bus_P=net.bus_P * jnp.asarray(p[k], s.real_dtype),
            bus_Q=net.bus_Q * jnp.asarray(p[k], s.real_dtype))
        single = hpf_single(net_k, _manual_scaled(dev, inj[k]), settings=s)
        assert int(batch.n_iter[k]) == int(single.n_iter), k
        np.testing.assert_allclose(np.asarray(batch.V_m[k]),
                                   np.asarray(single.V_m), atol=1e-10)


def test_analytic_device_lanes_matches_vmap():
    """AnalyticDeviceSet (autodiff injections) on the lane-major path:
    equals both the vmap analytic sweep and the closed-form Norton sweep
    (norton_inject is exactly the NE physics)."""
    import hpfx as _h
    from hpfx.devices import AnalyticDeviceSet, norton_inject

    s = _h.settings_for_hmax(9, coupled=True, solver="arrow")
    net = _h.load_network(f"{DATA}/net2_buses.csv",
                          f"{DATA}/net2_lines.csv", s)
    dev = _h.load_device_set(net, s)
    adev = AnalyticDeviceSet(params=(dev.I_N, dev.Y_N),
                             inject=norton_inject, n_nl=net.n_nonlinear)
    B = 4
    rng = np.random.default_rng(6)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.95, 1.05, B)),
        q_scale=jnp.ones(B),
        injection_scale=jnp.asarray(
            rng.uniform(0.7, 1.2, (B, net.n_nonlinear))))
    r_v = hpf_sweep(net, adev, settings=s.with_(layout="vmap"),
                    scenarios=scen)
    r_l = hpf_sweep(net, adev, settings=s.with_(layout="lanes"),
                    scenarios=scen)
    r_n = hpf_sweep(net, dev, settings=s.with_(layout="lanes"),
                    scenarios=scen)
    np.testing.assert_array_equal(np.asarray(r_l.n_iter),
                                  np.asarray(r_v.n_iter))
    np.testing.assert_allclose(np.asarray(r_l.V_m), np.asarray(r_v.V_m),
                               atol=2e-9)
    np.testing.assert_allclose(np.asarray(r_l.V_m), np.asarray(r_n.V_m),
                               atol=1e-8)
