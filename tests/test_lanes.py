"""Lane-major (batch-minor) sweep path: equivalence with the vmap path.

The lanes path (hpfx.lanes) is the batch-last layout of the exact same
batched solver hpfx.solve.hpf_sweep runs under vmap; these tests pin down
that both layouts compute the same iteration.  Comparisons allow the
fp-reorder noise Newton amplifies near the convergence threshold: the two
paths stop at (slightly) different points of the same basin, so states are
compared as phasors at the thresh_h·sensitivity scale, and scenario
convergence flags must match exactly.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import hpfx
from hpfx.lanes import supports_lanes
from hpfx.solve import Scenarios, hpf_sweep, hpf_sweep_adaptive

from conftest import DATA, load_golden


def _setup(net_name, h_max, coupled, stable=True, dtype="float32"):
    s = hpfx.settings_for_hmax(h_max, coupled=coupled).with_(
        solver="arrow", stable_mismatch=stable, dtype=dtype)
    net = hpfx.load_network(f"{DATA}/{net_name}_buses.csv",
                            f"{DATA}/{net_name}_lines.csv", s)
    dev = hpfx.load_device_set(net, s)
    return s, net, dev


def _scen(B, dtype=jnp.float32):
    return Scenarios(
        p_scale=jnp.linspace(0.9, 1.1, B, dtype=dtype),
        q_scale=jnp.linspace(0.95, 1.05, B, dtype=dtype),
        injection_scale=jnp.linspace(0.8, 1.2, B, dtype=dtype))


def _phasor_dist(r_a, r_b):
    """Max |V_a - V_b| as phasors (angle noise where V_m ~ 0 is physically
    meaningless and excluded by construction)."""
    pa = np.asarray(r_a.V_m) * np.exp(1j * np.asarray(r_a.V_a))
    pb = np.asarray(r_b.V_m) * np.exp(1j * np.asarray(r_b.V_a))
    return np.abs(pa - pb).max()


CONFIGS = [
    ("net2", 25, True, True),
    ("net2", 25, False, False),
    ("net3", 25, True, True),    # PV bus (c = 2)
    ("net3", 5, False, True),
    ("net1", 25, True, True),    # reference-scale, 7 devices
]


@pytest.mark.parametrize("net_name,h_max,coupled,stable", CONFIGS,
                         ids=lambda v: str(v))
def test_lanes_matches_vmap(net_name, h_max, coupled, stable):
    s, net, dev = _setup(net_name, h_max, coupled, stable)
    assert supports_lanes(dev, s, net)
    sc = _scen(6)
    r_v = hpf_sweep(net, dev, s.with_(layout="vmap"), sc)
    r_l = hpf_sweep(net, dev, s.with_(layout="lanes"), sc)
    assert np.array_equal(np.asarray(r_v.converged),
                          np.asarray(r_l.converged))
    assert np.asarray(r_l.converged).all()
    assert _phasor_dist(r_v, r_l) < 5e-4
    # fundamental warm start identical (same ops, same layout-insensitive
    # convergence) to f32 noise
    np.testing.assert_allclose(np.asarray(r_v.fund.V_m),
                               np.asarray(r_l.fund.V_m), atol=1e-5)


def test_lanes_matches_golden_nominal():
    """The lanes f32 solution at the nominal scenario stays within the
    same distance of the f64 golden the vmap f32 path is held to
    (tests/test_f32_path.py)."""
    for cfg in (("net2", 25, True), ("net1", 25, True)):
        net_name, h_max, coupled = cfg
        g = load_golden(cfg)
        s, net, dev = _setup(net_name, h_max, coupled, stable=True)
        one = jnp.ones((4,), jnp.float32)
        res = hpf_sweep(net, dev, s.with_(layout="lanes"),
                        Scenarios(one, one, one))
        assert np.asarray(res.converged).all()
        assert np.abs(np.asarray(res.V_m)[0] - g["V_m"]).max() < 3e-4


def test_lanes_err_hist_semantics():
    """err_hist rows: finite for exactly the first n_iter trips, NaN after
    (same contract as the vmap path)."""
    s, net, dev = _setup("net2", 25, True)
    sc = _scen(5)
    res = hpf_sweep(net, dev, s.with_(layout="lanes"), sc)
    hist = np.asarray(res.err_hist)
    n_iter = np.asarray(res.n_iter)
    for i in range(hist.shape[0]):
        assert np.isfinite(hist[i, : n_iter[i]]).all()
        assert np.isnan(hist[i, n_iter[i]:]).all()


def test_lanes_warm_start_and_adaptive():
    """V0 warm starts flow through the lanes path (the adaptive sweep's
    phase-2 re-solve) and the adaptive sweep converges everything."""
    s, net, dev = _setup("net2", 25, True)
    sc = _scen(8)
    full = hpf_sweep(net, dev, s.with_(layout="lanes"), sc)
    warm = hpf_sweep(net, dev, s.with_(layout="lanes"), sc,
                     V0=(full.V_m, full.V_a))
    # warm-started from the converged solution: 0 or 1 touch-up iterations
    assert int(np.asarray(warm.n_iter).max()) <= 1
    assert np.asarray(warm.converged).all()

    ada = hpf_sweep_adaptive(net, dev, s.with_(layout="lanes"), sc,
                             phase_iters=8)
    assert np.asarray(ada.converged).all()
    assert _phasor_dist(full, ada) < 5e-4


def test_lanes_per_bus_scaling():
    """p/q scales given per (scenario, bus) — the (B, n) broadcast arm."""
    s, net, dev = _setup("net2", 25, True)
    B, n = 4, net.n
    rng = np.random.default_rng(0)
    p = jnp.asarray(1.0 + 0.1 * rng.standard_normal((B, n)), jnp.float32)
    q = jnp.asarray(1.0 + 0.1 * rng.standard_normal((B, n)), jnp.float32)
    inj = jnp.linspace(0.9, 1.1, B, dtype=jnp.float32)
    sc = Scenarios(p_scale=p, q_scale=q, injection_scale=inj)
    r_v = hpf_sweep(net, dev, s.with_(layout="vmap"), sc)
    r_l = hpf_sweep(net, dev, s.with_(layout="lanes"), sc)
    assert np.array_equal(np.asarray(r_v.converged),
                          np.asarray(r_l.converged))
    assert _phasor_dist(r_v, r_l) < 5e-4


def test_lanes_f64_trajectory_parity():
    """In f64 the two layouts follow the same trajectory to fp noise for
    the early iterations (before chaotic NR amplification) — a much
    stronger check than final-state agreement."""
    s, net, dev = _setup("net2", 25, True, dtype="float64")
    sc = Scenarios(p_scale=jnp.linspace(0.9, 1.1, 4),
                   q_scale=jnp.ones((4,)),
                   injection_scale=jnp.ones((4,)))
    r_v = hpf_sweep(net, dev, s.with_(layout="vmap"), sc)
    r_l = hpf_sweep(net, dev, s.with_(layout="lanes"), sc)
    h_v = np.asarray(r_v.err_hist)[:, :4]
    h_l = np.asarray(r_l.err_hist)[:, :4]
    np.testing.assert_allclose(h_v, h_l, rtol=1e-6)


def test_lanes_fallback_unsupported():
    """Configurations outside the lanes scope (dense solver) silently use
    the vmap path under layout='auto' — results must exist and converge."""
    s, net, dev = _setup("net2", 25, True)
    s_dense = s.with_(solver="dense", layout="auto")
    assert not supports_lanes(dev, s_dense, net)
    res = hpf_sweep(net, dev, s_dense, _scen(3))
    assert np.asarray(res.converged).all()


def test_lanes_sharded_matches_unsharded():
    """The lanes layout under GSPMD scenario sharding (8-device CPU mesh,
    non-divisible batch -> padding arm) equals the unsharded sweep."""
    from hpfx.parallel import hpf_sweep_sharded, scenario_mesh
    s, net, dev = _setup("net2", 25, True, True)
    s = s.with_(layout="lanes")
    # mild spread: robustly convergent, so flags can't flip on fp noise
    sc = Scenarios(
        p_scale=jnp.linspace(0.95, 1.05, 12, dtype=jnp.float32),
        q_scale=jnp.linspace(0.98, 1.02, 12, dtype=jnp.float32),
        injection_scale=jnp.linspace(0.9, 1.1, 12, dtype=jnp.float32))
    mesh = scenario_mesh(8)
    r_sh = hpf_sweep_sharded(net, dev, s, sc, mesh)
    r_un = hpf_sweep(net, dev, s, sc)
    conv_sh = np.asarray(r_sh.converged)
    conv_un = np.asarray(r_un.converged)
    assert conv_sh.shape == (12,)
    # net2-coupled-f32 has basin-boundary scenarios whose convergence can
    # flip on ANY fp difference (incl. batch-padding-induced fusion
    # changes) — compare states on the commonly-converged set only
    both = conv_sh & conv_un
    assert both.sum() >= 10
    take = lambda r: r._replace(V_m=r.V_m[both], V_a=r.V_a[both])
    assert _phasor_dist(take(r_sh), take(r_un)) < 5e-4


def test_solve_lanes_kernel_interpret():
    """Batch-minor Pallas kernel through Triton (interpret mode) vs
    LAPACK."""
    from hpfx.ops.gj_triton import gj_solve_triton_lanes
    rng = np.random.default_rng(1)
    n, R, B = 14, 3, 40
    A = rng.standard_normal((B, n, n)).astype(np.float32)
    A += n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((B, n, R)).astype(np.float32)
    x_ref = np.linalg.solve(A, b)
    Al = jnp.moveaxis(jnp.asarray(A), 0, -1)
    bl = jnp.moveaxis(jnp.asarray(b), 0, -1)
    x = gj_solve_triton_lanes(Al, bl, interpret=True)
    np.testing.assert_allclose(np.moveaxis(np.asarray(x), -1, 0), x_ref,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# device-side continuation sweep (hpf_sweep_continuation_lanes): the whole
# key-sort / chunk / warm-start / rescue schedule as ONE compiled program
# ---------------------------------------------------------------------------

def test_continuation_lanes_matches_plain():
    """The scan-based continuation sweep reaches the same fixed points as
    the plain lanes sweep (warm starts change the path, not the root) at
    materially fewer total NR iterations, with uneven chunking (B=14,
    n_stages=4 -> padded last chunk)."""
    from hpfx.lanes import hpf_sweep_continuation_lanes, hpf_sweep_lanes
    s, net, dev = _setup("net2", 15, True, True)
    B = 14
    rng = np.random.default_rng(7)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.8, 1.2, B), jnp.float32),
        q_scale=jnp.asarray(rng.uniform(0.9, 1.1, B), jnp.float32),
        injection_scale=jnp.asarray(rng.uniform(0.5, 1.5, B), jnp.float32))
    plain = hpf_sweep_lanes(net, dev, s, scen)
    cont = hpf_sweep_continuation_lanes(net, dev, s, scen, n_stages=4)
    # warm starts + rescue converge AT LEAST the plain sweep's set (the
    # knife-edge class plain sweeps drop is exactly what they fix)
    conv_p = np.asarray(plain.converged)
    conv_c = np.asarray(cont.converged)
    assert np.all(conv_c)
    take = lambda r: r._replace(V_m=r.V_m[conv_p], V_a=r.V_a[conv_p])
    assert _phasor_dist(take(cont), take(plain)) < 1e-5
    assert int(np.sum(np.asarray(cont.n_iter))) < \
        int(np.sum(np.asarray(plain.n_iter)))


def test_continuation_lanes_single_stage_is_plain():
    """n_stages=1 degenerates to the plain cold-start sweep: identical
    iteration counts and states (the scan wrapper adds nothing)."""
    from hpfx.lanes import hpf_sweep_continuation_lanes, hpf_sweep_lanes
    s, net, dev = _setup("net2", 5, False, True)
    scen = _scen(6)
    plain = hpf_sweep_lanes(net, dev, s, scen)
    cont = hpf_sweep_continuation_lanes(net, dev, s, scen, n_stages=1,
                                        rescue=False)
    np.testing.assert_array_equal(np.asarray(cont.n_iter),
                                  np.asarray(plain.n_iter))
    np.testing.assert_allclose(np.asarray(cont.V_m), np.asarray(plain.V_m),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(cont.V_a), np.asarray(plain.V_a),
                               atol=1e-12)


def test_continuation_lanes_device_mix():
    """Continuation composes with the device-mix Monte-Carlo axes
    (DeviceLibrary + (B, n_nl, T) mixes + (B, n_nl) injection scales):
    same roots as the plain lanes sweep."""
    from hpfx.devices import load_device_library
    from hpfx.lanes import hpf_sweep_continuation_lanes, hpf_sweep_lanes
    s, net, _ = _setup("net4", 9, True, True)
    lib = load_device_library(("SMPS", "ev_1", "ev_4"), s)
    B, n_nl = 7, net.n_nonlinear
    rng = np.random.default_rng(13)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.9, 1.1, B), jnp.float32),
        q_scale=jnp.ones(B, jnp.float32),
        injection_scale=jnp.asarray(
            rng.uniform(0.5, 1.2, (B, n_nl)), jnp.float32),
        device_mix=jnp.asarray(
            rng.uniform(0.0, 1.0, (B, n_nl, lib.n_types)), jnp.float32))
    plain = hpf_sweep_lanes(net, lib, s, scen)
    cont = hpf_sweep_continuation_lanes(net, lib, s, scen, n_stages=3)
    np.testing.assert_array_equal(np.asarray(cont.converged),
                                  np.asarray(plain.converged))
    assert np.all(np.asarray(cont.converged))
    assert _phasor_dist(cont, plain) < 1e-5


def test_continuation_lanes_divergent_isolation():
    """A truly divergent scenario stays unconverged without poisoning its
    chunk neighbors or being used as a warm-start seed (converged-only
    seeding), and the rescue pass leaves converged scenarios untouched."""
    from hpfx.lanes import hpf_sweep_continuation_lanes, hpf_sweep_lanes
    s, net, dev = _setup("net2", 5, True, True)
    B = 9
    p = np.linspace(0.9, 1.1, B).astype(np.float32)
    inj = np.linspace(0.8, 1.2, B).astype(np.float32)
    p[4] = 500.0                      # no solution
    scen = Scenarios(p_scale=jnp.asarray(p), q_scale=jnp.asarray(p),
                     injection_scale=jnp.asarray(inj))
    cont = hpf_sweep_continuation_lanes(net, dev, s, scen, n_stages=3)
    conv = np.asarray(cont.converged)
    assert not conv[4] and conv.sum() == B - 1
    ok = np.ones(B, bool)
    ok[4] = False
    plain = hpf_sweep_lanes(net, dev, s, scen)
    take = lambda r: r._replace(V_m=r.V_m[ok], V_a=r.V_a[ok])
    assert _phasor_dist(take(cont), take(plain)) < 1e-5
    assert np.all(np.isfinite(np.asarray(cont.V_m)[ok]))


def test_adaptive_lanes_matches_host_adaptive():
    """The single-program device-side adaptive sweep
    (hpf_sweep_adaptive_lanes) reproduces the host-driven
    hpf_sweep_adaptive: in f64 — where its gather width coincides with
    the host's phase-2 bucket — fp-identical states and exact
    per-scenario iteration counts; in f32 the two compiled schedules
    differ by fp noise, which the knife-edge iteration counts amplify
    (CLAUDE.md #3), so the gates are conv-flag equality, small count
    drift, and state agreement at the convergence level."""
    from functools import partial

    import jax
    from hpfx.lanes import hpf_sweep_adaptive_lanes

    for dtype, tol in (("float64", 1e-12), ("float32", 1e-4)):
        s, net, dev = _setup("net2", 25, True, True, dtype=dtype)
        s = s.with_(layout="lanes")
        B = 48
        rdt = jnp.float64 if dtype == "float64" else jnp.float32
        scen = Scenarios(p_scale=jnp.linspace(0.8, 1.2, B, dtype=rdt),
                         q_scale=jnp.linspace(0.8, 1.2, B, dtype=rdt),
                         injection_scale=jnp.linspace(0.6, 1.4, B,
                                                      dtype=rdt))
        r_host = hpf_sweep_adaptive(net, dev, s, scen, phase_iters=6)
        f = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                            phase_iters=6))
        r_dev = f(net, dev, scenarios=scen)
        assert np.asarray(r_dev.converged).all()
        np.testing.assert_array_equal(np.asarray(r_dev.converged),
                                      np.asarray(r_host.converged))
        dn = np.abs(np.asarray(r_dev.n_iter, np.int64)
                    - np.asarray(r_host.n_iter, np.int64))
        # f32: fp noise between the two compiled schedules perturbs
        # knife-edge counts (chaotic transient, same bound class as
        # conftest.LOOSE_ITERS); both states are gated at `tol` anyway
        assert dn.max() <= (0 if dtype == "float64" else 6)
        assert _phasor_dist(r_dev, r_host) < tol
        hist = np.asarray(r_dev.err_hist)
        ni = np.asarray(r_dev.n_iter)
        for i in range(B):
            assert np.isfinite(hist[i, : ni[i]]).all()
            assert np.isnan(hist[i, ni[i]:]).all()


def test_adaptive_lanes_divergent_and_rescue_width():
    """A truly divergent scenario stays unconverged (cold rescue cannot
    save it) without poisoning neighbors, with a rescue_width much
    smaller than the batch: phase_iters is set high enough that the
    easy lanes converge in phase 1, so the static-width gather (the
    device program's stand-in for the host's data-dependent straggler
    bucket) only has to cover the divergent lane."""
    from functools import partial

    import jax
    from hpfx.lanes import hpf_sweep_adaptive_lanes, hpf_sweep_lanes

    s, net, dev = _setup("net2", 5, True, True)
    B = 9
    p = np.linspace(0.9, 1.1, B).astype(np.float32)
    inj = np.linspace(0.8, 1.2, B).astype(np.float32)
    p[4] = 500.0                      # no solution
    scen = Scenarios(p_scale=jnp.asarray(p), q_scale=jnp.asarray(p),
                     injection_scale=jnp.asarray(inj))
    f = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                        phase_iters=24, rescue_width=2))
    r = f(net, dev, scenarios=scen)
    conv = np.asarray(r.converged)
    assert not conv[4] and conv.sum() == B - 1
    plain = hpf_sweep_lanes(net, dev, s, scen)
    ok = np.ones(B, bool)
    ok[4] = False
    take = lambda rr: rr._replace(V_m=rr.V_m[ok], V_a=rr.V_a[ok])
    assert _phasor_dist(take(r), take(plain)) < 1e-5
    assert np.all(np.isfinite(np.asarray(r.V_m)[ok]))


def test_hpf_sweep_device_rescue_overflow():
    """hpf_sweep_device = the single-program adaptive sweep + the host
    _rescue_sweep engaged only when lanes remain unconverged.  With a
    deliberately overflowed static rescue_width (1 lane for several
    stragglers — the gather-overflow failure mode of straggler-heavy
    net1 batches) the device program must leave honest
    unconverged lanes and the wrapper's host rescue must recover ALL of
    them to the host-adaptive fixed points; with the default width the
    rescue is a no-op and the wrapper returns the device result as-is."""
    from functools import partial

    import jax
    from hpfx.lanes import hpf_sweep_adaptive_lanes
    from hpfx.solve import hpf_sweep_device

    s, net, dev = _setup("net2", 5, True, True, dtype="float64")
    s = s.with_(layout="lanes")
    B = 12
    scen = Scenarios(
        p_scale=jnp.linspace(0.8, 1.2, B, dtype=jnp.float64),
        q_scale=jnp.linspace(0.8, 1.2, B, dtype=jnp.float64),
        injection_scale=jnp.linspace(0.6, 1.4, B, dtype=jnp.float64))

    # overflowed gather: phase_iters=2 leaves most lanes unconverged and
    # a 1-wide rescue can finish at most one of them inside the program
    f_narrow = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                               phase_iters=2, rescue_width=1))
    r_raw = f_narrow(net, dev, scenarios=scen)
    assert not np.asarray(r_raw.converged).all(), \
        "premise: the narrow device program must overflow"
    r_fix = hpf_sweep_device(net, dev, s, scen, jitted=f_narrow)
    assert np.asarray(r_fix.converged).all()
    r_host = hpf_sweep_adaptive(net, dev, s, scen, phase_iters=2)
    assert _phasor_dist(r_fix, r_host) < 1e-10

    # default width: everything converges on device; wrapper must not
    # touch the result (rescue path not entered)
    r_dev = hpf_sweep_device(net, dev, s, scen, phase_iters=16)
    assert np.asarray(r_dev.converged).all()


def test_hpf_sweep_stream_matches_device_sweep():
    """The pipelined stream executor must be a pure scheduling change:
    per-batch results identical (to the bit — same compiled program) to
    calling hpf_sweep_device on each batch, in input order, at any
    pipeline depth, including when the host rescue engages mid-stream
    (narrow rescue_width forces overflow on every batch)."""
    from functools import partial

    import jax
    from hpfx.lanes import hpf_sweep_adaptive_lanes
    from hpfx.solve import hpf_sweep_device, hpf_sweep_stream

    s, net, dev = _setup("net2", 5, True, True, dtype="float64")
    s = s.with_(layout="lanes")
    B = 8

    def batch(k):
        return Scenarios(
            p_scale=jnp.linspace(0.85, 1.15, B, dtype=jnp.float64) + 1e-3 * k,
            q_scale=jnp.linspace(0.85, 1.15, B, dtype=jnp.float64),
            injection_scale=jnp.linspace(0.7, 1.3, B, dtype=jnp.float64))

    ref = [hpf_sweep_device(net, dev, s, batch(k), phase_iters=16)
           for k in range(3)]
    for depth in (1, 3):
        got = list(hpf_sweep_stream(net, dev, s, (batch(k) for k in range(3)),
                                    phase_iters=16, depth=depth))
        assert len(got) == 3
        for r_ref, r_got in zip(ref, got):
            assert np.asarray(r_got.converged).all()
            np.testing.assert_array_equal(np.asarray(r_got.V_m),
                                          np.asarray(r_ref.V_m))
            np.testing.assert_array_equal(np.asarray(r_got.V_a),
                                          np.asarray(r_ref.V_a))

    # rescue engages per dequeued batch: a 1-wide device rescue overflows
    # (phase_iters=2 leaves several stragglers) and the stream's host
    # rescue must still converge every scenario of every batch
    f_narrow = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                               phase_iters=2, rescue_width=1))
    got = list(hpf_sweep_stream(net, dev, s, [batch(0), batch(1)],
                                depth=2, jitted=f_narrow))
    for k, r in enumerate(got):
        assert np.asarray(r.converged).all()
        r_ref = hpf_sweep_device(net, dev, s, batch(k), jitted=f_narrow)
        assert _phasor_dist(r, r_ref) < 1e-12


def test_adaptive_lanes_bucketed_rescue_widths():
    """rescue_width as a tuple: lax.switch picks the smallest bucket
    covering the straggler count.  phase_iters=1 leaves ~everything
    unconverged, overflowing a width-2 bucket — the single narrow width
    must under-converge honestly while the bucketed program escalates to
    the full-width bucket and converges everything."""
    from functools import partial

    import jax
    from hpfx.lanes import hpf_sweep_adaptive_lanes

    s, net, dev = _setup("net2", 25, True)
    s = s.with_(layout="lanes", solver="arrow")
    B = 16
    scen = Scenarios(p_scale=jnp.linspace(0.85, 1.15, B),
                     q_scale=jnp.linspace(0.85, 1.15, B),
                     injection_scale=jnp.linspace(0.7, 1.3, B))

    run = lambda **kw: jax.jit(partial(hpf_sweep_adaptive_lanes,
                                       settings=s, phase_iters=1,
                                       **kw))(net, dev, scenarios=scen)
    narrow = run(rescue_width=2)
    assert not bool(np.asarray(narrow.converged).all())

    bucketed = run(rescue_width=(2, B))
    assert bool(np.asarray(bucketed.converged).all())

    # when stragglers FIT the chosen bucket, the bucketed program is
    # fp-identical to the single width of that size
    wide = run(rescue_width=B)
    np.testing.assert_array_equal(np.asarray(bucketed.V_m),
                                  np.asarray(wide.V_m))
    np.testing.assert_array_equal(np.asarray(bucketed.n_iter),
                                  np.asarray(wide.n_iter))
