"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpfx.parallel import (hosting_capacity_sharded, hpf_sweep_sharded,
                           scenario_mesh, shard_scenarios)
from hpfx.solve import Scenarios, hosting_capacity_sweep, hpf_sweep

from conftest import make_setup

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")


def _scen(b):
    p = jnp.linspace(0.5, 1.5, b)
    return Scenarios(p_scale=p, q_scale=p,
                     injection_scale=jnp.linspace(0.2, 1.2, b))


def test_mesh_and_placement():
    mesh = scenario_mesh(8)
    assert mesh.devices.shape == (8,)
    scen = shard_scenarios(_scen(16), mesh)
    assert not scen.p_scale.sharding.is_fully_replicated
    assert scen.p_scale.sharding.num_devices == 8


def test_sharded_sweep_matches_unsharded():
    cfg = ("net2", 5, True)
    s, net, dev = make_setup(cfg)
    scen = _scen(16)
    mesh = scenario_mesh(8)
    ref = hpf_sweep(net, dev, settings=s, scenarios=scen)
    out = hpf_sweep_sharded(net, dev, s, scen, mesh)
    np.testing.assert_allclose(np.asarray(out.V_m), np.asarray(ref.V_m),
                               atol=1e-12)
    np.testing.assert_array_equal(np.asarray(out.n_iter),
                                  np.asarray(ref.n_iter))
    # outputs actually live sharded over the mesh
    assert out.V_m.sharding.num_devices == 8


def test_sharded_hosting_capacity_reduction():
    """The global fraction is an all-reduce across shards and matches the
    single-device computation."""
    cfg = ("net2", 5, True)
    s, net, dev = make_setup(cfg)
    scen = _scen(24)
    mesh = scenario_mesh(8)
    ref = hosting_capacity_sweep(net, dev, settings=s, scenarios=scen,
                                 thd_limit=0.3)
    out = hosting_capacity_sharded(net, dev, s, scen, mesh, thd_limit=0.3)
    np.testing.assert_allclose(np.asarray(out.max_thd_f),
                               np.asarray(ref.max_thd_f), atol=1e-12)
    np.testing.assert_allclose(float(out.frac_over_limit),
                               float(ref.frac_over_limit))
    assert out.frac_over_limit.sharding.is_fully_replicated


def test_sharded_sweep_non_divisible_batch():
    """B % mesh != 0: the batch is padded (last scenario repeated), results
    sliced back, and the hosting-capacity aggregate masks the padding."""
    cfg = ("net2", 5, True)
    s, net, dev = make_setup(cfg)
    scen = _scen(13)                       # 13 % 8 != 0
    mesh = scenario_mesh(8)
    ref = hpf_sweep(net, dev, settings=s, scenarios=scen)
    out = hpf_sweep_sharded(net, dev, s, scen, mesh)
    assert out.V_m.shape[0] == 13
    np.testing.assert_allclose(np.asarray(out.V_m), np.asarray(ref.V_m),
                               atol=1e-12)
    np.testing.assert_array_equal(np.asarray(out.n_iter),
                                  np.asarray(ref.n_iter))
    refh = hosting_capacity_sweep(net, dev, settings=s, scenarios=scen,
                                  thd_limit=0.3)
    outh = hosting_capacity_sharded(net, dev, s, scen, mesh, thd_limit=0.3)
    assert outh.max_thd_f.shape[0] == 13
    # the padded duplicate of scenario 13 must not bias the fraction
    np.testing.assert_allclose(float(outh.frac_over_limit),
                               float(refh.frac_over_limit))


def test_mesh_subset():
    mesh = scenario_mesh(4)
    cfg = ("net2", 5, False)
    s, net, dev = make_setup(cfg)
    scen = _scen(8)
    out = hpf_sweep_sharded(net, dev, s, scen, mesh)
    ref = hpf_sweep(net, dev, settings=s, scenarios=scen)
    np.testing.assert_allclose(np.asarray(out.V_m), np.asarray(ref.V_m),
                               atol=1e-12)


def test_hosting_capacity_at_scale():
    """Hosting-capacity shape: thousands of random EV-penetration
    scenarios swept over the full mesh with a global aggregate."""
    import numpy as np
    cfg = ("net2", 5, True)
    s, net, dev = make_setup(cfg)
    B = 2048
    rng = np.random.default_rng(0)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.85, 1.15, B), s.real_dtype),
        q_scale=jnp.asarray(rng.uniform(0.85, 1.15, B), s.real_dtype),
        injection_scale=jnp.asarray(rng.uniform(0.3, 1.3, B), s.real_dtype))
    mesh = scenario_mesh(8)
    out = hosting_capacity_sharded(net, dev, s, scen, mesh, thd_limit=0.3)
    conv = float(np.mean(np.asarray(out.converged)))
    assert conv > 0.9
    frac = float(out.frac_over_limit)
    # matches the host-side recomputation over the sharded outputs
    expect = float(np.mean((np.asarray(out.max_thd_f) > 0.3)
                           & np.asarray(out.converged)))
    np.testing.assert_allclose(frac, expect)


# ---------------------------------------------------------------------------
# harmonic-axis model parallelism (the TP analogue, SURVEY §5.7)


@pytest.mark.parametrize("solver", ["dense", "arrow"])
def test_hsharded_single_matches_unsharded(solver):
    """hpf_single with the harmonic axis sharded over 8 devices equals the
    unsharded solve (same fixed point, identical iteration count) — H=13
    does not divide 8, so GSPMD's uneven-shard padding is exercised too."""
    import hpfx
    from hpfx.parallel import harmonic_mesh, hpf_single_hsharded

    s, net, dev = make_setup(("net2", 25, True))
    s = s.with_(solver=solver)
    ref = hpfx.hpf_single(net, dev, settings=s)
    out = hpf_single_hsharded(net, dev, s, harmonic_mesh(8))
    assert bool(out.converged)
    assert int(out.n_iter) == int(ref.n_iter)
    np.testing.assert_allclose(np.asarray(out.V_m), np.asarray(ref.V_m),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(out.V_a), np.asarray(ref.V_a),
                               atol=1e-10)


def test_hsharded_collectives_in_hlo():
    """The compiled harmonic-sharded program is genuinely partitioned:
    cross-harmonic coupling lowers to collectives (not a replicated
    fallback)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hpfx.fundamental import solve_fundamental
    from hpfx.harmonic import solve_harmonic
    from hpfx.parallel import harmonic_mesh
    from hpfx.parallel.mesh import HARMONIC_AXIS, _replicate
    from hpfx.ybus import build_ybus, line_ybus_pair

    s, net, dev = make_setup(("net2", 25, True))
    s = s.with_(solver="arrow")
    mesh = harmonic_mesh(8)
    yspec = NamedSharding(mesh, P(HARMONIC_AXIS, None, None))
    vspec = NamedSharding(mesh, P(HARMONIC_AXIS, None))

    @jax.jit
    def run(net, dev):
        Y = build_ybus(net, s)
        Y = jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(a, yspec), Y)
        lineY, lineY_f = line_ybus_pair(net, s)
        fund = solve_fundamental(Y[0], net, s, lineY=lineY_f)
        return solve_harmonic(Y, fund, net, dev, s, lineY=lineY,
                              vsharding=vspec)

    txt = run.lower(_replicate(net, mesh), _replicate(dev, mesh)) \
             .compile().as_text()
    assert "all-reduce" in txt or "all-gather" in txt


def test_sharded2d_sweep_matches_lanes():
    """2-D scenario × harmonic mesh (DP × TP) vs the unsharded lanes sweep:
    same fixed points within the NR tolerance band (harmonic-axis
    collectives reorder fp reductions, so not bitwise), iteration counts
    within 1, identical convergence flags."""
    from hpfx.parallel import hpf_mesh, hpf_sweep_sharded2d

    s, net, dev = make_setup(("net2", 25, True))
    s = s.with_(solver="arrow", layout="lanes")
    scen = Scenarios(p_scale=jnp.linspace(0.95, 1.05, 10),
                     q_scale=jnp.linspace(0.98, 1.02, 10),
                     injection_scale=jnp.linspace(0.9, 1.1, 10))
    ref = hpf_sweep(net, dev, settings=s, scenarios=scen)
    out = hpf_sweep_sharded2d(net, dev, s, scen, hpf_mesh(4, 2))
    assert out.V_m.shape == ref.V_m.shape
    np.testing.assert_array_equal(np.asarray(out.converged),
                                  np.asarray(ref.converged))
    assert np.abs(np.asarray(out.n_iter) - np.asarray(ref.n_iter)).max() <= 1
    np.testing.assert_allclose(np.asarray(out.V_m), np.asarray(ref.V_m),
                               atol=5e-5)


def test_sharded2d_with_per_device_scales():
    """2-D scenario x harmonic mesh with (B, n_nl) per-device injection
    scales: the round-3 scenario axes shard end to end (the lanes layout
    transposes the scale to (n_nl, B), moving the sharded axis last —
    GSPMD must follow)."""
    from hpfx.parallel import hpf_mesh, hpf_sweep_sharded2d

    cfg = ("net1", 25, True)
    s, net, dev = make_setup(cfg)
    s = s.with_(solver="arrow", layout="lanes")
    B = 6
    rng = np.random.default_rng(3)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.95, 1.05, B)),
        q_scale=jnp.ones(B),
        injection_scale=jnp.asarray(
            rng.uniform(0.8, 1.2, (B, net.n_nonlinear))))
    mesh = hpf_mesh(4, 2)
    r2 = hpf_sweep_sharded2d(net, dev, s, scen, mesh)
    ru = hpf_sweep(net, dev, settings=s, scenarios=scen)
    assert r2.V_m.shape[0] == B
    np.testing.assert_array_equal(np.asarray(r2.converged),
                                  np.asarray(ru.converged))
    sel = np.asarray(ru.converged)
    dv = np.abs(np.asarray(r2.V_m) - np.asarray(ru.V_m))[sel].max()
    assert dv < 5e-8, dv


def test_continuation_sharded_matches_unsharded():
    """Device-side continuation sweep on the 1-D scenario mesh and the 2-D
    scenario × harmonic mesh vs the unsharded version: same convergence
    set, same fixed points within the NR tolerance band."""
    from hpfx.lanes import hpf_sweep_continuation_lanes
    from hpfx.parallel import (hpf_mesh, hpf_sweep_continuation_sharded,
                               scenario_mesh)

    s, net, dev = make_setup(("net2", 15, True))
    s = s.with_(solver="arrow", layout="lanes")
    B = 24
    rng = np.random.default_rng(9)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.85, 1.15, B)),
        q_scale=jnp.asarray(rng.uniform(0.9, 1.1, B)),
        injection_scale=jnp.asarray(rng.uniform(0.6, 1.4, B)))
    ref = hpf_sweep_continuation_lanes(net, dev, s, scen, n_stages=3)
    conv_ref = np.asarray(ref.converged)
    assert conv_ref.all()
    for mesh in (scenario_mesh(8), hpf_mesh(4, 2)):
        out = hpf_sweep_continuation_sharded(net, dev, s, scen, mesh,
                                             n_stages=3)
        assert out.V_m.shape == ref.V_m.shape
        np.testing.assert_array_equal(np.asarray(out.converged), conv_ref)
        np.testing.assert_allclose(np.asarray(out.V_m),
                                   np.asarray(ref.V_m), atol=5e-5)


def test_sharded_sweep_sensitivity_matches_unsharded():
    """sweep_sensitivity jitted over scenario-sharded inputs (GSPMD mesh)
    equals the unsharded computation — batched IFT gradients ride the same
    scenario-parallel axis as the sweep itself."""
    import hpfx
    from jax.sharding import NamedSharding, PartitionSpec as P
    from hpfx.parallel.mesh import SCENARIO_AXIS

    cfg = ("net2", 5, True)
    s, net, dev = make_setup(cfg)
    scen = _scen(16)
    mesh = scenario_mesh(8)
    res = hpf_sweep(net, dev, settings=s, scenarios=scen)
    ref = hpfx.sweep_sensitivity(net, dev, s, res, scen)

    spec = NamedSharding(mesh, P(SCENARIO_AXIS))
    scen_sh = shard_scenarios(scen, mesh)
    res_sh = jax.tree.map(lambda x: jax.device_put(x, spec), res)
    out = jax.jit(
        lambda r, sc: hpfx.sweep_sensitivity(net, dev, s, r, sc))(
        res_sh, scen_sh)
    np.testing.assert_allclose(np.asarray(out.value),
                               np.asarray(ref.value), atol=1e-12)
    for g_sh, g in zip(out.grad, ref.grad):
        np.testing.assert_allclose(np.asarray(g_sh), np.asarray(g),
                                   atol=1e-12)


def test_adaptive_sharded_matches_unsharded():
    """Single-program adaptive sweep on the 1-D scenario mesh and the
    2-D scenario × harmonic mesh vs the unsharded program: same
    convergence set, same fixed points within the NR tolerance band.
    The straggler gather/scatter crosses the scenario shards (global
    argsort + take), so this also exercises GSPMD's collectives around
    the rescue trips."""
    from functools import partial

    from hpfx.lanes import hpf_sweep_adaptive_lanes
    from hpfx.parallel import (hpf_mesh, hpf_sweep_adaptive_sharded,
                               scenario_mesh)

    s, net, dev = make_setup(("net2", 15, True))
    s = s.with_(solver="arrow", layout="lanes")
    B = 24
    rng = np.random.default_rng(9)
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.85, 1.15, B)),
        q_scale=jnp.asarray(rng.uniform(0.9, 1.1, B)),
        injection_scale=jnp.asarray(rng.uniform(0.6, 1.4, B)))
    ref = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                          phase_iters=8))(net, dev, scenarios=scen)
    conv_ref = np.asarray(ref.converged)
    assert conv_ref.all()
    for mesh in (scenario_mesh(8), hpf_mesh(4, 2)):
        out = hpf_sweep_adaptive_sharded(net, dev, s, scen, mesh,
                                         phase_iters=8)
        assert out.V_m.shape == ref.V_m.shape
        np.testing.assert_array_equal(np.asarray(out.converged), conv_ref)
        np.testing.assert_allclose(np.asarray(out.V_m),
                                   np.asarray(ref.V_m), atol=5e-5)


def test_studies_compose_with_sharded_sweeps():
    """The round-4 study layer consumes any sweep: quantile assessment
    over the mesh-sharded sweep equals the unsharded assessment, and a
    sharded time-series run feeds percentile_compliance unchanged."""
    import hpfx

    s, net, dev = make_setup(("net2", 5, True))
    mesh = scenario_mesh(8)
    scen = _scen(16)

    sharded = lambda n_, d_, s_, sc_: hpf_sweep_sharded(n_, d_, s_, sc_,
                                                        mesh)
    qa_ref = hpfx.assess_quantiles(net, dev, s, scen,
                                   quantiles=(0.5, 0.95))
    qa_sh = hpfx.assess_quantiles(net, dev, s, scen,
                                  quantiles=(0.5, 0.95), sweep=sharded)
    np.testing.assert_allclose(np.asarray(qa_sh.thd_q),
                               np.asarray(qa_ref.thd_q), atol=1e-12)
    np.testing.assert_allclose(np.asarray(qa_sh.vh_pct_q),
                               np.asarray(qa_ref.vh_pct_q), atol=1e-10)
    assert qa_sh.converged_frac == qa_ref.converged_frac == 1.0

    prof = hpfx.daily_profile(16, base=0.8, peak=1.05)
    ts_ref = hpfx.run_timeseries(net, dev, s, prof)
    ts_sh = hpfx.run_timeseries(net, dev, s, prof, sweep=sharded)
    pc_ref = hpfx.percentile_compliance(ts_ref, s)
    pc_sh = hpfx.percentile_compliance(ts_sh, s)
    np.testing.assert_allclose(np.asarray(pc_sh.thd_p),
                               np.asarray(pc_ref.thd_p), atol=1e-12)
    assert pc_sh.compliant == pc_ref.compliant
