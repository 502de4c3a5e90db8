"""f32 (sweep-numerics) regression tests, run on CPU.

The accelerator sweeps run in f32 with HIGHEST-precision matmuls; these
tests pin down that the solver still converges under f32 and stays within
the expected distance of the f64 goldens — the failure mode guarded
against is precision regressions (e.g. losing the HIGHEST matmul override,
which floors residuals at ~1e-2 and was observed on hardware).
"""
import numpy as np
import pytest

import hpfx

from conftest import load_golden, make_setup


@pytest.mark.parametrize("cfg", [("net2", 25, True), ("net3", 25, False)],
                         ids=lambda c: f"{c[0]}_h{c[1]}_{'c' if c[2] else 'uc'}")
def test_f32_convergence_and_accuracy(cfg):
    g = load_golden(cfg)
    s, _, _ = make_setup(cfg)
    s32 = s.with_(dtype="float32")
    net = hpfx.load_network(
        f"{__import__('conftest').DATA}/{cfg[0]}_buses.csv",
        f"{__import__('conftest').DATA}/{cfg[0]}_lines.csv", s32)
    dev = hpfx.load_device_set(net, s32)
    res = hpfx.hpf(net, dev, s32)
    assert bool(res.converged), float(res.err)
    # f32 solution within ~1e-4 of the f64 golden (thresh_h=1e-4 regime)
    assert np.abs(np.asarray(res.V_m) - g["V_m"]).max() < 1e-4
    # iteration count may differ by a couple under f32 rounding
    assert abs(int(res.n_iter) - int(g["n_iter_h"])) <= 4


def test_f32_fundamental_floor():
    """The fundamental threshold 1e-6 sits near the f32 noise floor; the
    solver must still terminate (converged or saturated) with a small
    residual rather than oscillate to NaN."""
    cfg = ("net2", 5, True)
    s, _, _ = make_setup(cfg)
    s32 = s.with_(dtype="float32")
    net = hpfx.load_network(
        f"{__import__('conftest').DATA}/net2_buses.csv",
        f"{__import__('conftest').DATA}/net2_lines.csv", s32)
    dev = hpfx.load_device_set(net, s32)
    res = hpfx.hpf(net, dev, s32)
    assert float(res.fund.err) < 1e-3
    assert np.isfinite(np.asarray(res.V_m)).all()

def test_stable_mismatch_matches_dense_f64():
    """The line-difference mismatch (Settings.stable_mismatch) is
    algebraically identical to the reference-form dense matvec: in f64 the
    two agree to accumulation noise on every golden config's first
    iteration, and the full solve reaches the same solution with the same
    iteration count."""
    import jax.numpy as jnp

    from hpfx import cx, harmonic
    from hpfx.ybus import build_line_ybus

    for cfg in [("net2", 25, True), ("net3", 25, True), ("net1", 25, True),
                ("net3", 5, False)]:
        s, net, dev = make_setup(cfg)
        Y = hpfx.build_ybus(net, s)
        fund = hpfx.pf(Y, net, s)
        V_m, V_a = harmonic.init_harmonic_voltages(fund, net, s)
        S = cx.Cx(net.bus_P, net.bus_Q)
        m, n, c = net.m, net.n, net.c
        f_d, _ = harmonic.harmonic_mismatch(V_m, V_a, Y, S, dev, m, n, c)
        lineY = build_line_ybus(net, s)
        f_s, _ = harmonic.harmonic_mismatch(V_m, V_a, Y, S, dev, m, n, c,
                                            lineY)
        scale = max(1.0, float(np.abs(np.asarray(f_d)).max()))
        np.testing.assert_allclose(np.asarray(f_s), np.asarray(f_d),
                                   atol=1e-12 * scale)
        ref = hpfx.hpf(net, dev, s)
        stab = hpfx.hpf(net, dev, s.with_(stable_mismatch=True))
        assert int(stab.n_iter) == int(ref.n_iter), cfg
        np.testing.assert_allclose(np.asarray(stab.V_m), np.asarray(ref.V_m),
                                   atol=1e-9)


def test_f32_net1_reference_scale_converges():
    """Round-2 gate: the f32 fast path converges at *reference scale*
    (net1, J dim 518) with the stable mismatch + floor-aware criterion +
    equilibrated Newton solves, and the solution matches the f64 golden.
    Without these the residual stalls at ~3e-4 > thresh_h (CLAUDE.md
    #2; PERF.md, numerics history)."""
    import jax.numpy as jnp

    from hpfx.solve import Scenarios, hpf_sweep_adaptive

    cfg = ("net1", 25, True)
    g = load_golden(cfg)
    s, _, _ = make_setup(cfg)
    s32 = s.with_(dtype="float32", solver="arrow", stable_mismatch=True)
    DATA = __import__('conftest').DATA
    net = hpfx.load_network(f"{DATA}/net1_buses.csv",
                            f"{DATA}/net1_lines.csv", s32)
    dev = hpfx.load_device_set(net, s32)
    B = 6
    scen = Scenarios(p_scale=jnp.linspace(0.9, 1.1, B),
                     q_scale=jnp.linspace(0.9, 1.1, B),
                     injection_scale=jnp.linspace(0.8, 1.2, B))
    res = hpf_sweep_adaptive(net, dev, s32, scen, phase_iters=24,
                             phase2_settings=s32.with_(solver="dense"))
    assert np.asarray(res.converged).all(), np.asarray(res.err)
    # nominal-ish scenario (index 3: p=1.02, inj=1.08) sanity vs golden
    one = Scenarios(p_scale=jnp.ones(1), q_scale=jnp.ones(1),
                    injection_scale=jnp.ones(1))
    r1 = hpf_sweep_adaptive(net, dev, s32, one, phase_iters=24,
                            phase2_settings=s32.with_(solver="dense"))
    assert bool(np.asarray(r1.converged)[0])
    assert np.abs(np.asarray(r1.V_m)[0] - g["V_m"]).max() < 3e-4


@pytest.mark.parametrize("h_max,bound", [(25, 3e-4), (51, 2e-3)])
def test_f32_net1_sweep_accuracy_vs_f64(h_max, bound):
    """The f32 sweep against float64 per-scenario solves over the bench's
    spread (the bounds chip_smoke.py holds the card to): floor-aware f32
    stopping leaves ~1.6e-4 at H<=25 and ~1.6e-3 at H<=51, whose dim-1038
    evaluation floor sits several times above thresh_h."""
    import os
    import sys

    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke as cs
    from hpfx.solve import hpf_sweep_adaptive

    s = cs._settings(h_max)
    net, dev = cs._fixture("net1", s)
    p, q, i = (x[[0, 128, 255]] for x in cs._scen_np(256))
    res = hpf_sweep_adaptive(net, dev, s, cs._to_scenarios(
        p, q, i, jnp.float32), phase_iters=30)
    V_ref, conv_ref = cs.reference_f64("net1", h_max, p, q, i)
    assert np.asarray(res.converged).all() and conv_ref.all()
    assert np.abs(np.asarray(res.V_m) - V_ref).max() < bound


def test_f32_net1_single_solve_converges():
    """Unbatched f32 solves route through the same equilibrated dispatcher
    as the sweep (round-2 review finding: the base cases of nr_solve /
    solve_blocks used raw LU and hit the exact f32 stall the sweep path
    fixes).  Single-case hpf at net1 scale must converge on both solvers."""
    DATA = __import__('conftest').DATA
    s64, _, _ = make_setup(("net1", 25, True))
    s = s64.with_(dtype="float32", stable_mismatch=True)
    net = hpfx.load_network(f"{DATA}/net1_buses.csv",
                            f"{DATA}/net1_lines.csv", s)
    dev = hpfx.load_device_set(net, s)
    g = load_golden(("net1", 25, True))
    for solver in ("dense", "arrow"):
        res = hpfx.hpf(net, dev, s.with_(solver=solver))
        assert bool(res.converged), (solver, float(res.err))
        assert np.abs(np.asarray(res.V_m) - g["V_m"]).max() < 3e-4, solver
