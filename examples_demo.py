"""End-to-end hpfx demo: every layer of the pipeline in one script.

Run: python examples_demo.py          (JAX's default backend;
     JAX_PLATFORMS=cpu python examples_demo.py for the CPU, ~1 min)

Covers, in order:
  1. device characterization: simulate an SMPS rectifier, fit its coupled
     Norton equivalent (replaces the reference's Simulink + NE_from_sim.py)
  2. harmonic power flow on net2 with the shipped smps table
  3. a batched hosting-capacity sweep with THD screening
  4. THD sensitivity to device penetration (implicit differentiation)
  5. Kron reduction of the passive bus
  6. device-mix Monte-Carlo: which EV/SMPS model at which bus, at what
     count (DeviceLibrary + Scenarios.device_mix), with per-parameter
     sensitivities
  7. warm-start continuation sweep (stages seeded from solved neighbors)
  8. a transformer feeder (tap + phase shift) solved end-to-end
  9. line-parameter sensitivities (tap / impedance gradients of THD)
  10. per-harmonic impedance scan with resonance detection
  11. emission allocation (per-device distortion contributions), dense
      operational frequency scan, and a single-tuned filter in service
  12. gradient-based tap optimization (optax loop on the exact IFT
      gradients) on the transformer feeder
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

# the demo prints reference-parity numbers: f64 on every backend
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import hpfx

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "hpfx", "data")


def main():
    # -- 1. characterize a rectifier and fit its Norton equivalent --------
    from hpfx.simulate import SweepProtocol, characterize_rectifier, smps_params
    proto = SweepProtocol(harm_freqs=(150.0, 250.0, 350.0, 450.0))
    ms = characterize_rectifier(smps_params(), proto)
    fit = hpfx.fit_norton_from_measurements(ms)
    print(f"[1] NE fit: self-test uncoupled={fit.err_uncoupled:.1e} "
          f"coupled={fit.err_coupled:.1e} passed={fit.passed}")

    # -- 2. harmonic power flow on net2 -----------------------------------
    s = hpfx.settings_for_hmax(25, coupled=True)
    net = hpfx.load_network(os.path.join(DATA, "net2_buses.csv"),
                            os.path.join(DATA, "net2_lines.csv"), s)
    dev = hpfx.load_device_set(net, s)
    res = hpfx.hpf(net, dev, s)
    rep = hpfx.report(res, s)
    print(f"[2] net2 H<=25 coupled: {rep.n_iter_harm} NR iterations, "
          f"err={rep.err_harm:.2e}, THD_F per bus="
          f"{np.round(np.asarray(rep.thd.THD_F), 4)}")

    # -- 3. hosting-capacity sweep ----------------------------------------
    B = 512
    rng = np.random.default_rng(0)
    scen = hpfx.Scenarios(
        p_scale=jnp.asarray(rng.uniform(0.9, 1.1, B), s.real_dtype),
        q_scale=jnp.asarray(rng.uniform(0.9, 1.1, B), s.real_dtype),
        injection_scale=jnp.asarray(rng.uniform(0.2, 1.2, B), s.real_dtype))
    summary = hpfx.hosting_capacity_sweep(net, dev, settings=s,
                                          scenarios=scen, thd_limit=0.5)
    print(f"[3] sweep B={B}: conv="
          f"{float(jnp.mean(summary.converged.astype(jnp.float32))):.3f}, "
          f"frac THD>0.5: {float(summary.frac_over_limit):.3f}")
    sweep_res = hpfx.hpf_sweep(net, dev, settings=s, scenarios=scen)
    ssens = hpfx.sweep_sensitivity(net, dev, s, sweep_res, scen)
    g = np.asarray(ssens.grad.injection_scale)[np.asarray(sweep_res.converged)]
    print(f"    per-scenario d(maxTHD)/d(penetration): "
          f"min={g.min():+.3f} median={np.median(g):+.3f} max={g.max():+.3f}")

    # -- 4. sensitivity of worst-bus THD to penetration -------------------
    sens = hpfx.injection_sensitivity(net, dev, s, res)
    print(f"[4] d(maxTHD)/d(penetration) at nominal: "
          f"{float(sens.grad):+.4f} (THD={float(sens.value):.4f})")

    # -- 5. Kron-reduce the passive bus -----------------------------------
    red = hpfx.kron_reduce(net, s)
    res_r = hpfx.hpf(red.net, dev, s, Y=red.Y)
    V_m, _ = hpfx.recover_voltages(red, res_r, net.n)
    dthd = np.abs(np.asarray(hpfx.get_thd(V_m).THD_F)
                  - np.asarray(rep.thd.THD_F)).max()
    print(f"[5] Kron-reduced ({net.n}->{red.net.n} buses): THD matches "
          f"full solve to {dthd:.1e}")

    # -- 6. device-mix Monte-Carlo on net4 --------------------------------
    s4 = hpfx.settings_for_hmax(9, coupled=True, solver="arrow")
    net4 = hpfx.load_network(os.path.join(DATA, "net4_buses.csv"),
                             os.path.join(DATA, "net4_lines.csv"), s4)
    lib = hpfx.load_device_library(("SMPS", "ev_1", "ev_4"), s4)
    Bm, n_nl = 64, net4.n_nonlinear
    w = np.zeros((Bm, n_nl, lib.n_types))
    t = rng.integers(0, lib.n_types, (Bm, n_nl))
    cnt = rng.integers(0, 3, (Bm, n_nl))
    w[np.arange(Bm)[:, None], np.arange(n_nl)[None, :], t] = cnt
    scen_m = hpfx.Scenarios(
        p_scale=jnp.ones(Bm, s4.real_dtype), q_scale=jnp.ones(Bm, s4.real_dtype),
        device_mix=jnp.asarray(w, s4.real_dtype))
    summ = hpfx.hosting_capacity_sweep(net4, lib, settings=s4,
                                       scenarios=scen_m, thd_limit=0.08)
    print(f"[6] device-mix sweep B={Bm} ({lib.n_types} types x {n_nl} buses,"
          f" 0-2 units each): conv="
          f"{float(jnp.mean(summ.converged.astype(jnp.float32))):.3f}, "
          f"frac THD>8%: {float(summ.frac_over_limit):.3f}")
    # marginal THD impact of one more device of each type at each bus
    w0 = jnp.asarray(np.ones((n_nl, lib.n_types)), s4.real_dtype)
    scen1 = hpfx.Scenarios(p_scale=jnp.ones(1, s4.real_dtype),
                           q_scale=jnp.ones(1, s4.real_dtype),
                           device_mix=w0[None])
    r1 = hpfx.hpf_sweep(net4, lib, settings=s4, scenarios=scen1)
    one = hpfx.HPFResult(V_m=r1.V_m[0], V_a=r1.V_a[0], err=r1.err[0],
                         n_iter=r1.n_iter[0], err_hist=r1.err_hist[0],
                         converged=r1.converged[0])
    msens = hpfx.mix_sensitivity(net4, lib, s4, one, w0)
    worst = np.unravel_index(np.argmax(np.asarray(msens.grad)),
                             msens.grad.shape)
    print(f"    d(maxTHD)/d(one more {lib.names[worst[1]]} at bus "
          f"{net4.m + worst[0] + 1}) = {float(msens.grad[worst]):+.4f} "
          f"(the worst marginal addition)")

    # -- 7. warm-start continuation sweep ---------------------------------
    Bc = 64
    scen_c = hpfx.Scenarios(
        p_scale=jnp.ones(Bc, s.real_dtype), q_scale=jnp.ones(Bc, s.real_dtype),
        injection_scale=jnp.asarray(np.linspace(0.3, 1.5, Bc), s.real_dtype))
    plain = hpfx.hpf_sweep(net, dev, settings=s, scenarios=scen_c)
    cont = hpfx.hpf_sweep_continuation(net, dev, s, scen_c, n_stages=4)
    print(f"[7] continuation sweep B={Bc}: mean NR trips "
          f"{float(np.mean(np.asarray(plain.n_iter))):.1f} -> "
          f"{float(np.mean(np.asarray(cont.n_iter))):.1f} at conv "
          f"{float(np.mean(np.asarray(cont.converged).astype(float))):.3f}")

    # -- 8. transformer feeder end-to-end ---------------------------------
    from hpfx.network import NONLINEAR, PQ, SLACK
    st = hpfx.settings_for_hmax(9, coupled=True)
    net_t = hpfx.network_from_arrays(
        bus_types=(SLACK, PQ, NONLINEAR),
        components=("generator", "lin_load", "SMPS"),
        P=[0, 100, 250], Q=[0, 50, 100], X_sh=[0.005, 0, 0],
        line_from=[0, 1], line_to=[1, 2],
        R=[0.5, 1.0], X=[2.0, 4.0],
        tau=[1.05, 1.0], phase_shift=[30.0, 0.0],
        settings=st, per_unit=False)
    dev_t = hpfx.load_device_set(net_t, st)
    res_t = hpfx.hpf(net_t, dev_t, st)
    print(f"[8] trafo feeder (tau=1.05, 30deg): converged="
          f"{bool(res_t.converged)} in {int(res_t.n_iter)} iters, "
          f"|V1|={float(res_t.V_m[0, 1]):.4f} "
          f"ang={np.degrees(float(res_t.V_a[0, 1])):.1f}deg")

    # -- 9. line-parameter sensitivities on the trafo feeder --------------
    lsens = hpfx.line_sensitivity(
        net_t, dev_t, st, res_t,
        line_params=hpfx.LineParams(z_scale=jnp.ones(net_t.n_lines)))
    print(f"[9] d(maxTHD)/d(trafo tap)={float(lsens.grad.tau[0]):+.4f}, "
          f"d/d(line-1 |Z| scale)={float(lsens.grad.z_scale[1]):+.4f} "
          f"(THD={float(lsens.value):.4f})")

    # -- 10. impedance scan: which orders does the grid amplify? ----------
    zmag = hpfx.driving_point_impedance(net, s)
    is_peak, worst_h, worst_z = hpfx.resonance_peaks(zmag, s)
    wb = int(np.argmax(np.asarray(worst_z)))
    print(f"[10] impedance scan net2: bus {wb} peaks at h="
          f"{int(worst_h[wb])} (|Z|={float(worst_z[wb]):.3f} pu; "
          f"{int(np.asarray(is_peak).sum())} local peaks across "
          f"{zmag.shape[1]} buses x {zmag.shape[0]} harmonics)")

    # -- 11. emission allocation + dense scan + tuned filter in service ---
    contrib = hpfx.distortion_contributions(net, dev, s)
    cmag = np.abs(np.asarray(contrib.re) + 1j * np.asarray(contrib.im))
    shares = cmag[1:, wb].sum(axis=0)             # per-device share at wb
    top_dev = int(np.argmax(shares))
    grid = np.round(np.arange(2.0, float(s.harmonics[-1]) + 0.25, 0.25), 4)
    zdense = np.asarray(hpfx.frequency_scan(net, s, grid, devices=dev))
    h_res = float(grid[int(np.argmax(zdense[:, wb]))])
    Yf = hpfx.install_shunt(
        hpfx.build_ybus(net, s), wb,
        hpfx.tuned_filter_admittance(s, h_res, x_cap=0.05))
    res_f = hpfx.hpf(net, dev, s, Y=Yf)
    thd_base = float(np.asarray(hpfx.get_thd(res.V_m).THD_F).max())
    thd_filt = float(np.asarray(hpfx.get_thd(res_f.V_m).THD_F).max())
    print(f"[11] emission allocation at bus {wb}: device {top_dev} "
          f"contributes {100 * shares[top_dev] / shares.sum():.0f}%; "
          f"operational resonance at h={h_res:.2f} (dense scan); "
          f"single-tuned filter there: maxTHD {thd_base:.4f} -> "
          f"{thd_filt:.4f} (converged={bool(res_f.converged)})")

    # -- 12. gradient-based tap optimization on the trafo feeder ----------
    opt = hpfx.optimize_line_params(
        net_t, dev_t, st, vary=("tau",), fixed_lines=[1],
        steps=20, learning_rate=0.01)
    print(f"[12] tap optimization (adam on IFT gradients, 20 steps): "
          f"maxTHD {opt.value0:.4f} -> {opt.value:.4f} at tau="
          f"{float(opt.params.tau[0]):.3f} ({opt.n_solves} HPF solves)")

    # -- 13. gradient-tuned filter: stage 11's hand-sized design, optimized
    fopt = hpfx.optimize_filter(net, dev, s, bus=wb, h_tune0=h_res,
                                x_cap0=0.05, steps=15, learning_rate=0.05)
    print(f"[13] filter optimization at bus {wb} (IFT gradients over "
          f"h_tune/x_cap, 15 steps): maxTHD {fopt.value0:.4f} -> "
          f"{fopt.value:.4f} at h_tune="
          f"{float(np.asarray(fopt.params.h_tune)):.2f}, x_cap="
          f"{float(np.asarray(fopt.params.x_cap)):.3f} "
          f"({fopt.n_solves} HPF solves)")

    # -- 14. line flows + IEEE-519: what the filter trade actually costs
    fl0 = hpfx.line_flows(net, s, res.V_m, res.V_a)
    res_opt = hpfx.hpf(net, dev, s, Y=fopt.Y)
    fl1 = hpfx.line_flows(net, s, res_opt.V_m, res_opt.V_a)
    rep519 = hpfx.check_ieee519(res_opt, s)
    h0 = float(np.asarray(fl0.loss)[1:].sum())
    h1 = float(np.asarray(fl1.loss)[1:].sum())
    print(f"[14] flows: harmonic line losses {h0:.4f} -> {h1:.4f} pu "
          f"(the filter absorbs harmonics THROUGH the feeder); "
          f"IEEE-519 (<=1 kV): "
          f"{int(np.asarray(rep519.compliant).sum())}/{net.n} buses "
          f"compliant, worst individual "
          f"{float(np.max(rep519.worst_ratio)):.1f}% "
          f"(limit {rep519.limit_individual}%)")

    # -- 15. inverse problem: localize the sources from meter readings --
    true_sc = np.array([0.85])                   # net2 has one device
    res_m = hpfx.hpf(net, dev.scale(jnp.asarray(true_sc, s.real_dtype)), s)
    est = hpfx.estimate_injections(net, dev, s, res_m.V_m,
                                   buses=[1], scales0=1.0)
    print(f"[15] source estimation from bus-1 meter only: true scale "
          f"{true_sc[0]:.2f}, fitted "
          f"{float(np.asarray(est.scales)[0]):.4f} "
          f"(misfit {est.misfit0:.1e} -> {est.misfit:.1e}, "
          f"{est.n_solves} solves)")

    # -- 16. hosting capacity: how much can the devices grow? ----------
    # net2's worst Monte-Carlo draw sits at THD_F ~0.66 already at nominal
    # (the shipped feeder is heavily distorted), so the demo asks how far
    # penetration can grow before the worst draw crosses 0.8.
    scen = hpfx.monte_carlo_scenarios(0, 16, net, s)
    cap = hpfx.find_hosting_capacity(net, dev, s, scen, confidence=1.0,
                                     thd_limit=0.8, hi=8.0, tol=0.125)
    if cap.feasible:
        print(f"[16] hosting capacity (B=16 Monte-Carlo draws, worst-bus "
              f"THD_F <= 0.8 at confidence 1.0): "
              f"{'>=' if cap.bracket_open else ''}{cap.level:.2f}x nominal "
              f"({len(cap.levels)} bisection probes, compliant fraction "
              f"{cap.frac_at_level:.2f})")
    else:
        print(f"[16] hosting capacity: base system already non-compliant "
              f"(compliant fraction {cap.frac_at_level:.2f} at nominal)")

    # -- 17. background grid distortion (upstream spectrum) -------------
    I_bg = hpfx.background_from_harmonics(net, s, {5: (0.02, 0.0),
                                                   7: (0.01, 0.5)})
    res_bg = hpfx.hpf(net, dev, s, I_bg=I_bg)
    thd_bg = np.asarray(hpfx.get_thd(res_bg.V_m).THD_F)
    print(f"[17] background distortion (2% 5th + 1% 7th behind the grid "
          f"X_sh): THD_F per bus {np.round(np.asarray(rep.thd.THD_F), 4)}"
          f" -> {np.round(thd_bg, 4)} (converged={bool(res_bg.converged)})")
    # -- 18. percentile assessment + quasi-static time series ------------
    scen_q = hpfx.monte_carlo_scenarios(1, 64, net, s, inj_spread=0.3)
    qa = hpfx.assess_quantiles(net, dev, s, scen_q,
                               quantiles=(0.5, 0.95, 0.99))
    pl = hpfx.check_planning_levels(qa, {5: 5.0, 7: 4.0, 11: 3.0},
                                    default_pct=3.0)
    print(f"[18] percentile assessment (B=64 draws): worst bus "
          f"{qa.worst_bus} THD p50/p95/p99 = "
          f"{float(qa.thd_q[0, qa.worst_bus]):.3f}/"
          f"{float(qa.thd_q[1, qa.worst_bus]):.3f}/"
          f"{float(qa.thd_q[2, qa.worst_bus]):.3f}; planning levels "
          f"(IEC 61000-3-6 shape): compliant={pl.compliant}, binding "
          f"h={pl.binding_order} at bus {pl.binding_bus}")
    ts = hpfx.run_timeseries(net, dev, s, hpfx.daily_profile(48), chunk=24)
    pc = hpfx.percentile_compliance(ts, s)
    print(f"     daily profile (48 steps): p95 worst-bus THD "
          f"{float(np.max(np.asarray(pc.thd_p))):.2f}% vs limit "
          f"{pc.limit_thd}% -> compliant={pc.compliant}")

    # -- 19. N-1 contingency screens on the meshed net1 feeder -----------
    s1 = hpfx.settings_for_hmax(5, coupled=False)
    net1 = hpfx.load_network(os.path.join(DATA, "net1_buses.csv"),
                             os.path.join(DATA, "net1_lines.csv"), s1)
    dev1 = hpfx.load_device_set(net1, s1)
    repc = hpfx.screen_line_outages(net1, dev1, s1, outages=[0, 20, 21, 22])
    top = repc.ranking[0]
    print(f"[19] N-1 line screen (net1, 4 outages, one vmapped program): "
          f"worst is line {repc.outages[top]} — worst-bus THD "
          f"{float(repc.base_thd.max()):.3f} -> "
          f"{float(repc.worst_thd[top]):.3f}")
    shift = hpfx.outage_impedance_shift(net1, dev1, s1, outages=[0, 22])
    st0 = shift.ranking[0]
    print(f"     resonance shift: losing line {shift.outages[st0]} "
          f"amplifies |Z(h={int(shift.shift_order[st0])})| at bus "
          f"{int(shift.shift_bus[st0])} by "
          f"{float(shift.amplification[st0]):.1f}x")

    # -- 20. load damping + sequence-aware triplen solve ------------------
    # (net1, uncoupled: harmonic orders solve independently, so the
    # sequence-network effect is visible as a pure triplen shift)
    base20 = hpfx.hpf(net1, dev1, s1)
    s25 = hpfx.settings_for_hmax(25, coupled=False)  # scan depth where
    yd25 = hpfx.linear_load_admittance(net1, s25)    # net1's X_sh resonates
    z_open = np.asarray(hpfx.driving_point_impedance(net1, s25))
    z_damp = np.asarray(hpfx.driving_point_impedance(
        net1, s25, Y=hpfx.fold_ydiag(hpfx.build_ybus(net1, s25), yd25)))
    k = int(np.argmax(z_open[1:]))  # worst harmonic driving-point |Z|
    print(f"[20] parallel-RL load damping (net1 H<=25, "
          f"{int(np.sum(np.asarray(net1.bus_P[:net1.m]) > 0))} damped "
          f"buses): worst harmonic |Z_kk| {float(z_open[1:].flat[k]):.2f} "
          f"-> {float(z_damp[1:].flat[k]):.2f} pu (open-circuit loads "
          f"overstate the peak)")
    seq = hpfx.hpf_sequence(net1, dev1, s1, r0_scale=2.5, x0_scale=3.0,
                            bus_Xg={1: 0.1})
    tri = hpfx.triplen_mask(s1.harmonics)
    dv = np.abs(np.asarray(seq.V_m) - np.asarray(base20.V_m))
    print(f"     sequence-aware solve (triplens on the zero-sequence "
          f"network): max |dV| triplen {float(dv[tri].max()):.2e} vs "
          f"non-triplen {float(dv[~tri].max()):.2e} (uncoupled: exact 0)")

    # -- 21. resonance mode analysis: mechanism behind the |Z| peaks ------
    grid = tuple(np.round(np.arange(2.0, 25.01, 0.25), 3))
    mscan = hpfx.modal_scan(net, s, h_grid=grid, devices=dev)
    m_peak, h_res, bus_res = hpfx.modal_peaks(mscan)
    ki = int(np.argmax(np.asarray(mscan.z_modal)))
    lam, sens = hpfx.eigen_sensitivity(net, s, float(h_res), devices=dev)
    dzx = np.asarray(sens["line_X"]["dz_modal"])
    kl = int(np.argmax(np.abs(dzx)))
    print(f"[21] resonance modes net2 (operational, 0.25-step grid): "
          f"dominant mode at order {float(h_res):g}, z_modal="
          f"{float(mscan.z_modal[ki]):.4f} pu, critical bus "
          f"{int(bus_res)} (participation "
          f"{float(mscan.participation[ki, int(bus_res)]):.3f}); "
          f"strongest retuning knob: line-{kl} X "
          f"(dz_modal/dX={dzx[kl]:+.2f})")

    # -- 22. unbalanced three-phase penetration ---------------------------
    # phase a carries 30% more converter load; device 0 is 3-wire (delta)
    s22 = hpfx.settings_for_hmax(13, coupled=False)
    dev22 = hpfx.load_device_set(net, s22)
    mag = np.ones((dev22.n_devices, 3))
    mag[:, 0] = 1.3
    res22 = hpfx.solve_unbalanced(net, dev22, s22, r0_scale=2.5,
                                  x0_scale=3.0, bus_Xg={1: 0.1},
                                  mag=mag, delta=[0])
    u0, u2 = hpfx.unbalance_factors(res22)
    tri22 = hpfx.triplen_mask(s22.harmonics)
    print(f"[22] unbalanced 3-phase penetration (net2, phase a +30%, "
          f"delta device): worst foreign-sequence leakage fractions "
          f"{float(np.asarray(u0)[1:].max()):.3f} / "
          f"{float(np.asarray(u2)[1:].max()):.3f} of total "
          f"(balanced theory calls both 0)")

    # -- 23. metering-point view: IEEE 1459 + waveshape --------------------
    pi = hpfx.line_power_indices(net, s, res.V_m, res.V_a, side="from")
    k = int(np.argmax(np.asarray(pi.thd_i)))
    wm = hpfx.waveform_metrics(res.V_m, res.V_a, s.harmonics)
    print(f"[23] IEEE 1459 at line {k} (net2's worst-TDD terminal): "
          f"S={float(pi.S[k]):.3f} = "
          f"sqrt(S1²+D_I²+D_V²+S_H²), true pf {float(pi.pf[k]):+.3f} vs "
          f"displacement {float(pi.dpf[k]):+.3f}; worst bus crest factor "
          f"{float(np.max(np.asarray(wm.crest))):.3f} (clean sine: 1.414)")

    # -- 24. long lines: electrical length grows with harmonic order ------
    import dataclasses as _dc
    net24 = _dc.replace(net, line_B=jnp.full_like(net.line_B, 4.1e-2))
    th24 = np.asarray(hpfx.electrical_length(net24, s))
    res24n = hpfx.hpf(net24, dev, s)
    res24l = hpfx.hpf(net24, dev, s, Y=hpfx.longline_structures(net24, s))
    print(f"[24] long-line correction (charged net2, |θ| up to "
          f"{th24[-1].max():.2f} rad at h=25): nominal-pi worst THD "
          f"{float(np.max(np.asarray(hpfx.get_thd(res24n.V_m).THD_F))):.4f}"
          f" vs exact-pi "
          f"{float(np.max(np.asarray(hpfx.get_thd(res24l.V_m).THD_F))):.4f}"
          f" — the short-line premise fails exactly where the study "
          f"looks")

    # -- 25. analytic converter devices (no NE data needed) ---------------
    s25 = hpfx.settings_for_hmax(25, coupled=False)
    dev6 = hpfx.converter_device_set(
        net, s25, [{"kind": "six_pulse", "I1": 0.3,
                    "alpha": np.deg2rad(20.0), "mu": np.deg2rad(10.0)}])
    v06 = hpfx.converter_warm_start(net, s25, dev6)
    r6 = hpfx.hpf(net, dev6, s25, V0=v06)
    dev12 = hpfx.converter_device_set(
        net, s25, [{"kind": "twelve_pulse", "I1": 0.3,
                    "alpha": np.deg2rad(20.0), "mu": np.deg2rad(10.0)}])
    r12 = hpfx.hpf(net, dev12, s25,
                   V0=hpfx.converter_warm_start(net, s25, dev12))
    t6 = float(np.max(np.asarray(hpfx.get_thd(r6.V_m).THD_F)))
    t12 = float(np.max(np.asarray(hpfx.get_thd(r12.V_m).THD_F)))
    print(f"[25] textbook converters on net2's NL bus (closed-form "
          f"spectra, exact linear warm start, {int(r6.n_iter)} NR "
          f"iters): 6-pulse worst THD {t6:.4f} -> 12-pulse {t12:.4f} "
          f"(the Y/Δ pair cancels 5,7,17,19)")

    # -- 26. active filter sizing ------------------------------------------
    af = hpfx.size_active_filter(net, dev, s, bus=3)
    print(f"[26] active filter at bus 3: THD {af.thd_before:.4f} -> "
          f"{af.thd_after:.4f} with a {af.rating_rms:.1f} pu rms "
          f"compensator ({af.n_solves} HPF solves; complex-target LM on "
          f"the IFT Jacobian — per-order impedance correction diverges "
          f"on coupled NEs)")


    # -- 27. exact-linear Norton warm start ---------------------------------
    from hpfx.solve import Scenarios as Sc27, hpf_sweep_adaptive as hsa27
    sc27 = Sc27(p_scale=jnp.linspace(0.9, 1.1, 8),
                q_scale=jnp.linspace(0.9, 1.1, 8),
                injection_scale=jnp.linspace(0.7, 1.3, 8))
    s27 = hpfx.settings_for_hmax(25, coupled=True).with_(solver="arrow")
    rc27 = hsa27(net, dev, s27, sc27)
    rw27 = hsa27(net, dev, s27, sc27, warm="linear")
    print(f"[27] exact-linear Norton warm start (one (H-1)n block solve "
          f"per scenario): NR trips mean {float(np.mean(np.asarray(rc27.n_iter))):.1f} "
          f"-> {float(np.mean(np.asarray(rw27.n_iter))):.1f} at the same "
          f"fixed points")

    # -- 28. batched background-distortion study --------------------------
    B28, H28 = 8, s27.n_harmonics
    rng28 = np.random.default_rng(5)
    full28 = np.zeros((B28, H28, net.n), complex)
    xsh28 = float(np.asarray(net.bus_Xsh)[0])
    full28[:, 2, 0] = (rng28.uniform(0.01, 0.03, B28)
                       * np.exp(1j * rng28.uniform(0, 2 * np.pi, B28))
                       / (1j * xsh28 * 5))
    ibg28 = hpfx.cx.Cx(jnp.asarray(full28.real), jnp.asarray(full28.imag))
    r28 = hpfx.background_sweep(net, dev, s27, ibg28)
    thd28 = np.asarray(hpfx.get_thd(np.moveaxis(np.asarray(r28.V_m), 0, -1)).THD_F)
    print(f"[28] background study (8 random upstream 5th-harmonic draws, "
          f"full rescue): conv {float(np.mean(np.asarray(r28.converged))):.3f}, "
          f"worst-bus THD spread {thd28.max(axis=0).min():.4f}.."
          f"{thd28.max(axis=0).max():.4f}")

    # -- 29. (outage x scenario) contingency cross ------------------------
    s29 = hpfx.settings_for_hmax(5, coupled=True)
    dev29 = hpfx.load_device_set(net, s29)   # device tables slice per H
    r29 = hpfx.screen_line_outages_sweep(
        net, dev29, s29,
        Sc27(p_scale=jnp.linspace(0.9, 1.1, 6),
             q_scale=jnp.linspace(0.9, 1.1, 6),
             injection_scale=jnp.linspace(0.8, 1.2, 6)))
    k29 = int(r29.ranking[0])
    print(f"[29] N-1 x scenario cross (net2: 4 outages x 6 draws, one "
          f"program): worst outage line {k29}, p95 dTHD "
          f"{r29.delta_q[k29]:+.4f}, conv {float(r29.conv_frac.min()):.3f}")


if __name__ == "__main__":
    main()
