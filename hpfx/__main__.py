"""Command-line interface: ``python -m hpfx <command>``.

The reference's user workflow is "edit the driver script, run it, read
the printed frame" (hcne_generalized.py:575-620's __main__ block).  This
CLI covers those workflows without editing code:

    python -m hpfx solve  --buses b.csv --lines l.csv --hmax 25 --coupled
    python -m hpfx scan   --buses b.csv --lines l.csv --operational
    python -m hpfx sweep  --buses b.csv --lines l.csv --batch 256
    python -m hpfx report --buses b.csv --lines l.csv --v-kv 10
    python -m hpfx estimate --buses b.csv --lines l.csv \\
                            --measurements solution.json --meter 1
    python -m hpfx filter --buses b.csv --lines l.csv --bus 2
    python -m hpfx place  --buses b.csv --lines l.csv --n-filters 2
    python -m hpfx capacity --buses b.csv --lines l.csv --batch 256 \\
                            --confidence 0.95 --limit 0.08
    python -m hpfx assess --buses b.csv --lines l.csv --batch 256 \\
                          --levels 5:5 --levels 7:4
    python -m hpfx timeseries --buses b.csv --lines l.csv --steps 96
    python -m hpfx contingency --buses b.csv --lines l.csv [--scan]

Every command also accepts ``--matpower case.m --nonlinear 4:SMPS
--slack-xsh 3e-5`` in place of ``--buses/--lines`` (hpfx.matpower);
``solve`` takes ``--skin {exponent,cigre_oh,cigre_cable}`` for
frequency-dependent line resistance, ``report`` takes ``--en50160``
for the per-order European voltage-quality table.

Backend: JAX's default backend (the GPU where one is present);
``JAX_PLATFORMS=cpu`` selects the CPU.  The CLI enables x64, so its
numbers are the f64 reference-parity numbers on either backend.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _settings(args):
    import hpfx
    kw = dict(coupled=args.coupled)
    if getattr(args, "solver", None):
        kw["solver"] = args.solver
    return hpfx.settings_for_hmax(args.hmax, **kw)


def _load(args):
    import hpfx
    s = _settings(args)
    if getattr(args, "matpower", None):
        nl = {}
        for item in args.nonlinear or ():
            bid, comp = item.split(":", 1)
            nl[int(bid)] = comp
        net = hpfx.load_matpower(args.matpower, s, nonlinear=nl or None,
                                 slack_xsh=args.slack_xsh)
    elif args.buses and args.lines:
        net = hpfx.load_network(args.buses, args.lines, s)
    else:
        raise SystemExit("provide --buses/--lines or --matpower")
    if getattr(args, "converter", None):
        dev = _converter_devices(args, net, s)
    else:
        dev = hpfx.load_device_set(net, s, search_dirs=tuple(args.ne_dir))
    return s, net, dev


def _converter_devices(args, net, s):
    """Build a DeviceSet from --converter BUS:KIND:I1[:ALPHA[:MU]] flags
    (angles in degrees) — every nonlinear bus needs one."""
    import numpy as np
    import hpfx
    by_bus = {}
    for item in args.converter:
        parts = item.split(":")
        if len(parts) < 3:
            raise SystemExit(f"--converter wants BUS:KIND:I1[:ALPHA[:MU]],"
                             f" got {item!r}")
        bus, kind, i1 = int(parts[0]), parts[1], float(parts[2])
        alpha = np.deg2rad(float(parts[3])) if len(parts) > 3 else 0.0
        mu = np.deg2rad(float(parts[4])) if len(parts) > 4 else 0.0
        by_bus[bus] = {"kind": kind, "I1": i1, "alpha": alpha, "mu": mu}
    nl_buses = list(range(net.m, net.n))
    missing = [b for b in nl_buses if b not in by_bus]
    extra = [b for b in by_bus if b not in nl_buses]
    if missing or extra:
        raise SystemExit(f"--converter must cover exactly the nonlinear "
                         f"buses {nl_buses} (missing {missing}, "
                         f"extra {extra})")
    return hpfx.converter_device_set(net, s, [by_bus[b] for b in nl_buses])


def _converter_v0(args, net, s, dev, Y=None):
    """Exact linear harmonic seed when the devices came from --converter
    (stiff current sources NaN from the flat start; hpfx.converters)."""
    import hpfx
    if not getattr(args, "converter", None):
        return None
    if getattr(args, "seq_aware", False):
        return None          # the blended-Y seed isn't wired up
    return hpfx.converter_warm_start(net, s, dev, Y=Y)


def _add_common(p):
    p.add_argument("--buses", help="bus CSV (either schema)")
    p.add_argument("--lines", help="line CSV")
    p.add_argument("--matpower", help="MATPOWER case .m file instead of "
                   "--buses/--lines (see hpfx.matpower mapping contract)")
    p.add_argument("--nonlinear", action="append", default=None,
                   metavar="BUSID:COMPONENT",
                   help="with --matpower: mark bus as a harmonic device "
                   "(repeatable, e.g. 4:SMPS)")
    p.add_argument("--slack-xsh", dest="slack_xsh", type=float,
                   default=None, help="with --matpower: grid "
                   "short-circuit reactance [pu] grounding the harmonic "
                   "network at the reference bus")
    p.add_argument("--hmax", type=int, default=25,
                   help="highest harmonic order (default 25)")
    p.add_argument("--coupled", action="store_true", default=True,
                   help="coupled Norton model (default)")
    p.add_argument("--uncoupled", dest="coupled", action="store_false")
    p.add_argument("--ne-dir", action="append",
                   default=None, help="extra NE-table search dir "
                   "(repeatable; the packaged tables are always searched)")
    p.add_argument("--converter", action="append", default=None,
                   metavar="BUS:KIND:I1[:ALPHA[:MU]]",
                   help="analytic converter instead of NE tables "
                   "(repeatable; KIND six_pulse|twelve_pulse, I1 pu, "
                   "ALPHA/MU deg; must cover every nonlinear bus)")


def cmd_solve(args) -> int:
    import numpy as np
    import hpfx

    s, net, dev = _load(args)
    I_bg = None
    if getattr(args, "bg", None):
        import numpy as _np
        spec = {}
        for item in args.bg:
            h, mag, ang = item.split(":")
            spec[int(h)] = (float(mag), float(ang) * _np.pi / 180.0)
        I_bg = hpfx.background_from_harmonics(net, s, spec)
    Y_diag = None
    if getattr(args, "load_model", None):
        Y_diag = hpfx.linear_load_admittance(net, s, model=args.load_model)
    Y = None
    Rh = None
    if getattr(args, "skin", None):
        if getattr(args, "seq_aware", False):
            raise SystemExit("--skin cannot combine with --seq-aware "
                             "(the sequence blend builds its own line "
                             "structures)")
        Rh = hpfx.line_resistance(net, s, model=args.skin,
                                  alpha=args.skin_alpha)
    if getattr(args, "long_line", False):
        if getattr(args, "seq_aware", False):
            raise SystemExit("--long-line cannot combine with --seq-aware "
                             "(the sequence blend builds its own line "
                             "structures)")
        Y = hpfx.longline_structures(net, s, Rh=Rh, Y_diag=Y_diag)
        Y_diag = None
    elif Rh is not None:
        Y = hpfx.skin_structures(net, s, Rh=Rh, Y_diag=Y_diag)
        Y_diag = None
    t0 = time.perf_counter()
    if getattr(args, "seq_aware", False):
        r0s, x0s = (float(v) for v in args.z0_scale.split(":"))
        xg = {}
        for item in args.xg or ():
            b, v = item.split(":")
            xg[int(b)] = float(v)
        res = hpfx.hpf_sequence(
            net, dev, s, r0_scale=r0s, x0_scale=x0s,
            blocked=[int(k) for k in args.blocked_line or ()],
            bus_Xg=xg or None,
            delta_devices=[int(k) for k in args.delta_device or ()],
            record_trajectory=bool(args.vlog), I_bg=I_bg, Y_diag=Y_diag)
    else:
        res = hpfx.hpf(net, dev, s, Y=Y,
                       V0=_converter_v0(args, net, s, dev, Y=Y),
                       record_trajectory=bool(args.vlog),
                       I_bg=I_bg, Y_diag=Y_diag)
    dt = time.perf_counter() - t0
    conv = bool(np.asarray(res.converged))
    thd = hpfx.get_thd(res.V_m)
    print(f"converged={conv} n_iter={int(res.n_iter)} "
          f"err={float(res.err):.3e}  ({dt:.2f}s incl. compile)")
    print(f"{'bus':>4} {'|V1| [pu]':>10} {'ang1 [deg]':>10} "
          f"{'THD_F':>8} {'THD_R':>8}")
    for i in range(net.n):
        print(f"{i:>4} {float(res.V_m[0, i]):>10.5f} "
              f"{float(res.V_a[0, i]) * 180 / np.pi:>10.2f} "
              f"{float(thd.THD_F[i]):>8.4f} {float(thd.THD_R[i]):>8.4f}")
    if args.vlog:
        n = hpfx.write_vlog(args.vlog, res.trajectory, s.harmonics,
                            n_iter=int(res.n_iter))
        print(f"wrote {n} iterations to {args.vlog}")
    if args.json:
        out = {"converged": conv, "n_iter": int(res.n_iter),
               "err": float(res.err),
               "V_m": np.asarray(res.V_m).tolist(),
               "V_a": np.asarray(res.V_a).tolist(),
               "THD_F": np.asarray(thd.THD_F).tolist(),
               "THD_R": np.asarray(thd.THD_R).tolist()}
        with open(args.json, "w") as f:
            json.dump(out, f)
        print(f"wrote solution to {args.json}")
    return 0 if conv else 2


def cmd_scan(args) -> int:
    import numpy as np
    import hpfx

    s, net, dev = _load(args)
    zmag = hpfx.driving_point_impedance(
        net, s, devices=dev if args.operational else None)
    is_peak, worst_h, worst_z = hpfx.resonance_peaks(zmag, s)
    kind = "operational" if args.operational else "passive"
    print(f"{kind} driving-point impedance scan, h in {list(s.harmonics)}")
    print(f"{'bus':>4} {'worst h':>8} {'|Z| [pu]':>10} {'peaks':>6}")
    for i in range(net.n):
        n_peaks = int(np.asarray(is_peak)[:, i].sum())
        print(f"{i:>4} {int(worst_h[i]):>8} {float(worst_z[i]):>10.4f} "
              f"{n_peaks:>6}")
    return 0


def cmd_modes(args) -> int:
    import numpy as np
    import hpfx

    s, net, dev = _load(args)
    devices = dev if args.operational else None
    if args.step and args.step > 0:
        lo, hi = 2.0, float(max(s.harmonics))
        grid = tuple(np.round(np.arange(lo, hi + 1e-9, args.step), 6))
    else:
        grid = None
    scan = hpfx.modal_scan(net, s, h_grid=grid, devices=devices)
    is_peak, h_res, bus_res = hpfx.modal_peaks(scan)
    kind = "operational" if args.operational else "passive"
    print(f"{kind} resonance mode scan "
          f"({len(np.asarray(scan.order))} orders)")
    print(f"{'order':>7} {'z_modal':>10} {'crit bus':>9}  participation")
    order = np.asarray(scan.order)
    pf = np.asarray(scan.participation)
    for k in np.nonzero(np.asarray(is_peak))[0]:
        top = np.argsort(pf[k])[::-1][:3]
        parts = "  ".join(f"bus {b}: {pf[k, b]:.3f}" for b in top
                          if pf[k, b] > 1e-6)
        print(f"{order[k]:>7.2f} {float(scan.z_modal[k]):>10.4f} "
              f"{int(scan.critical_bus[k]):>9}  {parts}")
    print(f"dominant resonance: order {float(h_res):g} at bus "
          f"{int(bus_res)}")
    if args.sensitivity:
        lam, sens = hpfx.eigen_sensitivity(net, s, float(h_res),
                                           devices=devices)
        dz = np.asarray(sens["line_X"]["dz_modal"])
        k = int(np.argmax(np.abs(dz)))
        print(f"strongest line-X knob: line {k} "
              f"(dz_modal/dX = {dz[k]:+.3f})")
        dzs = np.asarray(sens["bus_Xsh"]["dz_modal"])
        if np.abs(dzs).max() > 0:
            k = int(np.argmax(np.abs(dzs)))
            print(f"strongest shunt knob: bus {k} "
                  f"(dz_modal/dX_sh = {dzs[k]:+.3f})")
    return 0


def cmd_sweep(args) -> int:
    import numpy as np
    import jax.numpy as jnp
    import hpfx
    from hpfx.solve import Scenarios, hpf_sweep_adaptive

    s, net, dev = _load(args)
    rng = np.random.default_rng(args.seed)
    rd = s.real_dtype
    scen = Scenarios(
        p_scale=jnp.asarray(rng.uniform(*args.p_range, args.batch), rd),
        q_scale=jnp.asarray(rng.uniform(*args.p_range, args.batch), rd),
        injection_scale=jnp.asarray(
            rng.uniform(*args.inj_range, args.batch), rd))
    t0 = time.perf_counter()
    if args.bg_spread:
        # random upstream Thevenin draws (magnitude up to CAP per order,
        # uniform angle) behind the slack X_sh, solved as one batched
        # background study with the full deterministic rescue
        from . import cx as _cx
        B, H, n = args.batch, s.n_harmonics, net.n
        orders = np.asarray(s.harmonics, float)
        x_sh = float(np.asarray(net.bus_Xsh)[0])
        if x_sh == 0.0:
            print("--bg-spread needs a slack X_sh (grid impedance)",
                  file=sys.stderr)
            return 2
        caps = np.zeros(H)
        for item in args.bg_spread:
            h, cap = item.split(":")
            if int(h) not in [int(o) for o in orders]:
                print(f"--bg-spread order {h} not in harmonics",
                      file=sys.stderr)
                return 2
            caps[[int(o) for o in orders].index(int(h))] = float(cap)
        mag = rng.uniform(0.0, 1.0, (B, H)) * caps
        ang = rng.uniform(0.0, 2 * np.pi, (B, H))
        v = mag * np.exp(1j * ang)
        i = v / (1j * x_sh * orders)
        i[:, 0] = 0.0
        full = np.zeros((B, H, n), complex)
        full[:, :, 0] = i
        I_bg = _cx.Cx(jnp.asarray(full.real, rd),
                      jnp.asarray(full.imag, rd))
        res = hpfx.background_sweep(net, dev, s, I_bg, scenarios=scen,
                                    warm=args.warm)
    else:
        res = hpf_sweep_adaptive(net, dev, s, scen, warm=args.warm)
    conv = np.asarray(res.converged)
    dt = time.perf_counter() - t0
    thd = np.asarray(
        jnp.max(hpfx.get_thd(
            jnp.moveaxis(res.V_m, 0, -1)).THD_F, axis=0))
    ok = thd[conv]
    print(f"B={args.batch} conv={conv.mean():.4f} "
          f"({int(conv.sum())}/{args.batch})  {dt:.2f}s incl. compile")
    if ok.size:
        q = np.quantile(ok, [0.05, 0.5, 0.95])
        print(f"worst-bus THD_F over converged scenarios: "
              f"p5={q[0]:.4f} median={q[1]:.4f} p95={q[2]:.4f} "
              f"max={ok.max():.4f}")
    return 0 if conv.all() else 2


def cmd_report(args) -> int:
    import numpy as np
    import hpfx

    s, net, dev = _load(args)
    res = hpfx.hpf(net, dev, s, V0=_converter_v0(args, net, s, dev))
    if not bool(np.asarray(res.converged)):
        print("HPF did not converge — no report")
        return 2
    fl = hpfx.line_flows(net, s, res.V_m, res.V_a)
    loss = np.asarray(fl.loss)
    I = fl.I_f.abs()
    K = np.asarray(hpfx.k_factor(I, s.harmonics))
    _, rms_n = hpfx.neutral_current(I, s.harmonics)
    rms_p = np.sqrt(np.asarray((I * I).sum(0)))
    print(f"line flows ({net.n_lines} lines x {s.n_harmonics} harmonics), "
          f"total loss {float(fl.total_loss):.5f} pu")
    print(f"{'line':>4} {'from':>4} {'to':>4} {'P_fund':>9} {'loss_fund':>10} "
          f"{'loss_harm':>10} {'K-factor':>9} {'I TDD %':>8} {'I_N/I_ph':>9}")
    for k in range(net.n_lines):
        repc = hpfx.check_ieee519_current(I[:, k], s.harmonics,
                                          args.isc_il)
        ratio = float(rms_n[k]) / max(float(rms_p[k]), 1e-30)
        print(f"{k:>4} {int(net.line_from[k]):>4} {int(net.line_to[k]):>4} "
              f"{float(fl.P_f[0, k]):>9.5f} {loss[0, k]:>10.6f} "
              f"{loss[1:, k].sum():>10.6f} {K[k]:>9.2f} "
              f"{float(repc.tdd):>8.2f} {ratio:>9.3f}")
    if getattr(args, "waveshape", False):
        wm = hpfx.waveform_metrics(res.V_m, res.V_a, s.harmonics)
        print("waveshape (RMS-phasor convention; sine crest = 1.414):")
        print(f"{'bus':>4} {'true rms':>9} {'peak':>8} {'crest':>7} "
              f"{'form':>7}")
        for i in range(net.n):
            print(f"{i:>4} {float(wm.rms[i]):>9.5f} "
                  f"{float(wm.peak[i]):>8.4f} {float(wm.crest[i]):>7.4f} "
                  f"{float(wm.form[i]):>7.4f}")
    if getattr(args, "p1459", False):
        pi = hpfx.line_power_indices(net, s, res.V_m, res.V_a, side="from")
        print("IEEE 1459 power decomposition (from-terminal, pu):")
        print(f"{'line':>4} {'P':>9} {'Q1':>9} {'S':>9} {'S1':>9} "
              f"{'D_I':>9} {'D_V':>9} {'S_H':>9} {'N':>9} "
              f"{'pf':>7} {'dpf':>7}")
        for k in range(net.n_lines):
            print(f"{k:>4} {float(pi.P[k]):>9.5f} {float(pi.Q1[k]):>9.5f} "
                  f"{float(pi.S[k]):>9.5f} {float(pi.S1[k]):>9.5f} "
                  f"{float(pi.D_I[k]):>9.5f} {float(pi.D_V[k]):>9.5f} "
                  f"{float(pi.S_H[k]):>9.5f} {float(pi.N[k]):>9.5f} "
                  f"{float(pi.pf[k]):>7.4f} {float(pi.dpf[k]):>7.4f}")
    rep = hpfx.check_ieee519(res, s, v_kv=args.v_kv)
    print(f"IEEE-519 (individual<={rep.limit_individual}%, "
          f"THD<={rep.limit_thd}%):")
    print(f"{'bus':>4} {'THD %':>8} {'worst h':>8} {'V_h/V_1 %':>10} "
          f"{'compliant':>10}")
    for i in range(net.n):
        print(f"{i:>4} {float(rep.thd[i]):>8.3f} "
              f"{int(rep.worst_order[i]):>8} "
              f"{float(rep.worst_ratio[i]):>10.3f} "
              f"{str(bool(rep.compliant[i])):>10}")
    ok = bool(np.asarray(rep.compliant).all())
    if getattr(args, "en50160", False):
        ren = hpfx.check_en50160(res, s)
        print("EN 50160 (per-order table, THD<=8%):")
        print(f"{'bus':>4} {'THD %':>8} {'binding h':>10} "
              f"{'margin %':>9} {'compliant':>10}")
        margin = np.array(ren.margin)          # writable copy
        tab = np.isfinite(np.asarray(ren.limits))
        margin[~tab] = np.inf
        for i in range(net.n):
            print(f"{i:>4} {float(ren.thd[i]):>8.3f} "
                  f"{int(ren.worst_order[i]):>10} "
                  f"{float(margin[:, i].min()):>9.3f} "
                  f"{str(bool(ren.compliant[i])):>10}")
        ok = ok and bool(np.asarray(ren.compliant).all())
    return 0 if ok else 3


def cmd_estimate(args) -> int:
    import json as _json

    import numpy as np
    import jax.numpy as jnp
    import hpfx

    s, net, dev = _load(args)
    d = _json.load(open(args.measurements))
    V_meas = jnp.asarray(np.asarray(d["V_m"], float), s.real_dtype)
    if V_meas.shape != (s.n_harmonics, net.n):
        raise SystemExit(
            f"measurements V_m shape {tuple(V_meas.shape)} does not match "
            f"(H, n) = ({s.n_harmonics}, {net.n}) — same --hmax as the "
            f"solve that wrote the file?")
    out = hpfx.estimate_injections(net, dev, s, V_meas,
                                   buses=args.meter, scales0=args.scales0)
    where = "all buses" if args.meter is None else f"buses {args.meter}"
    print(f"fitted {net.n_nonlinear} device scale(s) from {where}: "
          + " ".join(f"{float(x):.4f}" for x in np.asarray(out.scales)))
    print(f"misfit {out.misfit0:.3e} -> {out.misfit:.3e} "
          f"({out.n_solves} HPF solves)")
    return 0


def cmd_filter(args) -> int:
    import numpy as np
    import hpfx

    s, net, dev = _load(args)
    bus = args.bus[0] if len(args.bus) == 1 else list(args.bus)
    out = hpfx.optimize_filter(net, dev, s, bus=bus,
                               x_cap0=args.x_cap0, steps=args.steps,
                               learning_rate=args.lr)
    h_t = np.atleast_1d(np.asarray(out.params.h_tune))
    x_c = np.atleast_1d(np.asarray(out.params.x_cap))
    branches = ", ".join(f"bus {b}: h_tune={h:.2f} x_cap={x:.4f}"
                         for b, h, x in zip(np.atleast_1d(bus), h_t, x_c))
    print(f"filter bank ({len(h_t)} branch(es)): maxTHD "
          f"{out.value0:.4f} -> {out.value:.4f} [{branches}] "
          f"({out.n_solves} HPF solves)")
    return 0


def cmd_afilter(args) -> int:
    import numpy as np
    import hpfx

    s, net, dev = _load(args)
    buses = args.bus[0] if len(args.bus) == 1 else list(args.bus)
    out = hpfx.size_active_filter(
        net, dev, s, bus=buses,
        orders=[int(o) for o in args.orders] if args.orders else None,
        residual=args.residual,
        V0=_converter_v0(args, net, s, dev))
    t0, t1 = np.atleast_1d(out.thd_before), np.atleast_1d(out.thd_after)
    rat = np.atleast_1d(out.rating_rms)
    ic = np.atleast_2d(np.asarray(out.I_c.re) + 1j * np.asarray(out.I_c.im))
    for j, b in enumerate(np.atleast_1d(buses)):
        print(f"active filter at bus {b}: THD {t0[j]:.4f} -> "
              f"{t1[j]:.4f}, rating {rat[j]:.4f} pu rms")
    print(f"({out.n_solves} HPF solves, misfit {out.misfit:.2e})")
    print(f"{'bus':>4} {'h':>4} {'|I_c| [pu]':>11} {'angle [deg]':>12}")
    for j, b in enumerate(np.atleast_1d(buses)):
        for k, h in enumerate(s.harmonics):
            if abs(ic[j, k]) > 0:
                print(f"{b:>4} {h:>4} {abs(ic[j, k]):>11.5f} "
                      f"{np.degrees(np.angle(ic[j, k])):>12.2f}")
    return 0 if bool(np.asarray(out.result.converged)) else 2


def cmd_export(args) -> int:
    import hpfx

    s, net, dev = _load(args)
    n_def = hpfx.export_opendss_case(net, dev, s, args.dss)
    print(f"wrote {n_def} OpenDSS element definitions to {args.dss} "
          f"({net.n} buses, {net.n_lines} branches, "
          f"{net.n_nonlinear} device spectra)")
    return 0


def cmd_place(args) -> int:
    import numpy as np
    import hpfx

    s, net, dev = _load(args)
    kw = dict(buses=args.bus, h_tunes=args.h_tune, x_caps=args.x_cap,
              topology=args.topology)
    plan = hpfx.plan_filter_bank(net, dev, s, n_filters=args.n_filters,
                                 target=args.target, **kw)
    rep = plan.reports[0] if plan.reports else \
        hpfx.screen_filter_placement(net, dev, s, **kw)
    print(f"base worst THD_F {rep.base_objective:.4f} — "
          f"{rep.bus.size} candidates ({args.topology}):")
    print(f"{'rank':>4} {'bus':>4} {'h_tune':>7} {'x_cap':>7} "
          f"{'worstTHD':>9} {'q_fund':>8} {'Irms/I1':>8} {'ok':>4}")
    for r, k in enumerate(rep.order[:args.top]):
        print(f"{r:>4} {int(rep.bus[k]):>4} {float(rep.h_tune[k]):>7.2f} "
              f"{float(rep.x_cap[k]):>7.3f} {float(rep.thd_worst[k]):>9.4f} "
              f"{float(rep.q_fund[k]):>8.4f} "
              f"{float(rep.i_rms_ratio[k]):>8.3f} "
              f"{'yes' if rep.accepted[k] else 'NO':>4}")
    if plan.buses.size:
        stages = " -> ".join(f"{v:.4f}" for v in plan.history)
        branches = ", ".join(
            f"bus {b}: h={h:.2f} x_cap={x:.3f}"
            for b, h, x in zip(plan.buses, plan.h_tunes, plan.x_caps))
        print(f"greedy bank ({plan.buses.size} branch(es)): THD {stages} "
              f"[{branches}]")
    return 0


def cmd_capacity(args) -> int:
    import hpfx
    from hpfx.solve import hpf_sweep_adaptive

    s, net, dev = _load(args)
    scen = hpfx.monte_carlo_scenarios(
        args.seed, args.batch, net, s,
        p_spread=args.p_spread, inj_spread=args.inj_spread)
    mask = None
    if args.bus:
        nl = [i for i in range(net.m, net.n)]
        bad = [b for b in args.bus if b not in nl]
        if bad:
            print(f"error: buses {bad} are not nonlinear "
                  f"(nonlinear buses: {nl})", file=sys.stderr)
            return 2
        mask = [1.0 if b in args.bus else 0.0 for b in nl]
    criterion = "ieee519" if args.ieee519 else "thd"
    t0 = time.perf_counter()
    out = hpfx.find_hosting_capacity(
        net, dev, s, scen, confidence=args.confidence,
        criterion=criterion, thd_limit=args.limit, v_kv=args.v_kv,
        lo=args.lo, hi=args.hi, tol=args.tol, device_mask=mask,
        sweep=hpf_sweep_adaptive)
    dt = time.perf_counter() - t0
    crit = ("IEEE-519 table limits" if args.ieee519
            else f"worst-bus THD_F <= {args.limit}")
    scope = f"buses {sorted(args.bus)}" if args.bus else "all devices"
    print(f"criterion: {crit} at confidence {args.confidence} "
          f"over B={args.batch} Monte-Carlo scenarios ({scope})")
    for lvl, fr in sorted(zip(out.levels, out.fracs)):
        print(f"  level {lvl:7.3f}  compliant {fr:.4f}")
    if not out.feasible:
        print(f"NOT feasible at level {args.lo} "
              f"(compliant fraction {out.frac_at_level:.4f})  ({dt:.1f}s)")
        return 2
    qual = ">=" if out.bracket_open else "="
    print(f"hosting capacity {qual} {out.level:.3f}x nominal injections "
          f"(compliant fraction {out.frac_at_level:.4f}, "
          f"{len(out.levels)} probes, {dt:.1f}s incl. compile)")
    return 0


def cmd_assess(args) -> int:
    import numpy as np
    import hpfx
    from hpfx.solve import hpf_sweep_adaptive

    s, net, dev = _load(args)
    scen = hpfx.monte_carlo_scenarios(
        args.seed, args.batch, net, s,
        p_spread=args.p_spread, inj_spread=args.inj_spread)
    t0 = time.perf_counter()
    qa = hpfx.assess_quantiles(net, dev, s, scen,
                               quantiles=tuple(args.quantiles),
                               thd_limit=args.limit,
                               sweep=hpf_sweep_adaptive)
    dt = time.perf_counter() - t0
    print(f"Monte-Carlo percentile assessment: B={qa.n_samples} "
          f"conv={qa.converged_frac:.4f}  ({dt:.2f}s incl. compile)")
    hdr = " ".join(f"{'THD p' + format(q * 100, 'g'):>10}"
                   for q in qa.quantiles)
    print(f"{'bus':>4} {hdr} {'P(>limit)':>10}")
    thd_q = np.asarray(qa.thd_q)
    for i in range(net.n):
        cells = " ".join(f"{thd_q[k, i]:>10.4f}"
                         for k in range(len(qa.quantiles)))
        print(f"{i:>4} {cells} {float(qa.exceed_prob[i]):>10.4f}")
    if args.levels:
        levels = {}
        for item in args.levels:
            h, pct = item.split(":")
            levels[int(h)] = float(pct)
        pl = hpfx.check_planning_levels(qa, levels,
                                        quantile=args.level_quantile,
                                        default_pct=args.default_level)
        print(f"planning levels (p{args.level_quantile * 100:g} vs "
              f"per-order %): compliant={pl.compliant} "
              f"binding h={pl.binding_order} bus={pl.binding_bus} "
              f"margin={float(np.asarray(pl.margin_pct).min()):.3f}%")
        return 0 if pl.compliant else 3
    return 0


def cmd_timeseries(args) -> int:
    import numpy as np
    import hpfx

    s, net, dev = _load(args)
    if args.profile:
        prof = np.loadtxt(args.profile, delimiter=",", ndmin=1)
    else:
        prof = hpfx.daily_profile(args.steps)
    inj = prof if args.inj_follows_load else None
    t0 = time.perf_counter()
    ts = hpfx.run_timeseries(net, dev, s, prof, inj_profile=inj,
                             chunk=args.chunk)
    pc = hpfx.percentile_compliance(ts, s, percentile=args.percentile,
                                    v_kv=args.v_kv)
    dt = time.perf_counter() - t0
    T = prof.shape[0]
    print(f"quasi-static time series: T={T} steps, "
          f"conv={pc.converged_frac:.4f}  ({dt:.2f}s incl. compile)")
    print(f"IEEE-519 on the p{args.percentile:g} values "
          f"(individual<={pc.limit_individual}%, THD<={pc.limit_thd}%): "
          f"compliant={pc.compliant}")
    thd_p = np.asarray(pc.thd_p)
    vh_p = np.asarray(pc.vh_p)
    frac = np.asarray(pc.frac_steps_over)
    print(f"{'bus':>4} {'THD_p %':>9} {'worst h':>8} {'V_h/V_1 p %':>12} "
          f"{'steps>limit':>12}")
    for i in range(net.n):
        k = int(np.argmax(vh_p[:, i]))
        print(f"{i:>4} {thd_p[i]:>9.3f} {pc.harmonics[k]:>8} "
              f"{vh_p[k, i]:>12.3f} {frac[i]:>12.3f}")
    if args.json:
        out = {"thd": np.asarray(
                   100.0 * np.sqrt((np.asarray(ts.V_m)[:, 1:] ** 2)
                                   .sum(1)) / np.asarray(ts.V_m)[:, 0]
               ).tolist(),
               "converged": np.asarray(ts.converged).astype(bool).tolist(),
               "profile": np.asarray(prof).tolist()}
        with open(args.json, "w") as f:
            json.dump(out, f)
        print(f"wrote THD time series to {args.json}")
    return 0 if pc.compliant else 3


def cmd_contingency(args) -> int:
    import numpy as np
    import hpfx

    s, net, dev = _load(args)
    t0 = time.perf_counter()
    if args.scan:
        if args.type != "line":
            print("--scan applies to line outages only", file=sys.stderr)
            return 2
        rep = hpfx.outage_impedance_shift(net, dev, s,
                                          outages=args.element)
        dt = time.perf_counter() - t0
        print(f"N-1 resonance-shift scan: {len(rep.outages)} line "
              f"outages  ({dt:.2f}s incl. compile)")
        print(f"{'rank':>5} {'line':>7} {'status':>10} {'|Z| amp':>9} "
              f"{'at order':>9} {'at bus':>7}")
        for r, pos in enumerate(rep.ranking):
            if rep.islanded[pos]:
                print(f"{r:>5} {rep.outages[pos]:>7} {'ISLANDED':>10} "
                      f"{'-':>9} {'-':>9} {'-':>7}")
            else:
                print(f"{r:>5} {rep.outages[pos]:>7} {'ok':>10} "
                      f"{rep.amplification[pos]:>9.3f} "
                      f"{int(rep.shift_order[pos]):>9} "
                      f"{int(rep.shift_bus[pos]):>7}")
        amp = rep.amplification[~rep.islanded]
        return 3 if amp.size and np.nanmax(amp) > args.alert \
            and args.alert > 0 else 0
    if args.type == "line" and args.draws > 1:
        # (outage x scenario) cross: rank by the quantile over draws of
        # the worst-bus THD increase (planning-level screen)
        import jax.numpy as jnp

        from .solve import Scenarios
        S = args.draws
        rng = np.random.default_rng(args.seed)
        rd = s.real_dtype
        scen = Scenarios(
            p_scale=jnp.asarray(rng.uniform(*args.load_range, S), rd),
            q_scale=jnp.asarray(rng.uniform(*args.load_range, S), rd),
            injection_scale=jnp.asarray(
                rng.uniform(*args.inj_range, S), rd))
        rep = hpfx.screen_line_outages_sweep(
            net, dev, s, scen, outages=args.element,
            quantile=args.quantile,
            verify_infeasible=args.verify_infeasible)
        dt = time.perf_counter() - t0
        K = len(rep.outages)
        print(f"N-1 line-outage x scenario screen: {K} outages x {S} "
              f"draws, base worst-bus THD_F p{int(100 * args.quantile)} "
              f"{float(np.quantile(rep.base_worst, args.quantile)):.4f}"
              f"  ({dt:.2f}s incl. compile)")
        print(f"{'rank':>5} {'line':>7} {'status':>10} "
              f"{'dTHD q':>9} {'conv':>6} {'infeas':>7}")
        for r, pos in enumerate(rep.ranking):
            if rep.islanded[pos]:
                print(f"{r:>5} {rep.outages[pos]:>7} {'ISLANDED':>10} "
                      f"{'-':>9} {'-':>6} {'-':>7}")
            else:
                nin = int(rep.infeasible[pos].sum())
                print(f"{r:>5} {rep.outages[pos]:>7} {'ok':>10} "
                      f"{rep.delta_q[pos]:>+9.4f} "
                      f"{rep.conv_frac[pos]:>6.3f} "
                      f"{nin if args.verify_infeasible else '-':>7}")
        dq = rep.delta_q[~rep.islanded]
        return 3 if dq.size and np.nanmax(dq) > args.alert else 0
    if args.type == "line":
        rep = hpfx.screen_line_outages(net, dev, s, outages=args.element)
        label = "line"
    elif args.type == "shunt":
        rep = hpfx.screen_shunt_outages(net, dev, s, buses=args.element)
        label = "bus"
    else:
        rep = hpfx.screen_device_outages(net, dev, s,
                                         devices_out=args.element)
        label = "device"
    dt = time.perf_counter() - t0
    K = len(rep.outages)
    print(f"N-1 {args.type}-outage screen: {K} outages, base worst-bus "
          f"THD_F {float(rep.base_thd.max()):.4f}  ({dt:.2f}s incl. "
          f"compile)")
    print(f"{'rank':>5} {label:>7} {'status':>10} {'worst THD':>10} "
          f"{'delta':>9} {'min |V1|':>9} {'n_iter':>7}")
    for r, pos in enumerate(rep.ranking):
        if rep.islanded[pos]:
            status, worst, delta, v1, it = "ISLANDED", "-", "-", "-", "-"
        elif not rep.converged[pos]:
            status, worst, delta, v1, it = ("DIVERGED", "-", "-", "-",
                                            str(int(rep.n_iter[pos])))
        else:
            status = "ok"
            worst = f"{rep.worst_thd[pos]:.4f}"
            delta = f"{rep.delta_thd[pos]:+.4f}"
            v1 = f"{rep.v1_min[pos]:.4f}"
            it = str(int(rep.n_iter[pos]))
        print(f"{r:>5} {rep.outages[pos]:>7} {status:>10} {worst:>10} "
              f"{delta:>9} {v1:>9} {it:>7}")
    solved = rep.converged & ~rep.islanded
    if solved.any() and np.nanmax(rep.delta_thd[solved]) > args.alert:
        return 3
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m hpfx",
        description="harmonic power flow in JAX (JAX's default backend; "
                    "JAX_PLATFORMS=cpu selects the CPU)")
    sub = p.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("solve", help="single coupled-NR HPF solve")
    _add_common(ps)
    ps.add_argument("--solver", choices=["dense", "arrow"], default=None)
    ps.add_argument("--vlog", help="write V_log.json-format trajectory")
    ps.add_argument("--json", help="write the full solution as JSON")
    ps.add_argument("--bg", action="append", default=None,
                    metavar="ORDER:MAG:ANG_DEG",
                    help="background Thevenin voltage behind the slack "
                    "X_sh, e.g. --bg 5:0.02:0 (repeatable; pu magnitude, "
                    "degrees)")
    ps.add_argument("--load-model",
                    choices=["resistive", "parallel_rl", "motor"],
                    default=None,
                    help="fold a frequency-dependent linear-load damping "
                         "model into the harmonic Ybus (hpfx.loadmodel)")
    ps.add_argument("--skin", choices=["exponent", "cigre_oh",
                                       "cigre_cable"], default=None,
                    help="frequency-dependent series line resistance "
                    "model (hpfx.lineskin)")
    ps.add_argument("--skin-alpha", dest="skin_alpha", type=float,
                    default=0.5, help="exponent for --skin exponent "
                    "(default 0.5)")
    ps.add_argument("--long-line", dest="long_line", action="store_true",
                    help="exact distributed-parameter pi per harmonic "
                         "(sinh/tanh long-line correction; composes "
                         "with --skin)")
    ps.add_argument("--seq-aware", action="store_true",
                    help="solve triplen orders on the zero-sequence "
                         "network (hpfx.hpf_sequence)")
    ps.add_argument("--z0-scale", default="2.5:3.0", metavar="R0S:X0S",
                    help="zero-sequence line-impedance scales (default "
                         "2.5:3.0)")
    ps.add_argument("--xg", action="append", default=None,
                    metavar="BUS:XG",
                    help="grounded-neutral zero-sequence reactance at a "
                         "bus (repeatable)")
    ps.add_argument("--blocked-line", action="append", default=None,
                    metavar="IDX", help="line index with no zero-sequence "
                    "path (delta/ungrounded transformer; repeatable)")
    ps.add_argument("--delta-device", action="append", default=None,
                    metavar="IDX", help="delta-connected device index "
                    "(no triplen injection; repeatable)")
    ps.set_defaults(fn=cmd_solve)

    pc = sub.add_parser("scan", help="impedance scan + resonance peaks")
    _add_common(pc)
    pc.add_argument("--operational", action="store_true",
                    help="fold device Norton admittances into the scan")
    pc.set_defaults(fn=cmd_scan)

    pm = sub.add_parser("modes", help="resonance mode analysis "
                        "(critical eigenmode, participation, knobs)")
    _add_common(pm)
    pm.add_argument("--operational", action="store_true",
                    help="fold device Norton admittances into the scan")
    pm.add_argument("--step", type=float, default=0.0,
                    help="fractional-order grid step (0 = integer "
                    "harmonics only)")
    pm.add_argument("--sensitivity", action="store_true",
                    help="rank the retuning knobs at the dominant "
                    "resonance (eigenvalue sensitivities)")
    pm.set_defaults(fn=cmd_modes)

    pw = sub.add_parser("sweep", help="batched scenario sweep summary")
    _add_common(pw)
    pw.add_argument("--solver", choices=["dense", "arrow"], default=None)
    pw.add_argument("--batch", type=int, default=256)
    pw.add_argument("--p-range", type=float, nargs=2, default=(0.8, 1.2))
    pw.add_argument("--inj-range", type=float, nargs=2, default=(0.5, 1.5))
    pw.add_argument("--seed", type=int, default=0)
    pw.add_argument("--warm", choices=["cold", "linear"], default="cold",
                    help="phase-1 start: 'linear' = exact-linear Norton "
                         "seed (one (H-1)n block solve per scenario "
                         "replaces most NR trips)")
    pw.add_argument("--bg-spread", action="append", default=None,
                    metavar="ORDER:CAP",
                    help="add random upstream background draws: per "
                         "scenario, a Thevenin voltage at ORDER with "
                         "magnitude uniform in [0, CAP] pu and random "
                         "angle behind the slack X_sh (repeatable, e.g. "
                         "--bg-spread 5:0.03 --bg-spread 7:0.02)")
    pw.set_defaults(fn=cmd_sweep)

    pr = sub.add_parser("report",
                        help="line flows/losses + IEEE-519 compliance")
    _add_common(pr)
    pr.add_argument("--v-kv", dest="v_kv", type=float, default=None,
                    help="PCC voltage class in kV (default: the pu base)")
    pr.add_argument("--en50160", action="store_true",
                    help="also apply the EN 50160 per-order voltage "
                    "limits")
    pr.add_argument("--waveshape", action="store_true",
                    help="also print true RMS / peak / crest / form "
                         "factors per bus")
    pr.add_argument("--p1459", action="store_true",
                    help="also print the IEEE 1459 power decomposition "
                         "(S1/D_I/D_V/S_H/N, true vs displacement pf) "
                         "at every from-terminal")
    pr.add_argument("--isc-il", dest="isc_il", type=float, default=20.0,
                    help="PCC short-circuit ratio Isc/IL for the "
                         "Table-2 current-limit class (default 20)")
    pr.set_defaults(fn=cmd_report)

    pe = sub.add_parser("estimate",
                        help="fit device injection levels to measured "
                             "|V(h)| (the JSON a solve --json writes)")
    _add_common(pe)
    pe.add_argument("--measurements", required=True,
                    help="JSON with a V_m field, e.g. from solve --json")
    pe.add_argument("--meter", type=int, nargs="+", default=None,
                    help="metered bus subset (default: all buses)")
    pe.add_argument("--scales0", type=float, default=1.0)
    pe.set_defaults(fn=cmd_estimate)

    pf = sub.add_parser("filter",
                        help="gradient-tuned shunt filter design")
    _add_common(pf)
    pf.add_argument("--bus", type=int, required=True, nargs="+",
                    help="installation bus (repeat for a co-optimized "
                         "multi-bus bank)")
    pf.add_argument("--steps", type=int, default=25)
    pf.add_argument("--lr", type=float, default=0.05)
    pf.add_argument("--x-cap0", dest="x_cap0", type=float, default=0.05)
    pf.set_defaults(fn=cmd_filter)

    pa = sub.add_parser("afilter",
                        help="size a shunt active filter (compensating "
                             "injection spectrum + rating)")
    _add_common(pa)
    pa.add_argument("--bus", type=int, required=True, nargs="+",
                    help="bus(es) carrying the active filter "
                         "(several = one co-sized bank)")
    pa.add_argument("--orders", type=int, nargs="+", default=None,
                    help="orders to compensate (default: all solved)")
    pa.add_argument("--residual", type=float, default=0.05,
                    help="voltage fraction left at the targeted orders "
                         "(default 0.05; exactly 0 is polar-singular)")
    pa.set_defaults(fn=cmd_afilter)

    px = sub.add_parser("export",
                        help="write the case as a runnable OpenDSS "
                             ".dss script (harmonics-mode solve)")
    _add_common(px)
    px.add_argument("--dss", required=True, help="output .dss path")
    px.set_defaults(fn=cmd_export)

    pp = sub.add_parser("place",
                        help="screen shunt-filter placements (one "
                             "vmapped HPF over the candidate grid) and "
                             "greedily plan a bank")
    _add_common(pp)
    pp.add_argument("--bus", type=int, nargs="+", default=None,
                    help="candidate buses (default: every non-slack bus)")
    pp.add_argument("--h-tune", dest="h_tune", type=float, nargs="+",
                    default=None, help="candidate tuned orders (default: "
                    "0.97 x the 3 dominant distortion orders)")
    pp.add_argument("--x-cap", dest="x_cap", type=float, nargs="+",
                    default=[0.5, 1.0, 2.0],
                    help="candidate capacitor sizes [pu fundamental "
                    "reactance] (default 0.5 1.0 2.0)")
    pp.add_argument("--topology", choices=["tuned", "highpass", "ctype"],
                    default="tuned")
    pp.add_argument("--n-filters", dest="n_filters", type=int, default=1,
                    help="greedy bank size (default 1 = pure screen)")
    pp.add_argument("--target", type=float, default=None,
                    help="stop once worst-bus THD_F <= target")
    pp.add_argument("--top", type=int, default=10,
                    help="rows of the ranked table to print (default 10)")
    pp.set_defaults(fn=cmd_place)

    ph = sub.add_parser("capacity",
                        help="Monte-Carlo hosting-capacity bisection: "
                             "max penetration meeting a harmonic limit")
    _add_common(ph)
    ph.add_argument("--batch", type=int, default=256,
                    help="Monte-Carlo scenarios per probe (default 256)")
    ph.add_argument("--confidence", type=float, default=0.95,
                    help="required compliant fraction (default 0.95)")
    ph.add_argument("--limit", type=float, default=0.08,
                    help="worst-bus THD_F limit (default 0.08)")
    ph.add_argument("--ieee519", action="store_true",
                    help="use the IEEE-519 table limits instead of --limit")
    ph.add_argument("--v-kv", dest="v_kv", type=float, default=None,
                    help="voltage class for the IEEE-519 limits")
    ph.add_argument("--lo", type=float, default=1.0,
                    help="bracket low end; 1.0 = today's penetration "
                         "(must be > 0: level 0 is singular)")
    ph.add_argument("--hi", type=float, default=4.0)
    ph.add_argument("--tol", type=float, default=0.02)
    ph.add_argument("--p-spread", type=float, default=0.2)
    ph.add_argument("--inj-spread", type=float, default=0.2)
    ph.add_argument("--bus", type=int, nargs="+", default=None,
                    help="grow only these nonlinear buses (others stay "
                         "at their base draw)")
    ph.add_argument("--seed", type=int, default=0)
    ph.set_defaults(fn=cmd_capacity)

    pa = sub.add_parser("assess",
                        help="Monte-Carlo percentile assessment "
                             "(IEC 61000-3-6 shape: THD/harmonic "
                             "quantiles per bus + planning levels)")
    _add_common(pa)
    pa.add_argument("--batch", type=int, default=256)
    pa.add_argument("--quantiles", type=float, nargs="+",
                    default=(0.5, 0.95, 0.99))
    pa.add_argument("--limit", type=float, default=0.08,
                    help="THD exceedance-probability threshold")
    pa.add_argument("--p-spread", type=float, default=0.2)
    pa.add_argument("--inj-spread", type=float, default=0.2)
    pa.add_argument("--levels", action="append", default=None,
                    metavar="ORDER:PCT",
                    help="per-order planning level in %% (repeatable, "
                         "e.g. --levels 5:5 --levels 7:4); enables the "
                         "planning-level verdict")
    pa.add_argument("--default-level", type=float, default=3.0,
                    help="planning level for orders not listed (default 3)")
    pa.add_argument("--level-quantile", type=float, default=0.95,
                    help="assessed quantile compared against the levels")
    pa.add_argument("--seed", type=int, default=0)
    pa.set_defaults(fn=cmd_assess)

    pt = sub.add_parser("timeseries",
                        help="quasi-static profile study + IEEE-519 on "
                             "the 95th-percentile values over the window")
    _add_common(pt)
    pt.add_argument("--profile", default=None,
                    help="CSV of per-step load multipliers (one column); "
                         "default: a synthetic daily curve")
    pt.add_argument("--steps", type=int, default=96,
                    help="steps of the synthetic daily curve (default 96 "
                         "= 15-min values)")
    pt.add_argument("--inj-follows-load", action="store_true",
                    help="scale device injections with the load profile "
                         "(default: constant nominal injections)")
    pt.add_argument("--chunk", type=int, default=None,
                    help="solve the profile in batches of this many steps")
    pt.add_argument("--percentile", type=float, default=95.0)
    pt.add_argument("--v-kv", dest="v_kv", type=float, default=None)
    pt.add_argument("--json", help="write the THD time series as JSON")
    pt.set_defaults(fn=cmd_timeseries)

    pn = sub.add_parser("contingency",
                        help="N-1 outage screen ranked by worst-bus THD "
                             "increase (line / shunt / device outages)")
    _add_common(pn)
    pn.add_argument("--type", choices=["line", "shunt", "device"],
                    default="line")
    pn.add_argument("--element", type=int, nargs="+", default=None,
                    help="element indices to screen (default: all of "
                         "the chosen type)")
    pn.add_argument("--alert", type=float, default=0.0,
                    help="exit 3 when any outage raises worst-bus THD "
                         "by more than this (default 0 = any increase); "
                         "with --scan: |Z| amplification threshold "
                         "(0 disables)")
    pn.add_argument("--scan", action="store_true",
                    help="rank line outages by driving-point-impedance "
                         "amplification (resonance shift) instead of "
                         "solved THD")
    pn.add_argument("--draws", type=int, default=1,
                    help=">1 crosses every line outage with this many "
                         "random load/injection draws in one batched "
                         "program and ranks by the --quantile of the "
                         "THD increase over draws")
    pn.add_argument("--quantile", type=float, default=0.95)
    pn.add_argument("--seed", type=int, default=0)
    pn.add_argument("--load-range", type=float, nargs=2,
                    default=(0.9, 1.1), metavar=("LO", "HI"))
    pn.add_argument("--inj-range", type=float, nargs=2,
                    default=(0.8, 1.2), metavar=("LO", "HI"))
    pn.add_argument("--verify-infeasible", action="store_true",
                    help="with --draws: re-solve unconverged pairs in "
                         "f64 — recovered pairs merge back, the "
                         "rest are confirmed power-flow infeasibility "
                         "of the weakened topology")
    pn.set_defaults(fn=cmd_contingency)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.ne_dir is None:
        args.ne_dir = []
    from .devices import DATA_DIR
    args.ne_dir = list(args.ne_dir) + [DATA_DIR]

    import jax
    jax.config.update("jax_enable_x64", True)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
