"""Benchmark: batched coupled-NR harmonic power flow throughput on the GPU.

Measures end-to-end converged HPF solves/sec (Ybus + fundamental + coupled
harmonic NR to convergence, per scenario) for scenario sweeps, plus the
study stages built on them:

- net2 H<=25 (4 buses, 1 device) on the single-program device schedule
  with the exact-linear warm seed, as one sweep and as a pipelined stream;
- net1 at H<=25, H<=51 and H<=99 (20 buses, 7 devices, the reference's
  own scale test, hcne.jl:495-505) on the host-driven adaptive schedule;
- synthetic feeders of 64 and 128 buses;
- batched IFT sensitivities, the percentile assessment, the quasi-static
  time series and the (outage x draw) contingency cross.

Every stage runs in every run; any failure exits nonzero.  A run without
a GPU exits nonzero before measuring anything.  Timing ends in
``block_until_ready``; the first call of each stage (compilation) is
untimed.  Prints ONE JSON line naming the platform, device kind, device
count and the card's name and power limit.

Run on the card:  python bench.py
"""
import json
import os
import subprocess
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import hpfx  # noqa: E402
from hpfx.lanes import hpf_sweep_adaptive_lanes  # noqa: E402
from hpfx.solve import (Scenarios, hpf_sweep_adaptive,  # noqa: E402
                        hpf_sweep_device, hpf_sweep_stream)
from hpfx.utils.cache import enable_persistent_cache  # noqa: E402

BATCH = 16384
BATCH_NET1 = 2048
REPEATS = 5
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "hpfx", "data")


def card_info() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _settings(h_max: int) -> hpfx.Settings:
    # stable_mismatch: cancellation-free residual evaluation — required for
    # reference-threshold f32 convergence on stiff grids
    return hpfx.settings_for_hmax(h_max, coupled=True).with_(
        solver="arrow", stable_mismatch=True, dtype="float32")


def _fixture(name: str, s):
    net = hpfx.load_network(os.path.join(DATA, f"{name}_buses.csv"),
                            os.path.join(DATA, f"{name}_lines.csv"), s)
    return net, hpfx.load_device_set(net, s)


def _scen(batch: int, k: int, spread=(0.8, 1.2, 0.6, 1.4)) -> Scenarios:
    """Hosting-capacity style spread; every repetition ``k`` gets a
    distinct scenario set."""
    p_lo, p_hi, i_lo, i_hi = spread
    lin = lambda a, b: np.linspace(a, b, batch)  # noqa: E731
    return Scenarios(
        p_scale=jnp.asarray(lin(p_lo, p_hi) + 1e-4 * k, jnp.float32),
        q_scale=jnp.asarray(lin(p_lo, p_hi), jnp.float32),
        injection_scale=jnp.asarray(lin(i_lo, i_hi), jnp.float32))


def _timed(run, repeats: int):
    """Untimed warm-up (compilation) then ``repeats`` timed calls of
    ``run(k)``, each ending in block_until_ready.  Returns (best seconds,
    last result)."""
    jax.block_until_ready(run(-1))
    times, out = [], None
    for k in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(k))
        times.append(time.perf_counter() - t0)
    return min(times), out


def bench_net(net, dev, s, batch: int, repeats: int, phase_iters: int = 24,
              device: bool = False, spread=(0.8, 1.2, 0.6, 1.4)) -> dict:
    """One sweep stage: the single-program device schedule with the
    in-program warm seed (``device=True``) or the host-driven adaptive
    schedule."""
    if device:
        jitted = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                                 phase_iters=phase_iters, warm="linear"))
        sweep = lambda sc: hpf_sweep_device(  # noqa: E731
            net, dev, s, sc, phase_iters=phase_iters, jitted=jitted)
    else:
        sweep = lambda sc: hpf_sweep_adaptive(  # noqa: E731
            net, dev, s, sc, phase_iters=phase_iters)
    dt, res = _timed(lambda k: sweep(_scen(batch, k, spread)), repeats)
    conv = float(np.mean(np.asarray(res.converged)))
    return dict(solves_per_sec=conv * batch / dt, raw_solves_per_sec=batch / dt,
                convergence=conv, batch=batch)


def bench_stream(net, dev, s, batch: int, n_batches: int = 4,
                 passes: int = 3, phase_iters: int = 24) -> dict:
    """Steady-state pipelined throughput: hpf_sweep_stream over
    ``n_batches`` distinct scenario batches with depth-2 double
    buffering (same programs as the net2 stage)."""
    jitted = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                             phase_iters=phase_iters, warm="linear"))

    def one_pass(k0):
        gen = (_scen(batch, k0 + i) for i in range(n_batches))
        return [r for r in hpf_sweep_stream(net, dev, s, gen, depth=2,
                                            phase_iters=phase_iters,
                                            jitted=jitted)]

    dt, outs = _timed(lambda k: one_pass(100 * (k + 1)), passes)
    conv = min(float(np.mean(np.asarray(r.converged))) for r in outs)
    return dict(solves_per_sec=conv * n_batches * batch / dt,
                convergence=conv, batch=batch, n_batches=n_batches)


def bench_grads(batch: int = 1024, repeats: int = 3) -> dict:
    """grads/sec of the batched IFT gradient program (sweep_sensitivity,
    net2 H<=25)."""
    from hpfx.sensitivity import sweep_sensitivity
    from hpfx.solve import hpf_sweep

    s = _settings(25)
    net, dev = _fixture("net2", s)
    sweep = jax.jit(partial(hpf_sweep, net, dev, settings=s))
    grads = jax.jit(lambda sr, sc: sweep_sensitivity(net, dev, s, sr, sc))
    # the sweeps that feed the gradients are solved up front, untimed
    inputs = {k: (sweep(scenarios=_scen(batch, k)), _scen(batch, k))
              for k in range(-1, repeats)}
    dt, g = _timed(lambda k: grads(*inputs[k]).grad, repeats)
    finite = float(np.mean([np.isfinite(np.asarray(leaf)).mean()
                            for leaf in jax.tree_util.tree_leaves(g)]))
    return dict(grads_per_sec=batch / dt, finite_frac=finite, batch=batch)


def bench_studies(batch: int = 4096, T: int = 1008,
                  repeats: int = 2) -> dict:
    """Percentile assessment + quasi-static time series (hpfx.studies) on
    the device schedule with the warm seed."""
    s = _settings(25)
    net, dev = _fixture("net2", s)
    jitted = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                             phase_iters=24, warm="linear"))
    sweep_fn = lambda n_, d_, s_, sc_: hpf_sweep_device(  # noqa: E731
        n_, d_, s_, sc_, phase_iters=24, jitted=jitted)

    def assess(k):
        # negative seeds are rejected by the rng: warm up on a disjoint one
        scen = hpfx.monte_carlo_scenarios(999 if k < 0 else k, batch, net, s,
                                          inj_spread=0.3)
        return hpfx.assess_quantiles(net, dev, s, scen, sweep=sweep_fn)

    at, qa = _timed(assess, repeats)

    def tseries(k):
        prof = hpfx.daily_profile(T, base=0.7 + 0.002 * k, peak=1.15)
        ts = hpfx.run_timeseries(net, dev, s, prof, inj_profile=prof,
                                 chunk=T, sweep=sweep_fn)
        return hpfx.percentile_compliance(ts, s)

    tt, pc = _timed(tseries, repeats)
    return {
        "studies_assess_solves_per_sec": qa.converged_frac * batch / at,
        "studies_assess_convergence": qa.converged_frac,
        "studies_assess_batch": batch,
        "timeseries_steps_per_sec": T / tt,
        "timeseries_convergence": pc.converged_frac,
        "timeseries_steps": T,
    }


def bench_contingency(S: int = 128, repeats: int = 2) -> dict:
    """(outage x draw) N-1 line screen on net1 H<=5 uncoupled, every pair
    one lane of a single vmapped full-HPF program, then an untimed f64
    verification of the unconverged pairs (pairs that fail even in f64
    are genuine power-flow infeasibility of the weakened topology)."""
    from hpfx import contingency as cg

    s = hpfx.settings_for_hmax(5, coupled=False).with_(
        stable_mismatch=True, dtype="float32")
    net, dev = _fixture("net1", s)
    spread = (0.9, 1.1, 0.8, 1.2)
    dt, rep = _timed(lambda k: cg.screen_line_outages_sweep(
        net, dev, s, _scen(S, k, spread)), repeats)
    solved = ~rep.islanded
    conv = float(rep.converged[solved].mean())
    n_pairs = int(solved.sum()) * S
    vrep = cg.screen_line_outages_sweep(net, dev, s,
                                        _scen(S, repeats - 1, spread),
                                        verify_infeasible=True)
    rows = ~vrep.islanded
    n_feasible = int(rows.sum()) * S - int(vrep.infeasible.sum())
    return {
        "contingency_pairs_per_sec": conv * n_pairs / dt,
        "contingency_convergence": conv,
        "contingency_pairs": n_pairs,
        "contingency_infeasible_pairs": int(vrep.infeasible.sum()),
        "contingency_conv_among_feasible":
            int(vrep.converged[rows].sum()) / max(1, n_feasible),
    }


def main() -> int:
    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX's default backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    enable_persistent_cache()
    dev0 = jax.devices()[0]
    out = {"platform": dev0.platform, "device_kind": dev0.device_kind,
           "device_count": len(jax.devices()), "card": card_info()}

    def stage(prefix, result):
        out.update({f"{prefix}_{k}": v for k, v in result.items()})
        print(f"# {prefix}: {result}", file=sys.stderr, flush=True)

    s25 = _settings(25)
    net2, dev2 = _fixture("net2", s25)
    stage("net2", bench_net(net2, dev2, s25, BATCH, REPEATS, device=True))
    stage("net2_stream", bench_stream(net2, dev2, s25, BATCH))
    net1, dev1 = _fixture("net1", s25)
    stage("net1", bench_net(net1, dev1, s25, BATCH_NET1, 3))
    s51 = _settings(51)
    stage("net1_h51", bench_net(*_fixture("net1", s51), s51, 256, 2,
                                phase_iters=30))
    s99 = _settings(99)
    stage("net1_h99", bench_net(*_fixture("net1", s99), s99, 64, 2,
                                phase_iters=30))
    from hpfx.generators import synthetic_feeder
    for n, n_nl, batch, spread in ((64, 7, 256, (0.9, 1.1, 0.7, 1.2)),
                                   (128, 30, 128, (0.95, 1.05, 0.8, 1.1))):
        # spreads narrowed to each feeder's feasible range: the heavy
        # synthetic feeders have no power-flow solution past ~1.1-1.25x
        # injections
        feeder = synthetic_feeder(n, n_nl, s25, components=("SMPS",), seed=1)
        stage(f"synthetic_n{n}", bench_net(
            feeder, hpfx.load_device_set(feeder, s25), s25, batch, 2,
            phase_iters=30, spread=spread))
    stage("sweep_sensitivity", bench_grads())
    out.update(bench_studies())
    out.update(bench_contingency())
    out["metric"] = "batched coupled-NR HPF converged solves/sec " \
                    f"(net2, H<=25, B={BATCH})"
    out["value"] = out["net2_solves_per_sec"]
    out["unit"] = "solves/sec"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
