"""Smoke run of hpfx's main path on an NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --multichip  # four cards: the sharded sweeps only

One card, in order (any failed phase exits nonzero):

1. the card's name and power limit (nvidia-smi);
2. the GPU test tier, ``pytest -m gpu``, in a child process before this
   process opens the card (one JAX process per card);
3. JAX's default platform must be ``gpu`` — there is no CPU fallback;
4. every linear-solve route the dispatcher can pick, at the dims and
   batches of the sweep stages, against a float64 LAPACK solve on the
   host, beside XLA's own f32 LU on the card;
5. the main-path sweeps through their public entry points: net2 H<=25
   on the device schedule (B=16384), net1 H<=25 (B=2048) and H<=51
   (B=256) on the host schedule, each with compile time, memory analysis,
   peak device memory and 64 sampled scenarios against float64
   per-scenario ``hpfx.hpf`` solves on the card;
6. float64 ``hpf_single`` on net1 H<=25 against the reference golden;
7. the CLI sweep in-process (last: the CLI enables x64 process-wide).

``--multichip`` runs only the scenario-sharded hosting-capacity sweep
and the 2-D scenario x harmonic sweep on four cards, each against the
same scenarios solved on one card.

All matmuls run at ``highest`` precision.  The last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``
and is printed only when every phase passed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
from functools import partial

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import hpfx  # noqa: E402
from hpfx.lanes import hpf_sweep_adaptive_lanes  # noqa: E402
from hpfx.ops import batched_solve, batched_solve_lanes  # noqa: E402
from hpfx.ops.dispatch import solve_route  # noqa: E402
from hpfx.solve import (Scenarios, hpf_single, hpf_sweep,  # noqa: E402
                        hpf_sweep_adaptive, hpf_sweep_device)

DATA = os.path.join(REPO, "hpfx", "data")
GOLDENS = os.path.join(REPO, "validation", "goldens")

#: (dim, batch) of the solve-route phase: the arrow blocks (8) and the
#: capacitance solve (26) and warm seed (96) of net2 at B=16384, net1's
#: capacitance solve at H<=25 (182, B=2048) and H<=51 (364, B=256), and
#: net1's dense H<=25 Newton step (518, B=256)
ROUTE_CASES = ((8, 16384), (26, 16384), (96, 16384), (182, 2048),
               (364, 256), (518, 256))
#: f32 bound of the sampled-scenario comparison per harmonic depth
#: (tests/test_f32_path.py): floor-aware f32 stopping at net1 scale leaves
#: up to ~1.6e-4 at H<=25 and ~1.6e-3 at H<=51 (dim 1038, where the f32
#: evaluation floor is several times thresh_h).  The H<=51 bound records
#: today's f32 accuracy, an open numerics question (PERF.md), not a target
SWEEP_DV_BOUND = {25: 3e-4, 51: 2e-3}
#: reference-parity gate of the f64 path
PARITY_BOUND = 1e-8
#: bound of the sharded-vs-one-card comparison (f32 stopping tolerance)
SHARD_DV_BOUND = 5e-4


class PhaseError(RuntimeError):
    """A smoke phase found a wrong or missing result."""


def check(cond, msg: str):
    if not cond:
        raise PhaseError(msg)


def log(msg: str):
    print(msg, flush=True)


def card_info() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    check(out, "nvidia-smi listed no card")
    return out


def run_gpu_tests() -> str:
    """``pytest -m gpu`` in a child process, with the platform left to
    the environment.  Fails unless every selected test ran and passed."""
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        env = dict(os.environ, HPFX_TEST_PLATFORM="gpu")
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
             "-p", "no:cacheprovider", f"--junitxml={xml}"],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=900)
        tail = "\n".join(proc.stdout.strip().splitlines()[-15:])
        check(proc.returncode == 0,
              f"pytest -m gpu exited {proc.returncode}:\n{tail}\n"
              f"{proc.stderr[-2000:]}")
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n, skipped = int(suite.get("tests")), int(suite.get("skipped"))
        check(n > 0 and skipped == 0,
              f"pytest -m gpu ran {n} tests with {skipped} skipped")
    return f"{n} passed"


def _errors(x, ref):
    """(batch error, mean per-system error): max |x - ref| over the batch
    relative to max |ref| (the tests/test_ops.py bound), and the mean
    over systems of each system's relative error (the statistic the
    routes are compared on — the batch maximum is decided by the single
    worst-conditioned system)."""
    d = np.abs(x - ref)
    per = d.max(axis=1) / np.abs(ref).max(axis=1)
    return float(d.max() / np.abs(ref).max()), float(per.mean())


def _systems(kind: str, n: int, B: int, key):
    """Well-conditioned (random + 3·sqrt(n)·I) or Woodbury-capacitance
    style (I + coupling, the arrow step's S matrix) f32 systems, made on
    the device."""
    ka, kb = jax.random.split(key)
    G = jax.random.normal(ka, (B, n, n), jnp.float32)
    eye = jnp.eye(n, dtype=jnp.float32)
    A = G + 3.0 * np.sqrt(n) * eye if kind == "well" \
        else eye + G * (0.8 / np.sqrt(n))
    return A, jax.random.normal(kb, (B, n), jnp.float32)


def phase_solve_routes(cases=ROUTE_CASES, n_ref: int = 256, seed: int = 0):
    """Each route at each (dim, batch) against float64 LAPACK on the
    host (first ``n_ref`` systems), beside XLA's own f32 LU on the card.

    A route passes when its mean per-system error is at most 4x that of
    the LU (floor 1e-6) and its batch error is within the 1e-4 bound of
    the dispatch tests (tests/test_ops.py)."""
    platform = jax.default_backend()
    lu = jax.jit(lambda A, b: jnp.linalg.solve(A, b[..., None])[..., 0])
    major = jax.jit(batched_solve)
    lanes = jax.jit(lambda A, b: batched_solve_lanes(
        jnp.moveaxis(A, 0, -1), jnp.moveaxis(b, 0, -1)[:, None, :]))
    key = jax.random.PRNGKey(seed)
    for n, B in cases:
        for kind in ("well", "capacitance"):
            key, sub = jax.random.split(key)
            A, b = _systems(kind, n, B, sub)
            A64 = np.asarray(A[:n_ref], np.float64)
            b64 = np.asarray(b[:n_ref], np.float64)
            ref = np.linalg.solve(A64, b64[..., None])[..., 0]
            _, mean_lu = _errors(np.asarray(lu(A, b)[:n_ref]), ref)
            bound = max(4.0 * mean_lu, 1e-6)
            route = solve_route(platform, A.dtype, n)
            outs = {"batched_solve": major(A, b),
                    f"batched_solve_lanes:{route}":
                        jnp.moveaxis(lanes(A, b)[:, 0, :], -1, 0)}
            for name, x in outs.items():
                check(x.shape == (B, n) and bool(jnp.isfinite(x).all()),
                      f"{name} dim {n} B={B}: bad shape or non-finite")
                err, mean = _errors(np.asarray(x[:n_ref]), ref)
                log(f"  route {name:<36} dim {n:>3} B={B:>5} {kind:<11} "
                    f"mean err {mean:.2e} (xla f32 lu {mean_lu:.2e}), "
                    f"batch err {err:.2e}")
                check(mean <= bound, f"{name} dim {n} {kind}: mean err "
                      f"{mean:.2e} > {bound:.2e}")
                check(err <= 1e-4, f"{name} dim {n} {kind}: batch err "
                      f"{err:.2e} > 1e-4")


def _settings(h_max: int, dtype: str = "float32") -> hpfx.Settings:
    return hpfx.settings_for_hmax(h_max, coupled=True).with_(
        solver="arrow", stable_mismatch=True, dtype=dtype)


def _fixture(name: str, s):
    net = hpfx.load_network(os.path.join(DATA, f"{name}_buses.csv"),
                            os.path.join(DATA, f"{name}_lines.csv"), s)
    return net, hpfx.load_device_set(net, s)


def _scen_np(B: int):
    """The bench's hosting-capacity spread: load 0.8-1.2, injection
    0.6-1.4."""
    return (np.linspace(0.8, 1.2, B), np.linspace(0.8, 1.2, B)[::-1],
            np.linspace(0.6, 1.4, B))


def _to_scenarios(p, q, i, dtype) -> Scenarios:
    return Scenarios(jnp.asarray(p, dtype), jnp.asarray(q, dtype),
                     jnp.asarray(i, dtype))


def reference_f64(net_name: str, h_max: int, p, q, i):
    """Float64 per-scenario ``hpfx.hpf`` solves (dense reference-form
    Newton step) of the given scenarios on the default device."""
    with jax.enable_x64():
        s64 = hpfx.settings_for_hmax(h_max, coupled=True).with_(
            dtype="float64")
        net, dev = _fixture(net_name, s64)

        def one(p_, q_, i_):
            net_s = dataclasses.replace(net, bus_P=net.bus_P * p_,
                                        bus_Q=net.bus_Q * q_)
            r = hpfx.hpf(net_s, dev.scale(i_), s64)
            return r.V_m, r.converged

        V_m, conv = jax.jit(jax.vmap(one))(
            *(jnp.asarray(x, jnp.float64) for x in (p, q, i)))
        return np.asarray(V_m), np.asarray(conv)


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: not available"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f.removesuffix('_size_in_bytes')} {getattr(ma, f, 0) / 2**20:.1f} MiB"
        for f in fields)


def _peak_line() -> str:
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return ("peak_bytes_in_use: not available" if peak is None
            else f"peak_bytes_in_use: {peak / 2**30:.2f} GiB")


def phase_sweep(net_name: str, h_max: int, B: int, schedule: str,
                phase_iters: int = 24, n_sample: int = 64):
    """One main-path sweep through its public entry point.

    ``schedule="device"``: :func:`hpfx.solve.hpf_sweep_device` running
    :func:`hpfx.lanes.hpf_sweep_adaptive_lanes` with ``warm="linear"``;
    ``"host"``: :func:`hpfx.solve.hpf_sweep_adaptive`.  Reports compile
    time (set-up), the compiled program's memory analysis (for the host
    schedule, of its phase-1 program) and the process's peak device
    memory, then checks that every scenario converged and that
    ``n_sample`` of them match float64 per-scenario solves."""
    s = _settings(h_max)
    net, dev = _fixture(net_name, s)
    p, q, i = _scen_np(B)
    scen = _to_scenarios(p, q, i, jnp.float32)
    t0 = time.perf_counter()
    if schedule == "device":
        program = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                                  phase_iters=phase_iters, warm="linear"))
        compiled = program.lower(net, dev, scenarios=scen).compile()
        run = lambda: hpf_sweep_device(  # noqa: E731
            net, dev, s, scen, phase_iters=phase_iters, jitted=compiled)
    else:
        s1 = s.with_(max_iter_h=min(phase_iters, s.max_iter_h))
        compiled = hpf_sweep.lower(net, dev, settings=s1,
                                   scenarios=scen).compile()
        run = lambda: hpf_sweep_adaptive(  # noqa: E731
            net, dev, s, scen, phase_iters=phase_iters)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(run())
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(run())
    t_second = time.perf_counter() - t0
    conv = np.asarray(res.converged)
    log(f"  {net_name} H<={h_max} B={B} {schedule}: converged "
        f"{conv.mean():.4f}; compile {t_compile:.1f} s (set-up), first "
        f"call {t_first:.2f} s, second call {t_second:.2f} s")
    log(f"    {_memory_line(compiled)}")
    log(f"    {_peak_line()}")
    check(res.V_m.shape == (B, s.n_harmonics, net.n),
          f"V_m shape {res.V_m.shape}")
    check(bool(np.isfinite(np.asarray(res.V_m)[conv]).all()),
          "non-finite voltages on converged scenarios")
    check(conv.all(), f"converged fraction {conv.mean():.4f} < 1")
    idx = np.unique(np.linspace(0, B - 1, n_sample).astype(int))
    V_ref, conv_ref = reference_f64(net_name, h_max, p[idx], q[idx], i[idx])
    both = conv[idx] & conv_ref
    check(both.all(), f"only {both.sum()}/{len(idx)} sampled scenarios "
          "converged in both f32 and the f64 reference")
    dv = float(np.abs(np.asarray(res.V_m)[idx][both] - V_ref[both]).max())
    bound = SWEEP_DV_BOUND[25 if h_max <= 25 else 51]
    log(f"    {both.sum()}/{len(idx)} sampled scenarios vs f64 per-scenario "
        f"hpf: max |dV_m| {dv:.2e} (bound {bound:.0e})")
    check(dv <= bound, f"|dV_m| {dv:.2e} > {bound:.0e}")
    return float(conv.mean())


def phase_f64_parity(net_name: str = "net1", h_max: int = 25):
    """Float64 ``hpf_single`` against the reference golden: voltages and
    THD within 1e-8 at the same NR iteration count."""
    g = np.load(os.path.join(GOLDENS, f"{net_name}_h{h_max}_c.npz"))
    with jax.enable_x64():
        s = hpfx.settings_for_hmax(h_max, coupled=True).with_(
            dtype="float64")
        net, dev = _fixture(net_name, s)
        res = hpf_single(net, dev, settings=s)
        thd = hpfx.get_thd(res.V_m)
        diffs = {
            "V_m": np.abs(np.asarray(res.V_m) - g["V_m"]).max(),
            "V_a": np.abs(np.asarray(res.V_a) - g["V_a"]).max(),
            "THD_F": np.abs(np.asarray(thd.THD_F) - g["THD_F"]).max(),
            "THD_R": np.abs(np.asarray(thd.THD_R) - g["THD_R"]).max(),
        }
        n_iter, conv = int(res.n_iter), bool(res.converged)
    log(f"  {net_name} H<={h_max} coupled f64: converged {conv}, NR "
        f"iterations {n_iter} (golden {int(g['n_iter_h'])}); max |diff| "
        + ", ".join(f"{k} {v:.1e}" for k, v in diffs.items()))
    check(conv, "f64 solve did not converge")
    check(n_iter == int(g["n_iter_h"]), "NR iteration count differs")
    for k, v in diffs.items():
        check(v <= PARITY_BOUND, f"{k} differs by {v:.1e}")


def phase_cli(batch: int = 4096, h_max: int = 25):
    """``python -m hpfx sweep`` in-process on net2; exit code 0 means
    every scenario converged."""
    from hpfx.__main__ import main
    argv = ["sweep", "--buses", os.path.join(DATA, "net2_buses.csv"),
            "--lines", os.path.join(DATA, "net2_lines.csv"),
            "--hmax", str(h_max), "--batch", str(batch)]
    log(f"  python -m hpfx {' '.join(argv[:1] + argv[5:])}")
    rc = main(argv)
    check(rc == 0, f"CLI sweep exited {rc}")


def _conv_gap(a, b) -> float:
    """Difference of two runs' converged fractions.  The plain lockstep
    sweep leaves ~1% of the bench spread hovering at the f32 floor, and
    which scenarios those are flips with the arithmetic order, which
    sharding changes (CLAUDE.md #3) — so the runs are held to the same
    fraction, and to the same voltages where both converged."""
    return abs(float(np.mean(np.asarray(a.converged)))
               - float(np.mean(np.asarray(b.converged))))


def _thd_bound(V_m, dv: float) -> float:
    """Largest change of a bus's THD_F = |V_h>1| / V_1 when every
    harmonic voltage magnitude moves by at most ``dv``, over the (B, H, n)
    voltages ``V_m``: (sqrt(H-1)·dv + THD_F·dv) / (V_1 - dv)."""
    v1 = V_m[:, 0, :]
    thd = np.sqrt((V_m[:, 1:, :] ** 2).sum(axis=1)) / v1
    dh = np.sqrt(V_m.shape[1] - 1) * dv
    return float(((dh + thd * dv) / (v1 - dv)).max())


def _distinct_shards(x, n: int) -> bool:
    shards = x.addressable_shards
    return (len({sh.device for sh in shards}) == n
            and len({str(sh.index) for sh in shards}) == n)


def phase_multichip(n_devices: int = 4, B_per_card: int = 16384,
                    h_max: int = 25):
    """Scenario-sharded hosting capacity on ``scenario_mesh(n)`` and the
    2-D sweep on ``hpf_mesh(n/2, 2)``, each against the same scenarios
    solved on one card, with every card holding a distinct shard."""
    from hpfx.parallel import (hosting_capacity_sharded, hpf_mesh,
                               hpf_sweep_sharded, hpf_sweep_sharded2d,
                               scenario_mesh)
    from hpfx.solve import hosting_capacity_sweep

    check(len(jax.devices()) >= n_devices,
          f"{len(jax.devices())} devices < {n_devices}")
    s = _settings(h_max)
    net, dev = _fixture("net2", s)
    B = n_devices * B_per_card
    scen = _to_scenarios(*_scen_np(B), jnp.float32)
    mesh = scenario_mesh(n_devices)

    one = hosting_capacity_sweep(net, dev, settings=s, scenarios=scen)
    ref = hpf_sweep(net, dev, settings=s, scenarios=scen)
    thd_one, conv_one = np.asarray(one.max_thd_f), np.asarray(one.converged)
    thd_limit = float(np.median(thd_one))
    t0 = time.perf_counter()
    summ = jax.block_until_ready(hosting_capacity_sharded(
        net, dev, s, scen, mesh, thd_limit=thd_limit))
    t_hc = time.perf_counter() - t0
    max_thd, conv = np.asarray(summ.max_thd_f), np.asarray(summ.converged)
    frac = float(summ.frac_over_limit)
    expect = float(np.mean((max_thd > thd_limit) & conv))
    frac_one = float(np.mean((thd_one > thd_limit) & conv_one))
    both = conv & conv_one
    dthd = float(np.abs(max_thd[both] - thd_one[both]).max())
    thd_bound = _thd_bound(np.asarray(ref.V_m)[np.asarray(ref.converged)],
                           SHARD_DV_BOUND)
    log(f"  hosting_capacity_sharded B={B} on {mesh.devices.shape}: "
        f"frac_over_limit {frac:.4f}, host recomputation {expect:.4f}, one "
        f"card {frac_one:.4f}; converged {conv.mean():.4f} vs "
        f"{conv_one.mean():.4f}; max |d max_thd_f| vs one card {dthd:.2e} "
        f"(bound {thd_bound:.2e}) on {both.sum()}/{B}; first call "
        f"{t_hc:.1f} s")
    check(abs(frac - expect) < 1e-6, "aggregate != host recomputation")
    check(0.0 < frac < 1.0, f"non-discriminating aggregate {frac}")
    check(abs(conv.mean() - conv_one.mean()) <= 0.01,
          "sharded converged fraction differs from one card by more than 1%")
    check(dthd <= thd_bound, f"max_thd_f differs from one card by "
          f"{dthd:.2e} > {thd_bound:.2e}")
    check(abs(frac - frac_one) <= 0.01,
          f"frac_over_limit {frac:.4f} vs one card {frac_one:.4f}")
    check(_distinct_shards(summ.max_thd_f, n_devices),
          "hosting-capacity outputs are not one distinct shard per card")

    res = hpf_sweep_sharded(net, dev, s, scen, mesh)
    both = np.asarray(res.converged) & np.asarray(ref.converged)
    dv = float(np.abs(np.asarray(res.V_m)[both]
                      - np.asarray(ref.V_m)[both]).max())
    log(f"  hpf_sweep_sharded (the sweep inside the hosting capacity) vs "
        f"one card: converged {np.mean(np.asarray(res.converged)):.4f} vs "
        f"{np.mean(np.asarray(ref.converged)):.4f}, {both.sum()}/{B} in "
        f"both, max |dV_m| {dv:.2e}")
    check(_conv_gap(res, ref) <= 0.01,
          "sharded sweep's converged fraction differs by more than 1%")
    check(dv <= SHARD_DV_BOUND, f"|dV_m| {dv:.2e} > {SHARD_DV_BOUND}")
    check(_distinct_shards(res.V_m, n_devices),
          "sweep outputs are not one distinct shard per card")

    s2 = s.with_(layout="lanes")
    mesh2 = hpf_mesh(n_devices // 2, 2)
    r2 = hpf_sweep_sharded2d(net, dev, s2, scen, mesh2)
    r2u = hpf_sweep(net, dev, settings=s2, scenarios=scen)
    both = np.asarray(r2.converged) & np.asarray(r2u.converged)
    dv2 = float(np.abs(np.asarray(r2.V_m)[both]
                       - np.asarray(r2u.V_m)[both]).max())
    log(f"  hpf_sweep_sharded2d B={B} on {mesh2.devices.shape} vs one "
        f"card: converged {np.mean(np.asarray(r2.converged)):.4f} vs "
        f"{np.mean(np.asarray(r2u.converged)):.4f}, {both.sum()}/{B} in "
        f"both, max |dV_m| {dv2:.2e}")
    check(_conv_gap(r2, r2u) <= 0.01,
          "2-D sweep's converged fraction differs by more than 1%")
    check(dv2 <= SHARD_DV_BOUND, f"|dV_m| {dv2:.2e} > {SHARD_DV_BOUND}")
    check(len({sh.device for sh in r2.V_m.addressable_shards})
          == n_devices, "2-D sweep outputs do not span every card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    log(f"card: {card_info()}")
    if not args.multichip:
        log(f"gpu test tier: {run_gpu_tests()}")
    platform = jax.default_backend()
    devices = jax.devices()
    log(f"jax {jax.__version__}; devices: {devices}")
    check(platform == "gpu", f"JAX's default platform is {platform!r}, "
          "not 'gpu'")
    from hpfx.utils.cache import enable_persistent_cache
    log(f"compile cache: {enable_persistent_cache()}")

    with jax.default_matmul_precision("highest"):
        log("matmul precision in effect: "
            f"{jax.config.jax_default_matmul_precision}")
        if args.multichip:
            phase_multichip()
        else:
            log("solve routes:")
            phase_solve_routes()
            log("sweeps:")
            phase_sweep("net2", 25, 16384, "device")
            phase_sweep("net1", 25, 2048, "host")
            phase_sweep("net1", 51, 256, "host", phase_iters=30)
            log("f64 parity:")
            phase_f64_parity()
            log("CLI:")
            phase_cli()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (PhaseError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        sys.exit(1)
