"""Scenario-axis sharding over device meshes (GSPMD / jax.sharding).

The HPF scenario sweep is embarrassingly parallel (SURVEY §2.6, §5.8): the
only cross-scenario communication is the final statistics reduction of a
hosting-capacity sweep.  The design is therefore a 1-D ``Mesh`` over all
devices with the batch axis sharded (the data-parallel analogue) and the
network/device pytrees replicated; XLA inserts the cross-device all-reduce
for the aggregate automatically.

Works identically on several GPUs of one host (``chip_smoke.py
--multichip``) and on the CPU-mesh simulator
(``--xla_force_host_platform_device_count=N``), which is how the tests
validate the sharded programs without accelerators.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Settings
from ..devices import DeviceSet
from ..harmonic import HPFResult
from ..network import Network
from ..solve import (Scenarios, SweepSummary,
                     hosting_capacity_sweep_unjitted, hpf_sweep_unjitted)

SCENARIO_AXIS = "scenario"
HARMONIC_AXIS = "harmonic"


def scenario_mesh(n_devices: Optional[int] = None,
                  devices=None) -> Mesh:
    """1-D mesh over the available chips, scenario axis only."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SCENARIO_AXIS,))


def harmonic_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh with the *harmonic* axis sharded — model parallelism over
    the problem's own scaling dimension (SURVEY §5.7: state dim grows as
    2·H·n; the coupled Jacobian has (K+1)² coupling blocks)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (HARMONIC_AXIS,))


def hpf_mesh(n_scenario: int, n_harmonic: int, devices=None) -> Mesh:
    """2-D scenario × harmonic mesh (the DP × TP analogue): independent
    scenarios ride the first axis, the per-scenario harmonic blocks are
    model-parallel over the second.  Collectives for the cross-harmonic
    Norton coupling and the Woodbury capacitance reduction stay inside a
    harmonic group (on one host's NVLink for a 2 x 2 mesh)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[:n_scenario * n_harmonic]).reshape(
        n_scenario, n_harmonic)
    return Mesh(devices, (SCENARIO_AXIS, HARMONIC_AXIS))


def _pad_scenarios(scenarios: Scenarios, mesh: Mesh):
    """Pad the batch up to a scenario-shard-divisible size by repeating
    the last scenario (discarded from results/aggregates by the callers).
    Only the SCENARIO_AXIS extent matters: on a 2-D scenario × harmonic
    mesh the batch is sharded over the scenario axis alone, so padding to
    the total device count would over-pad by the harmonic-axis factor.
    Returns (padded_scenarios, original_batch)."""
    import jax.numpy as jnp

    B = scenarios.batch
    n_dev = int(mesh.shape.get(SCENARIO_AXIS,
                               int(np.prod(mesh.devices.shape))))
    Bp = -(-B // n_dev) * n_dev
    if Bp == B:
        return scenarios, B

    def pad(x):
        if x is None:
            return None
        reps = jnp.broadcast_to(x[-1:], (Bp - B,) + x.shape[1:])
        return jnp.concatenate([x, reps], axis=0)

    return Scenarios(*(pad(x) for x in scenarios)), B


def shard_scenarios(scenarios: Scenarios, mesh: Mesh) -> Scenarios:
    """Place scenario arrays with the batch axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))

    def put(x):
        return None if x is None else jax.device_put(x, sharding)

    return Scenarios(*(put(x) for x in scenarios))


def _replicate(tree, mesh: Mesh):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def hpf_sweep_sharded(net: Network, devices: DeviceSet, settings: Settings,
                      scenarios: Scenarios, mesh: Mesh) -> HPFResult:
    """Batched HPF with the scenario axis sharded over ``mesh``.

    Batch sizes that don't divide the mesh are padded by repeating the
    last scenario; padding is sliced off the result.  Each chip runs its
    shard of scenarios independently; no collective is needed until the
    caller reduces the result.
    """
    scenarios, B = _pad_scenarios(scenarios, mesh)
    net = _replicate(net, mesh)
    devices = _replicate(devices, mesh)
    scenarios = shard_scenarios(scenarios, mesh)
    out_spec = NamedSharding(mesh, P(SCENARIO_AXIS))
    fn = jax.jit(
        partial(hpf_sweep_unjitted, settings=settings),
        static_argnames=(),
        out_shardings=out_spec)
    res = fn(net, devices, scenarios=scenarios)
    if res.V_m.shape[0] != B:
        res = jax.tree.map(lambda x: x[:B], res)
    return res


def hpf_single_hsharded(net: Network, devices: DeviceSet,
                        settings: Settings, mesh: Mesh):
    """Single HPF solve with the **harmonic axis** sharded over ``mesh``
    (model parallelism; the TP analogue of SURVEY §5.7).

    The (H, n, n) admittance tensor and the (H, n) voltage state are
    partitioned over the mesh axis named ``HARMONIC_AXIS``; GSPMD then
    keeps every per-harmonic operation — Ybus matvecs, per-harmonic block
    Jacobians, and (with ``Settings.solver="arrow"``) the independent
    per-harmonic block factorizations of the arrow Newton step — local to
    its shard, and inserts collectives only where harmonics genuinely
    couple: the Norton cross-harmonic injection einsum
    (hcne_generalized.py:319-322 — an all-gather of the nonlinear-bus
    voltages) and the dim-2·H·n_nl Woodbury capacitance reduction
    (hpfx/arrow.py — an all-reduce of per-harmonic G-blocks).

    ``mesh`` may be 1-D (``harmonic_mesh``) or the harmonic axis of a 2-D
    ``hpf_mesh``.  Uneven H over the axis is handled by GSPMD padding.
    Numerically identical to ``hpf_single`` (tests/test_sharding.py).
    Retraces per call — this is the large-H·n scaling demonstrator, not
    the throughput path (that is the scenario-sharded sweep)."""
    from ..fundamental import solve_fundamental
    from ..harmonic import solve_harmonic
    from ..ybus import build_ybus, line_ybus_pair

    yspec = NamedSharding(mesh, P(HARMONIC_AXIS, None, None))
    vspec = NamedSharding(mesh, P(HARMONIC_AXIS, None))
    net = _replicate(net, mesh)
    dev_r = _replicate(devices, mesh)

    @jax.jit
    def run(net, dev):
        Y = build_ybus(net, settings)
        Y = jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(a, yspec), Y)
        lineY, lineY_f = line_ybus_pair(net, settings)
        fund = solve_fundamental(Y[0], net, settings, lineY=lineY_f)
        return solve_harmonic(Y, fund, net, dev, settings, lineY=lineY,
                              vsharding=vspec)

    return run(net, dev_r)


def hpf_sweep_sharded2d(net: Network, devices: DeviceSet,
                        settings: Settings, scenarios: Scenarios,
                        mesh: Mesh) -> HPFResult:
    """Batched HPF sweep on a 2-D scenario × harmonic mesh (DP × TP).

    Rides the lane-major trip (hpfx.lanes), whose (H, n, B) layout
    exposes both parallel axes of the problem as array axes: the batch
    axis is sharded over ``SCENARIO_AXIS`` (independent scenarios, no
    communication) and the harmonic axis over ``HARMONIC_AXIS``
    (model parallelism; collectives for the Norton cross-harmonic
    coupling and the Woodbury reduction stay inside a harmonic group).
    Build ``mesh`` with :func:`hpf_mesh`.  Requires the lanes-supported
    configuration (``Settings.solver="arrow"``, stacked DeviceSet).

    Numerically identical to the unsharded lanes sweep
    (tests/test_sharding.py); batch padded to the scenario axis,
    GSPMD-padded over harmonics."""
    from ..lanes import hpf_sweep_lanes, supports_lanes

    if not supports_lanes(devices, settings, net):
        raise ValueError("hpf_sweep_sharded2d needs the lanes-supported "
                         "configuration (arrow solver, stacked DeviceSet)")
    scenarios, B = _pad_scenarios(scenarios, mesh)
    net = _replicate(net, mesh)
    devices = _replicate(devices, mesh)
    scenarios = shard_scenarios(scenarios, mesh)
    vspec = NamedSharding(mesh, P(HARMONIC_AXIS, None, SCENARIO_AXIS))
    fn = jax.jit(partial(hpf_sweep_lanes, settings=settings,
                         vsharding=vspec))
    res = fn(net, devices, scenarios=scenarios)
    if res.V_m.shape[0] != B:
        res = jax.tree.map(lambda x: x[:B], res)
    return res


def hpf_sweep_continuation_sharded(net: Network, devices,
                                   settings: Settings,
                                   scenarios: Scenarios, mesh: Mesh,
                                   n_stages: int = 8,
                                   rescue: bool = True) -> HPFResult:
    """Device-side continuation sweep on a scenario (or scenario ×
    harmonic) mesh.

    The single-program scan continuation (:func:`hpfx.lanes.
    hpf_sweep_continuation_lanes`) with each chunk's Newton trip and the
    rescue passes sharded over ``mesh``: the chunk batch axis rides
    ``SCENARIO_AXIS`` (independent scenarios, no communication) and — on
    a 2-D ``hpf_mesh`` — the harmonic axis rides ``HARMONIC_AXIS``.  The
    one-time key sort / chunk gather is global (a prefix of the program;
    GSPMD inserts the collectives).  Numerically identical to the
    unsharded continuation sweep (tests/test_sharding.py)."""
    from ..lanes import hpf_sweep_continuation_lanes, supports_lanes

    if not supports_lanes(devices, settings, net):
        raise ValueError("hpf_sweep_continuation_sharded needs the "
                         "lanes-supported configuration (arrow solver)")
    scenarios, B = _pad_scenarios(scenarios, mesh)
    net = _replicate(net, mesh)
    devices = _replicate(devices, mesh)
    scenarios = shard_scenarios(scenarios, mesh)
    hax = HARMONIC_AXIS if HARMONIC_AXIS in mesh.axis_names else None
    vspec = NamedSharding(mesh, P(hax, None, SCENARIO_AXIS))
    fn = jax.jit(partial(hpf_sweep_continuation_lanes, settings=settings,
                         n_stages=n_stages, rescue=rescue,
                         vsharding=vspec))
    res = fn(net, devices, scenarios=scenarios)
    if res.V_m.shape[0] != B:
        res = jax.tree.map(lambda x: x[:B], res)
    return res


def hpf_sweep_adaptive_sharded(net: Network, devices,
                               settings: Settings,
                               scenarios: Scenarios, mesh: Mesh,
                               phase_iters: int = 24,
                               rescue_width=None,
                               warm: str = "cold") -> HPFResult:
    """Single-program adaptive sweep on a scenario (or scenario ×
    harmonic) mesh.

    :func:`hpfx.lanes.hpf_sweep_adaptive_lanes` — phase-capped trip,
    gathered warm straggler rescue, cold knife-edge restart, all one
    compiled program — with every Newton trip sharded over ``mesh``:
    the batch axis rides ``SCENARIO_AXIS`` and, on a 2-D ``hpf_mesh``,
    the harmonic axis rides ``HARMONIC_AXIS``.  The straggler gather
    (argsort over the convergence mask + take) is global; GSPMD inserts
    the collectives.  Numerically identical to the unsharded program
    (tests/test_sharding.py)."""
    from ..lanes import hpf_sweep_adaptive_lanes, supports_lanes

    if not supports_lanes(devices, settings, net):
        raise ValueError("hpf_sweep_adaptive_sharded needs the "
                         "lanes-supported configuration (arrow solver)")
    scenarios, B = _pad_scenarios(scenarios, mesh)
    net = _replicate(net, mesh)
    devices = _replicate(devices, mesh)
    scenarios = shard_scenarios(scenarios, mesh)
    hax = HARMONIC_AXIS if HARMONIC_AXIS in mesh.axis_names else None
    vspec = NamedSharding(mesh, P(hax, None, SCENARIO_AXIS))
    fn = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=settings,
                         phase_iters=phase_iters,
                         rescue_width=rescue_width, vsharding=vspec,
                         warm=warm))
    res = fn(net, devices, scenarios=scenarios)
    if res.V_m.shape[0] != B:
        res = jax.tree.map(lambda x: x[:B], res)
    return res


def hosting_capacity_sharded(net: Network, devices: DeviceSet,
                             settings: Settings, scenarios: Scenarios,
                             mesh: Mesh, thd_limit: float = 0.08
                             ) -> SweepSummary:
    """Sharded Monte-Carlo hosting-capacity sweep.

    Per-scenario outputs stay sharded; the over-limit fraction is a global
    mean XLA lowers to a cross-device all-reduce.  Non-mesh-divisible batches are
    padded; padding is masked out of the aggregate and sliced off the
    per-scenario outputs.
    """
    scenarios, B = _pad_scenarios(scenarios, mesh)
    net = _replicate(net, mesh)
    devices = _replicate(devices, mesh)
    Bp = scenarios.batch
    scenarios = shard_scenarios(scenarios, mesh)
    fn = jax.jit(
        partial(hosting_capacity_sweep_unjitted,
                settings=settings, thd_limit=thd_limit,
                valid_count=B if Bp != B else None),
        out_shardings=(
            SweepSummary(
                max_thd_f=NamedSharding(mesh, P(SCENARIO_AXIS)),
                converged=NamedSharding(mesh, P(SCENARIO_AXIS)),
                n_iter=NamedSharding(mesh, P(SCENARIO_AXIS)),
                frac_over_limit=NamedSharding(mesh, P()),
            )))
    out = fn(net, devices, scenarios=scenarios)
    if Bp != B:
        out = SweepSummary(out.max_thd_f[:B], out.converged[:B],
                           out.n_iter[:B], out.frac_over_limit)
    return out
