"""Batched scenario solving: vmap over the scenario axis.

The reference is a strictly single-case solver (SURVEY §2.6: no parallelism
of any kind exists there).  This module adds the scaling story: ``vmap``
batches whole HPF solves over a scenario axis (load scaling,
device-penetration scaling) so thousands of coupled-NR solves run as one
XLA program of batched contractions and batched LU solves.

Convergence isolation: JAX's ``while_loop`` batching rule predicates the
carry per batch element, so each scenario iterates exactly as it would
serially and a diverged scenario cannot poison the batch (it just saturates
at max_iter with its own error; see HPFResult.converged).

The admittance tensor depends only on lines/shunts, not on loads or devices,
so it is built once outside the vmap and shared by every scenario.
"""
from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .config import Settings
from .devices import DeviceSet
from .fundamental import solve_fundamental
from .harmonic import HPFResult, solve_harmonic
from .network import Network
from .ops.dispatch import auto_layout
from .results import get_thd
from .utils.precision import highest_precision
from .ybus import build_ybus, line_ybus_pair, resolve_ybus


class Scenarios(NamedTuple):
    """Per-scenario multipliers over a batch of B cases.

    - ``p_scale``/``q_scale`` (B,) or (B, n): bus active/reactive load
      scaling (scalar per scenario or per bus),
    - ``injection_scale`` (B,) or (B, n_nl): nonlinear-device Norton
      scaling — scalar per scenario (lockstep penetration) or per device
      (each nonlinear bus at its own penetration level, the real
      hosting-capacity Monte-Carlo axis),
    - ``device_mix`` (B, n_nl, T): per-bus blend weights over the T device
      types of a :class:`hpfx.devices.DeviceLibrary` (which EV/SMPS model
      sits at which bus, at what count); requires passing a DeviceLibrary
      as the sweep's ``devices``.  Composes with ``injection_scale``
      (mix first, then scale).
    """
    p_scale: jnp.ndarray
    q_scale: Optional[jnp.ndarray] = None
    injection_scale: Optional[jnp.ndarray] = None
    device_mix: Optional[jnp.ndarray] = None

    @property
    def batch(self) -> int:
        return self.p_scale.shape[0]

    @staticmethod
    def uniform(b: int, dtype=jnp.float32) -> "Scenarios":
        one = jnp.ones((b,), dtype)
        return Scenarios(one, one, one)


def _expand(scale, like):
    """Broadcast a scalar/per-bus multiplier against a (n,)-shaped field."""
    s = jnp.asarray(scale, like.dtype)
    return s if s.ndim else s[None]


def _solve_scenario(Y, net: Network, devices, settings: Settings,
                    p_scale, q_scale, inj_scale, mix=None, V0=None,
                    lineY=None, lineY_f=None, I_bg=None) -> HPFResult:
    net_s = dataclasses.replace(
        net,
        bus_P=net.bus_P * _expand(p_scale, net.bus_P),
        bus_Q=net.bus_Q * _expand(q_scale, net.bus_Q))
    if mix is not None:                # DeviceLibrary + per-bus blend
        devices = devices.mixed(mix)
    dev_s = devices.scale(inj_scale)   # DeviceSet or AnalyticDeviceSet
    fund = solve_fundamental(Y[0], net_s, settings, lineY=lineY_f)
    return solve_harmonic(Y, fund, net_s, dev_s, settings, V0=V0,
                          lineY=lineY, I_bg=I_bg)


def uses_lanes(devices, settings: Settings, net: Network) -> bool:
    """Whether a sweep of this configuration runs on the lane-major
    layout: ``Settings.layout`` ("auto" resolves through
    :func:`hpfx.ops.auto_layout` for the traced backend) and the
    configurations hpfx.lanes supports."""
    from .lanes import supports_lanes
    layout = settings.layout
    if layout == "auto":
        layout = auto_layout(jax.default_backend())
    return layout == "lanes" and supports_lanes(devices, settings, net)


@highest_precision
def hpf_sweep_unjitted(net: Network, devices, settings: Settings,
                       scenarios: Scenarios, V0=None, Y=None,
                       I_bg=None) -> HPFResult:
    """Unjitted body of :func:`hpf_sweep` — the structured entry point for
    callers that need their own ``jax.jit`` wrapping (hpfx.parallel wraps
    it with mesh ``out_shardings``).  Call :func:`hpf_sweep` otherwise.

    Solve B independent HPF cases in one compiled program.

    Returns an HPFResult whose leaves carry a leading batch dimension.
    ``devices``: a DeviceSet / AnalyticDeviceSet, or a
    :class:`hpfx.devices.DeviceLibrary` when ``scenarios.device_mix``
    carries per-bus type blends.  ``V0``: optional batched (V_m, V_a) warm
    starts.  ``Y``: optional precomputed admittance tensor overriding
    ``build_ybus`` (the Kron-reduced sweep path, where the dense reduced
    blocks replace the line-built ones).  ``I_bg``: optional
    PER-SCENARIO background injections, a split-complex (B, H, n) batch
    (hpfx.background) — batched background-distortion studies ride the
    full sweep/rescue machinery this way (threaded through BOTH layouts;
    the lanes fast path carries it (H, n, B) like the voltage state).
    """
    from .devices import DeviceLibrary
    from .lanes import hpf_sweep_lanes
    mix = scenarios.device_mix
    if (mix is not None) != isinstance(devices, DeviceLibrary):
        raise ValueError(
            "Scenarios.device_mix requires passing a DeviceLibrary as "
            "devices (and a DeviceLibrary requires a device_mix to assign "
            "types to buses)")
    if uses_lanes(devices, settings, net):
        # lane-major fast path: batch carried on the last (lane) axis
        # through the whole trip (see hpfx.lanes) — identical iteration
        return hpf_sweep_lanes(net, devices, settings, scenarios,
                               V0=V0, Y=Y, I_bg=I_bg)

    # a dense Y override (Kron-reduced blocks) gets the reference-form
    # dense mismatch — the line structure belongs to the network it was
    # NOT built from; a (Y, lineY, lineY_f) triple (sequence_structures)
    # carries its own consistent structures
    Y, lineY, lineY_f = resolve_ybus(net, settings, Y)
    q = scenarios.q_scale if scenarios.q_scale is not None \
        else scenarios.p_scale
    inj = scenarios.injection_scale if scenarios.injection_scale is not None \
        else jnp.ones((scenarios.batch,), scenarios.p_scale.dtype)
    vm = None if V0 is None else V0[0]
    va = None if V0 is None else V0[1]
    ax = lambda x: None if x is None else 0
    return jax.vmap(
        lambda p, qq, i, mx, vm_, va_, bg: _solve_scenario(
            Y, net, devices, settings, p, qq, i, mix=mx,
            V0=None if vm_ is None else (vm_, va_),
            lineY=lineY, lineY_f=lineY_f, I_bg=bg),
        in_axes=(0, 0, 0, ax(mix), ax(vm), ax(va), ax(I_bg)),
    )(scenarios.p_scale, q, inj, mix, vm, va, I_bg)


hpf_sweep = partial(jax.jit, static_argnames=("settings",))(
    hpf_sweep_unjitted)


def _take_scen(scenarios: Scenarios, idx) -> Scenarios:
    return Scenarios(*(None if x is None else jnp.asarray(x)[idx]
                       for x in scenarios))


def _to64(tree):
    """Cast every floating leaf of a pytree to f64 (ints/bools kept),
    through the host so the f64 arrays are made under x64."""
    import numpy as np

    def cast(x):
        a = np.asarray(x)
        return jnp.asarray(a.astype(np.float64) if a.dtype.kind == "f"
                           else a)

    return jax.tree.map(cast, tree)


def _f64_resolve(net: Network, devices, settings: Settings,
                 sub: Scenarios, Y=None, I_bg=None) -> HPFResult:
    """Re-solve a (small) scenario subset cold in f64 on the default
    device.

    The knife-edge f32 class (PERF.md, numerics history) converges in
    f64 on the same draws — so the last rescue resort is simply more
    precision.  Runs under ``jax.enable_x64``, then returns the result
    cast back to the caller's dtype; ``converged`` reflects the f64
    criterion (thresh_h on the true residual — strictly stronger
    evidence than the f32 floor-aware test).  Intended for O(1..10)
    stragglers."""
    import numpy as np

    s64 = settings.with_(dtype="float64")
    with jax.enable_x64():
        r = hpf_sweep(_to64(net), _to64(devices), s64, _to64(sub),
                      Y=None if Y is None else _to64(Y),
                      I_bg=None if I_bg is None else _to64(I_bg))
        r = jax.tree.map(np.asarray, r)
    rd = settings.real_dtype

    def back(x):
        a = np.asarray(x)
        return jnp.asarray(a.astype(rd) if a.dtype.kind == "f" else a)

    return jax.tree.map(back, r)


def _rescue_sweep(settings: Settings, scenarios: Scenarios, out: HPFResult,
                  run, run64=None, take=None) -> HPFResult:
    """Deterministic straggler rescue shared by the adaptive and
    continuation sweeps: re-solve scenarios left unconverged with a fresh
    iteration budget, in two passes —

      1. warm-started from the scenario's OWN final state: round 2
         measured that this self-warm-start breaks the oscillation/
         floor-hover stalls of hard scenarios, where a cold repeat just
         reproduces the stall (PERF.md, numerics history).  Scenarios
         whose state went non-finite (true divergence) get the flat start
         instead — their own state would no-op the re-solve at iter 0;
      2. cold flat restart for anything STILL stuck — the complementary
         failure, a stall caused by a bad warm seed (mirrors the second
         rescue pass of hpfx.lanes.hpf_sweep_continuation_lanes).

    Bucketed to a power of two (padding with duplicates of the first
    straggler) for call-count-independent shapes, like the adaptive
    sweep's phase 2.  ``run(sub_scenarios, V0)`` must return an HPFResult
    with err_hist width == settings.max_iter_h.

    ``run64``: optional third pass — anything surviving BOTH passes (the
    knife-edge f32 class (PERF.md, numerics history), whose convergence is decided by
    batch-composition fp noise) is re-solved cold in f64 via this
    callable (``run64(sub_scenarios) -> HPFResult``; see
    :func:`_f64_resolve`).  The merged ``converged`` then reflects the
    f64 criterion for those rows.  ``take``: index->subset function for
    the batch carrier (defaults to Scenarios slicing) so non-Scenarios
    sweeps (e.g. background-injection batches) reuse this rescue.
    """
    import numpy as np

    if take is None:
        take = lambda idx: _take_scen(scenarios, idx)  # noqa: E731

    def _merge(out, idx, res_r):
        return out._replace(
            V_m=out.V_m.at[idx].set(res_r.V_m),
            V_a=out.V_a.at[idx].set(res_r.V_a),
            err=out.err.at[idx].set(res_r.err),
            n_iter=out.n_iter.at[idx].set(out.n_iter[idx] + res_r.n_iter),
            err_hist=out.err_hist.at[idx].set(res_r.err_hist),
            converged=out.converged.at[idx].set(res_r.converged))

    B = out.V_m.shape[0]
    rd = settings.real_dtype
    flat_m = jnp.full(out.V_m.shape[1:], settings.v_init_h, rd) \
        .at[0].set(settings.v_init_f)
    flat_a = jnp.full(out.V_a.shape[1:], settings.a_init_h, rd) \
        .at[0].set(settings.a_init_f)
    for use_self in (True, False):
        pend = np.where(~np.asarray(out.converged))[0]
        if pend.size == 0:
            return out
        bucket = min(1 << (int(pend.size) - 1).bit_length(), B)
        pend_p = np.concatenate(
            [pend, np.full(bucket - pend.size, pend[0], pend.dtype)])
        sub = take(pend_p)
        idx = jnp.asarray(pend_p)
        if use_self:
            Vm0, Va0 = out.V_m[idx], out.V_a[idx]
            finite = (jnp.isfinite(Vm0).all(axis=(1, 2))
                      & jnp.isfinite(Va0).all(axis=(1, 2)))
            Vm0 = jnp.where(finite[:, None, None], Vm0, flat_m)
            Va0 = jnp.where(finite[:, None, None], Va0, flat_a)
        else:
            Vm0 = jnp.broadcast_to(flat_m, (bucket,) + flat_m.shape)
            Va0 = jnp.broadcast_to(flat_a, (bucket,) + flat_a.shape)
        out = _merge(out, idx, run(sub, (Vm0, Va0)))
    if run64 is not None \
            and jnp.dtype(settings.real_dtype) != jnp.dtype(np.float64):
        pend = np.where(~np.asarray(out.converged))[0]
        if pend.size:
            # bucket like the passes above so the f64 program
            # compiles once per power-of-two straggler count
            bucket = min(1 << (int(pend.size) - 1).bit_length(), B)
            pend_p = np.concatenate(
                [pend, np.full(bucket - pend.size, pend[0], pend.dtype)])
            out = _merge(out, jnp.asarray(pend_p), run64(take(pend_p)))
    return out


def hpf_sweep_adaptive(net: Network, devices, settings: Settings,
                       scenarios: Scenarios, phase_iters: int = 16,
                       phase2_settings: Optional[Settings] = None,
                       V0=None, rescue: bool = True, Y=None,
                       warm: str = "cold", I_bg=None) -> HPFResult:
    """Two-phase sweep that avoids straggler lockstep.

    The batched while-loop runs every scenario until the *slowest* one
    stops, so a few hard scenarios make the whole batch pay max_iter_h
    trips.  Phase 1 caps iterations at ``phase_iters`` (above the typical
    count); phase 2 re-solves only the unconverged scenarios, warm-started
    from their phase-1 states, for the remaining budget.  Solutions are
    identical to the plain sweep (same fixed points; per-scenario iteration
    totals are preserved in n_iter).  Host-driven: not jittable as a whole,
    but each phase is one compiled program.

    ``phase2_settings``: optional settings override for the re-solve phase
    (e.g. phase 1 on the fast structured ``solver="arrow"``, stragglers on
    the dense solver, whose f32 Newton steps are sturdier).

    ``rescue`` (default on): scenarios still unconverged after phase 2 —
    the knife-edge f32 class whose convergence depends on batch
    composition (PERF.md, numerics history) — get the deterministic two-pass rescue
    of :func:`_rescue_sweep` (self-warm-start, then cold restart), each
    with a fresh iteration budget.

    ``Y``: admittance override forwarded to every phase's ``hpf_sweep``
    (dense Cx or a (Y, lineY, lineY_f) triple — see
    :func:`hpfx.ybus.resolve_ybus`; damped/sequence-aware systems ride
    the adaptive schedule this way).

    ``I_bg``: optional per-scenario (B, H, n) background injections
    (hpfx.background) — every phase and rescue pass (f64 fallback
    included) threads the matching rows, so batched background studies
    get the same deterministic-convergence contract as plain sweeps.
    """
    import numpy as np

    def _bg_take(idx):
        return jax.tree.map(lambda x: x[jnp.asarray(idx)], I_bg)

    def take(idx):
        sub = _take_scen(scenarios, idx)
        return (sub, _bg_take(idx)) if I_bg is not None else sub

    def _unpack(subt):
        return subt if I_bg is not None else (subt, None)

    def run_r(subt, V0_):
        sub, bg = _unpack(subt)
        return hpf_sweep(net, devices, settings, sub, V0=V0_, Y=Y,
                         I_bg=bg)

    def run64(subt):
        sub, bg = _unpack(subt)
        return _f64_resolve(net, devices, settings, sub, Y=Y, I_bg=bg)

    if V0 is None and warm == "linear":
        if I_bg is not None:
            raise ValueError("warm='linear' with a batched I_bg is not "
                             "supported — pass V0 explicitly or use the "
                             "cold start")
        # exact-linear Norton seed (hpfx.warmstart) as the phase-1 start;
        # the rescue passes keep their flat-restart semantics
        from .warmstart import norton_warm_start
        V0 = norton_warm_start(net, devices, settings, scenarios, Y=Y)

    s1 = settings.with_(max_iter_h=min(phase_iters, settings.max_iter_h))
    r1 = hpf_sweep(net, devices, s1, scenarios, V0=V0, Y=Y, I_bg=I_bg)
    pending = np.where(~np.asarray(r1.converged))[0]
    if pending.size == 0 or s1.max_iter_h == settings.max_iter_h:
        if s1.max_iter_h < settings.max_iter_h:
            # NaN-pad histories to the full width the caller asked for
            B = r1.err_hist.shape[0]
            hist = jnp.full((B, settings.max_iter_h), jnp.nan,
                            r1.err_hist.dtype)
            r1 = r1._replace(err_hist=hist.at[:, : s1.max_iter_h]
                             .set(r1.err_hist))
        if rescue and pending.size:
            r1 = _rescue_sweep(settings, scenarios, r1, run_r,
                               run64=run64, take=take)
        return r1

    # bucket the re-solve batch to the next power of two (padding with
    # duplicates of the first straggler): the pending count is data-
    # dependent, and exact-size phase-2/merge programs would recompile on
    # every new scenario set — each a multi-second compile that dwarfs
    # the solve itself.  The padded index is used for
    # the merge too (duplicates scatter identical rows), so every op below
    # has call-count-independent shapes and compiles exactly once.
    n_pend = pending.size
    bucket = min(1 << (n_pend - 1).bit_length(), r1.V_m.shape[0])
    pend_p = np.concatenate(
        [pending, np.full(bucket - n_pend, pending[0], pending.dtype)])
    sub = Scenarios(*(None if x is None else jnp.asarray(x)[pend_p]
                      for x in scenarios))
    V0 = (r1.V_m[pend_p], r1.V_a[pend_p])
    base2 = settings if phase2_settings is None else phase2_settings
    s2 = base2.with_(max_iter_h=settings.max_iter_h - s1.max_iter_h)
    r2 = hpf_sweep(net, devices, s2, sub, V0=V0, Y=Y,
                   I_bg=None if I_bg is None else _bg_take(pend_p))

    idx = jnp.asarray(pend_p)
    # full-width residual histories: phase-1 rows NaN-padded to max_iter_h;
    # re-solved scenarios (which by construction ran all phase_iters trips)
    # get their phase-2 history spliced in at the phase-1 offset, so
    # err_hist semantics match the plain sweep's (err after trip i at [i])
    B = r1.err_hist.shape[0]
    hist = jnp.full((B, settings.max_iter_h), jnp.nan, r1.err_hist.dtype)
    hist = hist.at[:, : s1.max_iter_h].set(r1.err_hist)
    hist = hist.at[idx, s1.max_iter_h:].set(r2.err_hist)
    merged = HPFResult(
        V_m=r1.V_m.at[idx].set(r2.V_m),
        V_a=r1.V_a.at[idx].set(r2.V_a),
        err=r1.err.at[idx].set(r2.err),
        n_iter=r1.n_iter.at[idx].set(r1.n_iter[idx] + r2.n_iter),
        err_hist=hist,
        converged=r1.converged.at[idx].set(r2.converged),
        fund=r1.fund)
    if rescue:
        merged = _rescue_sweep(settings, scenarios, merged, run_r,
                               run64=run64, take=take)
    return merged


@functools.lru_cache(maxsize=64)
def _device_program(settings: Settings, phase_iters: int, warm: str,
                    rescue_width):
    """Memoized jit wrapper for the device-side adaptive program.

    A fresh ``jax.jit(partial(...))`` per call would RE-TRACE the whole
    lanes program every invocation (jit caches by callable identity);
    the lru_cache keys on the static knobs so repeat calls share one
    traced program."""
    from .lanes import hpf_sweep_adaptive_lanes
    return jax.jit(partial(hpf_sweep_adaptive_lanes, settings=settings,
                           phase_iters=phase_iters, warm=warm,
                           rescue_width=rescue_width))


def hpf_sweep_device(net: Network, devices, settings: Settings,
                     scenarios: Scenarios, phase_iters: int = 16,
                     jitted=None, rescue: bool = True,
                     warm: str = "cold",
                     rescue_width=None, I_bg=None) -> HPFResult:
    """Single-program device-side adaptive sweep with a host-side
    deterministic straggler rescue.

    Runs :func:`hpfx.lanes.hpf_sweep_adaptive_lanes` — phase-capped trip,
    gathered warm straggler re-solve, cold knife-edge restart, all inside
    ONE compiled program (no host round-trip between phases) — then
    applies the same two-pass
    :func:`_rescue_sweep` the host schedule uses, but ONLY when lanes
    remain unconverged (static ``rescue_width`` gather overflow, or the
    knife-edge f32 class).  The rescue costs one small
    mask transfer per sweep and no dispatch at all when everything
    converged, so the fast path keeps the single-program speed while the
    result contract (deterministic conv) matches the host schedule.

    ``jitted``: optional pre-jitted adaptive-lanes program (so callers
    timing repeated sweeps share one cache entry); must accept
    ``(net, devices, scenarios=...)``.

    ``warm="linear"``: compute the exact-linear Norton seed
    (hpfx.warmstart) IN-PROGRAM as the phase-1 initial state — one
    (H−1)·n block solve per lane replaces most of the Newton trips
    (f64: 10-21 trips → 3 on net2/net3 at every harmonic depth); the
    floor-aware threshold and the knife-edge cold-restart rescue keep
    using the cold state.

    ``rescue_width``: forwarded to the lanes program — an int overrides
    the static gather width, a TUPLE enables bucketed widths
    (lax.switch to the smallest covering bucket), the device-only
    answer for straggler-heavy configs (net1-class batches can leave
    more stragglers than the 128-lane default).
    """
    import numpy as np

    if jitted is None:
        if rescue_width is not None and isinstance(rescue_width, list):
            rescue_width = tuple(rescue_width)
        jitted = _device_program(settings, phase_iters, warm,
                                 rescue_width)
    elif warm != "cold":
        import warnings
        warnings.warn(
            "hpf_sweep_device: `warm` is baked into the compiled program "
            "— a caller-supplied `jitted` takes precedence and this "
            "warm=%r is ignored; bake warm= into the jitted partial"
            % warm, stacklevel=2)
    if I_bg is None:
        out = jitted(net, devices, scenarios=scenarios)
    else:
        out = jitted(net, devices, scenarios=scenarios, I_bg=I_bg)
    if rescue and not bool(np.asarray(out.converged).all()):
        def take(idx):
            sub = _take_scen(scenarios, idx)
            if I_bg is None:
                return sub
            return (sub, jax.tree.map(lambda x: x[jnp.asarray(idx)],
                                      I_bg))

        def unpack(subt):
            return subt if I_bg is not None else (subt, None)

        out = _rescue_sweep(
            settings, scenarios, out,
            lambda subt, V0_: hpf_sweep(net, devices, settings,
                                        unpack(subt)[0], V0=V0_,
                                        I_bg=unpack(subt)[1]),
            run64=lambda subt: _f64_resolve(net, devices, settings,
                                            unpack(subt)[0],
                                            I_bg=unpack(subt)[1]),
            take=take)
    return out


def hpf_sweep_stream(net: Network, devices, settings: Settings,
                     scenario_batches, phase_iters: int = 16,
                     depth: int = 2, rescue: bool = True, jitted=None,
                     warm: str = "cold"):
    """Pipelined sweep executor: generator over scenario batches that
    keeps ``depth`` sweeps in flight on the device queue.

    The single-sweep drivers pay their host-side cost — scenario
    construction/upload, program dispatch, result download, straggler
    rescue — *serially* with device compute.  For a sustained scenario stream (hosting-capacity Monte-Carlo, grid
    screening services) that gap is avoidable: JAX dispatch is
    asynchronous, so enqueueing sweep ``k+1`` (and pulling batch ``k+2``
    from the iterator, which is where the caller builds/uploads its
    scenario arrays) *before* materializing sweep ``k``'s result hides
    the host work under the previous batch's device compute — classic
    double buffering, no new compiled programs.

    - ``scenario_batches``: iterable of :class:`Scenarios`; all batches
      must share shapes/dtypes (one compiled program).  Generators are
      ideal — their per-batch host work lands inside the pipeline.
    - ``depth``: sweeps in flight (1 = no overlap; 2 = double buffering,
      default).  Memory holds ``depth + 1`` result pytrees.
    - Yields per-batch :class:`HPFResult` in input order, each with the
      same deterministic-convergence contract as
      :func:`hpf_sweep_device` (the host rescue runs, when lanes remain
      unconverged, at dequeue time — its extra dispatches simply join
      the device queue behind the already-enqueued sweeps).

    The reference is strictly single-case (SURVEY §2.6); this is the
    serving-throughput counterpart of its timed driver loop
    (hcne_generalized.py:609-620).
    """
    import collections

    import numpy as np

    if jitted is None:
        jitted = _device_program(settings, phase_iters, warm, None)
    elif warm != "cold":
        import warnings
        warnings.warn(
            "hpf_sweep_stream: `warm` is baked into the compiled program "
            "— a caller-supplied `jitted` takes precedence and this "
            "warm=%r is ignored; bake warm= into the jitted partial"
            % warm, stacklevel=2)
    depth = max(1, int(depth))

    def _finish(sc, out):
        if rescue and not bool(np.asarray(out.converged).all()):
            out = _rescue_sweep(
                settings, sc, out,
                lambda sub, V0_: hpf_sweep(net, devices, settings, sub,
                                           V0=V0_),
                run64=lambda sub: _f64_resolve(net, devices, settings,
                                               sub))
        # wait for the voltages so a consumer's timing of this generator
        # measures completed work, not enqueued work
        out.V_m.block_until_ready()
        return out

    inflight = collections.deque()
    for sc in scenario_batches:
        inflight.append((sc, jitted(net, devices, scenarios=sc)))
        if len(inflight) > depth:
            yield _finish(*inflight.popleft())
    while inflight:
        yield _finish(*inflight.popleft())


def hpf_sweep_continuation(net: Network, devices, settings: Settings,
                           scenarios: Scenarios, n_stages: int = 4,
                           key=None, phase_iters: Optional[int] = None,
                           phase2_settings: Optional[Settings] = None,
                           rescue: bool = True) -> HPFResult:
    """Warm-start continuation sweep: solve the scenario grid in stages
    ordered by a continuation key, seeding every stage from the nearest
    already-solved neighbor.

    The plain lockstep sweep pays two costs on wide scenario grids: every
    scenario cold-starts from the 0.1-pu flat start (hcne_generalized.py
    :183), and the batched while-loop runs until the *slowest* scenario
    stops.  Warm starts are known to break straggler oscillation
    (PERF.md, numerics history); this exploits them proactively: scenarios are
    sorted by ``key`` (default: the mean injection scale, the axis that
    moves the harmonic solution most), split into ``n_stages`` equal
    chunks, and each chunk's scenarios start from the solved state of the
    nearest-key scenario of the previous chunks.  Each stage is the same
    compiled ``hpf_sweep`` program (uniform chunk shapes; one compile).

    Solutions are the same fixed points as the plain sweep's (warm starts
    change the path, not the root).  Knife-edge f32 scenarios can stall
    hovering at the evaluation floor in one batch composition and pass in
    another (measured: net1 f32 B=64 spread, 2/64 — the same class as the
    plain sweep's own conv<1 runs); ``rescue`` (default on) re-solves any
    scenario unconverged after its stage, warm-started from its own final
    state — the adaptive sweep's straggler mechanism, measured in round 2
    to break oscillation/floor-hover stalls a cold repeat reproduces.
    ``phase_iters``: optionally run each stage through
    :func:`hpf_sweep_adaptive` with this phase-1 budget.  Host-driven
    like the adaptive sweep.
    """
    import numpy as np

    B = scenarios.batch
    n_stages = max(1, min(n_stages, B))
    if key is None:
        if scenarios.injection_scale is not None:
            k = np.asarray(scenarios.injection_scale, np.float64)
            key = k if k.ndim == 1 else k.mean(axis=1)
        elif scenarios.device_mix is not None:
            # total installed device weight — the natural continuation
            # axis of a device-mix Monte-Carlo
            key = np.asarray(scenarios.device_mix,
                             np.float64).sum(axis=(1, 2))
        else:
            key = np.asarray(scenarios.p_scale, np.float64)
            key = key if key.ndim == 1 else key.mean(axis=1)
    key = np.asarray(key, np.float64)
    order = np.argsort(key, kind="stable")

    # uniform chunk size (one compile); pad the last chunk with repeats
    Bc = -(-B // n_stages)
    pad = n_stages * Bc - B
    order_p = np.concatenate([order, np.repeat(order[-1:], pad)])
    chunks = order_p.reshape(n_stages, Bc)

    def run(sub, V0):
        if phase_iters is not None:
            # rescue=False: the continuation does one rescue over the
            # merged result instead of one per stage
            return hpf_sweep_adaptive(net, devices, settings, sub,
                                      phase_iters=phase_iters, V0=V0,
                                      phase2_settings=phase2_settings,
                                      rescue=False)
        if V0 is not None:
            return hpf_sweep(net, devices, settings, sub, V0=V0)
        return hpf_sweep(net, devices, settings, sub)

    solved_keys: list = []
    solved_Vm: list = []
    solved_Va: list = []
    parts = []
    for si in range(n_stages):
        idx = chunks[si]
        sub = _take_scen(scenarios, idx)
        V0 = None
        if solved_keys:
            sk = np.concatenate(solved_keys)
            sVm = jnp.concatenate(solved_Vm, axis=0)
            sVa = jnp.concatenate(solved_Va, axis=0)
            near = np.abs(key[idx][:, None] - sk[None, :]).argmin(axis=1)
            V0 = (sVm[near], sVa[near])
        res = run(sub, V0)
        parts.append(res)
        # only CONVERGED (finite) states may seed later stages: a diverged
        # scenario's NaN/runaway state as a warm start fails its whole
        # key-neighborhood instantly (a NaN V0 makes the NR active mask
        # false at iteration 0)
        good = np.asarray(res.converged)
        if good.any():
            gi = jnp.asarray(np.nonzero(good)[0])
            solved_keys.append(key[idx][good])
            solved_Vm.append(res.V_m[gi])
            solved_Va.append(res.V_a[gi])

    # merge back to the original order (drop padding duplicates)
    merged = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0),
                          *[p._replace(fund=None) for p in parts])
    flat_idx = chunks.reshape(-1)
    keep_first = np.zeros(len(flat_idx), bool)
    seen = set()
    for i, b in enumerate(flat_idx):
        if b not in seen:
            keep_first[i] = True
            seen.add(b)
    rows = np.nonzero(keep_first)[0]
    inv = flat_idx[rows]
    out = jax.tree.map(lambda x: jnp.zeros((B,) + x.shape[1:], x.dtype)
                       .at[jnp.asarray(inv)].set(x[jnp.asarray(rows)]),
                       merged)
    if not rescue:
        return out

    # deterministic straggler rescue (shared with hpf_sweep_adaptive):
    # self-warm-start pass then cold-restart pass, then the f64
    # knife-edge fallback, see _rescue_sweep.  Stage-level adaptive
    # rescue is disabled inside `run` (the merged result gets this one
    # rescue instead).
    return _rescue_sweep(settings, scenarios, out, run,
                         run64=lambda sub: _f64_resolve(
                             net, devices, settings, sub))


@partial(jax.jit, static_argnames=("settings",))
def hpf_single(net: Network, devices: DeviceSet,
               settings: Settings, I_bg=None) -> HPFResult:
    """Jitted single-case HPF (compiled once per (settings, net-structure)).

    ``I_bg``: optional (H, n) background-distortion injections
    (hpfx.background) — a distorted upstream grid superposed on the
    installation's own emissions."""
    Y = build_ybus(net, settings)
    lineY, lineY_f = line_ybus_pair(net, settings)
    fund = solve_fundamental(Y[0], net, settings, lineY=lineY_f)
    return solve_harmonic(Y, fund, net, devices, settings, lineY=lineY,
                          I_bg=I_bg)


class SweepSummary(NamedTuple):
    max_thd_f: jnp.ndarray     # (B,) worst-bus THD_F per scenario
    converged: jnp.ndarray     # (B,) bool
    n_iter: jnp.ndarray        # (B,)
    frac_over_limit: jnp.ndarray  # scalar


def hosting_capacity_sweep_unjitted(
        net: Network, devices, settings: Settings, scenarios: Scenarios,
        thd_limit: float = 0.08,
        valid_count: Optional[int] = None) -> SweepSummary:
    """Unjitted body of :func:`hosting_capacity_sweep` (structured entry
    point for hpfx.parallel's mesh-sharded jit wrapping).

    Monte-Carlo hosting-capacity style sweep: batched HPF + THD screen.

    Reduces the batch to the fraction of scenarios whose worst-bus THD_F
    exceeds ``thd_limit`` — the aggregate that rides a cross-device
    all-reduce when the scenario axis is sharded over a mesh (see
    hpfx.parallel).

    ``valid_count``: when the batch was padded up to a mesh-divisible size
    (hpfx.parallel.hpf_sweep_sharded), only the first ``valid_count``
    scenarios enter the aggregate.
    """
    res = hpf_sweep_unjitted(net, devices, settings, scenarios)
    thd = jax.vmap(get_thd)(res.V_m)
    max_thd = jnp.max(thd.THD_F, axis=-1)
    over = (max_thd > thd_limit) & res.converged
    B = max_thd.shape[0]
    nv = B if valid_count is None else valid_count
    w = (jnp.arange(B) < nv).astype(max_thd.dtype)
    frac = jnp.sum(over.astype(max_thd.dtype) * w) / nv
    return SweepSummary(max_thd, res.converged, res.n_iter, frac)


hosting_capacity_sweep = partial(
    jax.jit, static_argnames=("settings", "thd_limit", "valid_count"))(
    hosting_capacity_sweep_unjitted)


def summarize_thd(result: HPFResult, thd_limit: float = 0.08) -> SweepSummary:
    """The hosting-capacity aggregate for an already-solved batched
    result — lets host-driven sweeps (hpf_sweep_adaptive,
    hpf_sweep_continuation) reuse the same THD screen as
    :func:`hosting_capacity_sweep`."""
    thd = jax.vmap(get_thd)(result.V_m)
    max_thd = jnp.max(thd.THD_F, axis=-1)
    over = (max_thd > thd_limit) & result.converged
    frac = jnp.mean(over.astype(max_thd.dtype))
    return SweepSummary(max_thd, result.converged, result.n_iter, frac)


def hpf_sweep_kron(net: Network, devices: DeviceSet, settings: Settings,
                   scenarios: Scenarios) -> HPFResult:
    """Batched sweep with automatic Kron reduction of passive buses.

    Passive buses (PQ, zero load, no shunt, no device) are Schur-
    complemented out of every harmonic admittance block before solving
    (hpfx.kron) — the Newton dimension 2·H·n-1-c shrinks by 2·H per
    eliminated bus with an *identical* solution on the kept buses; the
    eliminated buses' voltages are recovered algebraically afterwards, so
    the returned HPFResult is full-size and directly comparable.

    Host-side dispatch: with no passive buses this is exactly
    ``hpf_sweep``.  The reduced admittance blocks are dense (no line
    structure), so the reduced solve always uses the reference-form
    mismatch (``stable_mismatch`` is ignored on this path); Y·V scales
    shrink under reduction, which is itself good for the f32 floor.
    """
    from .kron import expand_voltages, kron_reduce, passive_buses

    elim = passive_buses(net)
    if elim.size == 0:
        return hpf_sweep(net, devices, settings=settings,
                         scenarios=scenarios)
    red = kron_reduce(net, settings)
    s_red = settings.with_(stable_mismatch=False)
    res = hpf_sweep(red.net, devices, settings=s_red, scenarios=scenarios,
                    Y=red.Y)
    # batched recovery of eliminated-bus voltages: V_e[h] = R[h] @ V_k[h]
    V_m, V_a = expand_voltages(red, res.V_m, res.V_a, net.n)
    return res._replace(V_m=V_m, V_a=V_a)
