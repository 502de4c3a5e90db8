"""Lane-major (batch-minor) batched HPF — the sweep fast path.

``jax.vmap`` puts the scenario batch axis FIRST, so every tensor inside the
batched Newton trip — (B, H, n) voltages, (B, H, n, n) blocks, (B, dim)
residuals — has its two tiny per-scenario axes (n = 4..20, 2n = 8..40)
innermost, and every elementwise op, reduce and relayout of the trip
works on those short rows.

This module is the same solver with the batch carried on the LAST axis
instead: voltages are (H, n, B), Jacobian blocks (H, 2n, 2n, B), residuals
(dim, B).  Every op then runs over the long, contiguous scenario axis, and
the lane-minor solve dispatcher (hpfx.ops.batched_solve_lanes) consumes
the blocks without a per-trip (B, n, n) -> (n, n, B) relayout.
``Settings.layout="auto"`` picks this layout where
:func:`hpfx.ops.auto_layout` says so for the platform.

Scope: the structured arrow Newton step (Settings.solver = "arrow") with
stacked Norton-equivalent devices (DeviceSet, coupled or uncoupled), plain
or stable mismatch, PV buses, warm starts, per-device injection scales
((B, n_nl) Scenarios.injection_scale), device mixes
(DeviceLibrary + Scenarios.device_mix), and autodiff devices
(AnalyticDeviceSet, vmapped over the lane axis) — i.e. the production
sweep configuration.  Everything else (dense solver, AnalyticDeviceSet, single
solves, trajectory recording) stays on the vmap path in hpfx.solve; the
dispatcher there falls back automatically.  Both paths compute the same
iteration (same formulas, same per-scenario convergence predication as
JAX's batched while_loop) and are equality-tested against each other
(tests/test_lanes.py).

Reference parity contract: the math is hcne_generalized.py:313-560
exactly as implemented per-scenario in hpfx.harmonic / hpfx.arrow — see
those modules' docstrings for the per-function line cites; this module
only changes the batch layout.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

#: memory budget for the warm-seed embedded matrix (2N, 2N, chunk) —
#: the seed assembly/solve chunks the lane axis to stay under this.  The
#: LU of the chunk holds a few copies of it (operand, factors, relayouts),
#: so 2 GiB keeps the seed well inside the free device memory of a card
#: that holds the rest of the sweep's state at its largest batches.
SEED_CHUNK_BYTES = 1 << 31

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import cx
from .arrow import ArrowIndex, make_arrow_index
from .config import Settings
from .cx import Cx
from .devices import AnalyticDeviceSet, DeviceLibrary, DeviceSet
from .fundamental import FundResult
from .harmonic import HPFResult, cleanup_voltages
from .network import Network
from .ops.batched_solve import batched_solve_lanes
from .utils.precision import highest_precision
from .ybus import LineYbus, build_ybus, line_ybus_pair

_all = slice(None)


class LaneDevices(NamedTuple):
    """Norton parameters in the lane layout.

    ``batched=False``: the plain per-network arrays of a DeviceSet —
    I_N (n_nl, H), Y_N (n_nl, H, H) or (n_nl, H) — shared by every
    scenario.  ``batched=True``: per-scenario *effective* arrays with a
    trailing lane-batch axis — I_N (n_nl, H, B), Y_N (n_nl, H, H, B) /
    (n_nl, H, B) — produced by blending a DeviceLibrary with the
    per-scenario device-mix weights (Scenarios.device_mix); the blend is
    computed ONCE per sweep (weights are iteration-invariant), so the
    Newton trip pays only the extra lane axis on the device operands.
    """
    I_N: Cx
    Y_N: Cx
    coupled: bool
    batched: bool


def _as_lane_devices(devices):
    if isinstance(devices, (LaneDevices, AnalyticDeviceSet)):
        return devices       # analytic devices keep their own interface
    return LaneDevices(devices.I_N, devices.Y_N, devices.coupled, False)


def _mix_lane_devices(lib: DeviceLibrary, mix, rd) -> "LaneDevices":
    """Blend a DeviceLibrary with (B, n_nl, T) weights into effective
    batched device arrays (hpfx.devices.DeviceLibrary.mixed, lane-major):
    I_N[d, h, b] = sum_t mix[b, d, t] · I_lib[t, h] (same for Y)."""
    w = jnp.asarray(mix, rd)
    es = lambda spec, arr: Cx(
        jnp.einsum(spec, w, arr.re, precision=cx._PREC),
        jnp.einsum(spec, w, arr.im, precision=cx._PREC))
    I_N = es("bdt,th->dhb", lib.I_lib)
    Y_N = es("bdt,thp->dhpb" if lib.coupled else "bdt,th->dhb", lib.Y_lib)
    return LaneDevices(I_N=I_N, Y_N=Y_N, coupled=lib.coupled, batched=True)


def _as_inj_db(inj, n_nl: int, B: int, rd):
    """Normalize an injection scale to device-major (n_nl, B): 1-D (B,)
    per-scenario scalars broadcast over devices; 2-D input must already be
    (n_nl, B) (hpf_sweep_lanes transposes the user's (B, n_nl))."""
    inj = jnp.asarray(inj, rd)
    if inj.ndim == 1:
        return jnp.broadcast_to(inj[None, :], (n_nl, B))
    return inj


# ---------------------------------------------------------------------------
# mismatch (lane-major): hpfx.harmonic.harmonic_mismatch with batch last
# ---------------------------------------------------------------------------

def _polar_diff_lanes(mu_a, th_a, mu_b, th_b) -> Cx:
    """hpfx.ybus._polar_diff — elementwise, so identical code works on
    (H, L, B) operands."""
    dmu = mu_a - mu_b
    delta = th_b - th_a
    s_half = jnp.sin(0.5 * delta)
    re_local = dmu + 2.0 * mu_b * s_half * s_half
    im_local = -mu_b * jnp.sin(delta)
    return cx.expj(th_a) * Cx(re_local, im_local)


def stable_matvec_lanes(lineY: LineYbus, V_m, V_a) -> Cx:
    """Cancellation-free Y·V (hpfx.ybus.stable_matvec) on (H, n, B).

    The per-line flows are accumulated into buses through a one-hot
    incidence contraction instead of a scatter-add: the (n, 2L) incidence
    einsum is a plain fused contraction with a deterministic summation
    order (the one-hots are built by comparison, no gather/scatter
    anywhere on the store side)."""
    f, t = lineY.f_idx, lineY.t_idx
    a_ff = lineY.a_ff[:, None]                  # (L, 1)
    inv_tau = lineY.inv_tau[:, None]
    shift = lineY.shift[:, None]
    mu_f = V_m[:, f] * a_ff
    th_f = V_a[:, f]
    mu_t = V_m[:, t] * inv_tau
    th_t = V_a[:, t] + shift
    flow_f = lineY.Ys[..., None] * _polar_diff_lanes(mu_f, th_f, mu_t, th_t)
    mu_t2 = V_m[:, t]
    th_t2 = V_a[:, t]
    mu_f2 = V_m[:, f] * inv_tau
    th_f2 = V_a[:, f] - shift
    flow_t = lineY.Ys[..., None] * _polar_diff_lanes(mu_t2, th_t2,
                                                     mu_f2, th_f2)
    out = lineY.d[..., None] * cx.polar(V_m, V_a)
    n = V_m.shape[1]
    arange_n = jnp.arange(n)[:, None]
    Minc = jnp.concatenate([
        (f[None, :] == arange_n), (t[None, :] == arange_n)],
        axis=1).astype(V_m.dtype)               # (n, 2L)
    flows = cx.concatenate([flow_f, flow_t], axis=1)     # (H, 2L, B)
    acc = lambda x: jnp.einsum("nl,hlb->hnb", Minc, x,
                               precision=cx._PREC)
    return out + Cx(acc(flows.re), acc(flows.im))


def _injections_lanes(V_c: Cx, dev, inj_db, m: int,
                      V_m=None, V_a=None) -> Cx:
    """Current injections (hpfx.harmonic.current_injections) on (H, n, B)
    voltages -> (n_nl, H, B).  ``inj_db`` (n_nl, B) scales the Norton
    parameters per device (I_N and Y_N scale together, so the injection
    scales linearly; hcne_generalized.py:313-323).  ``dev`` may also be an
    AnalyticDeviceSet (autodiff injection, vmapped over the lane axis —
    needs the polar ``V_m``/``V_a``)."""
    if isinstance(dev, AnalyticDeviceSet):
        raw = jax.vmap(dev.injections, in_axes=(-1, -1), out_axes=-1)(
            V_m[:, m:], V_a[:, m:])                      # (n_nl, H, B)
        return raw * inj_db[:, None, :]
    V_nl = V_c[:, m:]                                    # (H, n_nl, B)
    if dev.coupled:
        if dev.batched:
            raw = dev.I_N - cx.einsum("dhpb,pdb->dhb", dev.Y_N, V_nl)
        else:
            raw = dev.I_N[..., None] - cx.einsum("dhp,pdb->dhb",
                                                 dev.Y_N, V_nl)
    else:
        Vt = V_nl.transpose(1, 0, 2)                     # (n_nl, H, B)
        if dev.batched:
            raw = dev.I_N - dev.Y_N * Vt
        else:
            raw = dev.I_N[..., None] - dev.Y_N[..., None] * Vt
    return raw * inj_db[:, None, :]


def mismatch_lanes(V_m, V_a, Y: Cx, S: Cx, devices, inj,
                   m: int, n: int, c: int, lineY: Optional[LineYbus],
                   ibg: Optional[Cx] = None):
    """Harmonic mismatch/residual (hpfx.harmonic.harmonic_mismatch) on
    (H, n, B) voltages; S is the scaled (n, B) load.  ``devices`` is a
    DeviceSet or LaneDevices; ``inj`` a (B,) per-scenario or (n_nl, B)
    per-device scale.  ``ibg``: optional (H, n, B) lane-major background
    injections (hpfx.background; fundamental row zero) — added to the
    harmonic rows like the host twin (hpfx.harmonic.current_balance).
    Returns (f (rows, B), err (B,))."""
    dev = _as_lane_devices(devices)
    inj_db = _as_inj_db(inj, n - m, V_m.shape[-1], V_m.dtype)
    V_c = cx.polar(V_m, V_a)
    if lineY is None:
        YV = cx.einsum("hij,hjb->hib", Y, V_c)
    else:
        YV = stable_matvec_lanes(lineY, V_m, V_a)
    I1 = YV[0, 1:m]
    Sl = V_c[0, 1:m] * I1.conj()
    dS = S[1:m] + Sl                                     # (m-1, B)
    I_inj = _injections_lanes(V_c, dev, inj_db, m,
                              V_m=V_m, V_a=V_a)          # (n_nl, H, B)
    dI_f = YV[0, m:] + I_inj[:, 0]
    dI_h = YV[1:]                                        # (K, n, B)
    dI_h = dI_h.at_add((_all, slice(m, None)),
                       I_inj[:, 1:].transpose(1, 0, 2))
    if ibg is not None:
        dI_h = dI_h + ibg[1:]
    K_, B = dI_h.shape[0], dI_h.shape[2]
    dI = cx.concatenate([dI_f, dI_h.reshape(K_ * n, B)])
    f_c = cx.concatenate([dS, dI])
    f = jnp.concatenate([f_c.re, f_c[c - 1:].im], axis=0)
    return f, jnp.max(jnp.abs(f), axis=0)


def mismatch_floor_lanes(V_m, Y: Cx, devices, inj, m: int,
                         settings: Settings, ibg: Optional[Cx] = None):
    """Per-scenario mismatch evaluation floor (hpfx.harmonic.mismatch_floor)
    -> (B,).  ``devices``/``inj``/``ibg`` as in :func:`mismatch_lanes`."""
    dev = _as_lane_devices(devices)
    inj_db = _as_inj_db(inj, V_m.shape[1] - m, V_m.shape[-1],
                        settings.real_dtype)
    eps = jnp.finfo(settings.real_dtype).eps
    vmax = jnp.abs(V_m)                                   # (H, n, B)
    rows = jnp.einsum("hij,hjb->hib", Y.abs(), vmax)
    scale = jnp.max(rows, axis=(0, 1))                    # (B,)
    if ibg is not None:   # constant background rows (hpfx.background)
        scale = jnp.maximum(scale, jnp.max(ibg.abs(), axis=(0, 1)))
    if isinstance(dev, AnalyticDeviceSet):
        # no Norton sensitivity bound for analytic devices (mirrors
        # hpfx.harmonic.mismatch_floor's isinstance gate)
        return eps * scale
    if dev.I_N.shape[0] > 0:
        v_nl = vmax[:, m:]                                # (H, n_nl, B)
        vt = v_nl.transpose(1, 0, 2)                      # (n_nl, H, B)
        if dev.coupled:
            spec = "dhpb,pdb->dhb" if dev.batched else "dhp,pdb->dhb"
            d_inj = jnp.einsum(spec, dev.Y_N.abs(), v_nl)
        else:
            Ya = dev.Y_N.abs() if dev.batched else dev.Y_N.abs()[..., None]
            d_inj = Ya * vt
        scale = jnp.maximum(
            scale,
            jnp.max(d_inj * jnp.abs(inj_db)[:, None, :], axis=(0, 1)))
    return eps * scale


# ---------------------------------------------------------------------------
# arrow Newton step (lane-major): hpfx.arrow with batch last
# ---------------------------------------------------------------------------

def _power_jacobian_blocks_lanes(V: Cx, Vn: Cx, Y: Cx, n: int):
    """hpfx.fundamental._power_jacobian_blocks on (n, B) voltages ->
    (n, n, B) split-complex dS/dA, dS/dV."""
    I = cx.einsum("ij,jb->ib", Y, V)
    eye = jnp.eye(n, dtype=V.re.dtype)[:, :, None]        # (n, n, 1)
    diag_I = Cx(eye * I.re[:, None, :], eye * I.im[:, None, :])
    YV = Y[..., None] * V[None, :]                        # Y_ij·V_j
    dSdA = (V[:, None] * (diag_I - YV).conj()).jmul()
    w = Vn * I.conj()
    diag_w = Cx(eye * w.re[:, None, :], eye * w.im[:, None, :])
    YVn = Y[..., None] * Vn[None, :]
    dSdV = diag_w + V[:, None] * YVn.conj()
    return dSdA, dSdV


def _coupling_lanes(V_m, V_a, dev, inj_db, m: int):
    """K_V/K_A (H, H, n_nl, B): hpfx.arrow._coupling_cx, batch last.
    ``inj_db`` (n_nl, B) scales couplings per device (the Jacobian twin of
    the injection scaling, hcne_generalized.py:425-435)."""
    if isinstance(dev, AnalyticDeviceSet):
        # autodiff coupling blocks, vmapped over the lane axis (the same
        # blocks hpfx.harmonic.build_harmonic_jacobian derives)
        JV, JA = jax.vmap(dev.injection_jacobians, in_axes=(-1, -1),
                          out_axes=-1)(V_m[:, m:], V_a[:, m:])
        s = inj_db[None, None, :, :]
        return (JV.transpose(1, 2, 0, 3) * s,
                JA.transpose(1, 2, 0, 3) * s)
    Vn_nl = cx.expj(V_a)[:, m:]                           # (H, n_nl, B)
    V_nl = cx.polar(V_m, V_a)[:, m:]
    if dev.coupled:
        spec = "dhpb,pdb->hpdb" if dev.batched else "dhp,pdb->hpdb"
        K_V = -cx.einsum(spec, dev.Y_N, Vn_nl)
        K_A = -cx.einsum(spec, dev.Y_N, V_nl).jmul()
    else:
        H, n_nl, B = Vn_nl.shape
        Yt = dev.Y_N.transpose(1, 0, 2) if dev.batched \
            else dev.Y_N.T[..., None]                     # (H, n_nl, B|1)
        diag_V = -(Yt * Vn_nl)                            # (H, n_nl, B)
        diag_A = -(Yt * V_nl).jmul()
        hh = jnp.arange(H)
        K_V = cx.zeros((H, H, n_nl, B), V_m.dtype).at_set((hh, hh), diag_V)
        K_A = cx.zeros((H, H, n_nl, B), V_m.dtype).at_set((hh, hh), diag_A)
    s = inj_db[None, None, :, :]
    return K_V * s, K_A * s


class _ArrowConsts(NamedTuple):
    """Host-side constants of the lane-major arrow solve (see
    hpfx.arrow.arrow_solve for their derivation)."""
    idx: ArrowIndex
    E0: np.ndarray        # (d0, r_blk) unit columns of U, block 0
    Eh: np.ndarray        # (2n, r_blk) unit columns of U, blocks h>=1
    inv_f_perm: np.ndarray  # (dim,) grouped row -> original position


def _make_arrow_consts(H: int, n: int, m: int, c: int) -> _ArrowConsts:
    idx = make_arrow_index(H, n, m, c)
    n_nl = n - m
    r_blk = 2 * n_nl
    rows0 = np.concatenate([
        (m - 1) + np.arange(n_nl),
        (m - 1) + n_nl + (m - c) + np.arange(n_nl)])
    rowsh = np.concatenate([np.arange(m, n), n + np.arange(m, n)])
    E0 = np.zeros((idx.d0, r_blk), np.float32)
    E0[rows0, np.arange(r_blk)] = 1.0
    Eh = np.zeros((2 * n, r_blk), np.float32)
    Eh[rowsh, np.arange(r_blk)] = 1.0
    return _ArrowConsts(idx=idx, E0=E0, Eh=Eh,
                        inv_f_perm=np.argsort(idx.f_perm))


def arrow_step_lanes(V_m, V_a, f, Y: Cx, devices, inj,
                     consts: _ArrowConsts):
    """One arrow Newton-step solve J dx = f on (H, n, B) state, (dim, B)
    mismatch -> dx (dim, B).  Same block + Woodbury factorization as
    hpfx.arrow.build_arrow_pieces/arrow_solve, batch kept lane-minor so the
    solves consume the blocks without relayout.  ``devices``/
    ``inj`` as in :func:`mismatch_lanes`."""
    idx = consts.idx
    H, n, m, c, d0 = idx.H, idx.n, idx.m, idx.c, idx.d0
    n_nl = n - m
    K = H - 1
    r = 2 * H * n_nl
    r_blk = 2 * n_nl
    rd = V_m.dtype
    B = V_m.shape[-1]
    dev = _as_lane_devices(devices)
    inj_db = _as_inj_db(inj, n_nl, B, rd)

    V_c = cx.polar(V_m, V_a)
    Vn = cx.expj(V_a)

    blocks_V = Y[..., None] * Vn[:, None, :, :]           # (H, n, n, B)
    blocks_A = (Y[..., None] * V_c[:, None, :, :]).jmul()
    K_V, K_A = _coupling_lanes(V_m, V_a, dev, inj_db, m)  # (H, H, n_nl, B)

    # fold the h == p coupling into the diagonal blocks.  Scatter-free:
    # the diagonal add is an eye-broadcast multiply-add that fuses into
    # one elementwise op
    hh = jnp.arange(H)
    eye_n = jnp.eye(n, dtype=rd)[None, :, :, None]        # (1, n, n, 1)

    def _diag_fold(blocks: Cx, diag: Cx) -> Cx:
        # diag (H, n_nl, B) onto rows/cols m..n of (H, n, n, B)
        pad = jnp.zeros((H, m, B), rd)
        full = Cx(jnp.concatenate([pad, diag.re], axis=1),
                  jnp.concatenate([pad, diag.im], axis=1))  # (H, n, B)
        return Cx(blocks.re + eye_n * full.re[:, None, :, :],
                  blocks.im + eye_n * full.im[:, None, :, :])

    M_V = _diag_fold(blocks_V, K_V[hh, hh])
    M_A = _diag_fold(blocks_A, K_A[hh, hh])

    dS1dA1, dS1dV1 = _power_jacobian_blocks_lanes(V_c[0], Vn[0], Y[0], n)

    def _hcat(a, b):
        return jnp.concatenate([a, b], axis=1)

    D0 = jnp.concatenate([
        _hcat(dS1dA1.re[1:m, 1:], dS1dV1.re[1:m, c:]),
        _hcat(M_A.re[0, m:, 1:], M_V.re[0, m:, c:]),
        _hcat(dS1dA1.im[c:m, 1:], dS1dV1.im[c:m, c:]),
        _hcat(M_A.im[0, m:, 1:], M_V.im[0, m:, c:]),
    ], axis=0)                                            # (d0, d0, B)
    Dh = jnp.concatenate([
        jnp.concatenate([M_A.re[1:], M_V.re[1:]], axis=2),
        jnp.concatenate([M_A.im[1:], M_V.im[1:]], axis=2),
    ], axis=1)                                            # (K, 2n, 2n, B)

    # dense coupling matrix C (r, r, B): h != p, d == d' entries only
    off = ~jnp.eye(H, dtype=bool)[:, :, None, None]       # (H, H, 1, 1)
    zero = jnp.zeros_like(K_V.re)
    KVr = jnp.where(off, K_V.re, zero)
    KVi = jnp.where(off, K_V.im, zero)
    KAr = jnp.where(off, K_A.re, zero)
    KAi = jnp.where(off, K_A.im, zero)
    eye_d = jnp.eye(n_nl, dtype=rd)
    # (H, H, n_nl, B, rc, c): rows use (Re, Im), cols use (angle, magnitude)
    Cfull = jnp.stack([
        jnp.stack([KAr, KVr], axis=-1),                   # rc=0 (Re row)
        jnp.stack([KAi, KVi], axis=-1),                   # rc=1 (Im row)
    ], axis=-2)                                           # (H,H,n_nl,B,2,2)
    Cexp = jnp.einsum("hpdbrc,de->hrdpceb", Cfull, eye_d)
    C = Cexp.reshape(r, r, B)

    # identity-pad the fundamental block to 2n (one uniform batched solve)
    D0p = jnp.broadcast_to(jnp.eye(2 * n, dtype=rd)[:, :, None],
                           (2 * n, 2 * n, B)).at[:d0, :d0].set(D0)
    D_all = jnp.concatenate([D0p[None], Dh], axis=0)      # (H, 2n, 2n, B)

    # grouped RHS + Woodbury U columns through one multi-RHS factorization
    # (inverse-permutation gather instead of a scatter-set)
    fp = f[jnp.asarray(consts.inv_f_perm)]                      # (dim, B)
    f0 = fp[:d0]
    fh = fp[d0:].reshape(K, 2 * n, B)
    E0 = jnp.asarray(consts.E0, rd)
    Eh = jnp.asarray(consts.Eh, rd)
    rhs0 = jnp.concatenate(
        [f0[:, None, :], jnp.broadcast_to(E0[:, :, None],
                                          (d0, r_blk, B))], axis=1)
    rhs0p = jnp.zeros((2 * n, 1 + r_blk, B), rd).at[:d0].set(rhs0)
    rhsh = jnp.concatenate(
        [fh[:, :, None, :],
         jnp.broadcast_to(Eh[None, :, :, None], (K, 2 * n, r_blk, B))],
        axis=2)                                           # (K, 2n, R, B)
    rhs_all = jnp.concatenate([rhs0p[None], rhsh], axis=0)

    # (H, 2n, 2n, B) -> (2n, 2n, H·B): fold the harmonic-block axis into
    # the lane batch (one batched solve for all blocks)
    k2 = 2 * n
    R = 1 + r_blk
    D_flat = D_all.transpose(1, 2, 0, 3).reshape(k2, k2, H * B)
    rhs_flat = rhs_all.transpose(1, 2, 0, 3).reshape(k2, R, H * B)
    sol = batched_solve_lanes(D_flat, rhs_flat)
    sol_all = sol.reshape(k2, R, H, B).transpose(2, 0, 1, 3)  # (H,2n,R,B)

    z0, X0 = sol_all[0, :d0, 0], sol_all[0, :d0, 1:]      # (d0,B),(d0,rb,B)
    zh, Xh = sol_all[1:, :, 0], sol_all[1:, :, 1:]

    cpl0 = jnp.asarray(idx.cpl0)
    cplh = jnp.asarray(idx.cplh)
    Vz = jnp.concatenate([z0[cpl0][None], zh[:, cplh]], axis=0)  # (H,rb,B)
    Vz = Vz.reshape(r, B)

    G0 = X0[cpl0]                                         # (r_blk,r_blk,B)
    Gh = Xh[:, cplh, :]
    Gblocks = jnp.concatenate([G0[None], Gh], axis=0)     # (H,rb,rb,B)

    Cb = C.reshape(r, H, r_blk, B)
    CG = jnp.einsum("rpsb,pstb->rptb", Cb, Gblocks)
    S_w = jnp.eye(r, dtype=rd)[:, :, None] + CG.reshape(r, r, B)
    rhs_w = jnp.einsum("rub,ub->rb", C, Vz)
    y = batched_solve_lanes(S_w, rhs_w[:, None, :])[:, 0]  # (r, B)

    yb = y.reshape(H, r_blk, B)
    corr0 = jnp.einsum("dsb,sb->db", X0, yb[0])
    corrh = jnp.einsum("kdsb,ksb->kdb", Xh, yb[1:])
    x0 = z0 - corr0
    xh = zh - corrh
    xp = jnp.concatenate([x0, xh.reshape(K * k2, B)], axis=0)
    return xp[jnp.asarray(idx.x_perm)]


# ---------------------------------------------------------------------------
# fundamental NR (lane-major)
# ---------------------------------------------------------------------------

class FundLanes(NamedTuple):
    V_m: jnp.ndarray       # (n, B)
    V_a: jnp.ndarray       # (n, B)
    err: jnp.ndarray       # (B,)
    n_iter: jnp.ndarray    # (B,)
    err_hist: jnp.ndarray  # (max_iter_f, B)
    converged: jnp.ndarray


def _fund_mismatch_lanes(V_m, V_a, Y1: Cx, S: Cx, c: int,
                         lineY: Optional[LineYbus]):
    V = cx.polar(V_m, V_a)
    if lineY is None:
        I = cx.einsum("ij,jb->ib", Y1, V)
    else:
        I = stable_matvec_lanes(lineY, V_m[None], V_a[None])[0]
    mis = V * I.conj() + S
    f = jnp.concatenate([mis.re[1:], mis.im[c:]], axis=0)
    return f, jnp.max(jnp.abs(f), axis=0)


def solve_fundamental_lanes(Y1: Cx, S: Cx, net: Network, settings: Settings,
                            B: int, lineY: Optional[LineYbus]) -> FundLanes:
    """Fundamental NR (hpfx.fundamental.solve_fundamental) with the batch
    lane-minor; S is the per-scenario scaled (n, B) load."""
    n, c = net.n, net.c
    rd = settings.real_dtype
    V_m = jnp.full((n, B), settings.v_init_f, rd)
    V_a = jnp.full((n, B), settings.a_init_f, rd)

    x0 = jnp.concatenate([V_a[1:], V_m[c:]], axis=0)
    f0, err0 = _fund_mismatch_lanes(V_m, V_a, Y1, S, c, lineY)
    hist0 = jnp.full((settings.max_iter_f, B), jnp.nan, rd)

    eps = jnp.finfo(rd).eps
    rows = jnp.abs(V_m) * jnp.einsum("ij,jb->ib", Y1.abs(), jnp.abs(V_m))
    thresh_eff = jnp.maximum(
        jnp.asarray(settings.thresh_f, rd),
        settings.floor_kappa * eps * jnp.max(rows + S.abs(), axis=0))

    def active(err, it):
        return (err > thresh_eff) & (it < settings.max_iter_f)

    def cond(carry):
        _, _, _, _, err, it, _, _ = carry
        return jnp.any(active(err, it))

    def body(carry):
        V_m, V_a, x, f, err, it, hist, t = carry
        act = active(err, it)
        J = _fund_jacobian_lanes(V_m, V_a, Y1, n, c)
        dx = batched_solve_lanes(J, f[:, None, :])[:, 0]
        x_new = x - dx
        Va_new = jnp.concatenate([V_a[:1], x_new[: n - 1]], axis=0)
        Vm_new = jnp.concatenate([V_m[:c], x_new[n - 1:]], axis=0)
        f_new, err_new = _fund_mismatch_lanes(Vm_new, Va_new, Y1, S, c,
                                              lineY)
        V_m = jnp.where(act, Vm_new, V_m)
        V_a = jnp.where(act, Va_new, V_a)
        x = jnp.where(act, x_new, x)
        f = jnp.where(act, f_new, f)
        err = jnp.where(act, err_new, err)
        hist = hist.at[t].set(jnp.where(act, err_new, hist[t]))
        return V_m, V_a, x, f, err, it + act.astype(it.dtype), hist, t + 1

    it0 = jnp.zeros((B,), jnp.int32)
    V_m, V_a, _, _, err, n_iter, hist, _ = lax.while_loop(
        cond, body, (V_m, V_a, x0, f0, err0, it0, hist0, jnp.int32(0)))
    return FundLanes(V_m, V_a, err, n_iter, hist, err <= thresh_eff)


def _fund_jacobian_lanes(V_m, V_a, Y1: Cx, n: int, c: int):
    V = cx.polar(V_m, V_a)
    Vn = V * (1.0 / V.abs())
    dSdA, dSdV = _power_jacobian_blocks_lanes(V, Vn, Y1, n)
    top = jnp.concatenate([dSdA.re[1:, 1:], dSdV.re[1:, c:]], axis=1)
    bot = jnp.concatenate([dSdA.im[c:, 1:], dSdV.im[c:, c:]], axis=1)
    return jnp.concatenate([top, bot], axis=0)


# ---------------------------------------------------------------------------
# the harmonic sweep
# ---------------------------------------------------------------------------

def supports_lanes(devices, settings: Settings, net: Network) -> bool:
    """Whether the lane-major path implements this configuration."""
    if settings.solver != "arrow" or net.n <= net.m:
        return False
    if isinstance(devices, (DeviceLibrary, AnalyticDeviceSet)):
        return True          # device-mix sweeps / autodiff devices
    return isinstance(devices, DeviceSet) and devices.n_devices > 0


def _scale_cols(base, scale, n: int, B: int):
    """Per-scenario load scaling -> (n, B): scale is (B,) or (B, n)."""
    s = jnp.asarray(scale, base.dtype)
    if s.ndim == 1:
        return base[:, None] * s[None, :]
    return base[:, None] * s.T


def nr_trip_lanes(Y: Cx, lineY, S: Cx, dev, inj_db, V_m, V_a,
                  settings: Settings, consts: _ArrowConsts, thresh_eff,
                  vc=None, f0=None, ibg: Optional[Cx] = None):
    """The lane-major harmonic NR while-loop from state (V_m, V_a)
    (H, n, B) to convergence/max_iter_h.

    The reusable core of :func:`hpf_sweep_lanes`, also driven per-chunk by
    the scan-based continuation sweep.  ``vc``: optional sharding-
    constraint hook for the carry; ``f0``: optional precomputed
    (f, err) at the initial state.  Returns raw (V_m, V_a, err, n_iter,
    err_hist) — callers apply ``cleanup_voltages``.
    """
    idx = consts.idx
    H, n, m, c = idx.H, idx.n, idx.m, idx.c
    B = V_m.shape[-1]
    rd = V_m.dtype
    if vc is None:
        vc = lambda a, b: (a, b)
    if f0 is None:
        f_init, err_init = mismatch_lanes(V_m, V_a, Y, S, dev, inj_db,
                                          m, n, c, lineY, ibg=ibg)
    else:
        f_init, err_init = f0
    hist0 = jnp.full((settings.max_iter_h, B), jnp.nan, rd)
    x0 = jnp.concatenate([V_a.reshape(H * n, B)[1:],
                          V_m.reshape(H * n, B)[c:]], axis=0)

    def active(err, it):
        return (err > thresh_eff) & (it < settings.max_iter_h)

    def cond(carry):
        _, _, _, _, err, it, _, _ = carry
        return jnp.any(active(err, it))

    D = H * n

    def body(carry):
        V_m, V_a, x, f, err, it, hist, t = carry
        act = active(err, it)
        dx = arrow_step_lanes(V_m, V_a, f, Y, dev, inj_db, consts)
        x_new = x - dx
        Va_new = jnp.concatenate([V_a.reshape(D, B)[:1],
                                  x_new[: D - 1]], axis=0).reshape(H, n, B)
        Vm_new = jnp.concatenate([V_m.reshape(D, B)[:c],
                                  x_new[D - 1:]], axis=0).reshape(H, n, B)
        f_new, err_new = mismatch_lanes(Vm_new, Va_new, Y, S, dev, inj_db,
                                        m, n, c, lineY, ibg=ibg)
        V_m = jnp.where(act, Vm_new, V_m)
        V_a = jnp.where(act, Va_new, V_a)
        V_m, V_a = vc(V_m, V_a)
        x = jnp.where(act, x_new, x)
        f = jnp.where(act, f_new, f)
        err = jnp.where(act, err_new, err)
        hist = hist.at[t].set(jnp.where(act, err_new, hist[t]))
        return V_m, V_a, x, f, err, it + act.astype(it.dtype), hist, t + 1

    it0 = jnp.zeros((B,), jnp.int32)
    V_m, V_a, _, _, err, n_iter, hist, _ = lax.while_loop(
        cond, body, (V_m, V_a, x0, f_init, err_init, it0, hist0,
                     jnp.int32(0)))
    return V_m, V_a, err, n_iter, hist


@highest_precision
def hpf_sweep_lanes(net: Network, devices: DeviceSet, settings: Settings,
                    scenarios, V0=None, Y: Optional[Cx] = None,
                    vsharding=None, I_bg=None) -> HPFResult:
    """Batched HPF sweep with the scenario batch lane-minor throughout.

    Drop-in equivalent of ``hpfx.solve.hpf_sweep`` for the supported
    configuration (see :func:`supports_lanes`); returns the usual
    batch-major ``HPFResult``.  The final transpose back to batch-major is
    the only layout change the caller sees.

    ``vsharding``: optional ``NamedSharding`` for the (H, n, B) voltage
    carry — the 2-D scenario × harmonic mesh hook
    (hpfx.parallel.hpf_sweep_sharded2d): the lane-major layout exposes
    both parallel axes of the problem as array axes, so a single
    ``P(harmonic, None, scenario)`` constraint makes the whole Newton
    trip DP × TP partitioned under GSPMD.  Requires jit; None = off.
    """
    su = _sweep_setup(net, devices, settings, scenarios, Y=Y,
                      vsharding=vsharding, I_bg=I_bg)
    if V0 is None:
        V_m, V_a = su.cold_V_m, su.cold_V_a
    else:
        rd = settings.real_dtype
        V_m = jnp.moveaxis(jnp.asarray(V0[0], rd), 0, -1)
        V_a = jnp.moveaxis(jnp.asarray(V0[1], rd), 0, -1)

    V_m, V_a = su.vc(V_m, V_a)
    V_m, V_a, err, n_iter, hist = nr_trip_lanes(
        su.Y, su.lineY, su.S, su.dev, su.inj_db, V_m, V_a, settings,
        su.consts, su.thresh, vc=su.vc, ibg=su.ibg)

    V_m, V_a = cleanup_voltages(V_m, V_a)
    return _lanes_result(V_m, V_a, err, n_iter, hist, su.thresh, su.fund)


class _SweepSetup(NamedTuple):
    """Shared pre-trip state of the lane-major sweep entry points."""
    Y: Cx
    lineY: object
    S: Cx
    dev: object
    inj_db: jnp.ndarray
    fund: object
    cold_V_m: jnp.ndarray
    cold_V_a: jnp.ndarray
    consts: object
    thresh: jnp.ndarray          # floor-aware, evaluated at the COLD state
    vc: object                   # sharding-constraint hook (V_m, V_a)
    ibg: object = None           # optional (H, n, B) background injections


def _sweep_setup(net: Network, devices, settings: Settings, scenarios,
                 Y=None, vsharding=None, I_bg=None) -> _SweepSetup:
    """Everything a lane-major sweep needs before its first Newton trip:
    admittances, scenario-scaled powers/injections, lane devices, the
    batched fundamental solve, cold-start state and the floor-aware
    threshold (evaluated at the cold state even for warm starts — same
    rule as hpfx.harmonic.solve_harmonic)."""
    H, n, m, c = settings.n_harmonics, net.n, net.m, net.c
    rd = settings.real_dtype
    B = scenarios.p_scale.shape[0]

    # None → build both forms; dense Cx override → no line structure;
    # (Y, lineY, lineY_f) triple (hpfx.sequence.sequence_structures) →
    # carries its own consistent structures
    from .ybus import resolve_ybus
    Y, lineY, lineY_f = resolve_ybus(net, settings, Y)
    if vsharding is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P
        yspec = NamedSharding(vsharding.mesh,
                              _P(vsharding.spec[0], None, None))
        Y = jax.tree.map(
            lambda a: lax.with_sharding_constraint(a, yspec), Y)

    q_scale = scenarios.q_scale if scenarios.q_scale is not None \
        else scenarios.p_scale
    inj = scenarios.injection_scale if scenarios.injection_scale is not None \
        else jnp.ones((B,), rd)
    inj = jnp.asarray(inj, rd)
    # per-device injection scales arrive batch-major (B, n_nl); the lane
    # layout carries them device-major (n_nl, B)
    inj_db = _as_inj_db(inj.T if inj.ndim == 2 else inj, n - m, B, rd)
    mix = getattr(scenarios, "device_mix", None)
    if (mix is not None) != isinstance(devices, DeviceLibrary):
        raise ValueError(
            "Scenarios.device_mix requires passing a DeviceLibrary as "
            "devices (and vice versa)")
    dev = (_mix_lane_devices(devices, mix, rd)
           if isinstance(devices, DeviceLibrary)
           else _as_lane_devices(devices))
    S = Cx(_scale_cols(net.bus_P, scenarios.p_scale, n, B),
           _scale_cols(net.bus_Q, q_scale, n, B))

    fund = solve_fundamental_lanes(Y[0], S, net, settings, B, lineY_f)

    cold_V_m = jnp.full((H, n, B), settings.v_init_h, rd).at[0].set(fund.V_m)
    cold_V_a = jnp.full((H, n, B), settings.a_init_h, rd).at[0].set(fund.V_a)

    def vc(V_m, V_a):
        if vsharding is None:
            return V_m, V_a
        return (lax.with_sharding_constraint(V_m, vsharding),
                lax.with_sharding_constraint(V_a, vsharding))

    # background injections arrive batch-major (B, H, n); the lane
    # layout carries them (H, n, B) like the voltage state
    ibg = None
    if I_bg is not None:
        ibg = Cx(jnp.moveaxis(jnp.asarray(I_bg.re, rd), 0, -1),
                 jnp.moveaxis(jnp.asarray(I_bg.im, rd), 0, -1))

    consts = _make_arrow_consts(H, n, m, c)
    thresh = _thresh_lanes(cold_V_m, Y, dev, inj_db, m, settings,
                           ibg=ibg)
    return _SweepSetup(Y, lineY, S, dev, inj_db, fund, cold_V_m, cold_V_a,
                       consts, thresh, vc, ibg)


def _linear_seed_lanes(su: "_SweepSetup", net: Network,
                       settings: Settings):
    """Exact-linear Norton seed (hpfx.warmstart) computed IN-PROGRAM in
    the lane layout — the harmonic current-balance rows are linear in
    rectangular coordinates, so one (H−1)·n block solve per lane lands
    phase 1 on the exact harmonic solution at the just-solved
    fundamental (hcne_generalized.py:326-357; see hpfx/warmstart.py for
    the block system).  Reuses the setup's lane-major fundamental —
    zero redundant work vs the standalone ``norton_warm_start``.

    Returns the (H, n, B) phase-1 initial state.  Requires Norton
    LaneDevices (analytic devices keep the cold start).
    """
    H, n, m = settings.n_harmonics, net.n, net.m
    K, rd = H - 1, settings.real_dtype
    dev, inj = su.dev, su.inj_db                      # inj: (n_nl, B)
    B = inj.shape[-1]
    eyeN = jnp.eye(n, dtype=rd)
    eyeK = jnp.eye(K, dtype=rd)

    # shared network block diagonal δ_hp·Y_h → (h, i, p, j)
    blockdiag = lambda Yh: eyeK[:, None, :, None] * Yh[:, :, None, :]

    # per-lane device coupling, scaled like _injections_lanes
    # (I_inj = inj·I_N − inj·Y_N·V): D[h, p, i, b] on nonlinear buses
    def scatter(Cb_re, Cb_im):
        # Cb: (n_nl, K, K, B) — device-major coupling rows/cols ≥ 1
        z = jnp.zeros((K, K, n, B), rd)
        return (z.at[:, :, m:, :].set(jnp.moveaxis(Cb_re, 0, 2)),
                z.at[:, :, m:, :].set(jnp.moveaxis(Cb_im, 0, 2)))

    YN, IN = dev.Y_N, dev.I_N
    s_ = inj[:, None, None, :] if dev.coupled else inj[:, None, :]
    if dev.coupled:
        C = YN[:, 1:, 1:] if dev.batched else \
            Cx(YN.re[:, 1:, 1:, None], YN.im[:, 1:, 1:, None])
        D_re, D_im = scatter(C.re * s_, C.im * s_)
    else:
        Cd = YN[:, 1:] if dev.batched else \
            Cx(YN.re[:, 1:, None], YN.im[:, 1:, None])   # (n_nl, K, B)
        i = jnp.arange(K)
        z = jnp.zeros((K, K, n, B), rd)
        D_re = z.at[i, i, m:, :].set(jnp.moveaxis(Cd.re * s_, 0, 1))
        D_im = z.at[i, i, m:, :].set(jnp.moveaxis(Cd.im * s_, 0, 1))

    # A = blockdiag(Y) − δ_ij·D, kept LANE-MAJOR (K·n, K·n, B)
    def assemble(Ypart, D):
        Dt = jnp.swapaxes(D, 1, 2)                    # (h, i, p, b)
        t = Dt[:, :, :, None, :] * eyeN[None, :, None, :, None]
        full = blockdiag(Ypart)[..., None] - t        # (K, n, K, n, B)
        # -1: the lane axis is the CHUNK width when the seed assembly is
        # chunked below, not the full batch B
        return full.reshape(K * n, K * n, -1)

    Ar = assemble(su.Y.re[1:], D_re)
    Ai = assemble(su.Y.im[1:], D_im)

    fund = su.fund
    V1 = cx.polar(fund.V_m, fund.V_a)                 # (n, B)
    V1nl = V1[m:]                                     # (n_nl, B)
    I1 = IN[:, 1:] if dev.batched else \
        Cx(IN.re[:, 1:, None], IN.im[:, 1:, None])    # (n_nl, K, B)
    si = inj[:, None, :]
    rhs_nl = -(I1 * si)                               # (n_nl, K, B)
    if dev.coupled:
        col0 = YN[:, 1:, 0] if dev.batched else \
            Cx(YN.re[:, 1:, 0, None], YN.im[:, 1:, 0, None])
        rhs_nl = rhs_nl + (col0 * si) * V1nl[:, None, :]
    rhs = cx.zeros((K, n, B), rd).at_set(
        (slice(None), slice(m, None), slice(None)),
        Cx(jnp.moveaxis(rhs_nl.re, 0, 1), jnp.moveaxis(rhs_nl.im, 0, 1)))
    if su.ibg is not None:
        # constant background rows move to the RHS (hpfx.warmstart's
        # harmonic_linear_seed does the same with its (H, n) I_bg)
        rhs = rhs - su.ibg[1:]

    # real block embedding, solved by the lane-minor dispatcher —
    # operands stay lane-minor end to end, matching the trip's own
    # solves.  The embedded matrix is (2N, 2N, B); at big dims × large
    # batches that alone is multiple GB (net1 h51 B=2048: ~8 GB), so the
    # assemble+solve is chunked over the lane axis to SEED_CHUNK_BYTES —
    # a no-op at net2 B=16384 (~0.6 GB).
    N = K * n

    def solve_lanes(D_re, D_im, rhs_re, rhs_im):
        Ar = assemble(su.Y.re[1:], D_re)
        Ai = assemble(su.Y.im[1:], D_im)
        top = jnp.concatenate([Ar, -Ai], axis=1)
        bot = jnp.concatenate([Ai, Ar], axis=1)
        A_real = jnp.concatenate([top, bot], axis=0)  # (2N, 2N, chunk)
        b_real = jnp.concatenate([rhs_re.reshape(N, -1),
                                  rhs_im.reshape(N, -1)],
                                 axis=0)[:, None, :]
        return batched_solve_lanes(A_real, b_real)[:, 0, :]

    bytes_per_lane = (2 * N) * (2 * N) * jnp.dtype(rd).itemsize
    chunk = int(max(1, min(B, SEED_CHUNK_BYTES // bytes_per_lane)))
    if chunk >= B:
        x = solve_lanes(D_re, D_im, rhs.re, rhs.im)   # (2N, B)
    else:
        nb = -(-B // chunk)
        pad = nb * chunk - B

        def tochunks(a):
            a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
            return jnp.moveaxis(
                a.reshape(a.shape[:-1] + (nb, chunk)), -2, 0)

        x = jax.lax.map(
            lambda t: solve_lanes(*t),
            (tochunks(D_re), tochunks(D_im),
             tochunks(rhs.re), tochunks(rhs.im)))     # (nb, 2N, chunk)
        x = jnp.moveaxis(x, 0, -2).reshape(2 * N, nb * chunk)[:, :B]

    from .warmstart import _floor_seed_mag
    Vh = Cx(x[:N].reshape(K, n, B), x[N:].reshape(K, n, B))
    V_m = jnp.concatenate([fund.V_m[None],
                           _floor_seed_mag(Vh.abs(), settings)])
    V_a = jnp.concatenate([fund.V_a[None], Vh.angle()])
    return V_m, V_a


@highest_precision
def hpf_sweep_adaptive_lanes(net: Network, devices, settings: Settings,
                             scenarios, phase_iters: int = 24,
                             rescue_width=None,
                             vsharding=None, warm: str = "cold",
                             V0=None, I_bg=None) -> HPFResult:
    """Two-phase adaptive sweep + deterministic knife-edge rescue as ONE
    device program — no host round-trip between phases.

    The host-driven :func:`hpfx.solve.hpf_sweep_adaptive` pays a second
    dispatch plus a full host materialization between phase 1 and
    phase 2.  Here the whole schedule compiles once:

      1. phase 1: full-width lane trip capped at ``phase_iters``;
      2. phase 2: the ``rescue_width`` worst lanes are GATHERED into a
         narrow batch (converged gather-padding lanes keep a lifted
         threshold so they stay inactive) and continue warm from their
         own phase-1 state with the remaining budget — the self-warm-
         start that breaks floor-hover/oscillation stalls (CLAUDE.md
         #23);
      3. cold-restart rescue: lanes STILL unconverged (the knife-edge
         f32 class, CLAUDE.md #3) restart from the flat start with a
         fresh full budget — mirroring hpfx.solve._rescue_sweep and the
         continuation rescue below;
      4. scatter back with full-width ``err_hist`` splicing.

    Semantics match ``hpf_sweep_adaptive(rescue=True)`` except at most
    ``rescue_width`` stragglers re-solve (default ``max(128, B//16)``;
    typical straggler counts at phase_iters=24 are far below that).
    The width is STATIC — the price of the single compiled program vs
    the host twin's data-dependent straggler bucket: should stragglers
    ever exceed it, the excess lanes keep their phase-1 state and are
    honestly reported unconverged (never silently wrong).

    ``rescue_width`` may also be a TUPLE of widths: the program then
    compiles one rescue block per width and ``lax.switch``es to the
    smallest that covers the phase-1 straggler count — the device-only
    answer to straggler-heavy configs (net1-class f32 batches can leave
    more stragglers than the 128-lane default).  Include ``B`` as the widest bucket for a coverage
    guarantee.  ``vsharding`` as in :func:`hpf_sweep_lanes`.
    """
    su = _sweep_setup(net, devices, settings, scenarios,
                      vsharding=vsharding, I_bg=I_bg)
    rd = settings.real_dtype
    B = scenarios.p_scale.shape[0]
    p1 = min(phase_iters, settings.max_iter_h)

    # phase-1 initial state: cold flat start (the reference's), an
    # explicit V0 (batch-major (B, H, n), fundamental row replaced by
    # the program's own fundamental solve — the solve_harmonic rule), or
    # the in-program exact-linear Norton seed (warm="linear"); the cold
    # state keeps its roles in the floor-aware threshold and the
    # knife-edge cold-restart rescue either way
    if V0 is not None:
        Vm1 = jnp.moveaxis(V0[0], 0, -1).at[0].set(su.fund.V_m)
        Va1 = jnp.moveaxis(V0[1], 0, -1).at[0].set(su.fund.V_a)
    elif warm == "linear" and isinstance(su.dev, LaneDevices):
        Vm1, Va1 = _linear_seed_lanes(su, net, settings)
    else:
        Vm1, Va1 = su.cold_V_m, su.cold_V_a

    s1 = settings.with_(max_iter_h=p1)
    V_m, V_a, err, n_iter, hist1 = nr_trip_lanes(
        su.Y, su.lineY, su.S, su.dev, su.inj_db,
        Vm1, Va1, s1, su.consts, su.thresh, vc=su.vc, ibg=su.ibg)
    conv = err <= su.thresh
    hist = jnp.full((settings.max_iter_h, B), jnp.nan, rd) \
        .at[:p1].set(hist1)

    def _rescue_block(K, hist):
        """Gathered straggler rescue at static width ``K``: phase-2
        self-warm continuation + cold-restart pass, scattered back to
        full width.  Returns the full-width (V_m, V_a, err, n_iter,
        conv, hist)."""
        # unconverged lanes first (stable: deterministic padding choice)
        bad = jnp.argsort(conv.astype(rd), stable=True)[:K]
        was_bad = ~conv[bad]
        g = lambda x: jnp.take(x, bad, axis=-1)
        S_k = Cx(g(su.S.re), g(su.S.im))
        inj_k = g(su.inj_db)
        dev_k = su.dev
        if isinstance(su.dev, LaneDevices) and su.dev.batched:
            dev_k = LaneDevices(
                I_N=Cx(g(su.dev.I_N.re), g(su.dev.I_N.im)),
                Y_N=Cx(g(su.dev.Y_N.re), g(su.dev.Y_N.im)),
                coupled=su.dev.coupled, batched=True)
        thresh_k = g(su.thresh)
        coldVm_k, coldVa_k = g(su.cold_V_m), g(su.cold_V_a)
        ibg_k = None if su.ibg is None else Cx(g(su.ibg.re), g(su.ibg.im))

        Vmk, Vak = g(V_m), g(V_a)
        errk, nitk, convk = g(err), g(n_iter), conv[bad]

        def rescue_pass(s_pass, Vm0, Va0, state):
            Vmk, Vak, errk, nitk, convk = state
            # converged gather-padding stays inactive: threshold lifted
            # to its achieved error
            thresh_r = jnp.where(convk, jnp.maximum(thresh_k, errk),
                                 thresh_k)
            Vm2, Va2, err2, nit2, hist2 = nr_trip_lanes(
                su.Y, su.lineY, S_k, dev_k, inj_k, Vm0, Va0, s_pass,
                su.consts, thresh_r, vc=su.vc, ibg=ibg_k)
            redo = ~convk
            Vmk = jnp.where(redo[None, None, :], Vm2, Vmk)
            Vak = jnp.where(redo[None, None, :], Va2, Vak)
            errk = jnp.where(redo, err2, errk)
            nitk = nitk + jnp.where(redo, nit2, 0)
            convk = convk | (redo & (err2 <= thresh_r))
            return (Vmk, Vak, errk, nitk, convk), redo, hist2

        state = (Vmk, Vak, errk, nitk, convk)
        if p1 < settings.max_iter_h:
            # phase 2: continue warm from the phase-1 state (cold where
            # it went non-finite — a NaN state no-ops the trip at
            # iteration 0).  The seed passes through cleanup_voltages
            # exactly like the host twin's (hpf_sweep_adaptive phase-2
            # V0 is a finished hpf_sweep result, i.e. post-cleanup) —
            # cleanup is idempotent, so the two schedules stay
            # fp-identical when their gather widths coincide
            finite = (jnp.isfinite(Vmk).all(axis=(0, 1))
                      & jnp.isfinite(Vak).all(axis=(0, 1)))
            use_self = (finite | convk)[None, None, :]
            Vmc, Vac = cleanup_voltages(Vmk, Vak)
            s2 = settings.with_(max_iter_h=settings.max_iter_h - p1)
            state, redo, hist2 = rescue_pass(
                s2, jnp.where(use_self, Vmc, coldVm_k),
                jnp.where(use_self, Vac, coldVa_k), state)
            hist = hist.at[p1:, bad].set(
                jnp.where(redo[None, :], hist2, hist[p1:, bad]))

        # cold-restart rescue with a fresh full budget for anything
        # STILL stuck; its history replaces the whole row (a restart,
        # not a resume)
        state, redo, hist3 = rescue_pass(settings, coldVm_k, coldVa_k,
                                         state)
        hist = hist.at[:, bad].set(
            jnp.where(redo[None, :], hist3, hist[:, bad]))
        Vmk, Vak, errk, nitk, convk = state

        sc = lambda full, kk, mask: full.at[..., bad].set(
            jnp.where(mask, kk, jnp.take(full, bad, axis=-1)))
        return (sc(V_m, Vmk, was_bad[None, None, :]),
                sc(V_a, Vak, was_bad[None, None, :]),
                sc(err, errk, was_bad),
                sc(n_iter, nitk, was_bad),
                sc(conv, convk, was_bad),
                hist)

    if isinstance(rescue_width, (tuple, list)):
        # bucketed widths: pick the smallest static width that covers
        # the phase-1 straggler count via lax.switch — every branch
        # compiles, the chosen one executes.  The widest bucket should
        # be >= the worst plausible straggler count (include B for a
        # guarantee); overflow beyond the widest bucket degrades like
        # the single-width case (honestly-unconverged excess lanes).
        widths = sorted({min(B, max(1, int(w))) for w in rescue_width})
        n_bad = jnp.sum(~conv)
        if len(widths) == 1:
            V_m, V_a, err, n_iter, conv, hist = \
                _rescue_block(widths[0], hist)
        else:
            idx = sum((n_bad > w).astype(jnp.int32)
                      for w in widths[:-1])
            V_m, V_a, err, n_iter, conv, hist = lax.switch(
                idx, [partial(_rescue_block, w) for w in widths], hist)
    else:
        K = min(B, rescue_width if rescue_width is not None
                else max(128, B // 16))
        V_m, V_a, err, n_iter, conv, hist = _rescue_block(K, hist)

    V_m, V_a = cleanup_voltages(V_m, V_a)
    res = _lanes_result(V_m, V_a, err, n_iter, hist, su.thresh, su.fund)
    return res._replace(converged=conv)


def _lanes_result(V_m, V_a, err, n_iter, hist, thresh_eff,
                  fund) -> HPFResult:
    fund_bm = None
    if fund is not None:
        fund_bm = FundResult(
            V_m=fund.V_m.T, V_a=fund.V_a.T, err=fund.err,
            n_iter=fund.n_iter, err_hist=fund.err_hist.T,
            converged=fund.converged)
    return HPFResult(
        V_m=jnp.moveaxis(V_m, -1, 0), V_a=jnp.moveaxis(V_a, -1, 0),
        err=err, n_iter=n_iter, err_hist=hist.T,
        converged=err <= thresh_eff, fund=fund_bm)


def _thresh_lanes(V_m, Y, dev, inj_db, m, settings, ibg=None):
    return jnp.maximum(
        jnp.asarray(settings.thresh_h, settings.real_dtype),
        settings.floor_kappa *
        mismatch_floor_lanes(V_m, Y, dev, inj_db, m, settings, ibg=ibg))


@highest_precision
def hpf_sweep_continuation_lanes(net: Network, devices, settings: Settings,
                                 scenarios, n_stages: int = 8,
                                 rescue: bool = True,
                                 vsharding=None) -> HPFResult:
    """Warm-start continuation sweep compiled as ONE device program.

    The host-driven :func:`hpfx.solve.hpf_sweep_continuation` pays a host
    round-trip per stage (seed gathering + dispatch).  Here the whole
    schedule — key sort, chunking,
    per-stage solves seeded from the previous stage's nearest CONVERGED
    neighbor, and the self-warm rescue pass — is a single jitted program:
    a ``lax.scan`` over key-ordered scenario chunks around
    :func:`nr_trip_lanes`, so the only host interaction is the final
    result transfer.

    Semantics mirror the host version with one difference: stages seed
    from the immediately PREVIOUS chunk only (a scan carry), not from all
    earlier chunks — for key-sorted chunks the nearest neighbor is in the
    adjacent chunk anyway.  Requires the lanes-supported configuration.

    ``vsharding``: optional ``NamedSharding`` for the (H, n, Bc) chunk
    voltage carry (same convention as :func:`hpf_sweep_lanes`) — shards
    every per-chunk Newton trip and the rescue passes over the mesh;
    the one-time key sort / chunking stays global.  Requires jit.
    """
    H, n, m, c = settings.n_harmonics, net.n, net.m, net.c
    rd = settings.real_dtype
    B = scenarios.p_scale.shape[0]
    n_stages = max(1, min(n_stages, B))
    n_nl = n - m

    Y = build_ybus(net, settings)
    lineY, lineY_f = line_ybus_pair(net, settings)

    q_scale = scenarios.q_scale if scenarios.q_scale is not None \
        else scenarios.p_scale
    inj = scenarios.injection_scale if scenarios.injection_scale is not None \
        else jnp.ones((B,), rd)
    inj = jnp.asarray(inj, rd)
    inj_db = _as_inj_db(inj.T if inj.ndim == 2 else inj, n_nl, B, rd)
    mix = getattr(scenarios, "device_mix", None)
    if (mix is not None) != isinstance(devices, DeviceLibrary):
        raise ValueError(
            "Scenarios.device_mix requires passing a DeviceLibrary as "
            "devices (and vice versa)")
    dev = (_mix_lane_devices(devices, mix, rd)
           if isinstance(devices, DeviceLibrary)
           else _as_lane_devices(devices))
    S = Cx(_scale_cols(net.bus_P, scenarios.p_scale, n, B),
           _scale_cols(net.bus_Q, q_scale, n, B))

    # continuation key (device-side twin of the host version's default)
    if scenarios.injection_scale is not None:
        key = inj if inj.ndim == 1 else inj.mean(axis=1)
    elif mix is not None:
        key = jnp.asarray(mix, rd).sum(axis=(1, 2))
    else:
        p = jnp.asarray(scenarios.p_scale, rd)
        key = p if p.ndim == 1 else p.mean(axis=1)

    order = jnp.argsort(key)
    Bc = -(-B // n_stages)
    Bp = n_stages * Bc
    order_p = jnp.concatenate(
        [order, jnp.broadcast_to(order[-1:], (Bp - B,))])

    def chunk_last(x):
        """(..., B) -> (n_stages, ..., Bc) via the sorted order."""
        xs = jnp.take(x, order_p, axis=-1)
        xs = xs.reshape(x.shape[:-1] + (n_stages, Bc))
        return jnp.moveaxis(xs, -2, 0)

    S_ch = Cx(chunk_last(S.re), chunk_last(S.im))
    inj_ch = chunk_last(inj_db)
    key_ch = chunk_last(key)
    dev_ch = None
    if isinstance(dev, LaneDevices) and dev.batched:
        dev_ch = LaneDevices(
            I_N=Cx(chunk_last(dev.I_N.re), chunk_last(dev.I_N.im)),
            Y_N=Cx(chunk_last(dev.Y_N.re), chunk_last(dev.Y_N.im)),
            coupled=dev.coupled, batched=True)

    consts = _make_arrow_consts(H, n, m, c)

    def _vc(V_m, V_a):
        if vsharding is None:
            return V_m, V_a
        return (lax.with_sharding_constraint(V_m, vsharding),
                lax.with_sharding_constraint(V_a, vsharding))

    def step(carry, xs):
        pVm, pVa, pK, pConv = carry
        if dev_ch is None:
            S_re, S_im, injc, kc = xs
            dev_c = dev
        else:
            S_re, S_im, injc, kc, dIr, dIi, dYr, dYi = xs
            dev_c = LaneDevices(I_N=Cx(dIr, dIi), Y_N=Cx(dYr, dYi),
                                coupled=dev.coupled, batched=True)
        S_c = Cx(S_re, S_im)
        fund = solve_fundamental_lanes(Y[0], S_c, net, settings, Bc,
                                       lineY_f)
        coldVm = jnp.full((H, n, Bc), settings.v_init_h, rd) \
            .at[0].set(fund.V_m)
        coldVa = jnp.full((H, n, Bc), settings.a_init_h, rd) \
            .at[0].set(fund.V_a)
        # nearest CONVERGED scenario of the previous chunk
        dist = jnp.abs(kc[:, None] - pK[None, :]) \
            + 1e30 * (1.0 - pConv)[None, :]
        j = jnp.argmin(dist, axis=1)
        haveprev = jnp.any(pConv > 0)
        Vm0 = jnp.where(haveprev, pVm[:, :, j], coldVm)
        Va0 = jnp.where(haveprev, pVa[:, :, j], coldVa)
        Vm0, Va0 = _vc(Vm0, Va0)
        # the floor-aware threshold is evaluated at the COLD state — the
        # plain sweep's bar.  A warm seed sits near the solution where
        # harmonic |V| (and with it the mismatch floor) is ~10x smaller;
        # evaluating the floor there holds knife-edge scenarios to a
        # stricter criterion than the plain/adaptive paths (measured:
        # net1 B=512 conv 0.98 vs adaptive 1.000 before this fix)
        thresh = _thresh_lanes(coldVm, Y, dev_c, injc, m, settings)
        Vm, Va, err, n_it, hist = nr_trip_lanes(
            Y, lineY, S_c, dev_c, injc, Vm0, Va0, settings, consts, thresh,
            vc=_vc)
        conv = err <= thresh
        carry2 = (Vm, Va, kc, conv.astype(rd))
        return carry2, (Vm, Va, err, n_it, hist, conv)

    carry0 = (jnp.zeros((H, n, Bc), rd), jnp.zeros((H, n, Bc), rd),
              jnp.zeros((Bc,), rd), jnp.zeros((Bc,), rd))
    xs = (S_ch.re, S_ch.im, inj_ch, key_ch)
    if dev_ch is not None:
        xs = xs + (dev_ch.I_N.re, dev_ch.I_N.im,
                   dev_ch.Y_N.re, dev_ch.Y_N.im)
    _, outs = lax.scan(step, carry0, xs)
    Vm_s, Va_s, err_s, nit_s, hist_s, conv_s = outs

    def unchunk(x):
        """(n_stages, ..., Bc) -> (..., B) sorted -> original order."""
        x = jnp.moveaxis(x, 0, -2)
        flat = x.reshape(x.shape[:-2] + (Bp,))[..., :B]
        out = jnp.zeros_like(flat)
        return out.at[..., order].set(flat)

    V_m = unchunk(Vm_s)
    V_a = unchunk(Va_s)
    err = unchunk(err_s)
    n_iter = unchunk(nit_s)
    hist = unchunk(hist_s)
    conv = unchunk(conv_s)

    if rescue:
        # Two rescue passes, both in the same program:
        #   1. self-warm from the scenario's own final state — breaks the
        #      floor-hover stalls a cold repeat reproduces (CLAUDE.md
        #      #3);
        #   2. cold flat start for anything STILL stuck — breaks stalls
        #      caused by a bad continuation seed (the complementary
        #      failure: a cold start is exactly the plain sweep's path).
        # Stragglers are GATHERED into a chunk-width (K = Bc) batch first
        # (the adaptive sweep's narrow-re-solve trick, device-side):
        # B-wide rescue loops made the straggler reps ~1.8x slower at
        # net2 B=4096 — one knife-edge scenario dragged 32 lane-slabs
        # through up to 2·max_iter_h trips.  Up to K stragglers are
        # rescued; typical failure counts are <<Bc.
        K = min(Bc, B)
        bad = jnp.argsort(conv.astype(rd), stable=True)[:K]
        was_bad = ~conv[bad]
        g = lambda x: jnp.take(x, bad, axis=-1)
        S_k = Cx(g(S.re), g(S.im))
        inj_k = g(inj_db)
        dev_k = dev
        if isinstance(dev, LaneDevices) and dev.batched:
            dev_k = LaneDevices(I_N=Cx(g(dev.I_N.re), g(dev.I_N.im)),
                                Y_N=Cx(g(dev.Y_N.re), g(dev.Y_N.im)),
                                coupled=dev.coupled, batched=True)
        fundr = solve_fundamental_lanes(Y[0], S_k, net, settings, K,
                                        lineY_f)
        coldVm = jnp.full((H, n, K), settings.v_init_h, rd) \
            .at[0].set(fundr.V_m)
        coldVa = jnp.full((H, n, K), settings.a_init_h, rd) \
            .at[0].set(fundr.V_a)

        # rescue threshold: same cold-state floor as the chunks (above)
        thresh_k = _thresh_lanes(coldVm, Y, dev_k, inj_k, m, settings)

        def rescue_pass(V_mk, V_ak, errk, nitk, histk, convk, Vm0, Va0):
            # converged scenarios must stay inactive: lift their threshold
            # to their achieved error so the loop never touches them
            thresh_r = jnp.where(convk, jnp.maximum(thresh_k, errk),
                                 thresh_k)
            Vm2, Va2, err2, nit2, hist2 = nr_trip_lanes(
                Y, lineY, S_k, dev_k, inj_k, Vm0, Va0, settings, consts,
                thresh_r, vc=_vc)
            redo = ~convk
            V_mk = jnp.where(redo[None, None, :], Vm2, V_mk)
            V_ak = jnp.where(redo[None, None, :], Va2, V_ak)
            errk = jnp.where(redo, err2, errk)
            nitk = nitk + jnp.where(redo, nit2, 0)
            histk = jnp.where(redo[None, :], hist2, histk)
            convk = convk | (redo & (err2 <= thresh_r))
            return V_mk, V_ak, errk, nitk, histk, convk

        Vmk, Vak = g(V_m), g(V_a)
        finite = (jnp.isfinite(Vmk).all(axis=(0, 1))
                  & jnp.isfinite(Vak).all(axis=(0, 1)))
        use_self = (finite | conv[bad])[None, None, :]
        state = (Vmk, Vak, err[bad], n_iter[bad], g(hist), conv[bad])
        state = rescue_pass(*state, jnp.where(use_self, Vmk, coldVm),
                            jnp.where(use_self, Vak, coldVa))
        state = rescue_pass(*state, coldVm, coldVa)
        Vmk, Vak, errk, nitk, histk, convk = state

        # scatter the rescued stragglers back (slots that held converged
        # padding write their unchanged gathered values — harmless even
        # with duplicate indices)
        sc = lambda full, kk, mask: full.at[..., bad].set(
            jnp.where(mask, kk, jnp.take(full, bad, axis=-1)))
        V_m = sc(V_m, Vmk, was_bad[None, None, :])
        V_a = sc(V_a, Vak, was_bad[None, None, :])
        err = sc(err, errk, was_bad)
        n_iter = sc(n_iter, nitk, was_bad)
        hist = sc(hist, histk, was_bad[None, :])
        conv = sc(conv, convk, was_bad)

    V_m, V_a = cleanup_voltages(V_m, V_a)
    return HPFResult(
        V_m=jnp.moveaxis(V_m, -1, 0), V_a=jnp.moveaxis(V_a, -1, 0),
        err=err, n_iter=n_iter, err_hist=hist.T,
        converged=conv, fund=None)
