"""Fundamental-frequency Newton-Raphson power flow.

Batched JAX re-design of the reference fundamental solver
(``hcne_generalized.py:187-275``: init_fund_state_vec, fund_mismatch,
build_jacobian, update_fund_state_vec, update_fund_voltages, pf), which is in
turn PyPSA-style (see the permalink cited at hcne_generalized.py:8-9).

Differences from the reference's implementation (not its math):
- complex quantities are split-complex ``Cx`` pairs (see hpfx.cx) — every
  complex product lowers to real ops, with no complex element types
  anywhere,
- the NR iteration is a ``lax.while_loop`` with a (V, x, f, err, iter) carry,
  traced once and compiled by XLA; no Python-level looping,
- the Jacobian is a dense (2n-1-c)^2 real matrix assembled from broadcasted
  algebra (no scipy.sparse); at these sizes dense batched LU beats any
  sparse path,
- everything is shape-static: the slack/PV/PQ partition enters through the
  static constants n, c (hcne_generalized.py:113-128), so slicing is
  compile-time.

State layout (identical to the reference so states compare element-for-
element): ``x = [V_a[1:], V_m[c:]]`` — angles of all non-slack buses, then
magnitudes of all non-PV/non-slack buses (hcne_generalized.py:187-192).

Sign convention: mismatch = V*conj(Y1@V) + S with S > 0 for loads
(hcne_generalized.py:195-198).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network
from .ops.batched_solve import nr_solve
from .utils.precision import highest_precision


class FundResult(NamedTuple):
    V_m: jnp.ndarray       # (n,)
    V_a: jnp.ndarray       # (n,)
    err: jnp.ndarray       # scalar, final max-abs mismatch
    n_iter: jnp.ndarray    # scalar int
    err_hist: jnp.ndarray  # (max_iter_f,), NaN-padded
    converged: jnp.ndarray


def fund_mismatch(V_m, V_a, Y1: Cx, S: Cx, c: int, lineY=None):
    """Power mismatch and its residual (hcne_generalized.py:195-202).

    f = [Re(mis)[1:], Im(mis)[c:]] where mis = V∘conj(Y1·V) + S;
    err is the max-abs entry.  ``lineY``: optional fundamental-sliced
    ``hpfx.ybus.LineYbus`` for the cancellation-free Y·V form
    (Settings.stable_mismatch; see hpfx.ybus.stable_matvec).
    """
    V = cx.polar(V_m, V_a)
    if lineY is None:
        I = cx.matvec(Y1, V)
    else:
        from .ybus import stable_matvec
        I = stable_matvec(lineY, V_m[None], V_a[None])[0]
    mis = V * I.conj() + S
    f = jnp.concatenate([mis.re[1:], mis.im[c:]])
    return f, jnp.max(jnp.abs(f))


def _power_jacobian_blocks(V: Cx, Vn: Cx, Y: Cx, n: int):
    """dS/dA and dS/dV as (n, n) split-complex matrices.

    Complex derivation (PyPSA style; hcne_generalized.py:205-223):
        dS/dA[i,j] = j·V_i · conj(δ_ij·I_i − Y_ij·V_j)
        dS/dV[i,j] = δ_ij·Vn_i·conj(I_i) + V_i·conj(Y_ij·Vn_j)
    with I = Y·V and Vn the caller-chosen normalization (|V| in the
    fundamental solver at :210; signed V_m inside the harmonic Jacobian's
    fundamental rows at :455).
    """
    I = cx.matvec(Y, V)
    eye = jnp.eye(n, dtype=V.re.dtype)
    diag_I = Cx(eye * I.re[:, None], eye * I.im[:, None])
    dSdA = (V[:, None] * (diag_I - Y * V[None, :]).conj()).jmul()
    w = Vn * I.conj()
    diag_w = Cx(eye * w.re[:, None], eye * w.im[:, None])
    dSdV = diag_w + V[:, None] * (Y * Vn[None, :]).conj()
    return dSdA, dSdV


def fund_jacobian(V_m, V_a, Y1: Cx, n: int, c: int):
    """Dense real fundamental Jacobian (hcne_generalized.py:205-223):
    blocks [[Re dSdA[1:,1:], Re dSdV[1:,c:]], [Im dSdA[c:,1:], Im dSdV[c:,c:]]].
    """
    V = cx.polar(V_m, V_a)
    Vn = V * (1.0 / V.abs())        # |V| normalization (reference :210)
    dSdA, dSdV = _power_jacobian_blocks(V, Vn, Y1, n)
    return jnp.block([
        [dSdA.re[1:, 1:], dSdV.re[1:, c:]],
        [dSdA.im[c:, 1:], dSdV.im[c:, c:]],
    ])


def init_fund_voltages(net: Network, settings: Settings):
    rd = settings.real_dtype
    V_m = jnp.full((net.n,), settings.v_init_f, dtype=rd)
    V_a = jnp.full((net.n,), settings.a_init_f, dtype=rd)
    return V_m, V_a


@highest_precision
def solve_fundamental(Y1: Cx, net: Network, settings: Settings,
                      lineY=None) -> FundResult:
    """Fundamental NR loop (pf, hcne_generalized.py:244-275) as a jittable
    ``lax.while_loop``.  Safe under vmap: JAX's while-loop batching rule
    predicates the carry per batch element, so each scenario stops updating
    exactly when its own convergence test fires — matching serial behavior.

    ``lineY``: optional fundamental-sliced ``hpfx.ybus.LineYbus`` for the
    stable mismatch — supplied by the entry points that built ``Y1`` from
    the network (it must describe the SAME system as Y1; callers that
    override Y, e.g. the Kron-reduced path, pass None)."""
    n, c = net.n, net.c
    S = Cx(net.bus_P, net.bus_Q)
    V_m, V_a = init_fund_voltages(net, settings)

    x0 = jnp.concatenate([V_a[1:], V_m[c:]])
    f0, err0 = fund_mismatch(V_m, V_a, Y1, S, c, lineY)
    hist0 = jnp.full((settings.max_iter_f,), jnp.nan, settings.real_dtype)

    # floor-aware convergence (see hpfx.harmonic.mismatch_floor): the power
    # mismatch V∘conj(Y·V)+S can only be evaluated to eps·|V|·sum|Y||V|;
    # in f64 this reduces to the reference's absolute thresh_f
    eps = jnp.finfo(settings.real_dtype).eps
    rows = jnp.abs(V_m) * jnp.einsum("ij,j->i", Y1.abs(), jnp.abs(V_m))
    thresh_eff = jnp.maximum(
        jnp.asarray(settings.thresh_f, settings.real_dtype),
        settings.floor_kappa * eps * jnp.max(rows + S.abs()))

    def cond(carry):
        _, _, _, _, err, it, _ = carry
        return (err > thresh_eff) & (it < settings.max_iter_f)

    def body(carry):
        V_m, V_a, x, f, err, it, hist = carry
        J = fund_jacobian(V_m, V_a, Y1, n, c)
        x = x - nr_solve(J, f)
        V_a = V_a.at[1:].set(x[: n - 1])
        V_m = V_m.at[c:].set(x[n - 1:])
        f, err = fund_mismatch(V_m, V_a, Y1, S, c, lineY)
        hist = hist.at[it].set(err)
        return V_m, V_a, x, f, err, it + 1, hist

    V_m, V_a, _, _, err, n_iter, hist = lax.while_loop(
        cond, body, (V_m, V_a, x0, f0, err0, jnp.int32(0), hist0))
    return FundResult(V_m, V_a, err, n_iter, hist,
                      err <= thresh_eff)


def pf(Y: Cx, net: Network, settings: Settings) -> FundResult:
    """Convenience wrapper taking the (H, n, n) Ybus tensor and using its
    fundamental block, as the reference's pf does (hcne_generalized.py:255)."""
    return solve_fundamental(Y[0], net, settings)
