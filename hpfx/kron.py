"""Kron reduction: eliminate passive buses before solving.

Passive buses (PQ type, zero load, no shunt, no device — e.g. net2's bus 3
``nothing``) contribute pure zero-current-balance equations at every
frequency.  Schur-complementing them out of each harmonic admittance block

    Y_red[h] = Y_kk[h] - Y_ke[h] · Y_ee[h]^{-1} · Y_ek[h]

shrinks the Newton system (dim 2·H·n - 1 - c scales linearly in n) while
leaving the kept buses' solution *identical*; eliminated-bus voltages are
recovered afterwards from V_e[h] = -Y_ee[h]^{-1} · Y_ek[h] · V_k[h].

Classic network-analysis technique (cf. "Performance Assessment of Kron
Reduction in the Numerical Analysis of Polyphase Power Systems",
arXiv:1907.06930 — listed in PAPERS.md); absent from the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np

from . import cx
from .config import Settings
from .cx import Cx
from .harmonic import HPFResult
from .network import PQ, Network


class KronReduction(NamedTuple):
    net: Network          # reduced network (no line data; use Y)
    Y: Cx                 # (H, n_k, n_k) reduced admittance tensor
    keep: np.ndarray      # original indices of kept buses
    elim: np.ndarray      # original indices of eliminated buses
    # dense recovery operator R[h]: V_e[h] = R[h] @ V_k[h]
    R: Cx


def passive_buses(net: Network) -> np.ndarray:
    """Indices of eliminable buses: PQ with zero P/Q/S and no shunt."""
    types = np.asarray(net.bus_types)
    P = np.asarray(net.bus_P)
    Q = np.asarray(net.bus_Q)
    S = np.asarray(net.bus_S)
    Xsh = np.asarray(net.bus_Xsh)
    mask = (types == PQ) & (P == 0) & (Q == 0) & (S == 0) & (Xsh == 0)
    return np.where(mask)[0]


def kron_reduce(net: Network, settings: Settings, Y: Cx = None,
                elim: np.ndarray = None) -> KronReduction:
    """Schur-complement the passive buses out of every harmonic block."""
    from .ybus import build_ybus

    if Y is None:
        Y = build_ybus(net, settings)
    if elim is None:
        elim = passive_buses(net)
    elim = np.asarray(elim, int)
    keep = np.array([i for i in range(net.n) if i not in set(elim.tolist())])
    if elim.size == 0:
        raise ValueError("no passive buses to eliminate")

    kk = np.ix_(keep, keep)
    ke = np.ix_(keep, elim)
    ek = np.ix_(elim, keep)
    ee = np.ix_(elim, elim)
    Y_kk = Y[:, kk[0], kk[1]]
    Y_ke = Y[:, ke[0], ke[1]]
    Y_ek = Y[:, ek[0], ek[1]]
    Y_ee = Y[:, ee[0], ee[1]]

    # per-harmonic dense Schur complement (batched over H)
    X = cx.solve(Y_ee, Y_ek)                # Y_ee^{-1} Y_ek, (H, n_e, n_k)
    Y_red = Y_kk - _bmm(Y_ke, X)
    R = -X

    net_red = dataclasses.replace(
        net,
        bus_P=net.bus_P[keep], bus_Q=net.bus_Q[keep],
        bus_S=net.bus_S[keep], bus_Xsh=net.bus_Xsh[keep],
        line_from=np.zeros(0, np.int32), line_to=np.zeros(0, np.int32),
        line_R=np.zeros(0), line_X=np.zeros(0), line_G=np.zeros(0),
        line_B=np.zeros(0), line_tau=np.zeros(0), line_shift=np.zeros(0),
        n=len(keep),
        m=int(np.searchsorted(keep, net.m)),
        c=net.c,
        bus_types=tuple(net.bus_types[i] for i in keep),
        components=tuple(net.components[i] for i in keep))
    return KronReduction(net=net_red, Y=Y_red, keep=keep, elim=elim, R=R)


def _bmm(a: Cx, b: Cx) -> Cx:
    """Split-complex batched matmul at HIGHEST precision (the bf16 default
    would corrupt the Schur complement; see hpfx.utils.precision)."""
    import jax
    import jax.numpy as jnp

    mm = lambda x, y: jnp.matmul(x, y, precision=jax.lax.Precision.HIGHEST)
    return Cx(mm(a.re, b.re) - mm(a.im, b.im),
              mm(a.re, b.im) + mm(a.im, b.re))


def expand_voltages(red: KronReduction, V_m_k, V_a_k, n_full: int):
    """Expand kept-bus voltages (..., H, n_k) to all original buses.

    Eliminated-bus phasors come from V_e = R @ V_k per harmonic; accepts an
    optional leading batch axis (the sweep path).  All contractions request
    HIGHEST precision — a reduced-precision matmul default (TF32 on a
    GPU) would corrupt the recovered voltages.
    """
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    V_k = cx.polar(V_m_k, V_a_k)                        # (..., H, n_k)
    mm = lambda r, v: jnp.einsum("hek,...hk->...he", r, v, precision=hi)
    V_e = Cx(mm(red.R.re, V_k.re) - mm(red.R.im, V_k.im),
             mm(red.R.re, V_k.im) + mm(red.R.im, V_k.re))
    shape = V_m_k.shape[:-1] + (n_full,)
    keep = jnp.asarray(red.keep)
    elim = jnp.asarray(red.elim)
    V_m = jnp.zeros(shape, V_m_k.dtype).at[..., keep].set(V_m_k)
    V_a = jnp.zeros(shape, V_a_k.dtype).at[..., keep].set(V_a_k)
    V_m = V_m.at[..., elim].set(V_e.abs())
    V_a = V_a.at[..., elim].set(V_e.angle() % (2 * jnp.pi))
    return V_m, V_a


def recover_voltages(red: KronReduction, result: HPFResult, n_full: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Expand a reduced-solution HPFResult back to all original buses.

    Returns (V_m, V_a) of shape (H, n_full); see :func:`expand_voltages`.
    """
    return expand_voltages(red, result.V_m, result.V_a, n_full)
