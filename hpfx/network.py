"""Network data model: buses, lines, per-unit conversion.

JAX redesign of the reference's pandas data model
(``hcne_generalized.py:45-128`` — init_lines_from_csv / init_buses_from_csv /
init_network).  Instead of DataFrames, a ``Network`` is a registered JAX
dataclass-pytree whose numeric fields are arrays (jit/vmap-able leaves) and
whose structural fields (bus counts, type partition, component names) are
static metadata hashed into the jit cache key.

Bus ordering contract (same as the reference, hcne_generalized.py:83,114):
slack first, then PV, then PQ, then nonlinear buses.  The loader validates
this and can optionally sort on behalf of the user (the reference left this
as a TODO at :114).

Schema tolerance: the three shipped fixture nets use two schemas —
net2/net3 say ``X_sh`` (+ optional ``V_nom``) and lines carry G/B, while net1
says ``X_shunt`` and has no G/B columns (loadable only by the Julia twin,
hcne.jl:151).  This loader accepts both, normalizing exactly the way
HarmonicPowerFlow.jl does (G = B = 0 when absent).
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import numpy as np

from .config import Settings

# bus type codes
SLACK, PV, PQ, NONLINEAR = 0, 1, 2, 3
_TYPE_CODES = {"slack": SLACK, "PV": PV, "PQ": PQ, "nonlinear": NONLINEAR}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Network:
    """Static grid description in per-unit.

    Array fields are pytree leaves; ``n``/``m``/``c``/``components`` are
    static.  ``m`` is the index of the first nonlinear bus, ``c`` the number
    of PV buses plus one (slack) — the same partition constants the reference
    computes in init_network (hcne_generalized.py:121-127).
    """

    # bus arrays, shape (n,)
    bus_P: jax.Array
    bus_Q: jax.Array
    bus_S: jax.Array
    bus_Xsh: jax.Array
    # line arrays, shape (L,)
    line_from: jax.Array      # 0-based bus indices
    line_to: jax.Array
    line_R: jax.Array
    line_X: jax.Array
    line_G: jax.Array
    line_B: jax.Array
    # transformer extension (pi_trafo_pf_test.py:117-145); tau=1, shift=0 for
    # plain lines
    line_tau: jax.Array
    line_shift: jax.Array     # phase shift in radians

    # static metadata
    n: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    c: int = dataclasses.field(metadata=dict(static=True))
    bus_types: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    components: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def n_lines(self) -> int:
        return len(self.line_R)

    @property
    def n_nonlinear(self) -> int:
        return self.n - self.m

    @property
    def nonlinear_components(self) -> Tuple[str, ...]:
        return self.components[self.m:]

    def scale_loads(self, p_scale, q_scale) -> "Network":
        """Return a copy with bus P/Q scaled (scenario-sweep hook; vmap-able)."""
        return dataclasses.replace(
            self, bus_P=self.bus_P * p_scale, bus_Q=self.bus_Q * q_scale)


def _read_semicolon_csv(path: str):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh, delimiter=";"))


def _f(row, key, default=None) -> float:
    if key in row and row[key] not in (None, ""):
        return float(row[key])
    if default is None:
        raise KeyError(f"missing required column {key!r}")
    return float(default)


def load_network(
    buses_csv: str,
    lines_csv: str,
    settings: Settings,
    sort: bool = False,
    validate: bool = True,
) -> Network:
    """Load a network from the reference ``;``-delimited CSV schemas.

    Mirrors init_buses_from_csv / init_lines_from_csv / init_network
    (hcne_generalized.py:45-128) including per-unit conversion, with the
    net1 schema (``X_shunt``, no G/B) accepted as in hcne.jl:93-130.

    ``validate`` (default on) runs :func:`validate_network` on the result —
    a malformed CSV (unreachable bus, zero-impedance line, out-of-range
    endpoint) raises a descriptive ValueError instead of silently producing
    wrong physics.  Pass ``validate=False`` to load anyway.
    """
    bus_rows = _read_semicolon_csv(buses_csv)
    line_rows = _read_semicolon_csv(lines_csv)
    order = np.arange(len(bus_rows))
    types = [_TYPE_CODES[r["type"]] for r in bus_rows]
    if sort:
        order = np.argsort(types, kind="stable")
        bus_rows = [bus_rows[i] for i in order]
        types = [types[i] for i in order]
    if list(types) != sorted(types):
        raise ValueError(
            "buses must be ordered slack, PV, PQ, nonlinear "
            "(pass sort=True to reorder automatically)")

    # map original 1-based bus IDs -> possibly re-sorted 0-based indices
    id_to_idx = {int(float(r["ID"])): i for i, r in enumerate(bus_rows)}

    bp = settings.base_power
    zb = settings.base_impedance
    yb = settings.base_admittance

    bus_P = np.array([_f(r, "P") / bp for r in bus_rows])
    bus_Q = np.array([_f(r, "Q") / bp for r in bus_rows])
    bus_S = np.array([_f(r, "S", 0.0) / bp for r in bus_rows])
    bus_Xsh = np.array(
        [(_f(r, "X_sh", r.get("X_shunt", 0.0))) / zb for r in bus_rows])

    line_from = np.array([id_to_idx[int(float(r["fromID"]))] for r in line_rows])
    line_to = np.array([id_to_idx[int(float(r["toID"]))] for r in line_rows])
    line_R = np.array([_f(r, "R") / zb for r in line_rows])
    line_X = np.array([_f(r, "X") / zb for r in line_rows])
    line_G = np.array([_f(r, "G", 0.0) / yb for r in line_rows])
    line_B = np.array([_f(r, "B", 0.0) / yb for r in line_rows])
    line_tau = np.array([_f(r, "tau", 1.0) for r in line_rows])
    line_shift = np.array(
        [_f(r, "phase_shift", 0.0) * np.pi / 180.0 for r in line_rows])

    components = tuple(r["component"] for r in bus_rows)
    net = _make_network(
        bus_P, bus_Q, bus_S, bus_Xsh,
        line_from, line_to, line_R, line_X, line_G, line_B,
        line_tau, line_shift, tuple(types), components, settings)
    if validate:
        validate_network(net)
    return net


def network_from_arrays(
    *,
    bus_types: Sequence[int],
    components: Sequence[str],
    P, Q, S=None, X_sh=None,
    line_from, line_to, R, X, G=None, B=None, tau=None, phase_shift=None,
    settings: Settings,
    per_unit: bool = True,
) -> Network:
    """Programmatic constructor (replaces init_*_manually,
    hcne_generalized.py:64-110).  ``line_from``/``line_to`` are 0-based bus
    indices.  If ``per_unit`` is False, quantities are converted using the
    settings' bases, matching the CSV loader behavior."""
    nb, nl = len(P), len(R)
    P, Q = np.asarray(P, float), np.asarray(Q, float)
    S = np.zeros(nb) if S is None else np.asarray(S, float)
    X_sh = np.zeros(nb) if X_sh is None else np.asarray(X_sh, float)
    R, X = np.asarray(R, float), np.asarray(X, float)
    G = np.zeros(nl) if G is None else np.asarray(G, float)
    B = np.zeros(nl) if B is None else np.asarray(B, float)
    tau = np.ones(nl) if tau is None else np.asarray(tau, float)
    shift = (np.zeros(nl) if phase_shift is None
             else np.asarray(phase_shift, float) * np.pi / 180.0)
    if not per_unit:
        P, Q, S = P / settings.base_power, Q / settings.base_power, \
            S / settings.base_power
        X_sh = X_sh / settings.base_impedance
        R, X = R / settings.base_impedance, X / settings.base_impedance
        G, B = G / settings.base_admittance, B / settings.base_admittance
    return _make_network(
        P, Q, S, X_sh,
        np.asarray(line_from, int), np.asarray(line_to, int),
        R, X, G, B, tau, shift,
        tuple(int(t) for t in bus_types), tuple(components), settings)


def validate_network(net: "Network") -> None:
    """Structural checks the reference never performed (its init_network
    carries a TODO at hcne_generalized.py:114): every bus reachable from
    the slack, endpoints in range, no self-loops, positive impedances."""
    f = np.asarray(net.line_from)
    t = np.asarray(net.line_to)
    if f.size and (f.min() < 0 or t.min() < 0 or
                   f.max() >= net.n or t.max() >= net.n):
        raise ValueError("line endpoint out of range")
    if np.any(f == t):
        raise ValueError("self-loop line")
    z2 = np.asarray(net.line_R) ** 2 + np.asarray(net.line_X) ** 2
    if np.any(z2 <= 0):
        raise ValueError("line with zero series impedance")
    # reachability from the slack
    seen = {0}
    frontier = [0]
    adj = {}
    for a, b in zip(f.tolist(), t.tolist()):
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    while frontier:
        u = frontier.pop()
        for v in adj.get(u, ()):
            if v not in seen:
                seen.add(v)
                frontier.append(v)
    if len(seen) != net.n:
        missing = sorted(set(range(net.n)) - seen)
        raise ValueError(f"buses unreachable from the slack: {missing}")


def _make_network(bus_P, bus_Q, bus_S, bus_Xsh,
                  line_from, line_to, line_R, line_X, line_G, line_B,
                  line_tau, line_shift,
                  types: Tuple[int, ...], components: Tuple[str, ...],
                  settings: Settings) -> Network:
    n = len(bus_P)
    nl_idx = [i for i, t in enumerate(types) if t == NONLINEAR]
    m = min(nl_idx) if nl_idx else n          # hcne_generalized.py:122-125
    c = sum(1 for t in types if t == PV) + 1  # hcne_generalized.py:127
    rd = settings.real_dtype
    as_r = lambda a: np.asarray(a, dtype=rd)
    return Network(
        bus_P=as_r(bus_P), bus_Q=as_r(bus_Q), bus_S=as_r(bus_S),
        bus_Xsh=as_r(bus_Xsh),
        line_from=np.asarray(line_from, np.int32),
        line_to=np.asarray(line_to, np.int32),
        line_R=as_r(line_R), line_X=as_r(line_X),
        line_G=as_r(line_G), line_B=as_r(line_B),
        line_tau=as_r(line_tau), line_shift=as_r(line_shift),
        n=n, m=m, c=c, bus_types=types, components=components)
