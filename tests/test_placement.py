"""Filter placement screening (hpfx/placement.py).

The solver and the filter admittance models are parity/oracle-gated
elsewhere (test_harmonic.py, test_impedance.py); these gate the
screening logic: batched-vs-serial solve identity, ranking and
acceptance accounting, branch-duty arithmetic, the collapse guard, and
the greedy bank planner's re-screening semantics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hpfx
from hpfx import placement as pl
from hpfx.cx import Cx

from conftest import make_setup


@pytest.fixture(scope="module")
def net2c():
    return make_setup(("net2", 25, True))


@pytest.fixture(scope="module")
def screen(net2c):
    s, net, dev = net2c
    return pl.screen_filter_placement(
        net, dev, s, buses=[1, 2, 3], h_tunes=[4.85, 6.79],
        x_caps=[0.5, 1.0])


def test_screen_shapes_and_grid(screen):
    K = 3 * 2 * 2
    assert screen.bus.shape == (K,)
    assert screen.converged.all()
    # full cross product present
    combos = set(zip(screen.bus.tolist(), screen.h_tune.tolist(),
                     screen.x_cap.tolist()))
    assert len(combos) == K


def test_screen_matches_serial_solves(net2c, screen):
    """The vmapped screen row equals an independent hpf(Y_diag=...)."""
    s, net, dev = net2c
    for k in (0, 5, 11):
        yd = pl.filter_ydiag(net, s, screen.bus[k], screen.h_tune[k],
                             screen.x_cap[k])
        res = jax.jit(lambda y: hpfx.hpf(net, dev, s, Y_diag=y))(yd)
        thd = float(np.max(np.asarray(hpfx.get_thd(res.V_m).THD_F)))
        assert bool(res.converged)
        assert thd == pytest.approx(float(screen.thd_worst[k]), abs=1e-10)


def test_ranking_and_best_improves(screen):
    i = screen.best
    assert bool(screen.accepted[i])
    # best-first ordering over accepted candidates
    obj = screen.objective[screen.order]
    acc = screen.accepted[screen.order]
    assert (np.diff(obj[acc]) >= 0).all()
    # a well-placed tuned filter beats the unmitigated base case
    assert screen.objective[i] < screen.base_objective
    assert screen.base_thd_worst == pytest.approx(screen.base_objective)


def test_branch_duty_accounting(net2c, screen):
    """q_fund / i_rms_ratio follow from the solved state and Y_f(h)."""
    s, net, dev = net2c
    k = screen.best
    yd = pl.filter_ydiag(net, s, screen.bus[k], screen.h_tune[k],
                         screen.x_cap[k])
    res = hpfx.hpf(net, dev, s, Y_diag=yd)
    b = int(screen.bus[k])
    y = Cx(yd.re[:, b], yd.im[:, b])
    i_mag = np.asarray(y.abs()) * np.asarray(res.V_m[:, b])
    assert screen.i_rms_ratio[k] == pytest.approx(
        np.sqrt((i_mag ** 2).sum()) / i_mag[0], rel=1e-9)
    # below its tuned order the branch is net capacitive: supplies vars
    assert screen.q_fund[k] > 0
    assert screen.q_fund[k] == pytest.approx(
        float(res.V_m[0, b]) ** 2 * float(yd.im[0, b]), rel=1e-9)


def test_collapse_guard_rejects(net2c):
    """A near-short x_cap candidate must be rejected, not ranked first
    (the degenerate pure-THD minimum, CLAUDE.md #15)."""
    s, net, dev = net2c
    rep = pl.screen_filter_placement(
        net, dev, s, buses=[3], h_tunes=[4.85], x_caps=[3e-3, 1.0],
        v_limits=(0.8, 1.2))
    tiny = int(np.argmin(rep.x_cap))
    assert not rep.accepted[tiny]
    assert int(rep.order[0]) != tiny


def test_dominant_orders(net2c):
    s, net, dev = net2c
    orders = pl.dominant_orders(net, dev, s, k=3)
    assert len(orders) == 3 and (np.diff(orders) > 0).all()
    # net2's SMPS spectrum is strongest at the low odd orders
    assert orders[0] in (3.0, 5.0, 7.0)


def test_plan_filter_bank_greedy(net2c):
    s, net, dev = net2c
    plan = pl.plan_filter_bank(
        net, dev, s, n_filters=2, buses=[2, 3], h_tunes=[4.85, 6.79],
        x_caps=[0.5, 1.0])
    assert len(plan.buses) >= 1
    # objective strictly improves along the greedy trajectory
    assert (np.diff(plan.history) < 0).all()
    # the cumulative Y_diag reproduces the final objective
    res = hpfx.hpf(net, dev, s, Y_diag=plan.Y_diag)
    thd = float(np.max(np.asarray(hpfx.get_thd(res.V_m).THD_F)))
    assert thd == pytest.approx(float(plan.history[-1]), abs=1e-10)
    # stage 2 screened against the stage-1 network, not the base case
    if len(plan.reports) == 2:
        assert plan.reports[1].base_objective == pytest.approx(
            plan.history[1], abs=1e-10)


def test_plan_stops_at_target(net2c):
    s, net, dev = net2c
    plan = pl.plan_filter_bank(
        net, dev, s, n_filters=3, target=1.0, buses=[3],
        h_tunes=[4.85], x_caps=[1.0])
    # base case already satisfies THD <= 1.0 -> nothing installed
    assert len(plan.buses) == 0 and plan.history.shape == (1,)


def test_unknown_topology_raises(net2c):
    s, net, dev = net2c
    with pytest.raises(ValueError, match="topology"):
        pl.screen_filter_placement(net, dev, s, topology="bandstop")
