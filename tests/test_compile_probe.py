"""GPU tier: compile the sweep programs and solve routes for the card.

Each test compiles for the GPU (``.lower().compile()``), runs once at a
small batch and compares with the CPU-independent reference where one
exists.  Run on a machine with a GPU:

    HPFX_TEST_PLATFORM=gpu python -m pytest tests -m gpu -q

(``chip_smoke.py`` runs exactly this first.)  Without a GPU every test
skips, decided inside the ``gpu`` fixture.
"""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hpfx
from hpfx.ops import batched_solve_lanes
from hpfx.ops.dispatch import ROUTES, solve_route

from conftest import DATA

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX's default backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


#: (dim, RHS count, batch) of every lane-minor solve class a sweep
#: dispatches: arrow blocks of net2 (8, 1+2) and net1 (40, 1+14), the
#: capacitance solves of net2 (26) and net1 (182), the warm seed (96)
#: and a dim past every small-system route (364)
SOLVE_SHAPES = [(8, 3, 4096), (40, 15, 512), (26, 1, 4096), (96, 1, 1024),
                (182, 1, 256), (364, 1, 64)]


@pytest.mark.parametrize("n,R,B", SOLVE_SHAPES)
def test_solve_route_compiles_and_solves(gpu, n, R, B):
    route = solve_route("gpu", jnp.float32, n)
    assert route in ROUTES
    rng = np.random.default_rng(n)
    A = (rng.normal(size=(n, n, B))
         + 3 * np.sqrt(n) * np.eye(n)[:, :, None]).astype(np.float32)
    b = rng.normal(size=(n, R, B)).astype(np.float32)
    f = jax.jit(batched_solve_lanes)
    with jax.default_matmul_precision("highest"):
        compiled = f.lower(jnp.asarray(A), jnp.asarray(b)).compile()
        x = np.asarray(compiled(jnp.asarray(A), jnp.asarray(b)))
    ref = np.linalg.solve(np.moveaxis(A, -1, 0).astype(np.float64),
                          np.moveaxis(b, -1, 0).astype(np.float64))
    np.testing.assert_allclose(np.moveaxis(x, -1, 0), ref,
                               atol=1e-4 * np.abs(ref).max())


def _net2(h_max=25, **kw):
    s = hpfx.settings_for_hmax(h_max, coupled=True).with_(
        stable_mismatch=True, dtype="float32", **kw)
    net = hpfx.load_network(os.path.join(DATA, "net2_buses.csv"),
                            os.path.join(DATA, "net2_lines.csv"), s)
    return s, net, hpfx.load_device_set(net, s)


def _scen(B):
    from hpfx.solve import Scenarios
    return Scenarios(p_scale=jnp.linspace(0.9, 1.1, B),
                     q_scale=jnp.linspace(0.9, 1.1, B),
                     injection_scale=jnp.linspace(0.8, 1.2, B))


@pytest.mark.parametrize("solver,layout", [("dense", "auto"),
                                           ("arrow", "vmap"),
                                           ("arrow", "lanes")])
def test_sweep_program_compiles(gpu, solver, layout):
    """The batched coupled-HPF sweep (net2, H<=25) compiles for the card
    and converges: the plain lockstep sweep has no rescue, so a
    knife-edge f32 scenario may stay unconverged (CLAUDE.md #3)."""
    from hpfx.solve import hpf_sweep
    s, net, dev = _net2(solver=solver, layout=layout)
    compiled = hpf_sweep.lower(net, dev, settings=s,
                               scenarios=_scen(128)).compile()
    res = compiled(net, dev, scenarios=_scen(128))
    conv = np.asarray(res.converged)
    assert conv.mean() >= 0.95, conv.mean()
    assert np.isfinite(np.asarray(res.V_m)[conv]).all()


def test_device_program_compiles(gpu):
    """The single-program adaptive sweep with the in-program warm seed
    (the net2 bench stage's program) compiles and converges."""
    from hpfx.lanes import hpf_sweep_adaptive_lanes
    s, net, dev = _net2(solver="arrow")
    f = jax.jit(partial(hpf_sweep_adaptive_lanes, settings=s,
                        phase_iters=24, warm="linear"))
    res = f.lower(net, dev, scenarios=_scen(256)).compile()(
        net, dev, scenarios=_scen(256))
    assert bool(np.all(np.asarray(res.converged)))


def test_f64_rescue_on_card(gpu):
    """The f64 straggler re-solve runs on the card."""
    from hpfx.solve import _f64_resolve
    s, net, dev = _net2(solver="arrow")
    r = _f64_resolve(net, dev, s, _scen(4))
    assert bool(np.all(np.asarray(r.converged)))
    assert r.V_m.devices() == {gpu}
