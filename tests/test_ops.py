"""Batched linear solves (hpfx.ops): every route against LAPACK, the route
and layout decisions, and the Pallas kernel through Triton in interpret
mode (the compiled kernel runs in the GPU tier, tests/test_compile_probe.py).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hpfx.ops import auto_layout, batched_solve, batched_solve_lanes
from hpfx.ops.batched_solve import (_LANE_ROUTES, _lu_solve,
                                    _lu_solve_lanes, equilibrated,
                                    equilibrated_lanes)
from hpfx.ops.dispatch import ROUTES, solve_route
from hpfx.ops.gj_triton import gj_solve_triton_lanes

rng = np.random.default_rng(7)


def _systems(B, n, cond_boost=3.0):
    A = (rng.normal(size=(B, n, n)) +
         cond_boost * np.sqrt(n) * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(B, n)).astype(np.float32)
    ref = np.stack([np.linalg.solve(A[i], b[i]) for i in range(B)])
    return A, b, ref


def _lanes(solve):
    """Adapt a lane-minor solve (n, n, B), (n, R, B) to batch-major
    (B, n, n), (B, n) or (B, n, R) operands."""
    def wrapped(A, b):
        multi = b.ndim == 3
        b3 = b if multi else b[..., None]
        x = solve(jnp.moveaxis(A, 0, -1), jnp.moveaxis(b3, 0, -1))
        x = jnp.moveaxis(x, -1, 0)
        return x if multi else x[..., 0]
    return wrapped


#: every f32 solve a sweep can take, batch-major in and out: the two
#: dispatchers as the CPU runs them, and the GPU's small-system route by
#: itself (the Triton kernel in the Pallas interpreter)
SOLVERS = {
    "batched_solve": batched_solve,
    "batched_solve_lanes": _lanes(batched_solve_lanes),
    "gj_triton": _lanes(equilibrated_lanes(
        partial(gj_solve_triton_lanes, interpret=True))),
}


@pytest.mark.parametrize("solver", SOLVERS)
def test_solve_needs_pivoting(solver):
    """Zero leading diagonal entry: elimination without pivoting would
    divide by zero; every route's pivoting must handle it."""
    A = np.array([[[0.0, 1.0], [1.0, 0.0]]], np.float32)
    b = np.array([[2.0, 3.0]], np.float32)
    x = SOLVERS[solver](jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(x), [[3.0, 2.0]], atol=1e-6)


@pytest.mark.parametrize("solver", SOLVERS)
def test_solve_batch_padding(solver):
    """Batch sizes that divide no block size come back unpadded."""
    A, b, ref = _systems(5, 10)
    x = SOLVERS[solver](jnp.asarray(A), jnp.asarray(b))
    assert x.shape == (5, 10)
    np.testing.assert_allclose(np.asarray(x), ref,
                               atol=3e-5 * np.abs(ref).max())


@pytest.mark.parametrize("solver", SOLVERS)
def test_solve_multi_rhs(solver):
    """Multi-RHS elimination (the arrow solver's per-block pattern)."""
    A, _, _ = _systems(6, 12)
    R = 5
    Brhs = rng.normal(size=(6, 12, R)).astype(np.float32)
    x = SOLVERS[solver](jnp.asarray(A), jnp.asarray(Brhs))
    assert x.shape == (6, 12, R)
    ref = np.stack([np.linalg.solve(A[i], Brhs[i]) for i in range(6)])
    np.testing.assert_allclose(np.asarray(x), ref,
                               atol=3e-5 * np.abs(ref).max())


@pytest.mark.parametrize("solver", ["batched_solve", "batched_solve_lanes"])
def test_solve_large_dims(solver):
    """The dispatchers at the capacitance and dense-step dims of net1
    (182 at H<=25, 364 at H<=51) and in between, multi-RHS included."""
    for n, B, R in [(182, 8, 1), (150, 4, 3), (364, 2, 1), (136, 4, 2)]:
        A = rng.normal(size=(B, n, n)).astype(np.float32)
        A += 0.1 * n * np.eye(n, dtype=np.float32)
        b = rng.normal(size=(B, n, R)).astype(np.float32)
        x = jax.jit(SOLVERS[solver])(jnp.asarray(A), jnp.asarray(b))
        ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(np.asarray(x), ref,
                                   atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("solver", SOLVERS)
def test_solve_capacitance_accuracy(solver):
    """On Woodbury-capacitance-style systems (I + coupling, the arrow
    solver's S matrix) every route's mean per-system f32 error stays
    within 4x of plain LU's vs an f64 reference (the bound chip_smoke.py
    holds the card's routes to)."""
    r = np.random.default_rng(0)
    n, B = 16, 16
    C = r.normal(size=(B, n, n)) * (0.8 / np.sqrt(n))
    A64 = np.eye(n) + C
    b64 = r.normal(size=(B, n))
    ref = np.linalg.solve(A64, b64[..., None])[..., 0]
    A32 = jnp.asarray(A64, jnp.float32)
    b32 = jnp.asarray(b64, jnp.float32)

    def errs(x):
        d = np.abs(np.asarray(x) - ref)
        per = d.max(axis=1) / np.abs(ref).max(axis=1)
        return d.max() / np.abs(ref).max(), per.mean()

    _, mean_lu = errs(_lu_solve(A32, b32))
    err, mean = errs(SOLVERS[solver](A32, b32))
    assert err < 1e-4, err
    assert mean <= 4 * mean_lu, (mean, mean_lu)


def test_batched_solve_dispatch_cpu():
    """On CPU the dispatcher uses LAPACK and handles any size/dtype."""
    A, b, ref = _systems(4, 50)
    x = batched_solve(jnp.asarray(A, jnp.float64), jnp.asarray(b, jnp.float64))
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-4)
    A, b, ref = _systems(2, 202)
    x = batched_solve(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(x), ref,
                               atol=1e-4 * np.abs(ref).max())




def test_gj_triton_rejects_large_dim():
    from hpfx.ops.gj_triton import MAX_DIM
    n = MAX_DIM + 1
    with pytest.raises(ValueError, match="exceeds"):
        gj_solve_triton_lanes(jnp.zeros((n, n, 2)), jnp.zeros((n, 1, 2)),
                              interpret=True)


@pytest.mark.parametrize("n,B", [(3, 4), (6, 16), (12, 8), (16, 4),
                                 (4, 5), (12, 7), (16, 3)])
def test_gj_triton_group_padding(n, B):
    """The kernel (in the Pallas interpreter, equilibrated as routed)
    solves every dim up to MAX_DIM; batches that no group size divides
    (5 at G=8, 7 and 3 at G=2) are padded up to the group and sliced off
    again."""
    A, b, ref = _systems(B, n)
    x = SOLVERS["gj_triton"](jnp.asarray(A), jnp.asarray(b))
    assert x.shape == (B, n)
    np.testing.assert_allclose(np.asarray(x), ref,
                               atol=3e-5 * np.abs(ref).max())


def test_solve_blocks_vmap_flattening():
    """solve_blocks' custom vmap rule flattens (scenario, harmonic) into
    one batch; results must equal per-scenario LAPACK solves exactly in
    semantics (CPU backend: both paths are LAPACK)."""
    from hpfx.ops.batched_solve import solve_blocks
    B, H, k, R = 3, 5, 8, 4
    D = (rng.normal(size=(B, H, k, k)) +
         3.0 * np.sqrt(k) * np.eye(k)).astype(np.float32)
    rhs = rng.normal(size=(B, H, k, R)).astype(np.float32)
    out = jax.vmap(solve_blocks)(jnp.asarray(D), jnp.asarray(rhs))
    ref = np.linalg.solve(D, rhs)
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=1e-4 * np.abs(ref).max())
    # unbatched base case
    one = solve_blocks(jnp.asarray(D[0]), jnp.asarray(rhs[0]))
    np.testing.assert_allclose(np.asarray(one), ref[0],
                               atol=1e-4 * np.abs(ref).max())


def test_batched_solve_multi_rhs_dispatch_cpu():
    """The dispatcher accepts (B, n, R) right-hand sides on every path."""
    A, _, _ = _systems(4, 12)
    R = 3
    rhs = rng.normal(size=(4, 12, R)).astype(np.float32)
    x = batched_solve(jnp.asarray(A), jnp.asarray(rhs))
    ref = np.linalg.solve(A, rhs)
    np.testing.assert_allclose(np.asarray(x), ref,
                               atol=1e-4 * np.abs(ref).max())


def test_equilibration_restores_f32_accuracy():
    """Row/column max-abs equilibration (applied on the f32 solve path):
    exact for diagonal scalings, and decisively more accurate when rows
    span several orders of magnitude — the HPF Jacobian's shape (power
    rows O(1), current rows O(|Y|) ~ 1e4)."""
    B, n = 8, 60
    A, b, _ = _systems(B, n)
    # blow up half the rows by 1e4 (keeps the exact solution if b scales)
    scale = np.ones((1, n, 1), np.float32)
    scale[:, ::2] = 1e4
    A64 = A.astype(np.float64) * scale
    b64 = b.astype(np.float64) * scale[..., 0]
    ref = np.linalg.solve(A64, b64[..., None])[..., 0]
    As, bs = A64.astype(np.float32), b64.astype(np.float32)
    x_eq = np.asarray(equilibrated(_lu_solve)(jnp.asarray(As),
                                              jnp.asarray(bs)))
    err_eq = np.abs(x_eq - ref).max() / np.abs(ref).max()
    x_raw = np.asarray(_lu_solve(jnp.asarray(As), jnp.asarray(bs)))
    err_raw = np.abs(x_raw - ref).max() / np.abs(ref).max()
    assert err_eq < 1e-4, err_eq
    assert err_eq <= err_raw * 1.5  # never meaningfully worse


# (platform, dtype, dim) -> route the dispatcher must pick
ROUTE_TABLE = [
    ("cpu", np.float32, 8, "lu_equilibrated"),
    ("cpu", np.float32, 26, "lu_equilibrated"),
    ("cpu", np.float32, 518, "lu_equilibrated"),
    ("cpu", np.float64, 26, "lu"),
    ("gpu", np.float32, 6, "gj_triton"),
    ("gpu", np.float32, 8, "gj_triton"),
    ("gpu", np.float32, 16, "gj_triton"),
    ("gpu", np.float32, 17, "lu_equilibrated"),
    ("gpu", np.float32, 26, "lu_equilibrated"),
    ("gpu", np.float32, 182, "lu_equilibrated"),
    ("gpu", np.float64, 8, "lu"),
    ("gpu", np.float64, 518, "lu"),
]


@pytest.mark.parametrize("platform,dtype,n,route", ROUTE_TABLE,
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_solve_route(platform, dtype, n, route):
    assert solve_route(platform, dtype, n) == route


def test_routes_are_all_implemented_and_compiled():
    """Every route the dispatcher names is implemented, and none runs a
    kernel in interpret mode: the traced Triton route's pallas_call is a
    compiled call."""
    assert set(_LANE_ROUTES) == set(ROUTES)
    picked = {solve_route(p, d, n) for p in ("cpu", "gpu")
              for d in (np.float32, np.float64) for n in range(1, 600)}
    assert picked == set(ROUTES)
    n = 8
    jaxpr = jax.make_jaxpr(_LANE_ROUTES["gj_triton"])(
        jnp.zeros((n, n, 8), jnp.float32), jnp.zeros((n, 1, 8), jnp.float32))
    calls = [e for e in _walk(jaxpr.jaxpr) if e.primitive.name == "pallas_call"]
    assert calls
    for e in calls:
        assert not e.params["interpret"], e.params["interpret"]


def _walk(jaxpr):
    for e in jaxpr.eqns:
        yield e
        for p in e.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _walk(inner)


@pytest.mark.parametrize("platform,layout", [("cpu", "vmap"),
                                             ("gpu", "lanes")])
def test_auto_layout(platform, layout):
    assert auto_layout(platform) == layout


def test_lu_lanes_matches_batch_major():
    """The lane-minor LU route is the batch-major LU, relayouted."""
    A, b, ref = _systems(6, 9)
    x = _lanes(_lu_solve_lanes)(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(x), ref,
                               atol=3e-5 * np.abs(ref).max())
