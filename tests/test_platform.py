"""Platform-facing behaviour that the CPU can check: the compile-cache
directory rule, where the f64 rescue runs, and matmul precision of the
f32 sweep programs."""
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hpfx
from hpfx.solve import Scenarios
from hpfx.utils import cache

from conftest import DATA, REPO


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in names}
    try:
        assert cache.enable_persistent_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)


def test_cache_dir_default_is_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == cache.DEFAULT_DIR
    assert cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")


def test_cache_compiles_into_env_dir(tmp_path):
    """A process with JAX_COMPILATION_CACHE_DIR set writes its compiled
    programs there, and JAX's cache setting names no other directory."""
    target = tmp_path / "cache"
    code = ("import jax, jax.numpy as jnp\n"
            "from hpfx.utils.cache import enable_persistent_cache\n"
            "enable_persistent_cache(min_compile_secs=0)\n"
            "jax.jit(lambda x: jnp.sin(x) @ x)(jnp.ones((8, 8))).block_until_ready()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(target),
               JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == str(target)
    assert any(target.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cache"]


def _net2(h_max=5, **kw):
    s = hpfx.settings_for_hmax(h_max, coupled=True).with_(
        stable_mismatch=True, dtype="float32", **kw)
    net = hpfx.load_network(os.path.join(DATA, "net2_buses.csv"),
                            os.path.join(DATA, "net2_lines.csv"), s)
    return s, net, hpfx.load_device_set(net, s)


def _scen(B, dtype=jnp.float32):
    return Scenarios(p_scale=jnp.linspace(0.9, 1.1, B, dtype=dtype),
                     q_scale=jnp.linspace(0.9, 1.1, B, dtype=dtype),
                     injection_scale=jnp.linspace(0.8, 1.2, B, dtype=dtype))


def test_f64_rescue_runs_on_default_device(monkeypatch):
    """The f64 straggler re-solve asks for no particular backend: it runs
    on the default device (the card, where there is one)."""
    from hpfx.solve import _f64_resolve
    s, net, dev = _net2(solver="arrow")
    real_devices = jax.devices

    def devices(backend=None):
        assert backend is None, f"pinned to {backend!r}"
        return real_devices()

    monkeypatch.setattr(jax, "devices", devices)
    r = _f64_resolve(net, dev, s, _scen(2))
    assert r.V_m.dtype == jnp.float32
    assert bool(np.all(np.asarray(r.converged)))
    assert r.V_m.devices() == {real_devices()[0]}


def _dot_precisions(jaxpr):
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            yield e.params["precision"], e.invars[0].aval.dtype
        for p in e.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dot_precisions(inner)


@pytest.mark.parametrize("program", ["vmap", "lanes", "device_warm"])
def test_f32_sweep_traces_highest_precision(program):
    """Every f32 dot_general of the sweep programs carries HIGHEST
    precision (on a GPU a plain f32 product may run in TF32)."""
    from hpfx.lanes import hpf_sweep_adaptive_lanes
    from hpfx.solve import hpf_sweep_unjitted
    s, net, dev = _net2(solver="arrow")
    if program == "device_warm":
        fn = partial(hpf_sweep_adaptive_lanes, settings=s, warm="linear")
    else:
        fn = partial(hpf_sweep_unjitted, settings=s.with_(layout=program))
    jaxpr = jax.make_jaxpr(lambda n, d, sc: fn(n, d, scenarios=sc))(
        net, dev, _scen(4))
    found = [(p, dt) for p, dt in _dot_precisions(jaxpr.jaxpr)
             if dt == jnp.float32]
    assert found
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    bad = [p for p, _ in found if p != highest]
    assert not bad, f"{len(bad)} of {len(found)} f32 dots: {bad[:3]}"
