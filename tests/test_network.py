"""Network loader tests (reference: hcne_generalized.py:45-128)."""
import numpy as np
import pytest

import hpfx
from hpfx.network import NONLINEAR, PQ, PV, SLACK

from conftest import DATA


def _paths(net):
    return f"{DATA}/{net}_buses.csv", f"{DATA}/{net}_lines.csv"


def test_net2_partition():
    s = hpfx.settings_for_hmax(5)
    net = hpfx.load_network(*_paths("net2"), s)
    assert (net.n, net.m, net.c) == (4, 3, 1)
    assert net.bus_types == (SLACK, PQ, PQ, NONLINEAR)
    assert net.components[3] == "SMPS"
    # per-unit: P=250 W at BASE_POWER=1000 -> 0.25
    assert np.isclose(float(net.bus_P[3]), 0.25)
    # line R=0.5 Ohm / base_impedance=160 Ohm
    assert np.isclose(float(net.line_R[0]), 0.5 / s.base_impedance)


def test_net3_pv_bus():
    s = hpfx.settings_for_hmax(5)
    net = hpfx.load_network(*_paths("net3"), s)
    assert (net.n, net.m, net.c) == (4, 3, 2)
    assert net.bus_types[1] == PV
    assert np.isclose(float(net.bus_P[1]), -0.2)  # generator, negative load


def test_net1_schema_tolerance():
    """net1 uses the X_shunt column and has no G/B — the reference Python
    loader rejects it (SURVEY §2.5); ours accepts the Julia interpretation."""
    s = hpfx.settings_for_hmax(5)
    net = hpfx.load_network(*_paths("net1"), s)
    assert (net.n, net.m, net.c) == (20, 13, 1)
    assert net.n_nonlinear == 7
    assert np.isclose(float(net.bus_Xsh[0]), 0.005 / s.base_impedance)
    assert np.all(np.asarray(net.line_G) == 0)


def test_unsorted_buses_rejected_then_sorted(tmp_path):
    buses = tmp_path / "b.csv"
    lines = tmp_path / "l.csv"
    buses.write_text(
        "ID;type;component;S;P;Q;X_sh\n"
        "1;slack;generator;0;0;0;0.005\n"
        "2;nonlinear;SMPS;0;250;100;0\n"
        "3;PQ;lin_load_2;0;100;100;0\n")
    lines.write_text(
        "ID;fromID;toID;R;X;G;B\n1;1;2;0.5;0.5;0;0\n2;2;3;1;4;0;0\n")
    s = hpfx.settings_for_hmax(5)
    with pytest.raises(ValueError, match="ordered"):
        hpfx.load_network(str(buses), str(lines), s)
    net = hpfx.load_network(str(buses), str(lines), s, sort=True)
    assert net.bus_types == (SLACK, PQ, NONLINEAR)
    # line endpoints remapped through the permutation
    assert list(net.line_from) == [0, 2] and list(net.line_to) == [2, 1]


def test_malformed_csv_rejected_on_load(tmp_path):
    """load_network validates by default: a zero-impedance line and an
    unreachable bus raise the written errors instead of silently producing
    wrong physics."""
    buses = tmp_path / "b.csv"
    lines = tmp_path / "l.csv"
    buses.write_text(
        "ID;type;component;S;P;Q;X_sh\n"
        "1;slack;generator;0;0;0;0.005\n"
        "2;PQ;lin_load_2;0;100;100;0\n"
        "3;nonlinear;SMPS;0;250;100;0\n")
    s = hpfx.settings_for_hmax(5)

    lines.write_text("ID;fromID;toID;R;X;G;B\n1;1;2;0;0;0;0\n2;2;3;1;4;0;0\n")
    with pytest.raises(ValueError, match="zero series impedance"):
        hpfx.load_network(str(buses), str(lines), s)

    lines.write_text("ID;fromID;toID;R;X;G;B\n1;2;3;1;4;0;0\n")
    with pytest.raises(ValueError, match="unreachable"):
        hpfx.load_network(str(buses), str(lines), s)
    # explicit opt-out loads anyway
    net = hpfx.load_network(str(buses), str(lines), s, validate=False)
    assert net.n == 3


def test_network_from_arrays_matches_csv():
    s = hpfx.settings_for_hmax(5)
    ref = hpfx.load_network(*_paths("net2"), s)
    net = hpfx.network_from_arrays(
        bus_types=(SLACK, PQ, PQ, NONLINEAR),
        components=("generator", "lin_load_2", "nothing", "SMPS"),
        P=[0, 100, 0, 250], Q=[0, 100, 0, 100], X_sh=[0.005, 0, 0, 0],
        line_from=[0, 1, 2, 3], line_to=[1, 2, 3, 0],
        R=[0.5, 1, 0.5, 0.5], X=[0.5, 4, 1, 1],
        settings=s, per_unit=False)
    for field in ("bus_P", "bus_Q", "bus_Xsh", "line_R", "line_X"):
        np.testing.assert_allclose(
            np.asarray(getattr(net, field)), np.asarray(getattr(ref, field)))
    assert (net.n, net.m, net.c) == (ref.n, ref.m, ref.c)


def test_scale_loads_is_jit_safe():
    import jax
    s = hpfx.settings_for_hmax(5)
    net = hpfx.load_network(*_paths("net2"), s)

    @jax.jit
    def f(n):
        return n.scale_loads(2.0, 3.0).bus_P

    np.testing.assert_allclose(np.asarray(f(net)),
                               2.0 * np.asarray(net.bus_P))
