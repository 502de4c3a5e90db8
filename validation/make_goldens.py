"""Golden-fixture generator: runs the *reference* implementation to capture oracles.

This script executes the unmodified reference solver
(/root/reference/Harmonic Power Flow/hcne_generalized.py) in-process and records
its outputs (voltages, THD, mismatches, Jacobians, iteration counts) as .npz
fixtures under validation/goldens/.  The new framework (hpfx) is
tested for 1e-8 parity against these fixtures.

Notes
-----
- The reference hardcodes the Norton-equivalent CSV path to
  ``~/Git/harmonic-power-flow/Circuit Simulation/<device>_NE.csv``
  (hcne_generalized.py:289-290), so we point $HOME at a temp dir with symlinks
  for both the ``SMPS`` (net2/net3) and ``smps`` (net1) component spellings.
- net1 cannot be loaded by the reference Python loader (its CSV says
  ``X_shunt`` and has no G/B columns; see hcne_generalized.py:59-60,92).  We
  pre-build the DataFrames the way the Julia twin (hcne.jl:93-130) interprets
  net1 (rename X_shunt -> X_sh, G = B = 0) and hand them to the reference
  functions unchanged.
- Only this dev-time script touches the reference; nothing in hpfx/ does.
"""
import os
import sys
import tempfile
import types
import numpy as np
import pandas as pd

REF_DIR = "/root/reference/Harmonic Power Flow"
NE_SRC = "/root/reference/Circuit Simulation/smps_NE.csv"
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def load_reference_module():
    """Exec the reference solver file as a module, sandboxing HOME and cwd."""
    os.environ["MPLBACKEND"] = "Agg"
    home = tempfile.mkdtemp(prefix="hpf_oracle_home_")
    ne_dir = os.path.join(home, "Git", "harmonic-power-flow", "Circuit Simulation")
    os.makedirs(ne_dir, exist_ok=True)
    for name in ("SMPS_NE.csv", "smps_NE.csv"):
        dst = os.path.join(ne_dir, name)
        if not os.path.exists(dst):
            os.symlink(NE_SRC, dst)
    os.environ["HOME"] = home

    # pandas>=3 refuses lossy float->int column assignment; the reference was
    # written for pandas 1.x which upcast silently.  Pre-floating the numeric
    # physics columns at load time is numerically identical.
    _orig_read_csv = pd.read_csv
    _float_cols = {"S", "P", "Q", "X_sh", "X_shunt", "R", "X", "G", "B"}

    def _read_csv(*args, **kwargs):
        df = _orig_read_csv(*args, **kwargs)
        for col in df.columns:
            if col in _float_cols:
                df[col] = df[col].astype(float)
        return df

    pd.read_csv = _read_csv

    # numpy 2 removed the np.Inf alias the reference uses (":389")
    if not hasattr(np, "Inf"):
        np.Inf = np.inf

    src_path = os.path.join(REF_DIR, "hcne_generalized.py")
    with open(src_path) as fh:
        src = fh.read()
    mod = types.ModuleType("reference_hcne")
    mod.__file__ = src_path
    cwd = os.getcwd()
    os.chdir(REF_DIR)  # net CSVs are loaded relative to cwd
    try:
        exec(compile(src, src_path, "exec"), mod.__dict__)
    finally:
        os.chdir(cwd)
        pd.read_csv = _orig_read_csv
    mod._patched_read_csv = _read_csv
    return mod


def set_harmonics(ns, h_max):
    ns.H_MAX = h_max
    ns.HARMONICS = [h for h in range(1, h_max + 1, 2)]
    ns.HARMONICS_FREQ = [ns.NET_FREQ * i for i in ns.HARMONICS]


def load_net(ns, name):
    """Return (buses, lines, m, n, c) per the reference loaders."""
    if name in ("net2", "net3"):
        cwd = os.getcwd()
        orig = pd.read_csv
        pd.read_csv = ns._patched_read_csv
        os.chdir(REF_DIR)
        try:
            buses, lines, m, n, c = ns.init_network(
                f"{name}_buses.csv", f"{name}_lines.csv")
        finally:
            os.chdir(cwd)
            pd.read_csv = orig
        return buses, lines, m, n, c
    # net1: Julia-compatible interpretation (X_shunt -> X_sh, G = B = 0)
    buses = pd.read_csv(os.path.join(REF_DIR, "net1_buses.csv"), delimiter=";")
    buses = buses.rename(columns={"X_shunt": "X_sh"})
    buses["S"] = buses.S / ns.BASE_POWER
    buses["P"] = buses.P / ns.BASE_POWER
    buses["Q"] = buses.Q / ns.BASE_POWER
    buses["X_sh"] = buses.X_sh / ns.base_impedance
    buses = buses[["ID", "type", "component", "S", "P", "Q", "X_sh"]]
    lines = pd.read_csv(os.path.join(REF_DIR, "net1_lines.csv"), delimiter=";")
    lines["G"] = 0.0
    lines["B"] = 0.0
    lines["R"] = lines.R / ns.base_impedance
    lines["X"] = lines.X / ns.base_impedance
    m = int(min(buses.index[buses["type"] == "nonlinear"]))
    n = len(buses)
    c = len(buses[buses.type == "PV"]) + 1
    return buses, lines, m, n, c


def mi_to_array(df_col, harmonics, n):
    """(harmonic, bus) MultiIndex series -> (H, n) array in harmonic order."""
    out = np.zeros((len(harmonics), n))
    for hi, h in enumerate(harmonics):
        out[hi] = np.asarray(df_col.loc[h])
    return out


def run_config(ns, net, h_max, coupled, save_jacobians=True):
    """``save_jacobians=False`` drops the dense J0/J_final blocks from the
    fixture (net1 at H=99 is dim ~2000: two dense f64 matrices would be
    ~64 MB of committed fixture; the parity tests guard on key presence)."""
    set_harmonics(ns, h_max)
    buses, lines, m, n, c = load_net(ns, net)
    ns.buses, ns.lines, ns.m, ns.n, ns.c = buses, lines, m, n, c

    harmonics = ns.HARMONICS
    Y = ns.build_admittance_matrices(buses, lines, harmonics)
    Y_arr = np.stack([np.asarray(Y.loc[h], dtype=complex) for h in harmonics])

    # fundamental power flow (same warm start hpf performs internally)
    V_f, err_f_t, n_iter_f = ns.pf(Y, buses)
    V_fund_m = np.asarray(V_f.loc[1, "V_m"], dtype=float)
    V_fund_a = np.asarray(V_f.loc[1, "V_a"], dtype=float)

    # first-iteration oracles for unit tests
    NE = ns.import_Norton_Equivalents(buses, coupled)
    f0, err_h0 = ns.harmonic_mismatch(V_f, Y, buses, NE)
    x0 = ns.harmonic_state_vector(V_f)
    J0 = ns.build_harmonic_jacobian(V_f, Y, NE, coupled)

    # full harmonic power flow
    V_h, err_h, n_iter_h, J = ns.hpf(buses, lines, coupled)
    THD = ns.get_THD(V_h)

    V_m = mi_to_array(V_h["V_m"], harmonics, n)
    V_a = mi_to_array(V_h["V_a"], harmonics, n)

    # store the pu Norton equivalents the reference loader produced
    devices = sorted(NE.keys())
    I_N = np.stack([np.asarray(NE[d][0], dtype=complex).reshape(-1)
                    for d in devices])
    Y_N = np.stack([np.asarray(NE[d][1], dtype=complex).reshape(
        len(harmonics), -1)[:, : (len(harmonics) if coupled else 1)]
        for d in devices])

    tag = f"{net}_h{h_max}_{'c' if coupled else 'uc'}"
    payload = dict(
        harmonics=np.array(harmonics),
        m=m, n=n, c=c,
        Y=Y_arr,
        V_fund_m=V_fund_m, V_fund_a=V_fund_a, n_iter_f=n_iter_f,
        err_f_t=np.array([err_f_t[k] for k in sorted(err_f_t)]),
        f0=np.asarray(f0, dtype=float), x0=np.asarray(x0, dtype=float),
        err_h0=err_h0,
        V_m=V_m, V_a=V_a, err_h=err_h, n_iter_h=n_iter_h,
        THD_F=np.asarray(THD.THD_F, dtype=float),
        THD_R=np.asarray(THD.THD_R, dtype=float),
        NE_devices=np.array(devices),
        NE_I_N=I_N, NE_Y_N=Y_N,
        coupled=coupled,
    )
    if save_jacobians:
        payload["J0"] = np.asarray(J0.todense(), dtype=float)
        payload["J_final"] = np.asarray(J.todense(), dtype=float)
    np.savez(os.path.join(OUT_DIR, tag + ".npz"), **payload)
    print(f"[golden] {tag}: n_iter_f={n_iter_f} n_iter_h={n_iter_h} "
          f"err_h={err_h:.3e} THD_F={np.asarray(THD.THD_F)}")


def main(argv=None):
    """Regenerate fixtures.  With no args: the full matrix.  With args:
    only the named configs, e.g. ``make_goldens.py net2_h99_c net1_h99_uc``.
    H=99 is the full depth of the shipped device table (smps_NE.csv
    carries odd harmonics 1..99, to 4950 Hz)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    ns = load_reference_module()
    configs = []
    for net in ("net2", "net3", "net1"):
        # net1 at H=51/99 are the dim-1038/1998 scale configs: slow
        # (minutes of reference pandas/scipy loops) but required — the
        # committed fixtures must stay reproducible from here
        for h_max in (5, 25, 51, 99):
            for coupled in (False, True):
                configs.append((net, h_max, coupled))
    only = set(argv) if argv else None
    for net, h_max, coupled in configs:
        tag = f"{net}_h{h_max}_{'c' if coupled else 'uc'}"
        if only is not None and tag not in only:
            continue
        # net1 H=99: dim ~2000 — skip the two ~32 MB dense Jacobian blocks
        save_j = not (net == "net1" and h_max == 99)
        try:
            run_config(ns, net, h_max, coupled, save_jacobians=save_j)
        except Exception as e:  # record which configs the reference itself fails on
            print(f"[golden] FAILED {net} H={h_max} coupled={coupled}: {e!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
