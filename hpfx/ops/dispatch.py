"""Platform decisions of the sweep path, in one place.

Two choices depend on the backend a program is traced for: which batched
linear-solve route a Newton step takes (:func:`solve_route`), and which
batch layout ``Settings.layout="auto"`` resolves to (:func:`auto_layout`).
Both are pure functions of the platform string (``jax.default_backend()``)
and the operand shape, so the CPU tests can check every branch.  PERF.md
records the card's measurements behind each choice.
"""
from __future__ import annotations

import numpy as np

from .gj_triton import MAX_DIM as TRITON_MAX_DIM

#: every route :func:`solve_route` can return
ROUTES = ("lu", "lu_equilibrated", "gj_triton")


def solve_route(platform: str, dtype, n: int) -> str:
    """Route of one lane-minor batched solve of dim ``n``.

    - ``"lu"``: raw XLA LU (LAPACK on the CPU, cuSOLVER/cuBLAS on the
      GPU) for f64 — the parity path keeps the reference's arithmetic;
    - ``"gj_triton"``: Gauss-Jordan with virtual partial pivoting as a
      Pallas kernel through Triton, equilibrated, for small f32 systems
      on the GPU;
    - ``"lu_equilibrated"``: XLA LU behind row/column equilibration for
      every other f32 system.
    """
    if np.dtype(dtype) == np.float64:
        return "lu"
    if platform == "gpu" and n <= TRITON_MAX_DIM:
        return "gj_triton"
    return "lu_equilibrated"


def auto_layout(platform: str) -> str:
    """Batch layout that ``Settings.layout="auto"`` resolves to on
    ``platform`` when the lane-major path supports the configuration:
    ``"lanes"`` (hpfx.lanes) or ``"vmap"`` (hpfx.solve).  On the GPU the
    lane-major layout was faster on the net2 sweep and tied on net1; the
    CPU keeps vmap, the layout its tests were tuned on."""
    return "lanes" if platform == "gpu" else "vmap"
