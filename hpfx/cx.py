"""Split-complex arithmetic: complex tensors as (re, im) real pairs.

hpfx carries the real and imaginary parts of every complex quantity as
separate real arrays: every complex matmul becomes 4 real matmuls, every
elementwise op a couple of real ops, every dtype is a real f32/f64 one,
and kernels see plain real refs.  (The representation dates from a
backend without complex element types; XLA on the GPU has
complex64/complex128, and whether native complex is faster there is an
open measurement — PERF.md.)

``Cx`` is a NamedTuple, hence automatically a pytree: it vmaps, jits, shards
and scatters transparently, and indexing/reshaping apply to both components.

The convention throughout hpfx: *all* device-resident complex quantities
(volt< phasors, admittances, Norton parameters) are ``Cx``; NumPy complex
arrays appear only at the host boundary (CSV loaders, test comparisons).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Cx(NamedTuple):
    """A complex tensor stored as two equal-shaped real tensors."""

    re: jnp.ndarray
    im: jnp.ndarray

    # -- structure ----------------------------------------------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    def __getitem__(self, idx) -> "Cx":
        return Cx(self.re[idx], self.im[idx])

    def reshape(self, *shape) -> "Cx":
        return Cx(self.re.reshape(*shape), self.im.reshape(*shape))

    def transpose(self, *axes) -> "Cx":
        return Cx(self.re.transpose(*axes), self.im.transpose(*axes))

    @property
    def T(self) -> "Cx":
        return Cx(self.re.T, self.im.T)

    def astype(self, dtype) -> "Cx":
        return Cx(self.re.astype(dtype), self.im.astype(dtype))

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re + o.re, self.im + o.im)
        return Cx(self.re + o, self.im)          # real scalar/array

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re - o.re, self.im - o.im)
        return Cx(self.re - o, self.im)

    def __rsub__(self, o):
        return (-self) + o

    def __neg__(self):
        return Cx(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, Cx):
            return Cx(self.re * o.re - self.im * o.im,
                      self.re * o.im + self.im * o.re)
        return Cx(self.re * o, self.im * o)      # real scalar/array

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Cx):
            return self * o.reciprocal()
        return Cx(self.re / o, self.im / o)

    def __rtruediv__(self, o):
        return self.reciprocal() * o

    def conj(self) -> "Cx":
        return Cx(self.re, -self.im)

    def jmul(self) -> "Cx":
        """Multiply by the imaginary unit."""
        return Cx(-self.im, self.re)

    def reciprocal(self) -> "Cx":
        d = self.re * self.re + self.im * self.im
        return Cx(self.re / d, -self.im / d)

    def abs2(self) -> jnp.ndarray:
        return self.re * self.re + self.im * self.im

    def abs(self) -> jnp.ndarray:
        return jnp.sqrt(self.abs2())

    def angle(self) -> jnp.ndarray:
        return jnp.arctan2(self.im, self.re)

    # -- updates (apply to both components) ---------------------------------
    def at_set(self, idx, val: "Cx") -> "Cx":
        return Cx(self.re.at[idx].set(val.re), self.im.at[idx].set(val.im))

    def at_add(self, idx, val: "Cx", mode=None) -> "Cx":
        kw = {} if mode is None else dict(mode=mode)
        return Cx(self.re.at[idx].add(val.re, **kw),
                  self.im.at[idx].add(val.im, **kw))

    # -- host boundary ------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.re) + 1j * np.asarray(self.im)


# -- constructors -----------------------------------------------------------

def cx(re, im=None) -> Cx:
    re = jnp.asarray(re)
    return Cx(re, jnp.zeros_like(re) if im is None else jnp.asarray(im))


def from_numpy(arr, dtype=None) -> Cx:
    """Host-side complex (or real) numpy array -> Cx with real dtype."""
    arr = np.asarray(arr)
    re, im = np.real(arr), np.imag(arr)
    return Cx(jnp.asarray(re, dtype), jnp.asarray(im, dtype))


def polar(mag, ang) -> Cx:
    """mag·e^{j·ang} (P2A, hcne_generalized.py:36-37).  ``mag`` may be signed
    (harmonic magnitudes go negative mid-iteration by design)."""
    return Cx(mag * jnp.cos(ang), mag * jnp.sin(ang))


def expj(ang) -> Cx:
    return Cx(jnp.cos(ang), jnp.sin(ang))


def sqrt(w: Cx) -> Cx:
    """Principal complex square root (branch cut on the negative real
    axis, matching numpy): |w|^{1/2}·e^{j·arg(w)/2}."""
    r = w.abs2() ** 0.25
    return polar(r, 0.5 * jnp.arctan2(w.im, w.re))


def sinh(w: Cx) -> Cx:
    """Complex sinh via the real decomposition
    sinh(a+jb) = sinh a·cos b + j·cosh a·sin b."""
    return Cx(jnp.sinh(w.re) * jnp.cos(w.im),
              jnp.cosh(w.re) * jnp.sin(w.im))


def cosh(w: Cx) -> Cx:
    """Complex cosh: cosh(a+jb) = cosh a·cos b + j·sinh a·sin b."""
    return Cx(jnp.cosh(w.re) * jnp.cos(w.im),
              jnp.sinh(w.re) * jnp.sin(w.im))


def zeros(shape, dtype) -> Cx:
    return Cx(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def eye(n, dtype) -> Cx:
    return Cx(jnp.eye(n, dtype=dtype), jnp.zeros((n, n), dtype))


# -- contractions (each = 4 real contractions) -------------------------------
#
# Precision note: JAX's DEFAULT matmul precision lets an accelerator use
# reduced-precision operands (TF32 on an NVIDIA GPU's tensor cores).
# Newton-Raphson residuals must resolve 1e-6
# (fundamental) / 1e-4 (harmonic) against admittance entries of O(100) pu, so
# every contraction here requests HIGHEST (full f32 accumulate).  Without
# this, batched solves silently stall at a ~1e-2 error floor.

_PREC = jax.lax.Precision.HIGHEST


def matmul(a: Cx, b: Cx) -> Cx:
    mm = lambda x, y: jnp.matmul(x, y, precision=_PREC)
    return Cx(mm(a.re, b.re) - mm(a.im, b.im),
              mm(a.re, b.im) + mm(a.im, b.re))


def matvec(A: Cx, v: Cx) -> Cx:
    mm = lambda x, y: jnp.matmul(x, y, precision=_PREC)
    return Cx(mm(A.re, v.re) - mm(A.im, v.im),
              mm(A.re, v.im) + mm(A.im, v.re))


def einsum(pattern: str, a: Cx, b: Cx) -> Cx:
    es = lambda x, y: jnp.einsum(pattern, x, y, precision=_PREC)
    return Cx(es(a.re, b.re) - es(a.im, b.im),
              es(a.re, b.im) + es(a.im, b.re))


def solve(A: Cx, B: Cx) -> Cx:
    """Solve the complex linear system A·X = B via the equivalent real block
    system [[Ar, -Ai], [Ai, Ar]]·[Xr; Xi] = [Br; Bi] — a single real
    LU."""
    M = A.shape[-1]
    top = jnp.concatenate([A.re, -A.im], axis=-1)
    bot = jnp.concatenate([A.im, A.re], axis=-1)
    A_real = jnp.concatenate([top, bot], axis=-2)
    b2 = B.re.ndim == A.re.ndim - 1
    Br, Bi = (B.re[..., None], B.im[..., None]) if b2 else (B.re, B.im)
    B_real = jnp.concatenate([Br, Bi], axis=-2)
    X = jnp.linalg.solve(A_real, B_real)
    Xr, Xi = X[..., :M, :], X[..., M:, :]
    if b2:
        Xr, Xi = Xr[..., 0], Xi[..., 0]
    return Cx(Xr, Xi)


def where(mask, a: Cx, b: Cx) -> Cx:
    return Cx(jnp.where(mask, a.re, b.re), jnp.where(mask, a.im, b.im))


def concatenate(parts, axis=0) -> Cx:
    return Cx(jnp.concatenate([p.re for p in parts], axis),
              jnp.concatenate([p.im for p in parts], axis))
