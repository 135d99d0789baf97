"""Legendre-Gauss-Lobatto points, weights and Lagrange bases.

Own copy of the basis layer for the PyTorch package (the JAX package keeps
its own in hnumo_tpu/basis/lgl.py; the two share no import)
(reference: src/mod_legendre.F90:54-433, src/mod_basis.F90:60-186).

Everything here is *setup-time* code: it runs once in float64 NumPy on the
host and produces small static operator tables (ngl x nq matrices) that the
compute path receives as tensors.
"""
from __future__ import annotations

import functools

import numpy as np


def _legendre_poly(n: int, x: float) -> tuple[float, float, float]:
    """Legendre polynomial P_n(x) and its first two derivatives.

    Three-term recurrence, matching reference src/mod_legendre.F90:189-237.
    """
    p1, p1_1, p1_2 = 0.0, 0.0, 0.0
    p0, p0_1, p0_2 = 1.0, 0.0, 0.0
    for j in range(1, n + 1):
        p2, p2_1, p2_2 = p1, p1_1, p1_2
        p1, p1_1, p1_2 = p0, p0_1, p0_2
        a = (2.0 * j - 1.0) / j
        b = (j - 1.0) / j
        p0 = a * x * p1 - b * p2
        p0_1 = a * (p1 + x * p1_1) - b * p2_1
        p0_2 = a * (2.0 * p1_1 + x * p1_2) - b * p2_2
    return p0, p0_1, p0_2


@functools.lru_cache(maxsize=None)
def lgl_points_weights(ngl: int) -> tuple[np.ndarray, np.ndarray]:
    """LGL quadrature nodes and weights on [-1, 1].

    Newton iteration on (1-x^2) P'_n(x) = 0, matching reference
    src/mod_legendre.F90:54-111 (same initial guesses and update), so the
    resulting tables agree to machine precision.
    """
    xgl = np.zeros(ngl)
    wgl = np.zeros(ngl)
    if ngl == 1:
        return xgl, np.full(1, 2.0)

    n = ngl - 1
    nh = (n + 1) // 2
    thres = np.finfo(np.float64).eps
    for i in range(1, nh + 1):
        x = np.cos((2.0 * i - 1.0) / (2.0 * n + 1.0) * np.pi)
        p0 = 1.0
        for _ in range(20):
            p0, p0_1, p0_2 = _legendre_poly(n, x)
            dx = -(1.0 - x * x) * p0_1 / (-2.0 * x * p0_1 + (1.0 - x * x) * p0_2)
            x = x + dx
            if abs(dx) < thres:
                break
        # re-evaluate p0 at the converged x for the weight
        p0, _, _ = _legendre_poly(n, x)
        xgl[n + 1 - i] = x
        wgl[n + 1 - i] = 2.0 / (n * (n + 1) * p0 * p0)

    if (n + 1) != 2 * nh:  # odd number of interior points: x=0 is a root
        p0, _, _ = _legendre_poly(n, 0.0)
        xgl[nh] = 0.0
        wgl[nh] = 2.0 / (n * (n + 1) * p0 * p0)

    for i in range(1, nh + 1):
        xgl[i - 1] = -xgl[n + 1 - i]
        wgl[i - 1] = wgl[n + 1 - i]
    return xgl, wgl


def lagrange_basis_at(xgl: np.ndarray, xq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Lagrange cardinal basis (and derivative) on nodes `xgl` evaluated at `xq`.

    Returns (psi, dpsi) with shape (ngl, nq): psi[i, l] = L_i(xq[l]).
    Product-form evaluation matching reference src/mod_legendre.F90:387-433.
    """
    ngl, nq = len(xgl), len(xq)
    psi = np.ones((ngl, nq))
    dpsi = np.zeros((ngl, nq))
    for l in range(nq):
        xl = xq[l]
        for i in range(ngl):
            xi = xgl[i]
            for j in range(ngl):
                if j == i:
                    continue
                xj = xgl[j]
                psi[i, l] *= (xl - xj) / (xi - xj)
                dd = 1.0
                for k in range(ngl):
                    if k != i and k != j:
                        xk = xgl[k]
                        dd *= (xl - xk) / (xi - xk)
                dpsi[i, l] += dd / (xi - xj)
    return psi, dpsi


def nodal_derivative_matrix(xgl: np.ndarray) -> np.ndarray:
    """Spectral differentiation matrix dpsi[i, j] = L_i'(xgl[j]).

    Log-sum stabilized barycentric form with the row-sum trick for the
    diagonal (reference src/mod_legendre.F90:288-320, reduce_round_off path).
    """
    ngl = len(xgl)
    bb = np.zeros(ngl)
    for j in range(ngl):
        for i in range(ngl):
            if i != j:
                bb[j] += np.log(abs(xgl[j] - xgl[i]))
    dpsi = np.zeros((ngl, ngl))
    cc = np.zeros(ngl)
    for j in range(ngl):
        for i in range(ngl):
            if i != j:
                dpsi[i, j] = (-1.0) ** (i + j) * np.exp(bb[j] - bb[i]) / (xgl[j] - xgl[i])
                cc[j] += dpsi[i, j]
    for j in range(ngl):
        dpsi[j, j] = -cc[j]
    return dpsi


class Basis1D:
    """1D nodal basis of order nop with over-integration grid.

    Mirrors the tables built by reference src/mod_basis.F90:60-186:
      xgl/wgl      : LGL nodes/weights, ngl = nop+1 points
      xnq/wnq      : over-integration LGL grid, nq = 2*nop+1 (dg_integ_exact)
                     or 2*nop-1 points
      psiq/dpsiq   : (ngl, nq) node->quad interpolation / derivative
      dpsi         : (ngl, ngl) nodal differentiation matrix
    """

    def __init__(self, nop: int, exact_integration: bool = True):
        self.nop = nop
        self.ngl = nop + 1
        self.nq = 2 * nop + 1 if exact_integration else 2 * nop - 1
        self.xgl, self.wgl = lgl_points_weights(self.ngl)
        self.xnq, self.wnq = lgl_points_weights(self.nq)
        self.psiq, self.dpsiq = lagrange_basis_at(self.xgl, self.xnq)
        self.dpsi = nodal_derivative_matrix(self.xgl)
        # identity at nodal points
        self.psi = np.eye(self.ngl)

    def interp_to_quad(self, u_nodal: np.ndarray) -> np.ndarray:
        """1D helper used by tests: (..., ngl) -> (..., nq)."""
        return u_nodal @ self.psiq
