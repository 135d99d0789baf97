"""Modal low-pass filter matrices (Boyd-Vandeven / quadratic / exponential).

Own copy for the PyTorch package of the JAX package's basis/filter.py (the
two share no import). Reference: src/filter_init.F90:10-215. Setup-time
NumPy, float64 (the reference uses quad precision for the Vandermonde
inverse; float64 + `numpy.linalg.inv` is well within the tolerance of these
small matrices). Nothing steps with it: the namelist's `filter_*` /
`ifilter` keys are read and have no effect (config.py).
"""
from __future__ import annotations

import numpy as np

from .lgl import _legendre_poly, lgl_points_weights


def _vandeven_modal(kk: int, ngl: int, p: float) -> float:
    """Boyd-Vandeven (ERF-log) transfer weight (reference src/filter_init.F90:154-214)."""
    pe, a1, a2, a3, a4, a5 = 0.3275911, 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    n = ngl - 1
    k = kk - 1
    i = 2 * n // 3
    eps = 1.0e-10
    if k <= i:
        return 1.0
    if k == n:
        return 0.0
    x = (k - i) / (n - i)
    omega = abs(x) - 0.5
    xlog = np.log(1.0 - 4.0 * omega**2)
    c = 4.0 * omega**2
    square_root = 1.0 if abs(x - 0.5) < eps else np.sqrt(-xlog / c)
    z = 2.0 * np.sqrt(p) * omega * square_root
    zc = abs(z)
    t = 1.0 / (1.0 + pe * zc)
    c = 1.0 - (a1 * t + a2 * t**2 + a3 * t**3 + a4 * t**4 + a5 * t**5) * np.exp(-zc * zc)
    c = 0.0 if zc < eps else c * z / zc
    return 0.5 * (1.0 - c)


def filter_matrix(
    nop: int,
    mu: float,
    weight_type: str = "erf",
    basis_type: str = "legendre",
) -> np.ndarray:
    """1D filter matrix F = mu * (V diag(w) V^-1) + (1-mu) I, shape (ngl, ngl).

    weight_type in {'erf', 'quad', 'exp'} (another raises ValueError);
    basis_type 'modal' is the hierarchical Szabo basis, anything else the
    Legendre basis.
    """
    ngl = nop + 1
    xgl, _ = lgl_points_weights(ngl)

    # Legendre Vandermonde leg[i, j] = P_j(x_i)
    leg = np.zeros((ngl, ngl))
    for i in range(ngl):
        for j in range(ngl):
            leg[i, j] = _legendre_poly(j, xgl[i])[0]

    if basis_type == "modal":  # hierarchical Szabo basis
        leg2 = leg.copy()
        leg2[:, 0] = 0.5 * (1.0 - xgl)
        if ngl > 1:
            leg2[:, 1] = 0.5 * (1.0 + xgl)
            for j in range(2, ngl):
                leg2[:, j] = leg[:, j] - leg[:, j - 2]
    else:
        leg2 = leg

    leg_inv = np.linalg.inv(leg2)

    weight = np.ones(ngl)
    if weight_type == "erf":
        erf_order = 12.0
        for k in range(1, ngl + 1):
            weight[k - 1] = _vandeven_modal(k, ngl, erf_order)
    elif weight_type == "quad":
        mode_filter = ngl // 3
        k0 = ngl - mode_filter
        for k in range(k0 + 1, ngl + 1):
            weight[k - 1] = 1.0 - (k - k0) ** 2 / float(mode_filter**2)
    elif weight_type == "exp":
        exp_alpha, exp_order = 17.0, 18.0
        for k in range(1, ngl + 1):
            weight[k - 1] = np.exp(-exp_alpha * ((k - 1) / nop) ** exp_order)
    else:
        raise ValueError(f"unknown filter weight type {weight_type!r}")

    f = mu * (leg2 @ np.diag(weight) @ leg_inv)
    f[np.diag_indices(ngl)] += 1.0 - mu
    return f
