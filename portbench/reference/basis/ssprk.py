"""SSPRK / LSRK coefficient tables for the barotropic sub-stepping.

Own copy for the PyTorch package (counterpart: hnumo_tpu/basis/ssprk.py).

Reference: src/mod_initial_mlswe.F90:582-681 (ssprk_coefficients).

Tables are returned as NumPy float64 arrays:
  a    : (kstages, 3)  combination weights over (qb0, qb1, qb2)
  beta : (kstages,)    RHS weights
For ti_method_btp == 'lsrk' the a[:,0] column holds the LSRK "A" coefficients
and beta the "B" coefficients of the low-storage scheme.
"""
from __future__ import annotations

import numpy as np

_SSP_TABLES: dict[int, tuple[list[list[float]], list[float]]] = {
    1: ([[1.0, 0.0, 0.0]], [1.0]),
    2: ([[1.0, 0.0, 0.0], [0.5, 0.5, 0.0]], [1.0, 0.5]),
    3: (
        [[1.0, 0.0, 0.0], [0.75, 0.25, 0.0], [1.0 / 3.0, 2.0 / 3.0, 0.0]],
        [1.0, 0.25, 2.0 / 3.0],
    ),
    4: (
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [2.0 / 3.0, 1.0 / 3.0, 0.0], [0.0, 1.0, 0.0]],
        [0.5, 0.5, 1.0 / 6.0, 0.5],
    ),
    5: (
        [
            [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.355909775063326, 0.644090224936674, 0.0],
            [0.367933791638137, 0.632066208361863, 0.0],
            [0.0, 0.762406163401431, 0.237593836598569],
        ],
        [
            0.377268915331368,
            0.377268915331368,
            0.242995220537396,
            0.238458932846290,
            0.287632146308408,
        ],
    ),
}

_LSRK5_A = [
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
]
_LSRK5_B = [
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
]

_LSRK14_A = [
    0.0, -0.7188012108672410, -0.7785331173421570, -0.0053282796654044,
    -0.8552979934029281, -3.9564138245774565, -1.5780575380587385,
    -2.0837094552574054, -0.7483334182761610, -0.7032861106563359,
    0.0013917096117681, -0.0932075369637460, -0.9514200470875948,
    -7.1151571693922548,
]
_LSRK14_B = [
    0.0367762454319673, 0.3136296607553959, 0.1531848691869027,
    0.0030097086818182, 0.3326293790646110, 0.2440251405350864,
    0.3718879239592277, 0.6204126221582444, 0.1524043173028741,
    0.0760894927419266, 0.0077604214040978, 0.0024647284755382,
    0.0780348340049386, 5.5059777270269628,
]


def ssprk_coefficients(kstages: int, ti_method_btp: str = "ssprk") -> tuple[np.ndarray, np.ndarray]:
    """Return (a, beta) for the requested barotropic time integrator."""
    if ti_method_btp == "lsrk":
        if kstages == 5:
            A, B = _LSRK5_A, _LSRK5_B
        elif kstages == 14:
            A, B = _LSRK14_A, _LSRK14_B
        else:
            raise ValueError(f"lsrk supports kstages in (5, 14), got {kstages}")
        a = np.zeros((kstages, 3))
        a[:, 0] = A
        return a, np.asarray(B)
    if kstages not in _SSP_TABLES:
        raise ValueError(f"ssprk supports kstages in 1..5, got {kstages}")
    a, beta = _SSP_TABLES[kstages]
    return np.asarray(a, dtype=np.float64), np.asarray(beta, dtype=np.float64)
