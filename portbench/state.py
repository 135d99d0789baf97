"""The seeded initial state that both the port and the reference start from.

The double gyre starts from rest. The seed draws a smooth displacement of
the interior layer interfaces (a sum of the basin's first few sine-cosine
modes with random weights and phases), scaled so that its largest value is
the traffic's amplitude on every seed: every seed brings the same size of
perturbation, in another shape. The rest of the state follows from the
displaced interfaces as the reference's restart derives it
(src/mod_restart.F90:39-65): layer thicknesses, the barotropic pressure and
the prime thicknesses; the velocities are zero. Built in float64 NumPy from
the reference's copy of the test case's rest state; nothing of the port is
read.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.basis.lgl import lgl_points_weights
from .reference.config import Config
from .reference.core.init import _test_case_fields


def nodal_coords(cfg: dict) -> np.ndarray:
    """(nely, nelx, ngl, ngl, 2) node coordinates of the uniform brick, the
    layout of the port's and the reference's nodal fields."""
    ngl = cfg["nopx"] + 1
    xgl, _ = lgl_points_weights(ngl)
    (x0, x1), (y0, y1) = cfg["xdims"], cfg["ydims"]
    nelx, nely = cfg["nelx"], cfg["nely"]
    dx, dy = (x1 - x0) / nelx, (y1 - y0) / nely
    x = x0 + dx * (np.arange(nelx)[None, :, None, None] + (xgl[None, None, None, :] + 1.0) / 2.0)
    y = y0 + dy * (np.arange(nely)[:, None, None, None] + (xgl[None, None, :, None] + 1.0) / 2.0)
    shape = (nely, nelx, ngl, ngl)
    return np.stack([np.broadcast_to(x, shape), np.broadcast_to(y, shape)], axis=-1)


def ref_config(cfg: dict, **over) -> Config:
    """The reference's Config of a configuration's fields."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    return Config(**{**kw, **over})


def interface_displacement(coord: np.ndarray, cfg: dict, seed: int, amplitude: float,
                           modes: int) -> np.ndarray:
    """A smooth field over the basin whose largest absolute value is
    `amplitude`: sum over m, n = 1..modes of w_mn cos(m pi x' + a_mn)
    cos(n pi y' + b_mn), x', y' in [0, 1]."""
    rng = np.random.default_rng(seed % 2**64)
    w = rng.standard_normal((modes, modes))
    a, b = rng.uniform(0.0, 2.0 * np.pi, (2, modes, modes))
    (x0, x1), (y0, y1) = cfg["xdims"], cfg["ydims"]
    xs = (coord[..., 0] - x0) / (x1 - x0)
    ys = (coord[..., 1] - y0) / (y1 - y0)
    eta = np.zeros(xs.shape)
    for m in range(modes):
        cx = np.cos((m + 1) * np.pi * xs[..., None] + a[m])          # (..., modes n)
        cy = np.cos(np.arange(1, modes + 1) * np.pi * ys[..., None] + b[m])
        eta += (w[m] * cx * cy).sum(-1)
    return amplitude * eta / np.abs(eta).max()


def initial_fields(cfg: dict, seed: int, perturbation: dict) -> dict:
    """{qb, q, qprime}: the seeded initial state in float64 NumPy, the
    thickness channels stored as perturbations of the rest thickness as the
    port's State holds them; with `dp_ref` (the rest thickness) and
    `pbprime` beside them."""
    coord = nodal_coords(cfg)

    class _Coords:
        pass

    geom = _Coords()
    geom.coord = coord
    ini = _test_case_fields(ref_config(cfg), geom)
    L = cfg["nlayers"]
    z = ini.z_interface.copy()
    eta = interface_displacement(coord, cfg, seed, perturbation["amplitude_m"],
                                 perturbation["modes"])
    for k in range(1, L):
        z[k] = np.maximum(z[k] + eta, ini.zbot_df)
    grav, alpha = ini.gravity, ini.alpha
    dp = np.stack([(grav / alpha[k]) * (z[k] - z[k + 1]) for k in range(L)])
    dp_ref = ini.qprime_df[0]
    pbprime = ini.pbprime_df
    zeros = np.zeros_like(dp)
    pb = dp.sum(0)
    one_plus_eta = pb / pbprime
    qb = np.stack([pb, pb - pbprime, np.zeros_like(pb), np.zeros_like(pb)])
    q = np.stack([dp - dp_ref, zeros, zeros])
    qprime = np.stack([dp / one_plus_eta[None] - dp_ref, zeros, zeros])
    return {"qb": qb, "q": q, "qprime": qprime, "dp_ref": dp_ref, "pbprime": pbprime}


def as_state(state_cls, fields: dict, dtype: torch.dtype, device, t: float = 0.0):
    """`state_cls(qb_df, q_df, qprime_df, t, ok)` of the fields, cast once
    from float64 to `dtype` on `device`."""
    opts = dict(dtype=dtype, device=device)
    return state_cls(torch.tensor(fields["qb"], **opts), torch.tensor(fields["q"], **opts),
                     torch.tensor(fields["qprime"], **opts), torch.tensor(t, **opts),
                     torch.tensor(True, device=device))
