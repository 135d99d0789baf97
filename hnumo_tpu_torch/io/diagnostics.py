"""Runtime diagnostics: derived fields and mass.

Counterpart of hnumo_tpu/io/diagnostics.py:19-55 (its `derived_fields` and
`compute_mass`; the rest of that module is not ported yet). Reference:
src/diagnostics.F90:24-45 (derived output fields), src/mod_time_loop.F90:
153-163 with src/compute_conserved.F90:7-44 (mass). Both read the state
back from the device and return float64 numpy arrays in the JAX package's
layout.
"""
from __future__ import annotations

import numpy as np


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _full_thickness(model, q: np.ndarray) -> np.ndarray:
    """dp per layer: q_df[0] stores δdp (core/types.State), so the full
    thickness is rebuilt with the f64 reference, which keeps an f32 run's
    perturbation from being rounded away (docs/float32.md)."""
    return np.asarray(model.init_fields.qprime_df[0], np.float64) + np.float64(q[0])


def derived_fields(model, state) -> np.ndarray:
    """(h, u, v, dp, ssh) per layer from the prognostic state — the
    reference's 5-variable output set (src/diagnostics.F90:24-45). Returns an
    array of shape (5, nlayers, ney, nex, ngl, ngl)."""
    q = _host(state.q_df)
    alpha = _host(model.P.alpha).astype(np.float64)
    grav = model.static.gravity
    L = q.shape[1]
    dp = _full_thickness(model, q)
    q = np.float64(q)
    h = alpha[:, None, None, None, None] / grav * dp
    u = q[1] / dp
    v = q[2] / dp
    zbot = _host(model.P.zbot_df).astype(np.float64)
    elev = np.empty((L + 1,) + zbot.shape, np.float64)
    elev[L] = zbot
    for k in range(L - 1, -1, -1):
        elev[k] = elev[k + 1] + h[k]
    ssh = elev[:L]  # layer k outputs interface elevation k (diagnostics.F90:44-45)
    return np.stack([h, u, v, dp, ssh])


def compute_mass(model, state) -> np.ndarray:
    """Per-layer integral of h (the reference integrates the DERIVED h,
    src/mod_time_loop.F90:153-163 via compute_conserved on qout(1))."""
    q = _host(state.q_df)
    alpha = _host(model.P.alpha).astype(np.float64)
    h = alpha[:, None, None, None, None] / model.static.gravity * _full_thickness(model, q)
    wj = _host(model.g.wjac_df).astype(np.float64)
    return (wj[None] * h).sum(axis=(1, 2, 3, 4))
