"""Snapshot writers (txt / NetCDF) and restart readers.

Counterpart of hnumo_tpu/io/snapshots.py, with the same file formats.
Reference: src/diagnostics.F90 (txt snapshot mlswe{NNNN}),
src/diagnostics_nc.F90 (NetCDF snapshot with vars dt, dt_btp, x, y, pb,
pbub, pbvb, h, u, v, eta, zbot), src/mod_restart.F90:15-87 (state
reconstruction from a snapshot). NetCDF via scipy.io.netcdf_file
(NetCDF-3; readable by the reference's tooling).

Node ordering in flat files: element-major DG concatenation — the same
rank-invariant ordering the reference produces by gatherv of contiguous
rank blocks (src/gather_data.F90:52-60).

Writers read the state back from the device; readers give float64 numpy
arrays, and `restore_state` / `load_checkpoint` build a State on the
model's device (and, for `restore_state`, in its dtype), shaped as its
initial state, so that a restored state can enter a captured step.

Under a domain decomposition the writers take the gathered state
(Model.gather) on rank 0, the only rank that writes; every rank reads a
restart file and keeps its own block of it (Model.block).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.types import State
from .diagnostics import _host, derived_fields


def snapshot_arrays(model, state) -> dict:
    """Build the reference's snapshot variable set as flat arrays."""
    q5 = derived_fields(model, state)          # (5, L, ney, nex, ngl, ngl)
    qb = _host(state.qb_df)
    coord = np.asarray(model.geom.coord)       # (ney, nex, ngl, ngl, 2)
    L = q5.shape[1]
    npoin = coord[..., 0].size
    return {
        "x": coord[..., 0].ravel(), "y": coord[..., 1].ravel(),
        "pb": qb[0].ravel(), "pbub": qb[2].ravel(), "pbvb": qb[3].ravel(),
        "h": q5[0].reshape(L, npoin), "u": q5[1].reshape(L, npoin),
        "v": q5[2].reshape(L, npoin), "eta": q5[4].reshape(L, npoin),
        "zbot": _host(model.global_table("zbot_df")).ravel(),
        "dt": model.static.dt, "dt_btp": model.static.dt_btp,
        "nlayers": L, "npoin": npoin, "time": float(state.t),
    }


def _fname(root, itime, ext=""):
    return f"{root}{itime:04d}{ext}"


def _column(values) -> str:
    """One value per line, as the reference's formatted write."""
    return "".join(map("{:23.16e}\n".format, np.asarray(values).ravel().tolist()))


def write_txt(model, state, itime, root="mlswe", outdir="."):
    """ASCII snapshot in the reference's column order
    (src/diagnostics.F90:77-89)."""
    a = snapshot_arrays(model, state)
    path = os.path.join(outdir, _fname(root, itime))
    with open(path, "w") as f:
        f.write(f"{a['nlayers']:4d}\n")
        f.write(f"{a['npoin']:10d}\n")
        f.write(_column([a["dt"], a["dt_btp"]]))
        f.write(_column(np.stack([a["x"], a["y"]]).T))    # interleaved (2, npoin) F-order
        for name in ("pb", "pbub", "pbvb"):
            f.write(_column(a[name]))
        for name in ("h", "u", "v", "eta"):
            f.write(_column(a[name]))                     # layer-major (k slowest)
        f.write(_column(a["zbot"]))
    return path


def read_txt(path) -> dict:
    """Read a write_txt snapshot back into a dict of arrays."""
    with open(path) as f:
        vals = f.read().split()
    nlayers = int(vals[0])
    npoin = int(vals[1])
    data = np.array([float(x) for x in vals[2:]])
    dt, dt_btp = data[0], data[1]
    i = 2
    coords = data[i:i + 2 * npoin].reshape(npoin, 2)
    i += 2 * npoin
    out = dict(nlayers=nlayers, npoin=npoin, dt=dt, dt_btp=dt_btp,
               x=coords[:, 0], y=coords[:, 1])
    for name in ("pb", "pbub", "pbvb"):
        out[name] = data[i:i + npoin]
        i += npoin
    for name in ("h", "u", "v", "eta"):
        out[name] = data[i:i + nlayers * npoin].reshape(nlayers, npoin)
        i += nlayers * npoin
    out["zbot"] = data[i:i + npoin]
    return out


def write_nc(model, state, itime, root="mlswe", outdir="."):
    """NetCDF-3 snapshot with the reference's dims/vars
    (src/diagnostics_nc.F90:27-47,101-143)."""
    from scipy.io import netcdf_file

    a = snapshot_arrays(model, state)
    path = os.path.join(outdir, _fname(root, itime, ".nc"))
    with netcdf_file(path, "w") as nc:
        nc.createDimension("time", None)
        nc.createDimension("npoin", a["npoin"])
        nc.createDimension("nlayers", a["nlayers"])
        nc.createDimension("zi", a["nlayers"] + 1)
        nc.createDimension("one", 1)
        for name in ("dt", "dt_btp"):
            v = nc.createVariable(name, "d", ("one",))
            v[0] = a[name]
        for name in ("x", "y", "pb", "pbub", "pbvb", "zbot"):
            v = nc.createVariable(name, "d", ("npoin",))
            v[:] = a[name]
        for name in ("h", "u", "v", "eta"):
            v = nc.createVariable(name, "d", ("nlayers", "npoin"))
            v[:] = a[name]
        v = nc.createVariable("time", "d", ("one",))
        v[0] = a["time"]
    return path


def read_nc(path) -> dict:
    from scipy.io import netcdf_file

    out = {}
    with netcdf_file(path, "r") as nc:
        for name in ("dt", "dt_btp", "time"):
            if name in nc.variables:
                out[name] = float(np.asarray(nc.variables[name][:])[0])
        for name in ("x", "y", "pb", "pbub", "pbvb", "zbot", "h", "u", "v", "eta"):
            out[name] = np.array(nc.variables[name][:])
    out["nlayers"] = out["h"].shape[0]
    out["npoin"] = out["h"].shape[1]
    return out


def restore_state(model, snap, t=None) -> State:
    """Reconstruct the prognostic State from snapshot fields, exactly as the
    reference restart (src/mod_restart.F90:39-65):
      qb = (pb, pb - pbprime, pbub, pbvb)
      dp_k = (g/alpha_k) h_k ; (u dp, v dp) from u,v
      dp'_k = dp_k / (sum dp / pbprime) ; u'_k = u_k - pbub/pb ; etc.
    Every field is built in float64 on the host, then cast to the model's
    dtype on its device, with the shapes of `model.state0`. The rest state
    subtracted is the float64 one that `derived_fields` added when the file
    was written (model.init_fields), not its copy in the model's dtype: in
    float32 that copy is rounded by up to half a unit in the last place of
    pbprime and of the layer thickness (~1-4 Pa at ocean depths), an error
    of the size of the perturbations themselves early in a run. In float64
    the two are the same numbers. Under a decomposition the State is this
    process's block.
    """
    pbprime_df = model.init_fields.pbprime_df           # float64
    shp = pbprime_df.shape                               # (ney, nex, ngl, ngl)
    L = snap["nlayers"]
    # as derived_fields has it: in float64 (NumPy would keep g/alpha in
    # float32 for a float32 alpha, ~1 Pa off at ocean depths)
    alpha = _host(model.P.alpha).astype(np.float64)
    grav = model.static.gravity

    pb = snap["pb"].reshape(shp)
    pbub = snap["pbub"].reshape(shp)
    pbvb = snap["pbvb"].reshape(shp)
    qb = np.stack([pb, pb - pbprime_df, pbub, pbvb])

    h = snap["h"].reshape((L,) + shp)
    u = snap["u"].reshape((L,) + shp)
    v = snap["v"].reshape((L,) + shp)
    dp = grav / alpha[:, None, None, None, None] * h
    dpp_ref = model.init_fields.qprime_df[0]             # float64
    # thickness channels are stored as perturbations (core/types.State)
    q = np.stack([dp - dpp_ref, u * dp, v * dp])

    one_plus_eta = dp.sum(0) / pbprime_df
    qprime = np.stack([dp / one_plus_eta[None] - dpp_ref,
                       u - (pbub / pb)[None],
                       v - (pbvb / pb)[None]])

    t_val = snap.get("time", 0.0) if t is None else t
    opts = dict(dtype=model.dtype)
    return model.block(State(
        qb_df=torch.tensor(qb, **opts), q_df=torch.tensor(q, **opts),
        qprime_df=torch.tensor(qprime, **opts), t=torch.tensor(t_val, **opts),
        ok=torch.tensor(True)))


# ---------------------------------------------------------------------------
# native checkpoint (exact-resume): full prognostic state, no derivation
# ---------------------------------------------------------------------------

def save_checkpoint(path, state, itime, model=None):
    """Exact binary checkpoint of the prognostic state (npz). Unlike the
    reference (whose checkpoints ARE the derived-field snapshots), this
    round-trips bit-exactly, and across decompositions: the file holds the
    whole grid. With `model` given, `state` is that model's (a block under a
    decomposition, which every rank must then pass: it is gathered, and
    rank 0 writes)."""
    if model is not None:
        state = model.gather(state)
        if not model.is_writer:
            return
    np.savez_compressed(
        path, qb_df=_host(state.qb_df), q_df=_host(state.q_df),
        qprime_df=_host(state.qprime_df), t=_host(state.t),
        ok=_host(state.ok), itime=itime)


def load_checkpoint(path, model):
    """(State on the model's device — its block under a decomposition —,
    itime) from a save_checkpoint file."""
    z = np.load(path)
    state = State(*[torch.tensor(z[name]) for name in State._fields])
    return model.block(state), int(z["itime"][()])
