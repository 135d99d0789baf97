"""Runtime diagnostics: derived fields, min/max, mass conservation, CFL.

Counterpart of hnumo_tpu/io/diagnostics.py. Reference:
src/diagnostics.F90:24-45 (derived output fields),
src/print_diagnostics.F90:14-190 (per-layer min/max + mass loss + CFL +
mlswe_FIN.txt — the CI golden-file contract, CI/bump/check.F90:41-83),
src/courant.F90:34-127, src/mod_time_loop.F90:153-163 with
src/compute_conserved.F90:7-44 (mass). Every function reads the state back
from the device and works on float64 numpy arrays in the JAX package's
layout, on the whole grid: under a domain decomposition the caller passes
the gathered state (Model.gather, on rank 0), and the tables are read
through Model.global_table.
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
    zbot = _host(model.global_table("zbot_df")).astype(np.float64)
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
    wj = _host(model.global_table("wjac_df")).astype(np.float64)
    return (wj[None] * h).sum(axis=(1, 2, 3, 4))


def courant(model, state):
    """(cfl_b, cfl, min_dx, min_dy) — reference courant_cube_mlswe
    (src/courant.F90:34-127): sub-cell 4-node averages of the barotropic
    MOMENTA (sic — the reference uses qb(3:4), i.e. pb*ub, as velocities;
    reproduced verbatim for output parity) and layer velocities."""
    qb = _host(state.qb_df)
    q5 = derived_fields(model, state)

    xn = np.asarray(model.geom.coord[..., 0])
    yn = np.asarray(model.geom.coord[..., 1])
    dx_sub = np.abs(np.diff(xn, axis=-1))
    dy_sub = np.abs(np.diff(yn, axis=-2))
    min_dx = float(dx_sub[dx_sub > 0].min())
    min_dy = float(dy_sub[dy_sub > 0].min())

    def subcell_avg(f):  # (ney, nex, ngl, ngl) -> 4-node sub-cell means
        return 0.25 * (f[..., :-1, :-1] + f[..., :-1, 1:]
                       + f[..., 1:, :-1] + f[..., 1:, 1:])

    ub = subcell_avg(qb[2])
    vb = subcell_avg(qb[3])
    cfl_b = max(np.abs(ub).max() * model.static.dt_btp / min_dx,
                np.abs(vb).max() * model.static.dt_btp / min_dy)
    uk = subcell_avg(q5[1])
    vk = subcell_avg(q5[2])
    cfl = max(np.abs(uk).max() * model.static.dt / min_dx,
              np.abs(vk).max() * model.static.dt / min_dy)
    return float(cfl_b), float(cfl), min_dx, min_dy


def summary(model, state, mass0=None):
    """Full diagnostic dict (print_diagnostics_mlswe equivalent)."""
    q5 = derived_fields(model, state)
    qb = _host(state.qb_df)
    L = q5.shape[1]
    out = {
        "time": float(state.t),
        "layers": [],
        "qb_max": qb.max(axis=(1, 2, 3, 4)).tolist(),
        "qb_min": qb.min(axis=(1, 2, 3, 4)).tolist(),
    }
    mass = compute_mass(model, state)
    out["mass"] = mass.tolist()
    for k in range(L):
        layer = {
            "max": q5[:, k].max(axis=(1, 2, 3, 4)).tolist(),
            "min": q5[:, k].min(axis=(1, 2, 3, 4)).tolist(),
        }
        if mass0 is not None:
            layer["mass_loss"] = float(abs(mass[k] - mass0[k]) / mass0[k])
        out["layers"].append(layer)
    cfl_b, cfl, min_dx, min_dy = courant(model, state)
    out.update(cfl_b=cfl_b, cfl=cfl, min_dx=min_dx, min_dy=min_dy)
    return out


_FIN_FIELDS = ("h", "u", "v", "dp", "ssh")


def write_fin(path, summ):
    """Write mlswe_FIN.txt in the reference's exact format
    (src/print_diagnostics.F90:167-184; parsed by CI/bump/check.F90:41-57).
    Note the reference skips field 4 (dp) in the file."""
    with open(path, "w") as f:
        for k, layer in enumerate(summ["layers"]):
            f.write(f"Layer = {k + 1:8d}\n")
            ml = layer.get("mass_loss", 0.0)
            f.write(f"Mass Loss  =   {_e(ml, 8)}\n")
            for i, name in enumerate(_FIN_FIELDS):
                if name == "dp":
                    continue
                f.write(f"Fields:   Max/Min = {name:<3s} "
                        f"{_e(layer['max'][i], 12):>24s}    "
                        f"{_e(layer['min'][i], 12):>24s}\n")


def _e(x, digits):
    """Fortran-style eN.M formatting: 0.XXXE+YY."""
    if x == 0.0:
        return f"0.{'0' * digits}E+00"
    import math

    neg = x < 0
    x = abs(x)
    exp = int(math.floor(math.log10(x))) + 1
    mant = x / 10.0**exp
    s = f"{mant:.{digits}f}"[1:]  # strip leading 0
    return f"{'-' if neg else ''}0{s}E{exp:+03d}"


def print_summary(summ, itime, dt, dt_btp, time_scale=1.0):
    """Human-readable block mirroring print_diagnostics_mlswe stdout."""
    lines = ["=" * 63,
             f"itime time dt dt_btp = {itime:8d} {summ['time']/time_scale:13.5e} "
             f"{dt:13.5e} {dt_btp:13.5e}",
             f"CFL_B = {summ['cfl_b']:11.4e} CFL = {summ['cfl']:11.4e}",
             f"dx_min = {summ['min_dx']:11.4e} dy_min = {summ['min_dy']:11.4e}",
             "-" * 63]
    for k, layer in enumerate(summ["layers"]):
        lines.append(f"Layer = {k + 1:8d}")
        if "mass_loss" in layer:
            lines.append(f"Mass Loss   = {layer['mass_loss']:22.8e}")
        for i, name in enumerate(_FIN_FIELDS):
            lines.append(f"Q: {name:<3s}  Max/Min = {layer['max'][i]:24.12e} "
                         f"{layer['min'][i]:24.12e}")
        lines.append("-" * 63)
    lines.append("Barotropic")
    for i in range(4):
        lines.append(f"Qb: i    Max/Min = {i+1:3d} {summ['qb_max'][i]:24.12e} "
                     f"{summ['qb_min'][i]:24.12e}")
    lines.append("=" * 63)
    return "\n".join(lines)


def print_header(model, flag=0, numproc=1):
    """Run-configuration banner (reference src/print_header.F90:14-71).

    flag=0 at simulation start, flag=1 at the end."""
    cfg = model.cfg
    geom = model.geom
    ngl = geom.psiq.shape[0]
    npoin = cfg.nelx * cfg.nely * ngl * ngl
    nboun = 2 * (cfg.nelx + cfg.nely)
    ts = cfg.time_scale
    lines = [
        "-------------------Begin Simulation----------------------------"
        if flag == 0 else
        "----------------------End Simulation---------------------------",
        "-" * 63,
        "eqn_set = mlswe",
        ("dt dt_btp time_initial time_final time_restart time_scale = "
         + " ".join(f"{v:12.4e}" for v in
                    (cfg.dt, cfg.dt_btp, cfg.time_initial,
                     cfg.time_final, cfg.time_restart, ts))),
        f"nopx nopy = {cfg.nopx:6d} {cfg.nopy:6d}",
        f"nelx nely = {cfg.nelx:6d} {cfg.nely:6d}",
        f"test_case  = {cfg.test_case}",
        f"ti_method_btp = {cfg.ti_method_btp}",
        f"kstages = {cfg.kstages:6d}",
        f"out_type = {cfg.out_type}",
        f"viscosity = {cfg.visc_mlswe:6.3f}",
        (f"nlayers npoin nelem nboun = {cfg.nlayers:9d} {npoin:9d} "
         f"{cfg.nelx * cfg.nely:9d} {nboun:9d}"),
        f"lprint_diagnostics = {cfg.lprint_diagnostics!r:7s}",
        f"numproc = {numproc:6d}",
        "-" * 63,
        "",
    ]
    return "\n".join(lines)
