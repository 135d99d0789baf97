"""Initial conditions and precomputed reference-state tables.

Counterpart of hnumo_tpu/core/init.py. Host-side NumPy setup mirroring the
reference init path:
  initial_conditions (src/initial_conditions.F90:7-418),
  mod_initial_create (src/mod_initial.F90:88-190),
  interpolate_pbprime_init / bot_topo_derivatives / wind_stress_coriolis /
  compute_reference_edge_variables (src/mod_initial_mlswe.F90).
All arrays are built in float64 NumPy and cast to the compute dtype on the
device that will step. The tables that the stepping code later SUBTRACTS
from its own results are recomputed there with the port's own operators
(see build_precomputed).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..basis.ssprk import ssprk_coefficients
from ..config import Config
from ..mesh.grid import Geometry
from ..ops.dg import device_geom, interp_n2q
from .faces import BCs, extract_faces, face_n2q
from .types import FaceDirGeom, Pair, Precomputed, State

GRAVITY_DEFAULT = 9.806

IMPLS = ("kernel", "plain")
# "auto" dispatches the megakernel up to this many elements. The number is
# the JAX package's (there a fast-memory cap of its kernel); it is kept so
# that both packages take the same path at the same size.
MEGA_AUTO_MAX_ELEMENTS = 1024
MEGA_MAX_NOP = 7
# batched_faces="auto" batches both face directions up to this many
# elements, per direction above: the JAX package's cut-over (there a
# measured crossover of its own), kept so the two packages take the same
# face path at the same size until a benchmark of the port moves it
BATCHED_FACES_AUTO_MAX_ELEMENTS = 8192


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Python-static solver parameters.

    The physics fields of the JAX package's StaticConfig; its backend flags
    are replaced by `mega_on` (the whole-solve megakernel path was asked
    for and the size allows it; `mega` adds the envelope), `fused_tail_on`,
    `uni_volume_on` and `batched_faces_on` (asked for, or for the flat face
    axis the size allows it; `fused_tail`, `uni_volume` and `batched_faces`
    add the envelopes) and one implementation switch, `impl`: "kernel" runs
    every hand-written CUDA kernel of the port on the path the flags choose
    (the barotropic volume stage, general or uniform-geometry, ops/btp_volume
    and ops/btp_volume_uni; the whole-solve megakernel, ops/mega; the fused
    path's face and update stages, ops/btp_tail; the coupling coefficients,
    ops/bcl_coeffs; the baroclinic thickness update, ops/bcl_mass; the baroclinic layer momentum's face fluxes,
    volume term and nodal-family viscosity, ops/bcl_flux, ops/bcl_mom_volume
    and ops/bcl_visc), "plain" runs their plain PyTorch versions."""

    nlayers: int
    kstages: int
    n_btp: int
    dt: float
    dt_btp: float
    gravity: float
    botfr: int
    cd_mlswe: float
    method_visc: int
    visc_mlswe: float
    ad_mlswe: float
    max_shear_dz: float
    alpha_bot: float    # alpha(nlayers), for quadratic bottom drag
    Pstress: float      # wind-stress distribution depth scale (pressure)
    Pbstress: float
    compat_reference_stress: bool = False  # verbatim reference stress slip
    uniform_geom: bool = False    # affine brick mesh with constant metrics
    periodic: bool = False        # any periodic boundary
    flat_bottom: bool = False     # grad(z_bot) == 0 everywhere
    ti_method_btp: str = "rk35"   # barotropic integrator: rk35/ssprk |
    #                               lsrk (2N low-storage) | lsrk_ref
    #                               (the reference's, divergent)
    impl: str = "plain"           # "kernel" | "plain"
    mega_on: bool = False         # whole-solve megakernel path (ops/mega)
    fused_tail_on: bool = False   # opt-in whole-stage fused path (config)
    uni_volume_on: bool = False   # opt-in uniform-geometry volume kernel
    batched_faces_on: bool = False  # both face directions on one flat axis
    # SSPRK tables (reference src/mod_initial_mlswe.F90:582-681; the LSRK
    # ones under lsrk and lsrk_ref, column 0 the A and beta the B
    # coefficients) as Python floats rounded to the compute dtype — the
    # values of P.ssprk_a / P.ssprk_beta — so that a solve reads no device
    # tensor on the host
    ssprk_a: tuple = ()           # kstages rows of 3
    ssprk_beta: tuple = ()        # kstages

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")

    @property
    def mega_envelope(self) -> bool:
        """What the whole-solve megakernel covers: uniform brick geometry,
        non-periodic walls, the SSP integrator `rk35` (lsrk carries a dq
        register with a different update), nodal LDG family or no
        viscosity. f32 and f64 alike."""
        return (self.uniform_geom and not self.periodic
                and self.ti_method_btp == "rk35"
                and (not self.use_visc or self.method_visc != 1))

    @property
    def mega(self) -> bool:
        """The barotropic solve goes through ops/mega (one launch per solve)."""
        return self.mega_on and self.mega_envelope

    @property
    def use_visc(self) -> bool:
        return self.visc_mlswe != 0.0

    @property
    def batched_faces(self) -> bool:
        """The per-stage path batches both face directions on one flat face
        axis (core/btp._btp_faces_visc_flat); else one pipeline per
        direction (core/btp._btp_faces_visc). Never under the fused path,
        whose face kernel has its own layout, nor in the quad viscosity
        family, which keeps the per-direction pipeline."""
        return (self.batched_faces_on and not self.fused_tail
                and (not self.use_visc or self.method_visc != 1))

    @property
    def uni_volume(self) -> bool:
        """The per-stage path runs the uniform-geometry volume kernel
        (ops/btp_volume_uni) in place of the general one. Needs the uniform
        brick: its metric terms are scalars folded into the weights."""
        return self.uni_volume_on and self.uniform_geom

    @property
    def fused_tail(self) -> bool:
        """Whole-stage fused path (core/btp._barotropic_solve_fused): volume
        stage with the velocity gradient, all-faces flux and update as three
        kernels. Needs the uniform-geometry operators (periodic sides
        included), the SSP combine (lsrk carries a dq register with a
        different update; lsrk_ref is the SSP combine on the LSRK tables)
        and the nodal viscosity family or none. `mega` is asked before
        it."""
        return (self.fused_tail_on and self.uniform_geom
                and self.ti_method_btp != "lsrk"
                and (not self.use_visc or self.method_visc != 1))


@dataclasses.dataclass
class InitialFields:
    """Host-side initial condition output (float64 NumPy)."""

    q_df: np.ndarray        # (3, L, nodal)
    qb_df: np.ndarray       # (4, nodal)
    qprime_df: np.ndarray   # (3, L, nodal)
    pbprime_df: np.ndarray  # (nodal)
    zbot_df: np.ndarray
    z_interface: np.ndarray  # (L+1, nodal)
    alpha: np.ndarray       # (L,)
    tau_wind_df: np.ndarray  # (2, nodal)
    gravity: float


def _test_case_fields(cfg: Config, geom: Geometry, zbot_ext=None) -> InitialFields:
    """Test-case switch (reference src/initial_conditions.F90:93-306).

    `zbot_ext`: optional external bathymetry (nely, nelx, ngl, ngl) that
    overrides the test case's analytic bottom (reference read_bathy path,
    src/read_gmsh.F90:178-207); the stratification (alpha, interface
    levels) still comes from the selected test case.
    """
    L = cfg.nlayers
    x = geom.coord[..., 0]
    y = geom.coord[..., 1]
    shape = x.shape
    zbot = np.zeros(shape)
    z_int = np.zeros((L + 1,) + shape)
    alpha = np.zeros(L)
    tau_wind_df = np.zeros((2,) + shape)
    grav = GRAVITY_DEFAULT
    Ly = cfg.ydims[1] - cfg.ydims[0]

    tc = cfg.test_case.strip().lower()
    if tc == "bump":
        H_bot = 40.0
        zbot[:] = -H_bot
        for k in range(L + 1):
            z_int[k] = -k * H_bot / L
        xm = 0.5 * (x.min() + x.max())
        yl = 0.5 * (y.min() + y.max())
        Lb, amp = 250.0, 1.0
        r = np.sqrt((x - xm) ** 2 + (y - yl) ** 2)
        z_int[1] = np.where(r < Lb, z_int[1] + 0.5 * amp * (1.0 + np.cos(np.pi * r / Lb)), z_int[1])
        alpha[0] = 0.9737e-3
        alpha[1] = 0.9735e-3
    elif tc == "lakeatrest":
        H_bot = 40.0
        zbot[:] = -H_bot
        xm = 0.5 * (cfg.xdims[0] + cfg.xdims[1])
        yl = 0.5 * (cfg.ydims[0] + cfg.ydims[1])
        Lb = 250.0
        r = np.sqrt((x - xm) ** 2 + (y - yl) ** 2)
        zbot = np.where(r < Lb, zbot + 3.0 * (1.0 + np.cos(np.pi * r / Lb)), zbot)
        for k in range(L + 1):
            if L < 5:
                z_int[k] = -k * H_bot / L
            else:
                z_int[k] = -k * 32.0 / (L - 1)
        if L >= 5:
            z_int[L] = -H_bot
        rho_0 = 1027.01037
        alpha[0] = 1.0 / rho_0
        for k in range(1, L):
            alpha[k] = 1.0 / (rho_0 + (k + 1) * 0.2110 / L)
    elif tc in ("double-gyre", "double_gyre"):
        H_bot = 9928.0
        zbot[:] = -H_bot
        z_int[1] = -1489.5
        z_int[2] = -H_bot
        alpha[0] = 9.7370e-4
        alpha[1] = 9.7350e-4
        tau_wind_df[0] = -0.1 * np.cos(2.0 * np.pi * y / Ly)
    elif tc == "dam":
        H_bot = 3600.0
        xk, yk = x / 1.0e3, y / 1.0e3
        zb = np.where(yk <= 300.0, H_bot,
                      np.where(yk <= 600.0, H_bot - 9.5 * (yk - 300.0), 0.0))
        zb = np.where((yk > 600.0) & (xk >= 400.0) & (xk <= 500.0), 600.0, zb)
        zbot = -zb
        indep = np.zeros(L + 1)
        for k in range(1, L):
            indep[k] = H_bot * (k - 0.5) / (L - 1)
        for k in range(L):
            z_int[k] = -indep[k]
        z_int[L] = zbot
        for k in range(L):
            z_int[k] = np.maximum(zbot, z_int[k])
        mask = (yk >= 650.0) & (yk <= Ly) & (xk >= 400.0) & (xk <= 500.0)
        for k in range(1, L):
            z_int[k] = np.where(mask, np.maximum(-100.0, z_int[k]), z_int[k])
        rho_0 = 1027.01037
        alpha[0] = 1.0 / rho_0
        for k in range(1, L):
            alpha[k] = 1.0 / (rho_0 + (k + 1) * 0.2110 / L)
    elif tc == "seamount":
        H_bot = 4000.0
        zbot[:] = -H_bot
        xm = 0.5 * (cfg.xdims[0] + cfg.xdims[1])
        Lb, delta = 1.0 / 20.0e3, 0.4998
        r = (Lb * (x - xm)) ** 2
        zbot = zbot * (1.0 - delta * np.exp(-r))
        for k in range(L + 1):
            z_int[k] = -k * H_bot / L
        z_int[L] = zbot
        rho_0 = 1027.01037
        alpha[0] = 1.0 / rho_0
        for k in range(1, L):
            alpha[k] = 1.0 / (rho_0 + (k + 1) * 0.2110 / L)
    else:
        raise ValueError(f"unknown test case {cfg.test_case!r}")

    if zbot_ext is not None:
        zbot = np.asarray(zbot_ext, dtype=np.float64)
        z_int[L] = zbot

    # clamp interfaces to bottom (reference :310-317)
    for k in range(L + 1):
        z_int[k] = np.maximum(zbot, z_int[k])

    # pbprime + layer dp + barotropic sums (reference :324-416)
    pbprime_df = np.zeros(shape)
    for k in range(L):
        pbprime_df += (grav / alpha[k]) * (z_int[k] - z_int[k + 1])

    q_df = np.zeros((3, L) + shape)
    one_plus_eta = np.zeros(shape)
    for k in range(L):
        q_df[0, k] = (grav / alpha[k]) * (z_int[k] - z_int[k + 1])
        one_plus_eta += q_df[0, k] / pbprime_df
    qprime_df = np.zeros_like(q_df)
    qprime_df[0] = q_df[0] / one_plus_eta[None]
    # initial velocities are zero for all shipped cases (u_df=v_df=0)

    qb_df = np.zeros((4,) + shape)
    qb_df[0] = q_df[0].sum(axis=0)
    qb_df[2] = q_df[1].sum(axis=0)
    qb_df[3] = q_df[2].sum(axis=0)
    qb_df[1] = qb_df[0] - pbprime_df
    with np.errstate(invalid="ignore", divide="ignore"):
        qprime_df[1] = q_df[1] / q_df[0] - (qb_df[2] / qb_df[0])[None]
        qprime_df[2] = q_df[2] / q_df[0] - (qb_df[3] / qb_df[0])[None]
    qprime_df = np.nan_to_num(qprime_df)

    return InitialFields(q_df=q_df, qb_df=qb_df, qprime_df=qprime_df,
                         pbprime_df=pbprime_df, zbot_df=zbot,
                         z_interface=z_int, alpha=alpha,
                         tau_wind_df=tau_wind_df, gravity=grav)


def _face_traces_np(u, geom: Geometry, bc: BCs):
    """Host-side nodal face trace extraction (scalar copy closure)."""
    east, west = u[..., :, :, :, -1], u[..., :, :, :, 0]
    north, south = u[..., :, :, -1, :], u[..., :, :, 0, :]
    if bc.x_periodic:
        xl = np.concatenate([east[..., -1:, :], east], axis=-2)
        xr = np.concatenate([west, west[..., :1, :]], axis=-2)
    else:
        xl = np.concatenate([west[..., :1, :], east], axis=-2)
        xr = np.concatenate([west[..., :1, :], west[..., 1:, :], east[..., -1:, :]], axis=-2)
    if bc.y_periodic:
        yl = np.concatenate([north[..., -1:, :, :], north], axis=-3)
        yr = np.concatenate([south, south[..., :1, :, :]], axis=-3)
    else:
        yl = np.concatenate([south[..., :1, :, :], north], axis=-3)
        yr = np.concatenate([south[..., :1, :, :], south[..., 1:, :, :], north[..., -1:, :, :]], axis=-3)
    return (xl, xr), (yl, yr)


def check_ported(cfg: Config) -> None:
    """Raise for what the JAX package refuses too (hnumo_tpu/model.py:47):
    a polynomial order that differs between x and y."""
    if cfg.nopy != cfg.nopx:
        raise NotImplementedError("anisotropic polynomial order not supported yet")


def static_for_blocks(static: StaticConfig, cfg: Config, nblocks: int) -> StaticConfig:
    """The StaticConfig of one block of a domain decomposition into `nblocks`
    blocks, as the JAX package sets it under a mesh (hnumo_tpu/model.py:
    127-146): the whole-solve megakernel is off (its in-kernel exchange has
    no counterpart between processes; `mega="on"` is turned off as there,
    without a word), and `batched_faces="auto"` is resolved on the elements
    of one block, which set the launch-latency regime, not the whole grid's."""
    per_block = (cfg.nelx * cfg.nely) // nblocks
    batched = (static.batched_faces_on if cfg.batched_faces != "auto"
               else per_block <= BATCHED_FACES_AUTO_MAX_ELEMENTS)
    return dataclasses.replace(static, mega_on=False, batched_faces_on=batched)


def build_precomputed(cfg: Config, geom: Geometry, dtype: torch.dtype, device,
                      impl: str = "plain", zbot_ext=None
                      ) -> tuple[Precomputed, State, StaticConfig, InitialFields]:
    """Build all static tables + initial state as tensors on `device`."""
    check_ported(cfg)
    bc = BCs(*geom.bc)
    ini = _test_case_fields(cfg, geom, zbot_ext=zbot_ext)
    grav = ini.gravity
    L = cfg.nlayers

    def cast(a):
        # contiguous whatever the host array's layout (a mesh read from a
        # file gives transposed face tables): the kernels take them so
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    def n2q(u):  # nodal -> quad interp, host side
        return np.einsum("...ji,jJ,iI->...JI", u, geom.psiq, geom.psiq, optimize=True)

    def grad_q(u):  # nodal -> quad gradient
        d_ksi = np.einsum("...ji,jJ,iI->...JI", u, geom.psiq, geom.dpsiq, optimize=True)
        d_eta = np.einsum("...ji,jJ,iI->...JI", u, geom.dpsiq, geom.psiq, optimize=True)
        return (d_ksi * geom.ksiq_x + d_eta * geom.etaq_x,
                d_ksi * geom.ksiq_y + d_eta * geom.etaq_y)

    pbprime_q = n2q(ini.pbprime_df)
    zbot_q = n2q(ini.zbot_df)
    gzx, gzy = grad_q(ini.zbot_df)

    with np.errstate(divide="ignore"):
        one_over_pbprime = np.where(pbprime_q > 0, 1.0 / pbprime_q, 0.0)
        one_over_pbprime_df = np.where(ini.pbprime_df > 0, 1.0 / ini.pbprime_df, 0.0)

    # Coriolis (reference wind_stress_coriolis, src/mod_initial_mlswe.F90:280-352)
    ym = 0.5 * cfg.ydims[1]
    coriolis_df = cfg.f0 + cfg.beta * (geom.coord[..., 1] - ym)
    coriolis_quad = n2q(coriolis_df)
    tau_wind_q = np.stack([n2q(ini.tau_wind_df[0]), n2q(ini.tau_wind_df[1])])
    fdt2 = 0.5 * cfg.dt * coriolis_df
    a_bcl = 1.0 / (1.0 + fdt2**2)
    b_bcl = fdt2 / (1.0 + fdt2**2)

    ssprk_a, ssprk_beta = ssprk_coefficients(
        cfg.kstages,
        "lsrk" if cfg.ti_method_btp in ("lsrk", "lsrk_ref") else "ssprk")

    # ---- reference-state (rest) tables for the f32 δ-formulation --------
    # (docs/float32.md). Reference = the t=0 rest profile: dp'_ref is the
    # initial prime thickness (one_plus_eta == 1 at t=0 by construction of
    # pbprime, src/initial_conditions.F90:324-416).
    dpp_ref_df = ini.qprime_df[0].copy()                  # (L, nodal) f64
    dpp_ref_q = n2q(dpp_ref_df)                           # (L, quad)
    P_ref_q = np.concatenate([np.zeros_like(dpp_ref_q[:1]),
                              np.cumsum(dpp_ref_q, axis=0)], axis=0)
    alz = ini.alpha.reshape((L, 1, 1, 1, 1))
    Hk_ref_q = 0.5 * alz * (P_ref_q[1:] ** 2 - P_ref_q[:-1] ** 2)
    H_bcl_ref = Hk_ref_q.sum(axis=0)
    dz_ref = (alz / grav) * dpp_ref_df                    # (L, nodal)
    z_ref_df = np.concatenate(
        [ini.zbot_df[None] + np.cumsum(dz_ref[::-1], axis=0)[::-1],
         ini.zbot_df[None]], axis=0)                      # (L+1, nodal)
    gz_ref = np.stack([np.stack(grad_q(z_ref_df[k]))
                       for k in range(L + 1)], axis=1)    # (2, L+1, quad)

    def ref_face_tables(xl_sel):
        """Per-direction ref face tables from the (continuous) nodal trace."""
        (fxl, _), (fyl, _) = _face_traces_np(dpp_ref_df, geom, bc)
        tr = xl_sel(fxl, fyl)                             # (L, F, ngl)
        trq = np.einsum("...n,nq->...q", tr, geom.psiq)   # (L, F, nq)
        Pe = np.concatenate([np.zeros_like(trq[:1]), np.cumsum(trq, axis=0)], 0)
        alf = ini.alpha.reshape((L, 1, 1, 1))
        Hke = 0.5 * alf * (Pe[1:] ** 2 - Pe[:-1] ** 2)
        return tr, trq, Pe, Hke

    # ---- per-direction face tables -------------------------------------
    (pbq_xl, pbq_xr), (pbq_yl, pbq_yr) = _face_traces_np(pbprime_q, geom, bc)
    # quad-grid face traces: slice quad field edges (pbprime at quad points,
    # one-sided limits — reference interpolate_pbprime_init :219-251)
    (pbdf_xl, pbdf_xr), (pbdf_yl, pbdf_yr) = _face_traces_np(ini.pbprime_df, geom, bc)
    (zb_xl, zb_xr), (zb_yl, zb_yr) = _face_traces_np(zbot_q, geom, bc)

    def face_dir_geom(direction):
        if direction == "x":
            nx, ny, jac = geom.nx_x, geom.ny_x, geom.jac_facex
            nx_df, ny_df, jac_df = geom.nx_x_df, geom.ny_x_df, geom.jac_facex_df
            pbL, pbR = pbq_xl, pbq_xr
            pbdfL, pbdfR = pbdf_xl, pbdf_xr
            zbL, zbR = zb_xl, zb_xr
            F = (geom.nely, geom.nelx + 1)
            wall = np.zeros(F + (1,))
            if not bc.x_periodic:
                if bc.west == 4:
                    wall[:, 0, 0] = 1.0
                if bc.east == 4:
                    wall[:, -1, 0] = 1.0
        else:
            nx, ny, jac = geom.nx_y, geom.ny_y, geom.jac_facey
            nx_df, ny_df, jac_df = geom.nx_y_df, geom.ny_y_df, geom.jac_facey_df
            pbL, pbR = pbq_yl, pbq_yr
            pbdfL, pbdfR = pbdf_yl, pbdf_yr
            zbL, zbR = zb_yl, zb_yr
            F = (geom.nely + 1, geom.nelx)
            wall = np.zeros(F + (1,))
            if not bc.y_periodic:
                if bc.south == 4:
                    wall[0, :, 0] = 1.0
                if bc.north == 4:
                    wall[-1, :, 0] = 1.0

        # linearized-Riemann wave-speed coefficient tables (quad version:
        # reference compute_reference_edge_variables, note c_minus is built
        # from the RIGHT face value, src/mod_initial_mlswe.F90:382-396)
        c_minus = np.sqrt(ini.alpha[L - 1] * pbR)
        c_plus = np.sqrt(ini.alpha[L - 1] * pbL)
        csum = c_minus + c_plus
        ok = (c_minus > 0) | (c_plus > 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            coeff_pbpert_L = np.where(ok, c_minus / csum, 0.0)
            coeff_pbpert_R = np.where(ok, c_plus / csum, 0.0)
            coeff_pbub_LR = np.where(ok, 1.0 / csum, 0.0)
            coeff_mass_pbub_L = np.where(ok, c_plus / csum, 0.0)
            coeff_mass_pbub_R = np.where(ok, c_minus / csum, 0.0)
            coeff_mass_pbpert_LR = np.where(ok, c_minus * c_plus / csum, 0.0)

        with np.errstate(divide="ignore"):
            one_over_pb_edge = np.where(pbL > 0, 1.0 / pbL, 0.0)

        # reference-state face tables (δ-formulation, docs/float32.md)
        if direction == "x":
            tr, trq, Pe, Hke = ref_face_tables(lambda fx, fy: fx)
        else:
            tr, trq, Pe, Hke = ref_face_tables(lambda fx, fy: fy)
        alf = ini.alpha.reshape((L, 1, 1, 1))
        thick_ref = (alf / grav) * trq
        z_ref_face = np.concatenate(
            [zbL[None] + np.cumsum(thick_ref[::-1], axis=0)[::-1], zbL[None]], 0)

        return FaceDirGeom(
            nx=cast(nx), ny=cast(ny), jac=cast(jac),
            nx_df=cast(nx_df), ny_df=cast(ny_df), jac_df=cast(jac_df),
            coeff_pbpert_L=cast(coeff_pbpert_L), coeff_pbpert_R=cast(coeff_pbpert_R),
            coeff_pbub_LR=cast(coeff_pbub_LR),
            coeff_mass_pbub_L=cast(coeff_mass_pbub_L),
            coeff_mass_pbub_R=cast(coeff_mass_pbub_R),
            coeff_mass_pbpert_LR=cast(coeff_mass_pbpert_LR),
            pbprime_face_L=cast(pbL), pbprime_face_R=cast(pbR),
            one_over_pbprime_edge=cast(one_over_pb_edge),
            pbprime_df_face_L=cast(pbdfL), pbprime_df_face_R=cast(pbdfR),
            zbot_face_L=cast(zbL), zbot_face_R=cast(zbR),
            wall4=cast(wall),
            dpp_ref_face=cast(tr), dpp_ref_face_q=cast(trq),
            P_ref_edge=cast(Pe), Hk_ref_edge=cast(Hke),
            Hedge_ref=cast(Hke.sum(axis=0)), z_ref_face=cast(z_ref_face),
        )

    # ---- static RHS vectors (f64, host NumPy mirrors of the stepping
    # operators, so that f32 runs get them rounded once from f64) --------
    # Exactly the terms the δ-form kernels drop (docs/float32.md): the
    # reference-state H fluxes + static sources. For a well-balanced case
    # these sum to ~1e-12; for an off-equilibrium IC they are the small
    # initial forcing. Assembled serially (global layout).
    def np_scatter_volume(Fx=None, Fy=None, Fs=None):
        out = 0.0
        if Fx is not None or Fy is not None:
            fx = Fx if Fx is not None else 0.0
            fy = Fy if Fy is not None else 0.0
            a_ksi = geom.wjac * (fx * geom.ksiq_x + fy * geom.ksiq_y)
            a_eta = geom.wjac * (fx * geom.etaq_x + fy * geom.etaq_y)
            out = np.einsum("...JI,jJ,iI->...ji", a_ksi, geom.psiq, geom.dpsiq,
                            optimize=True)
            out = out + np.einsum("...JI,jJ,iI->...ji", a_eta, geom.dpsiq,
                                  geom.psiq, optimize=True)
        if Fs is not None:
            out = out + np.einsum("...JI,jJ,iI->...ji", geom.wjac * Fs,
                                  geom.psiq, geom.psiq, optimize=True)
        return out

    def np_fqs(jac, flux):
        return np.einsum("...q,nq->...n", jac * flux, geom.psiq, optimize=True)

    def np_sfx(rhs, S):  # serial mirror of faces.scatter_face_x
        rhs = rhs.copy()
        rhs[..., :, :, :, -1] -= S[..., :, 1:, :]
        w0 = S[..., :, :1, :] if bc.x_periodic else -S[..., :, :1, :]
        rhs[..., :, :, :, 0] += np.concatenate([w0, S[..., :, 1:-1, :]], axis=-2)
        return rhs

    def np_sfy(rhs, S):
        rhs = rhs.copy()
        rhs[..., :, :, -1, :] -= S[..., 1:, :, :]
        s0 = S[..., :1, :, :] if bc.y_periodic else -S[..., :1, :, :]
        rhs[..., :, :, 0, :] += np.concatenate([s0, S[..., 1:-1, :, :]], axis=-3)
        return rhs

    _, trqx, Pex, Hkex = ref_face_tables(lambda fx, fy: fx)
    _, trqy, Pey, Hkey = ref_face_tables(lambda fx, fy: fy)
    Hex, Hey = Hkex.sum(axis=0), Hkey.sum(axis=0)

    rhs2 = np_scatter_volume(Fx=H_bcl_ref, Fs=-grav * pbprime_q * gzx)
    rhs3 = np_scatter_volume(Fy=H_bcl_ref, Fs=-grav * pbprime_q * gzy)
    rhs2 = np_sfy(np_sfx(rhs2, np_fqs(geom.jac_facex, geom.nx_x * Hex)),
                  np_fqs(geom.jac_facey, geom.nx_y * Hey))
    rhs3 = np_sfy(np_sfx(rhs3, np_fqs(geom.jac_facex, geom.ny_x * Hex)),
                  np_fqs(geom.jac_facey, geom.ny_y * Hey))
    btp_rhs_ref = np.stack([np.zeros_like(rhs2), rhs2, rhs3])

    src_x = grav * (P_ref_q[:-1] * gz_ref[0, :-1] - P_ref_q[1:] * gz_ref[0, 1:])
    src_y = grav * (P_ref_q[:-1] * gz_ref[1, :-1] - P_ref_q[1:] * gz_ref[1, 1:])
    rhs_u = np_scatter_volume(Fx=Hk_ref_q, Fs=src_x)
    rhs_v = np_scatter_volume(Fy=Hk_ref_q, Fs=src_y)
    rhs_u = np_sfy(np_sfx(rhs_u, np_fqs(geom.jac_facex, geom.nx_x[None] * Hkex)),
                   np_fqs(geom.jac_facey, geom.nx_y[None] * Hkey))
    rhs_v = np_sfy(np_sfx(rhs_v, np_fqs(geom.jac_facex, geom.ny_x[None] * Hkex)),
                   np_fqs(geom.jac_facey, geom.ny_y[None] * Hkey))
    bcl_rhs_ref = np.stack([rhs_u, rhs_v])

    P = Precomputed(
        alpha=cast(ini.alpha),
        pbprime=cast(pbprime_q), pbprime_df=cast(ini.pbprime_df),
        one_over_pbprime=cast(one_over_pbprime),
        one_over_pbprime_df=cast(one_over_pbprime_df),
        zbot_df=cast(ini.zbot_df), zbot_quad=cast(zbot_q),
        grad_zbot_quad=cast(np.stack([gzx, gzy])),
        tau_wind=cast(tau_wind_q), tau_wind_df=cast(ini.tau_wind_df),
        coriolis_quad=cast(coriolis_quad), coriolis_df=cast(coriolis_df),
        fdt2_bcl=cast(fdt2), a_bcl=cast(a_bcl), b_bcl=cast(b_bcl),
        ssprk_a=cast(ssprk_a), ssprk_beta=cast(ssprk_beta),
        dpp_ref_df=cast(dpp_ref_df), dpp_ref_q=cast(dpp_ref_q),
        sum_ref_residual=cast(np.zeros_like(ini.pbprime_df)),  # set below
        P_ref_q=cast(P_ref_q), Hk_ref_q=cast(Hk_ref_q),
        H_bcl_ref=cast(H_bcl_ref), z_ref_df=cast(z_ref_df),
        gz_ref=cast(gz_ref), btp_rhs_ref=cast(btp_rhs_ref),
        bcl_rhs_ref=cast(bcl_rhs_ref),
        faces=Pair(face_dir_geom("x"), face_dir_geom("y")),
    )

    # Ref tables that get SUBTRACTED from fields the stepping code computes
    # must come from the identical pipeline — the same operators, dtype and
    # device — so that δ == exact 0 at the reference state in fp arithmetic
    # (docs/float32.md). In f64 the host tables already match to roundoff
    # (and stay equal to the JAX package's); in f32 recompute on `device`.
    if dtype != torch.float64:
        gdt = device_geom(geom, dtype, device)
        dpp_ref_dt = cast(dpp_ref_df)
        flr, _ = extract_faces(dpp_ref_dt, bc)
        P = P._replace(
            dpp_ref_q=interp_n2q(gdt, dpp_ref_dt).contiguous(),  # a kernel operand
            faces=Pair(
                P.faces.x._replace(dpp_ref_face=flr.xl,
                                   dpp_ref_face_q=face_n2q(gdt.psiq, flr.xl)),
                P.faces.y._replace(dpp_ref_face=flr.yl,
                                   dpp_ref_face_q=face_n2q(gdt.psiq, flr.yl)),
            ))

    # perturbation residual for one_plus_eta (docs/float32.md): computed in
    # the COMPUTE dtype so eta from δ sums is exact at the reference state
    sum_ref_residual = torch.sum(cast(dpp_ref_df), dim=0) - cast(ini.pbprime_df)
    P = P._replace(sum_ref_residual=sum_ref_residual)

    # thickness channels stored as perturbations (State docstring): at t=0
    # the shipped cases start at the reference state, so δ = full - ref,
    # formed in f64 BEFORE the cast (exact zero for the rest-state layers)
    q_df0 = ini.q_df.copy()
    q_df0[0] = ini.q_df[0] - dpp_ref_df
    qprime0 = ini.qprime_df.copy()
    qprime0[0] = ini.qprime_df[0] - dpp_ref_df
    state = State(
        qb_df=cast(ini.qb_df), q_df=cast(q_df0), qprime_df=cast(qprime0),
        t=torch.tensor(cfg.t_initial, dtype=dtype, device=device),
        ok=torch.tensor(True, device=device),
    )

    # geometry/physics structure facts: uniform_geom = every element affine
    # with identical diagonal metrics (true for all brick grids);
    # flat_bottom = no bathymetry gradients.
    # The metrics are differences of node coordinates, whose rounding grows
    # with the number of elements across the domain (measured on the 2000 km
    # double-gyre brick: 1.2e-14 of the metric per element across, 3.1e-12 at
    # 256), so the tolerance does too: 1e-12 up to 16 elements across — the
    # JAX package's constant, under which a brick of 128 or more elements
    # across no longer counts as uniform — and in proportion above.
    _utol = 1e-12 * max(1.0, max(geom.nelx, geom.nely) / 16.0)
    _mscale = max(np.abs(geom.ksiq_x).max(), np.abs(geom.etaq_y).max())
    _wflat = geom.wjac.reshape(-1, geom.wjac.shape[-2] * geom.wjac.shape[-1])
    uniform_geom = bool(
        np.abs(geom.ksiq_y).max() <= _utol * _mscale
        and np.abs(geom.etaq_x).max() <= _utol * _mscale
        and np.ptp(geom.ksiq_x) <= _utol * _mscale
        and np.ptp(geom.etaq_y) <= _utol * _mscale
        and np.ptp(_wflat, axis=0).max() <= _utol * np.abs(_wflat).max())
    # numerical differentiation of a constant zbot leaves ~1e-16*|zbot|*|D|
    # noise; slopes below 1e-13 (dimensionless dz/dx) are physically flat
    flat_bottom = bool(max(np.abs(gzx).max(), np.abs(gzy).max()) <= 1e-13)

    static = StaticConfig(
        nlayers=L, kstages=cfg.kstages, n_btp=cfg.n_btp,
        dt=cfg.dt, dt_btp=cfg.dt_btp_eff, gravity=grav,
        botfr=cfg.botfr, cd_mlswe=cfg.cd_mlswe,
        method_visc=cfg.method_visc, visc_mlswe=cfg.visc_mlswe,
        ad_mlswe=cfg.ad_mlswe,
        max_shear_dz=cfg.max_shear_dz if cfg.max_shear_dz > 0 else 1.0,
        alpha_bot=float(ini.alpha[L - 1]),
        Pstress=float((grav / ini.alpha[0]) * 50.0),
        Pbstress=float((grav / ini.alpha[L - 1]) * 10.0),
        periodic=(3 in cfg.x_boundary or 3 in cfg.y_boundary),
        compat_reference_stress=cfg.compat_reference_stress,
        uniform_geom=uniform_geom, flat_bottom=flat_bottom,
        ti_method_btp=cfg.ti_method_btp,
        impl=impl,
        # "on" trusts the caller at any element count, "auto" stays under
        # the cap; both keep the JAX package's order cap (nop <= 7)
        mega_on=(cfg.mega in ("on", "auto") and cfg.nopx <= MEGA_MAX_NOP
                 and (cfg.mega == "on"
                      or cfg.nelx * cfg.nely <= MEGA_AUTO_MAX_ELEMENTS)),
        fused_tail_on=cfg.fused_tail == "on",
        uni_volume_on=cfg.uni_volume == "on",
        batched_faces_on=(cfg.batched_faces == "on"
                          or (cfg.batched_faces == "auto"
                              and cfg.nelx * cfg.nely <= BATCHED_FACES_AUTO_MAX_ELEMENTS)),
        ssprk_a=tuple(map(tuple, P.ssprk_a.tolist())),
        ssprk_beta=tuple(P.ssprk_beta.tolist()),
    )
    if cfg.mega == "on" and not static.mega:
        raise ValueError(
            "mega='on' is outside the megakernel's envelope (uniform brick, "
            "non-periodic walls, ti_method_btp='rk35', method_visc != 1, "
            f"nop <= {MEGA_MAX_NOP}): got nop={cfg.nopx}, "
            f"uniform_geom={uniform_geom}, periodic={static.periodic}, "
            f"ti_method_btp={cfg.ti_method_btp!r}, "
            f"method_visc={cfg.method_visc}; use mega='auto' or 'off'")
    for name, taken in (("fused_tail", static.fused_tail),
                        ("uni_volume", static.uni_volume)):
        if getattr(cfg, name) == "on" and not taken:
            raise ValueError(
                f"{name}='on' is outside its envelope (uniform brick, periodic "
                "sides included"
                + ("; ti_method_btp other than 'lsrk' (lsrk_ref is inside), "
                   "method_visc != 1" if name == "fused_tail" else "")
                + f"): got uniform_geom={uniform_geom}, "
                f"ti_method_btp={cfg.ti_method_btp!r}, "
                f"method_visc={cfg.method_visc}; use {name}='off'")
    if cfg.ti_method_btp == "lsrk_ref":
        warnings.warn(
            "ti_method_btp='lsrk_ref' reproduces the reference VERBATIM "
            "(src/mod_rk_mlswe.F90:99-106 applies its 3-register SSP update "
            "to the LSRK tables), which is formally inconsistent and "
            "DIVERGES within a few steps — for A/B comparison only. Use "
            "'lsrk' for the correct low-storage Carpenter-Kennedy scheme.")
    if cfg.compat_reference_stress and L > 3:
        # the reference expression reads qp(k) for k>3 out of bounds
        raise ValueError("compat_reference_stress only defined for nlayers<=3")
    return P, state, static, ini
