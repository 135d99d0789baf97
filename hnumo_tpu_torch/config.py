"""Run configuration for the PyTorch package.

Counterpart of hnumo_tpu/config.py: the same physics and namelist fields
with the same defaults (reference src/mod_input.F90:118-269), so a
configuration written for one package describes the same run in the other.
Of the JAX package's backend knobs `mega`, `fused_tail`, `uni_volume` and
`debug_checks` are carried over, with the same meaning and the same
defaults; use_pallas,
pallas_interpret, scan_stages, mega_precision and batched_faces have no
counterpart here (one precision, full f32; kernel or plain version is chosen
by `Model(..., volume_impl=, mega_impl=, tail_impl=)`).
The namelist file parser is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math


MEGA_MODES = ("auto", "on", "off")
ON_OFF = ("on", "off")


@dataclasses.dataclass(frozen=True)
class Config:
    # --- &gridnl ---
    nelx: int = 10
    nely: int = 10
    nopx: int = 4
    nopy: int = 4
    xdims: tuple[float, float] = (0.0, 1.0)
    ydims: tuple[float, float] = (0.0, 1.0)
    nlayers: int = 1
    # BC codes per side: 0=do nothing, 3=periodic, 4=free-slip, 2/5=no-slip
    x_boundary: tuple[int, int] = (4, 4)
    y_boundary: tuple[int, int] = (4, 4)

    # --- &input ---
    dt: float = 100.0
    dt_btp: float = 1.0
    time_initial: float = 0.0
    time_final: float = 1.0
    time_restart: float = 10.0
    time_scale: float = 1.0
    ad_mlswe: float = 0.0          # vertical eddy viscosity (shear stress)
    max_shear_dz: float = 0.0
    botfr: int = 0                 # 0=none, 1=linear, 2=quadratic bottom drag
    cd_mlswe: float = 0.0
    method_visc: int = 0           # 0=off path / per reference dispatch
    visc_mlswe: float = 0.0        # horizontal viscosity coefficient
    dg_integ_exact: bool = True
    beta: float = 0.0
    f0: float = 0.0
    test_case: str = "bump"
    ti_method_btp: str = "rk35"
    kstages: int = 5
    space_method: str = "dg"
    fname_root: str = "mlswe"
    format_vtk: str = "ascii"
    out_type: str = "txt"
    dump_data: bool = True
    lprint_diagnostics: bool = True
    lcheck_conserved: bool = True
    lrestart_file: bool = False
    irestart_file_number: int = 0
    lread_external_grid: bool = False
    mesh_file: str = ""
    lread_external_bathy: bool = False
    bathymetry_file: str = ""
    bathymetry_shift: float = 0.0
    lread_bc: bool = False

    # --- non-reference extensions ---
    dtype: str = "float64"         # compute dtype ("float64" validation, "float32" perf)
    # Whole-solve barotropic megakernel ("auto" | "on" | "off"): the entire
    # sub-cycling (N_btp x kstages stages) as ONE kernel launch per solve
    # (ops/mega.py). Envelope: uniform brick, non-periodic walls, rk35,
    # nodal/no viscosity, nop <= 7, one device. "auto" = on within the
    # envelope up to 1024 elements (the JAX package's dispatch, kept so the
    # two packages take the same path at the same size), the per-stage path
    # otherwise; "on" = at any element count, and raises outside the
    # envelope instead of taking the other path.
    mega: str = "auto"
    # Whole-stage fused barotropic path ("on" | "off"): three kernels per
    # stage (uniform-geometry volume stage with the velocity gradient, all-
    # faces flux, edge scatter + viscosity + SSPRK update; ops/btp_volume_uni
    # and ops/btp_tail) around a plain-PyTorch trace exchange. Envelope:
    # uniform brick, SSP integrator, nodal/no viscosity; "on" raises outside
    # it. `mega` is asked first: under 1024 elements say mega="off" too.
    fused_tail: str = "off"
    # Uniform-geometry volume kernel (ops/btp_volume_uni) in place of the
    # general one in the per-stage path ("on" | "off"); uniform brick only.
    uni_volume: str = "off"
    # Reproduce the reference's wind/bottom-stress vertical distribution
    # verbatim, including its indexing slip (see core/bcl.py).
    compat_reference_stress: bool = False
    # debug mode: after every step, raise on a non-finite value in the state
    # (the JAX package's per-step check, hnumo_tpu/model.py:186-200). Costs a
    # read of the state from the device per step; off in production.
    debug_checks: bool = False

    def __post_init__(self):
        # normalize periodic coupling (reference src/mod_input.F90:449-465)
        if 3 in self.x_boundary:
            object.__setattr__(self, "x_boundary", (3, 3))
        if 3 in self.y_boundary:
            object.__setattr__(self, "y_boundary", (3, 3))
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be 'float32' or 'float64', got {self.dtype!r}")
        if self.mega not in MEGA_MODES:
            raise ValueError(f"mega must be one of {MEGA_MODES}, got {self.mega!r}")
        for name in ("fused_tail", "uni_volume"):
            if getattr(self, name) not in ON_OFF:
                raise ValueError(
                    f"{name} must be one of {ON_OFF}, got {getattr(self, name)!r}")

    # Derived quantities (reference src/mod_initial.F90:176-186)
    @property
    def n_btp(self) -> int:
        return math.ceil(self.dt / self.dt_btp)

    @property
    def dt_btp_eff(self) -> float:
        return self.dt / self.n_btp

    @property
    def t_initial(self) -> float:
        return self.time_initial * self.time_scale

    @property
    def t_final(self) -> float:
        return self.time_final * self.time_scale
