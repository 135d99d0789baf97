"""Run configuration: dataclass + Fortran-namelist (`numo3d.in`) parser.

Counterpart of hnumo_tpu/config.py: the same physics and namelist fields
with the same defaults (reference src/mod_input.F90:118-269), so a
configuration written for one package describes the same run in the other,
and the same namelist parser (reference src/mod_input.F90:97-480), so one
`numo3d.in` drives both. Of the JAX package's backend knobs `mega`,
`fused_tail`, `uni_volume`, `batched_faces` and `debug_checks` are carried
over, with the same meaning and the same defaults; use_pallas,
pallas_interpret, scan_stages and mega_precision have no counterpart here
(one precision, full f32; kernel or plain version is chosen by
`Model(..., impl=)`): a namelist that sets
them is read with a warning that they have no effect.
"""
from __future__ import annotations

import dataclasses
import math
import re
import warnings
from pathlib import Path


MEGA_MODES = ("auto", "on", "off")
ON_OFF = ("on", "off")
# barotropic integrators: the SSP family (rk35 and ssprk name the same
# tables), the low-storage Carpenter-Kennedy scheme, and the reference's
# verbatim LSRK (its SSP update fed the LSRK tables; divergent, A/B only)
TI_METHODS_BTP = ("rk35", "ssprk", "lsrk", "lsrk_ref")


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
    # uniform brick (periodic sides too), an SSP update (not lsrk; lsrk_ref
    # runs the SSP update on the LSRK tables), nodal/no viscosity; "on"
    # raises outside it. `mega` is asked first: under 1024 elements say
    # mega="off" too.
    fused_tail: str = "off"
    # Uniform-geometry volume kernel (ops/btp_volume_uni) in place of the
    # general one in the per-stage path ("on" | "off"); uniform brick only.
    uni_volume: str = "off"
    # Both face directions of the per-stage barotropic path batched on one
    # flat face axis ("auto" | "on" | "off"), else one pipeline per direction
    # (the same formulas; results differ by summation order). "auto": the
    # flat axis up to 8192 elements, per direction above — the JAX package's
    # default, kept until a benchmark of the port moves it. The quad-family
    # viscosity (method_visc=1) and the fused path always take their own
    # face pipelines (core/init.StaticConfig.batched_faces).
    batched_faces: str = "auto"
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
        for name in ("mega", "batched_faces"):
            if getattr(self, name) not in MEGA_MODES:
                raise ValueError(
                    f"{name} must be one of {MEGA_MODES}, got {getattr(self, name)!r}")
        if self.ti_method_btp not in TI_METHODS_BTP:
            raise ValueError(f"ti_method_btp must be one of {TI_METHODS_BTP}, "
                             f"got {self.ti_method_btp!r}")
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

    @property
    def t_restart(self) -> float:
        return self.time_restart * self.time_scale


_BOOL = {".true.": True, "t": True, ".t.": True, ".false.": False, "f": False, ".f.": False}


def _parse_value(raw: str):
    raw = raw.strip().rstrip(",").strip()
    if not raw:
        return None
    low = raw.lower()
    if low in _BOOL:
        return _BOOL[low]
    if raw.startswith(("'", '"')):
        return raw.strip("'\"")
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace("d", "e").replace("D", "E"))
    except ValueError:
        return raw


def parse_namelist(path: str | Path) -> dict:
    """Parse the subset of Fortran namelist syntax used by numo3d.in files.

    Returns a flat {name: value} dict merged across all namelist groups.
    """
    text = Path(path).read_text()
    values: dict = {}
    in_group = False
    for line in text.splitlines():
        line = line.split("!")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            in_group = True
            continue
        if line in ("/", "&end", "$end"):
            in_group = False
            continue
        if not in_group or "=" not in line:
            continue
        name, raw = line.split("=", 1)
        name = name.strip().lower()
        parts = [p for p in re.split(r",(?=(?:[^']*'[^']*')*[^']*$)", raw) if p.strip()]
        vals = [_parse_value(p) for p in parts]
        values[name] = vals[0] if len(vals) == 1 else tuple(vals)
    return values


# Reference namelist members (src/mod_input.F90:320-381) that are accepted
# but have no effect on the MLSWE build: NUMA-3D lineage (z dims, sponge,
# filter, OCCA/GPU plumbing), AMR scaffolding inert in every shipped case
# (refinement_levels_h=0), and legacy grid-creation switches. Anything not in
# this set and not a Config field triggers a warning (a typo'd key must not
# silently become "feature off").
_INERT_REFERENCE_KEYS = frozenset("""
    eqn_set is_mlswe nelz nopz ztop zbottom nproc_z z_boundary
    x_periodic y_periodic z_periodic bc_tscale bc_xscale bc_yscale bc_zscale
    sponge_type sponge_top_coe sponge_lateralx_coe sponge_lateralx_coe_east
    sponge_lateralx_coe_west sponge_lateraly_coe lsommerfeld lgrid_only
    is_non_conforming_flg p4est_log_level xlim_min xlim_max ylim_min ylim_max
    zlim_min zlim_max amr_indicator_variables amr_smoothness_limits
    amr_max_min_lim amr_threshold_lim amr_smoothness_ql2_limit
    amr_mark_max_min amr_mark_random amr_mark_threshold amr_mark_modes
    amr_mark_modes_use_baseline_decay amr_num_neigh_iter amr_mark_set2nc
    lserial_grid_creation lparallel_grid_creation lwrite_grid_ascii
    refinement_levels_h nel_root_h xstretch_coe ystretch_coe zstretch_coe
    lxstretch lystretch lzstretch restoring_time lrestoring_sponge
    time_dynamic_amr dt0 dt1 dt2 filter_mux filter_muy filter_muz ifilter
    filter_weight_type filter_basis_type filter_tracers_flg lout_ascii
    lout_asciimaya nvtk_files vtk_cell_type write_mesh fname_initial
    restart_path ladapt_timestep iprint_diagnostics bcast_type imass
    lgpu numaocca_dir nelems nslices nslicesv vectorization platform
    platformid deviceid platformweight platform2 platformid2 deviceid2
    platformweight2 cpus_per_node gpus_per_node threads_per_process
    luse_hybrid_cpu_gpu gravity_in limit_threshold ibathymetry
    dp_tau_bot dp_tau_wind adjust_h_vertical_sum adjust_bcl_mom_flux
""".split())

# The JAX package's backend switches that have no counterpart here: read
# with a warning, so that one namelist drives both packages.
_JAX_BACKEND_KEYS = frozenset(("use_pallas", "pallas_interpret", "scan_stages",
                               "mega_precision"))


def config_from_namelist(path: str | Path, **overrides) -> Config:
    """Build a Config from a reference-format numo3d.in file.

    Unrecognized keys warn (reference `read(funit, input)` would hard-error
    on them, src/mod_input.F90:387 — a silent drop would turn a typo'd
    `visc_mlswe` into "viscosity off"); known-but-inert reference keys are
    accepted silently; the JAX package's backend keys are accepted with a
    warning that they have no effect. With lread_bc, `bc.inp` is read from
    the namelist's directory.
    """
    raw = parse_namelist(path)
    field_names = {f.name for f in dataclasses.fields(Config)}
    kwargs = {}
    for name, val in raw.items():
        if name in field_names:
            if name in ("xdims", "ydims", "x_boundary", "y_boundary"):
                val = tuple(val) if isinstance(val, tuple) else (val, val)
            kwargs[name] = val
        elif name in _JAX_BACKEND_KEYS:
            warnings.warn(f"{path}: namelist key {name!r} is a switch of the JAX "
                          "package and has no effect here", stacklevel=2)
        elif name not in _INERT_REFERENCE_KEYS:
            warnings.warn(f"{path}: unrecognized namelist key {name!r} "
                          "ignored", stacklevel=2)
    kwargs.update(overrides)
    cfg = Config(**kwargs)
    if cfg.lread_bc:
        # reference opens bc.inp from the working directory
        # (src/mod_bc.F90:119); it is resolved next to the namelist
        from .mesh.bcinp import read_bc_inp

        xb, yb = read_bc_inp(Path(path).parent / "bc.inp", cfg.nelx, cfg.nely,
                             cfg.xdims, cfg.ydims, cfg.x_boundary,
                             cfg.y_boundary)
        cfg = dataclasses.replace(cfg, x_boundary=xb, y_boundary=yb)
    return cfg
