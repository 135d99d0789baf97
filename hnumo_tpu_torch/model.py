"""Model facade: config -> geometry -> precomputed tables -> step loop.

Counterpart of hnumo_tpu/model.py for one device. Replaces the reference
wiring of grid init, field init and the time loop (src/amain.F90:12-190).
The baroclinic step (predictor + corrector + 2 barotropic sub-cycles) is a
pure function `state -> state`. On a CUDA device it runs as one captured
CUDA graph, replayed once per step (`step_impl="graph"`, the counterpart of
the JAX package's jitted step); elsewhere it runs eagerly. Either way a
caller's State is never mutated or consumed, so it can be stepped again.

Under a domain decomposition (`decomp`, parallel/sharding.Decomposition)
each process holds a Model of its own block: the tables are built for the
whole grid, as in a serial run, and cut to the block; the state is the
block's; the faces on a block boundary are closed by halos exchanged with
the neighbouring blocks (core/faces.py). Over NCCL such a model steps as
one captured CUDA graph too, halo exchanges and the `ok` all-reduce
included, the counterpart of the JAX package's jitted `shard_map` step;
over gloo (the CPU, or ranks sharing a GPU with host-staged halos) it
steps eagerly.
"""
from __future__ import annotations

import dataclasses

import torch

from .config import Config
from .core.btp import build_fused_operators, build_vol_operators
from .core.faces import BCs
from .core.init import IMPLS, build_precomputed, check_ported, static_for_blocks
from .core.stepper import ti_rk_bcl
from .core.types import State
from .mesh.grid import build_geometry
from .ops._build import build_libraries
from .ops.dg import device_geom
from .ops.mega import build_mega_static
from .spans import span


def _set_full_precision():
    """f32 contractions stay full f32: no TF32 in products or convolutions.

    Reduced-precision stage products conserve mass and track kinetic energy
    but destroy the free surface (docs/float32.md:79-97,
    docs/artifacts/dgyre_f32_tpu_bf16.json), so the precision is set here,
    not assumed from the library's defaults."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _resolve_device(device) -> torch.device:
    """`None` means the CUDA device, and raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hnumo_tpu_torch.Model runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


STEP_IMPLS = ("graph", "eager")


def _resolve_impl(name: str, impl, allowed, device: torch.device) -> str:
    """`allowed` = (the CUDA form, the form that runs anywhere): the first is
    the default on a CUDA device and raises elsewhere, the second is the
    default elsewhere."""
    cuda_only, anywhere = allowed
    if impl is None:
        return cuda_only if device.type == "cuda" else anywhere
    if impl not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {impl!r}")
    if impl == cuda_only and device.type != "cuda":
        raise ValueError(
            f"{name}={impl!r} needs a CUDA device, got {device}; it has no "
            f"CPU form (use {name}={anywhere!r})")
    return impl


def kernel_sources(static) -> list[str]:
    """The sources of ops/csrc/ whose kernels a step on `static`'s path
    launches under `impl == "kernel"` (none under "plain"): the barotropic
    path's, as core/btp.barotropic_solve picks them, then the baroclinic
    layer momentum's (face fluxes, volume term and, with the nodal-family
    viscosity, its Laplacian)."""
    if static.impl == "plain":
        return []
    if static.mega:
        names = ["btp_mega"]
    elif static.fused_tail:
        names = ["btp_volume_uni", "btp_faces", "btp_update"]
    else:
        names = ["btp_volume_uni" if static.uni_volume else "btp_volume"]
    names += ["bcl_flux", "bcl_mom_volume"]
    if static.use_visc and static.method_visc != 1:
        names.append("bcl_visc")
    return names


def resolve_step_impl(step_impl, decomp, device: torch.device) -> str:
    """`step_impl` of a model on `device`, under the decomposition `decomp`
    (or None): "graph" is the default on CUDA and "eager" elsewhere, as for
    one device. A decomposition adds one rule: halos staged through host
    memory ("gloo-host-staged") cannot be captured, so there "eager" is the
    default and "graph" raises."""
    if decomp is not None and decomp.transport == "gloo-host-staged":
        if step_impl == "graph":
            raise ValueError(
                "step_impl='graph' under the 'gloo-host-staged' transport: its halos "
                "are copied through host memory, which a CUDA graph cannot capture; "
                "use step_impl='eager', or backend 'nccl' with one GPU per rank")
        step_impl = step_impl or "eager"
    return _resolve_impl("step_impl", step_impl, STEP_IMPLS, device)


def capture_graph(fn, device: torch.device, decomp=None, keep_graph: bool = False):
    """`fn()` recorded into a CUDA graph on `device`; returns (graph, what the
    captured call returned). `keep_graph`: keep the captured graph's nodes
    beside its executable (`CUDAGraph.raw_cuda_graph`), so that a caller can
    list what each replay launches. One eager warm-up call on a side stream comes
    first (PyTorch's recipe): it builds the kernels, plans their launches
    and fills the caches of small device constants, none of which may
    happen while the stream is captured. A failed capture raises: there is
    no eager fallback.

    Under a decomposition (NCCL) the warm-up also posts every exchange and
    the all-reduce the call makes, which connects each NCCL peer and makes
    each receive buffer before the capture. Every rank warms up and
    captures at the same point, with the same calls in the same order.
    Between the two, the device is drained and the ranks meet: no NCCL work
    from before is pending while the stream is captured. The capture is
    "thread_local", so that the process group's watchdog thread, which
    queries the events of earlier work, cannot void it. A rank that fails
    to capture raises; the others hang in their first replay until the
    launcher's limit ends them (parallel/launch.py)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    mode = "global"
    if decomp is not None:
        torch.cuda.synchronize(device)
        decomp.barrier()
        torch.cuda.synchronize(device)
        mode = "thread_local"
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.graph(graph, capture_error_mode=mode):
        out = fn()
    if keep_graph:
        graph.instantiate()
    return graph, out


class Model:
    # True before the first step: the captured step keeps its graph's nodes
    # (capture_graph's keep_graph; self._graph[0].raw_cuda_graph())
    keep_graph = False

    def __init__(self, cfg: Config, device=None, impl: str | None = None,
                 step_impl: str | None = None, decomp=None):
        """`device`: None = the CUDA device (raises without one), or any
        torch device; the tests pass "cpu". `impl`: "kernel" (every
        hand-written CUDA kernel on the path that runs: the barotropic volume
        stage, general or uniform-geometry, the whole-solve megakernel, the
        fused path's face and update stages, and the baroclinic layer
        momentum's face fluxes, volume term and nodal-family viscosity;
        default on CUDA) or "plain" (their plain PyTorch versions; default
        on the CPU). Which barotropic
        path runs is `cfg.mega`, then `cfg.fused_tail` (see
        StaticConfig.mega, .fused_tail, .uni_volume; the per-stage path's
        face pipeline, .batched_faces). `step_impl`: "graph"
        (the step captured once as a CUDA graph and replayed; default on
        CUDA) or "eager" (dispatched op by op; default on the CPU).
        `decomp`: a parallel/sharding.Decomposition; the model is then this
        process's block of the grid (`device` defaults to the
        decomposition's). Over NCCL its step is graphed by default, as on
        one device: every rank captures at its first step, and every rank
        must step together; with halos staged through host memory
        (`resolve_step_impl`) it is eager, and "graph" raises."""
        self.decomp = decomp
        if decomp is not None:
            if device is None:
                device = decomp.device
            elif torch.device(device) != decomp.device:
                raise ValueError(f"device {device} is not the decomposition's "
                                 f"{decomp.device}")
        self.device = _resolve_device(device)
        impl = _resolve_impl("impl", impl, IMPLS, self.device)
        self.step_impl = resolve_step_impl(step_impl, decomp, self.device)
        _set_full_precision()
        check_ported(cfg)
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32

        zbot_ext = None
        if cfg.lread_external_grid:
            # external gmsh mesh (reference read_gmsh + read_bathy,
            # src/read_gmsh.F90); the BC codes come from its $BC section
            from .mesh.gmsh import geometry_from_msh

            self.geom, zbot_ext = geometry_from_msh(
                cfg.mesh_file, cfg.nopx, exact_integration=cfg.dg_integ_exact,
                bathy_path=(cfg.bathymetry_file
                            if cfg.lread_external_bathy else None),
                use_bathy=cfg.lread_external_bathy)
            if zbot_ext is not None and cfg.bathymetry_shift:
                zbot_ext = zbot_ext + cfg.bathymetry_shift
            # the configuration describes the grid that runs: the mesh's
            # element counts and boundary codes
            bc = self.geom.bc
            cfg = dataclasses.replace(cfg, nelx=self.geom.nelx, nely=self.geom.nely,
                                      x_boundary=bc[:2], y_boundary=bc[2:])
            check_ported(cfg)
        else:
            bc = (cfg.x_boundary[0], cfg.x_boundary[1],
                  cfg.y_boundary[0], cfg.y_boundary[1])
            self.geom = build_geometry(cfg.nelx, cfg.nely, cfg.nopx, cfg.xdims,
                                       cfg.ydims, bc=bc,
                                       exact_integration=cfg.dg_integ_exact)
        self.cfg = cfg
        self.g = device_geom(self.geom, self.dtype, self.device)
        self.bc = BCs(*bc)
        self.P, self._state0, self.static, self.init_fields = build_precomputed(
            cfg, self.geom, self.dtype, self.device, impl=impl, zbot_ext=zbot_ext)
        # the element whose metric the uniform operators fold (None: the
        # first of `self.g`; a block takes the whole grid's first)
        self._cell = None
        if decomp is not None:
            self._to_block(decomp)
        self._build_operators()
        if self.device.type == "cuda":
            # the step's kernels, compiled side by side now rather than one
            # after another at each wrapper's first launch
            build_libraries(kernel_sources(self.static))

    def _to_block(self, decomp):
        """Cut the whole grid's tables and initial state to this process's
        block and close its faces through the decomposition's axes."""
        from .parallel.sharding import local_state, local_tables

        decomp.bounds(self.cfg.nely, self.cfg.nelx)      # raises unless it divides
        # the whole grid's tables that the I/O reads (global_table)
        self._global_tables = {"zbot_df": self.P.zbot_df.cpu(),
                               "wjac_df": self.g.wjac_df.cpu()}
        self.static = static_for_blocks(self.static, self.cfg, decomp.size)
        # the whole grid's first element, as a one-element grid: the uniform
        # operators of every block fold its metric, which a serial run folds
        # (each element's metric agrees with it only to rounding: a block's
        # own first element would make the split differ from the serial run
        # by rounding, which a copy wall amplifies)
        nely, nelx = self.cfg.nely, self.cfg.nelx
        self._cell = local_tables(self.g, self.P, ((nely, nelx), (0, 0)))[0]
        self.g, self.P = local_tables(self.g, self.P, decomp)
        self._state0 = local_state(self._state0, decomp)
        self.bc = BCs(*self.bc[:4], *decomp.axes(self.bc.x_periodic, self.bc.y_periodic))

    def _build_operators(self):
        """State-independent operator tables of the barotropic solve, built
        once: the volume stage's, and the megakernel's or the fused path's
        when that is the path."""
        self.vol_ops = build_vol_operators(self.static, self.g, self.P, cell=self._cell)
        self.mega_ops = (build_mega_static(self.static, self.g, self.P, self.bc)
                         if self.static.mega else None)
        self.tail_ops = (build_fused_operators(self.static, self.g, self.P, self.bc,
                                               cell=self._cell)
                         if self.static.fused_tail and not self.static.mega else None)
        # a graph holds the addresses of the tables it was captured with
        self._graph = None

    @classmethod
    def from_tables(cls, cfg: Config, P, g, state0: State, device=None,
                    impl: str | None = None, step_impl: str | None = None,
                    decomp=None) -> "Model":
        """A model stepping on given tables (see convert.from_numpy_tables,
        and convert.block_from_numpy for a block of a decomposition) in place
        of the ones its own build_precomputed makes — the static parameters
        still come from `cfg`. Lets a test hold the stepping code against
        another implementation on identical tables."""
        m = cls(cfg, device=device, impl=impl, step_impl=step_impl, decomp=decomp)
        want = (m.dtype, m.device)
        for t in (P.pbprime, g.wjac, state0.qb_df):
            if (t.dtype, t.device) != want:
                raise ValueError(
                    f"tables are {t.dtype} on {t.device}, the model is "
                    f"{want[0]} on {want[1]}")
        if g.wjac.shape != m.g.wjac.shape:
            raise ValueError(f"tables of {tuple(g.wjac.shape[:2])} elements, the "
                             f"model's block has {tuple(m.g.wjac.shape[:2])}")
        m.P, m.g, m._state0 = P, g, state0
        m._build_operators()
        return m

    @property
    def state0(self) -> State:
        """The initial state (steps never mutate it); this process's block
        under a decomposition."""
        return self._state0

    def gather(self, state: State):
        """The whole grid's `state` where the I/O reads it: under a
        decomposition on rank 0 (CPU tensors; None on the other ranks, and
        every rank must call it), else `state` itself."""
        if self.decomp is None:
            return state
        from .parallel.sharding import gather_state

        return gather_state(state, self.decomp)

    def block(self, state: State) -> State:
        """This process's block of a whole grid's `state` (a restart), on
        the model's device (the whole of it without a decomposition)."""
        if self.decomp is not None:
            from .parallel.sharding import local_state

            state = local_state(state, self.decomp)
        return State(*[t.to(self.device) for t in state])

    @property
    def is_writer(self) -> bool:
        """This process writes the run's files (rank 0, or the only one)."""
        return self.decomp is None or self.decomp.rank == 0

    def global_table(self, name: str):
        """A table of the whole grid (`zbot_df` or `wjac_df`) as the I/O
        reads it, whatever block this process steps."""
        if self.decomp is None:
            return getattr(self.P if name == "zbot_df" else self.g, name)
        return self._global_tables[name]

    @property
    def nsteps_total(self) -> int:
        """Baroclinic steps from time_initial to time_final."""
        return int(round((self.cfg.t_final - self.cfg.t_initial) / self.cfg.dt))

    def step(self, state: State) -> State:
        with span("hnumo.step"):
            with torch.no_grad():
                out = (self._replay(state) if self.step_impl == "graph"
                       else self._step_eager(state))
            if self.cfg.debug_checks:
                # debug mode: a per-step finite-value check, read back from the
                # device after the step (the JAX package's, hnumo_tpu/model.py:186-200)
                for name in ("qb_df", "q_df", "qprime_df"):
                    bad = int((~torch.isfinite(getattr(out, name))).sum())
                    if bad:
                        raise FloatingPointError(
                            f"debug_checks: {bad} non-finite values in {name} "
                            f"at t={float(out.t)}")
            return out

    def _step_eager(self, state: State) -> State:
        return ti_rk_bcl(self.static, self.P, self.g, self.bc, state,
                         vol_ops=self.vol_ops, mega_ops=self.mega_ops,
                         tail_ops=self.tail_ops)

    def _capture(self, state: State) -> None:
        """Record one step, from static input buffers shaped like `state`,
        into a CUDA graph (`capture_graph`)."""
        inputs = State(*[t.clone() for t in state])
        graph, outputs = capture_graph(lambda: self._step_eager(inputs), self.device,
                                       self.decomp, self.keep_graph)
        self._graph = (graph, inputs, outputs)

    def _replay(self, state: State) -> State:
        """One step as a replay of the captured graph (captured at the first
        step). The reference donates the state to its jitted step; here the
        caller's state is copied into the graph's input buffers and the
        result cloned out of its output buffers — a few MB, against a step
        of thousands of launches — so that `step` keeps its contract: a
        caller's State is never mutated, and a state a step returned is not
        overwritten by a later one."""
        with torch.cuda.device(self.device):
            if self._graph is None:
                self._capture(state)
            graph, inputs, outputs = self._graph
            with span("hnumo.step.copy_in"):
                for name, dst, src in zip(State._fields, inputs, state):
                    if (src.shape, src.dtype, src.device) != (dst.shape, dst.dtype,
                                                              dst.device):
                        raise ValueError(
                            f"state.{name} is {tuple(src.shape)} {src.dtype} on "
                            f"{src.device}; the captured step takes "
                            f"{tuple(dst.shape)} {dst.dtype} on {dst.device}")
                    dst.copy_(src)
            with span("hnumo.step.replay"):
                graph.replay()
            with span("hnumo.step.clone_out"):
                return State(*[t.clone() for t in outputs])

    def run(self, state: State, nsteps: int, check_ok: bool = True) -> State:
        for _ in range(nsteps):
            state = self.step(state)
            # one host read per step, as in the JAX package (under a
            # decomposition `ok` is already and-reduced over the blocks, so
            # every rank stops together)
            if check_ok and not bool(state.ok):
                raise RuntimeError(
                    "Negative mass in thickness at some points "
                    f"(t={float(state.t)}) — aborting, as the reference does "
                    "(src/mod_splitting.F90:74-77)")
        return state
