"""The benchmark's plain reference: a frozen copy of the port's eager
baroclinic step, in plain PyTorch, with the CUDA kernels taken out.

The modules below are copies of hnumo_tpu_torch's as they stood when the
benchmark was defined (config, basis, mesh/grid, core, ops/dg and the plain
versions of ops/btp_volume, btp_volume_uni, btp_tail), with each kernel's
wrapper replaced by a function that raises. They import nothing of the port,
of jax or of the JAX package, and later changes to the port do not reach
them. `Reference` builds its own tables from a configuration's fields and
steps a state on the per-stage plain path, whatever path the port takes.
"""
from __future__ import annotations

import torch

from .core.btp import build_vol_operators
from .core.faces import BCs
from .core.init import build_precomputed
from .core.stepper import ti_rk_bcl
from .core.types import State
from .mesh.grid import build_geometry
from .ops.dg import device_geom

__all__ = ["Reference", "State"]


class Reference:
    """The step of a configuration (`cfg`: the reference's Config) on
    `device` in `dtype`, on the per-stage path with the plain versions.
    `tf32`: let float32 products run in TF32 (the control); by default they
    run in full float32."""

    def __init__(self, cfg, device, dtype=torch.float64, tf32: bool = False):
        import dataclasses

        cfg = dataclasses.replace(cfg, mega="off", fused_tail="off", uni_volume="off",
                                  dtype="float64" if dtype == torch.float64 else "float32")
        self.cfg, self.device, self.dtype, self.tf32 = cfg, torch.device(device), dtype, tf32
        bc = (cfg.x_boundary[0], cfg.x_boundary[1], cfg.y_boundary[0], cfg.y_boundary[1])
        self.geom = build_geometry(cfg.nelx, cfg.nely, cfg.nopx, cfg.xdims, cfg.ydims,
                                   bc=bc, exact_integration=cfg.dg_integ_exact)
        self.g = device_geom(self.geom, dtype, self.device)
        self.bc = BCs(*bc)
        self.P, _, self.static, self.init_fields = build_precomputed(
            cfg, self.geom, dtype, self.device)
        self.vol_ops = build_vol_operators(self.static, self.g, self.P)

    def step(self, state: State) -> State:
        """One baroclinic step of `state` (cast to the reference's dtype and
        device), eagerly."""
        state = State(*[t.to(self.device, self.dtype) if t.is_floating_point()
                        else t.to(self.device) for t in state])
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.set_float32_matmul_precision("high" if self.tf32 else "highest")
        try:
            with torch.no_grad():
                return ti_rk_bcl(self.static, self.P, self.g, self.bc, state,
                                 vol_ops=self.vol_ops)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[:2]
            torch.set_float32_matmul_precision(flags[2])

    def run(self, state: State, steps: int) -> State:
        for _ in range(steps):
            state = self.step(state)
        return state
