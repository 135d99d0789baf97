"""Domain decomposition over torch.distributed: one process per block.

Counterpart of hnumo_tpu/parallel/sharding.py in PyTorch's idiom for several
devices: where the JAX package runs the whole step inside `shard_map` over a
('y', 'x') device mesh from one controller, here each of the py*px blocks of
the (nely, nelx) element grid is stepped by a process of its own, and the
thin face halos travel as point-to-point messages of a `torch.distributed`
process group (core/faces._from_prev / _from_next, through `Axis.exchange`).
Rank r owns block (iy, ix) = divmod(r, px), the row-major order of the JAX
package's device array.

Tables are built for the whole grid, as in a serial run, and each rank then
keeps its block (`local_tables`): element tables their [y0:y1, x0:x1]
elements, x-face tables the faces [x0, x1] of its rows, y-face tables the
faces [y0, y1] of its columns — what `blockify_tables` plus `table_specs`
give a shard there. A face on a block boundary is held by both owners, and
each computes its flux from the same exchanged traces. Tables are told apart
by field name, never by shape (a shape test is ambiguous where, say,
nlayers == nely).

Transport, chosen from the group's backend and never switched silently:
- "nccl": device tensors, one process per GPU (cuda:local_rank);
- "gloo": CPU tensors (the tests);
- "gloo-host-staged": ranks on CUDA devices over gloo, which sends no CUDA
  tensor: each slab is copied to host memory, sent, received and copied
  back. This is how several ranks share one GPU, which NCCL refuses.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import FaceDirGeom, Pair, Precomputed, State
from ..ops.dg import DeviceGeom

BACKENDS = ("nccl", "gloo")

# DeviceGeom fields that are x-face / y-face tables, and those shared by all
# blocks (the 1-D basis); every other field is an element table
_GEOM_XFACE = ("jac_facex", "nx_x", "ny_x", "jac_facex_df", "nx_x_df", "ny_x_df")
_GEOM_YFACE = ("jac_facey", "nx_y", "ny_y", "jac_facey_df", "nx_y_df", "ny_y_df")
_GEOM_SHARED = ("psiq", "dpsiq", "dpsi")
# Precomputed fields shared by all blocks; `faces` holds the face tables
# (FaceDirGeom, every field of P.faces.x an x-face table); every other field
# is an element table
_P_SHARED = ("alpha", "ssprk_a", "ssprk_beta")


def block_bounds(n: int, p: int, i: int) -> tuple[int, int]:
    """[start, stop) of block `i` of `p` along an axis of `n` elements.
    Raises unless `p` divides `n`, as the JAX package does
    (hnumo_tpu/model.py:117-121)."""
    if p < 1 or n % p:
        raise ValueError(f"{n} elements do not split into {p} equal blocks")
    size = n // p
    return i * size, (i + 1) * size


@dataclasses.dataclass(eq=False)
class Axis:
    """One axis of the decomposition as the face code sees it (the
    counterpart of a shard_map axis name): this block's place along it, the
    ranks of the blocks before and after it (cyclic, as the JAX package's
    `ppermute`), and whether the domain wraps around along it.

    `exchange` moves one edge slab one block along the axis. `calls` counts
    its calls, the counterpart of the JAX step's `ppermute`s: on a block at
    a closed domain edge a call posts one message or none."""

    name: str
    size: int
    index: int
    prev: int
    next: int
    periodic: bool
    dec: "Decomposition"
    calls: int = 0
    _recv: dict = dataclasses.field(default_factory=dict)

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def exchange(self, slab: torch.Tensor, from_prev: bool) -> torch.Tensor:
        """The slab of the previous block along the axis (`from_prev`), or of
        the next one, in exchange for this block's `slab`: every block sends
        its slab one block on in the same sense. One `batch_isend_irecv`
        posts the send and the receive together, so no order of the pairs
        can deadlock; every rank must make the same calls in the same order.
        Across a closed domain edge nothing is sent, and the result on the
        edge block is `slab` itself (the caller closes that face with the
        wall's mirror and reads no ghost). The received tensor lives in a
        buffer of this axis, one per sense and shape, which the next such
        call overwrites: callers consume it at once."""
        self.calls += 1
        src, dst = (self.prev, self.next) if from_prev else (self.next, self.prev)
        recv_edge, send_edge = (self.first, self.last) if from_prev else (self.last, self.first)
        recv = self.periodic or not recv_edge
        send = self.periodic or not send_edge
        staged = self.dec.transport == "gloo-host-staged"
        ops, buf = [], None
        if send:
            out = slab.to("cpu") if staged else slab.contiguous()
            ops.append(dist.P2POp(dist.isend, out, dst))
        if recv:
            key = (from_prev, tuple(slab.shape), slab.dtype)
            buf = self._recv.get(key)
            if buf is None:
                buf = torch.empty(slab.shape, dtype=slab.dtype,
                                  device="cpu" if staged else slab.device)
                self._recv[key] = buf
            ops.append(dist.P2POp(dist.irecv, buf, src))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if buf is None:
            return slab
        return buf.to(slab.device) if staged else buf


@dataclasses.dataclass(eq=False)
class Decomposition:
    """This process's block of a (py, px) split of the element grid, and the
    process group that joins the blocks (the default group: one rank per
    block). Made by `init_decomposition`, the counterpart of `make_mesh`."""

    shape: tuple[int, int]
    rank: int
    backend: str
    transport: str
    device: torch.device
    _axes: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> tuple[int, int]:
        """(iy, ix) of this rank's block."""
        return divmod(self.rank, self.shape[1])

    def bounds(self, nely: int, nelx: int):
        """((y0, y1), (x0, x1)): this block's element rows and columns."""
        (py, px), (iy, ix) = self.shape, self.coords
        return block_bounds(nely, py, iy), block_bounds(nelx, px, ix)

    def axes(self, x_periodic: bool, y_periodic: bool):
        """(ax, ay) for core.faces.BCs: an Axis per axis the grid is split
        along, None for an axis of one block (there the serial code runs,
        which a one-block cyclic `ppermute` is in the JAX package too). Made
        once per periodicity, so that their call counts accumulate."""
        key = (x_periodic, y_periodic)
        if key not in self._axes:
            (py, px), (iy, ix) = self.shape, self.coords

            def rank(jy, jx):
                return (jy % py) * px + jx % px

            ax = (Axis("x", px, ix, rank(iy, ix - 1), rank(iy, ix + 1), x_periodic, self)
                  if px > 1 else None)
            ay = (Axis("y", py, iy, rank(iy - 1, ix), rank(iy + 1, ix), y_periodic, self)
                  if py > 1 else None)
            self._axes[key] = (ax, ay)
        return self._axes[key]

    @property
    def exchange_calls(self) -> int:
        """Calls of Axis.exchange on every axis made so far."""
        return sum(a.calls for pair in self._axes.values() for a in pair if a is not None)

    def _comm(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the transport can send it (host memory under
        gloo-host-staged)."""
        return t.to("cpu") if self.transport == "gloo-host-staged" else t

    def all_and(self, ok: torch.Tensor) -> torch.Tensor:
        """Logical AND of a boolean scalar over all blocks: one all-reduce
        (a sum of failures, as the JAX package's psum)."""
        bad = self._comm(torch.logical_not(ok).to(torch.int32).reshape(1))
        dist.all_reduce(bad, op=dist.ReduceOp.SUM)
        return (bad[0] == 0).to(ok.device)

    def gather(self, t: torch.Tensor, elem_axis: int):
        """The blocks of `t` (element axes `elem_axis`, `elem_axis + 1`)
        joined into the whole grid on rank 0, as a CPU tensor; None on the
        other ranks. The counterpart of `to_host`."""
        t = self._comm(t.contiguous())
        parts = [torch.empty_like(t) for _ in range(self.size)] if self.rank == 0 else None
        dist.gather(t, parts, dst=0)
        if self.rank == 0:
            py, px = self.shape
            rows = [torch.cat(parts[iy * px:(iy + 1) * px], dim=elem_axis + 1)
                    for iy in range(py)]
            return torch.cat(rows, dim=elem_axis).cpu()
        return None

    def barrier(self) -> None:
        dist.all_reduce(self._comm(torch.zeros(1, device=self.device)))


def init_decomposition(shape, backend: str | None = None, device=None) -> Decomposition:
    """Join the process group of a (py, px) decomposition: the counterpart of
    `make_mesh`. The rank and world size come from the environment that
    `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK), or the local launcher
    (parallel/launch.py), which also names the rendezvous in
    HNUMO_DIST_INIT (default `env://`, torchrun's MASTER_ADDR/MASTER_PORT).
    A group that is already initialised is joined as it is.

    `device`: None = the CUDA device of this rank (raises without CUDA),
    or "cpu". `backend`: None = "nccl" on CUDA devices, "gloo" on the CPU;
    "gloo" on CUDA devices stages the halos through host memory, so that
    several ranks can share one GPU. NCCL needs a GPU per rank on the host
    and raises where there are fewer; a backend other than these two
    raises. Once joined, the rank marks it by creating the file that
    HNUMO_READY_FILE names, where the local launcher set one."""
    py, px = (int(v) for v in shape)
    if py < 1 or px < 1:
        raise ValueError(f"decomposition shape {shape} must be positive")
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    if world != py * px:
        raise ValueError(f"a {py}x{px} decomposition needs {py * px} ranks, "
                         f"the group has {world}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the decomposition runs on CUDA devices by default and none is "
                "available; pass device='cpu' (backend gloo) to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if dist.is_initialized() and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"backend {backend!r} was asked for")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device.type == "cuda":
        ngpu = torch.cuda.device_count()
        if device.index is None:
            if backend == "nccl" and local_rank >= ngpu:
                raise RuntimeError(
                    f"NCCL needs one GPU per rank: local rank {local_rank} on a "
                    f"host with {ngpu}; use backend 'gloo' to share GPUs "
                    "(halos staged through host memory)")
            device = torch.device("cuda", local_rank % ngpu)
        torch.cuda.set_device(device)
        transport = "nccl" if backend == "nccl" else "gloo-host-staged"
    elif backend == "nccl":
        raise ValueError("NCCL sends CUDA tensors only; the CPU takes backend 'gloo'")
    else:
        transport = "gloo"
        torch.set_num_threads(1)

    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=os.environ.get("HNUMO_DIST_INIT", "env://"),
            rank=rank, world_size=world)
    dec = Decomposition(shape=(py, px), rank=rank, backend=backend,
                        transport=transport, device=device)
    # every rank takes part in the group's first operation (NCCL's rule for
    # a group whose first use is point-to-point)
    dec.barrier()
    if rank == 0:
        print(f"decomposition {py}x{px}: {world} ranks, backend {backend}, "
              f"transport {transport}, rank 0 on {device}", flush=True)
    # the local launcher (parallel/launch.py) starts the run's time limit
    # once every rank has marked that it joined
    mark = os.environ.get("HNUMO_READY_FILE")
    if mark:
        Path(mark).touch()
    return dec


# ---------------------------------------------------------------------------
# a rank's block of the tables and of the state
# ---------------------------------------------------------------------------

def _copy(a):
    """A contiguous copy (a block must not keep the whole grid's storage)."""
    if isinstance(a, torch.Tensor):
        return a.clone(memory_format=torch.contiguous_format)
    return np.array(a)


def _elements(a, ys, xs, nely, nelx):
    """Block of an element table (..., nely, nelx, m, m)."""
    if tuple(a.shape[-4:-2]) != (nely, nelx):
        raise ValueError(f"element table of shape {tuple(a.shape)} on a "
                         f"{nely}x{nelx} grid")
    return _copy(a[..., ys, xs, :, :])


def _xfaces(a, ys, xs, nely, nelx):
    """Block of an x-face table (..., nely, nelx+1, n): faces x0..x1."""
    if tuple(a.shape[-3:-1]) != (nely, nelx + 1):
        raise ValueError(f"x-face table of shape {tuple(a.shape)} on a "
                         f"{nely}x{nelx} grid")
    return _copy(a[..., ys, slice(xs.start, xs.stop + 1), :])


def _yfaces(a, ys, xs, nely, nelx):
    """Block of a y-face table (..., nely+1, nelx, n): faces y0..y1."""
    if tuple(a.shape[-3:-1]) != (nely + 1, nelx):
        raise ValueError(f"y-face table of shape {tuple(a.shape)} on a "
                         f"{nely}x{nelx} grid")
    return _copy(a[..., slice(ys.start, ys.stop + 1), xs, :])


def _block_slices(dec_or_block, nely, nelx):
    """(rows, cols) slices of a block given as a Decomposition or as
    ((py, px), (iy, ix))."""
    if isinstance(dec_or_block, Decomposition):
        (y0, y1), (x0, x1) = dec_or_block.bounds(nely, nelx)
    else:
        (py, px), (iy, ix) = dec_or_block
        (y0, y1), (x0, x1) = block_bounds(nely, py, iy), block_bounds(nelx, px, ix)
    return slice(y0, y1), slice(x0, x1)


def local_tables(g: DeviceGeom, P: Precomputed, dec):
    """This block's (DeviceGeom, Precomputed) out of the whole grid's, by
    field name. `dec`: a Decomposition, or ((py, px), (iy, ix)) for any
    block. Tensors or NumPy arrays alike (the latter carry the JAX package's
    tables across, see convert.py)."""
    nely, nelx = g.wjac.shape[0], g.wjac.shape[1]
    ys, xs = _block_slices(dec, nely, nelx)
    args = (ys, xs, nely, nelx)

    def geom_field(name, a):
        if name in _GEOM_SHARED:
            return a
        if name in _GEOM_XFACE:
            return _xfaces(a, *args)
        if name in _GEOM_YFACE:
            return _yfaces(a, *args)
        return _elements(a, *args)

    g_loc = DeviceGeom(**{k: geom_field(k, v) for k, v in g._asdict().items()})
    fx = FaceDirGeom(*[_xfaces(a, *args) for a in P.faces.x])
    fy = FaceDirGeom(*[_yfaces(a, *args) for a in P.faces.y])
    P_loc = Precomputed(
        **{k: (v if k in _P_SHARED else _elements(v, *args))
           for k, v in P._asdict().items() if k != "faces"},
        faces=Pair(fx, fy))
    return g_loc, P_loc


def local_state(state: State, dec) -> State:
    """This block's State out of the whole grid's (`dec` as in
    local_tables); `t` and `ok` are shared."""
    nely, nelx = state.qb_df.shape[1], state.qb_df.shape[2]
    ys, xs = _block_slices(dec, nely, nelx)
    return State(qb_df=_elements(state.qb_df, ys, xs, nely, nelx),
                 q_df=_elements(state.q_df, ys, xs, nely, nelx),
                 qprime_df=_elements(state.qprime_df, ys, xs, nely, nelx),
                 t=state.t, ok=state.ok)


def gather_state(state: State, dec: Decomposition):
    """The whole grid's State on rank 0 (CPU tensors), None elsewhere: the
    gather that I/O reads, the counterpart of `to_host`. Every rank must
    call it."""
    parts = {name: dec.gather(getattr(state, name), getattr(state, name).dim() - 4)
             for name in ("qb_df", "q_df", "qprime_df")}
    if dec.rank != 0:
        return None
    return State(**parts, t=state.t.cpu(), ok=state.ok.cpu())
