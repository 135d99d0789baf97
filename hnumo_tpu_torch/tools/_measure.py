"""What a timed run of the port's step is measured and held to: the gates of
its state, the kernels its captured CUDA graph holds, the device time of
one replay, the least time each kernel could take, and the card it ran on.

Shared by hnumo_tpu_torch/tools/bench.py and chip_smoke.py (and the other
tools of this package that name the card); `kernels_by_span` puts one
eager step's device activities down to the port's spans (spans.py).
Nothing here runs at import: torch is imported, and libcuda is opened only
when a graph is read.
"""
from __future__ import annotations

import re
import subprocess
from collections import Counter

import torch

from .. import spans

# published peaks of one H100 SXM (NVIDIA data sheet): the yardstick of `bound_ms`
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

MASS_TOL = 1e-6     # relative total-mass change over an f32 run

# the five kernels' symbols, as a trace or a graph node names them
KERNEL_SYMBOLS = {"btp_volume": "btp_volume_kernel", "btp_mega": "btp_mega_kernel",
                  "btp_volume_uni": "btp_volume_uni_kernel", "btp_faces": "btp_faces_kernel",
                  "btp_update": "btp_update_kernel"}


def card(index: int | None = None) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them: the
    first card's, or card `index`'s."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    if index is not None:
        cmd.insert(1, f"--id={index}")
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The current CUDA device's SM clock now, in MHz, as nvidia-smi reads it."""
    return float(subprocess.run(
        ["nvidia-smi", f"--id={torch.cuda.current_device()}", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip())


def total_mass(m, state) -> float:
    dp = (m.P.dpp_ref_df + state.q_df[0]).double()
    return float((m.g.wjac_df.double() * dp).sum())


def gates(m, state, state0=None):
    """ok, finite fields and the relative total-mass change from `state0`
    (default the initial state) to `state`, which must stay within MASS_TOL."""
    if not bool(state.ok):
        raise AssertionError("state.ok is False")
    for name in ("qb_df", "q_df", "qprime_df"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"non-finite values in {name}")
    m0 = total_mass(m, m.state0 if state0 is None else state0)
    drift = abs(total_mass(m, state) - m0) / m0
    if not drift <= MASS_TOL:
        raise AssertionError(f"relative total-mass change {drift:.3e} > {MASS_TOL}")
    return drift


def path_launches_per_step(m) -> dict:
    """{kernel: launches per baroclinic step} on this model's path. On the
    megakernel path a step is exactly 2 megakernel launches; on the fused
    path 2*N_btp*kstages launches of each of the uniform-geometry volume
    kernel, the face kernel and the update kernel; on the per-stage path
    2*N_btp*kstages volume kernel launches (of the uniform-geometry one under
    uni_volume). Every other kernel: none."""
    per_stage = 2 * m.static.n_btp * m.static.kstages
    if m.static.mega:
        return {"btp_mega": 2}
    if m.static.fused_tail:
        return {"btp_volume_uni": per_stage, "btp_faces": per_stage,
                "btp_update": per_stage}
    if m.static.uni_volume:
        return {"btp_volume_uni": per_stage}
    return {"btp_volume": per_stage}


def graph_kernels(graph) -> dict:
    """{kernel symbol (mangled): nodes} of a captured CUDA graph whose nodes
    were kept (torch.cuda.CUDAGraph(keep_graph=True); Model.keep_graph),
    read through the CUDA driver, child graphs included: what every replay
    of it launches, whatever a profiler's trace records. Its memcpy and
    memset nodes count under "(memcpy)" and "(memset)"."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    ptr, out = ctypes.c_void_p, ctypes.byref

    class KernelNodeParams(ctypes.Structure):   # cuda.h: CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ptr), ("dims", ctypes.c_uint * 6),
                    ("shared_bytes", ctypes.c_uint), ("params", ptr), ("extra", ptr),
                    ("kern", ptr), ("ctx", ptr)]

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc:
            raise RuntimeError(f"{fn} returned CUresult {rc}")

    counts = {}

    def walk(g):
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", g, None, out(n))
        nodes = (ptr * n.value)()
        call("cuGraphGetNodes", g, nodes, out(n))
        for node in map(ptr, nodes):
            kind = ctypes.c_int()
            call("cuGraphNodeGetType", node, out(kind))
            if kind.value == 4:                   # CU_GRAPH_NODE_TYPE_GRAPH
                child = ptr()
                call("cuGraphChildGraphNodeGetGraph", node, out(child))
                walk(child)
            elif kind.value in (1, 2):            # CU_GRAPH_NODE_TYPE_MEMCPY, _MEMSET
                key = "(memcpy)" if kind.value == 1 else "(memset)"
                counts[key] = counts.get(key, 0) + 1
            elif kind.value == 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
                params, name = KernelNodeParams(), ctypes.c_char_p()
                call("cuGraphKernelNodeGetParams_v2", node, out(params))
                if params.func:
                    call("cuFuncGetName", out(name), ptr(params.func))
                else:
                    call("cuKernelGetName", out(name), ptr(params.kern))
                key = name.value.decode()
                counts[key] = counts.get(key, 0) + 1

    walk(ptr(graph.raw_cuda_graph()))
    return counts


def demangle(symbol: str) -> str:
    """A kernel's mangled symbol as the profiler names it (the C++ ABI's
    demangler, which Kineto calls); the symbol itself where it is not a
    mangled C++ name."""
    import ctypes

    lib = ctypes.CDLL("libstdc++.so.6")
    fn = lib.__cxa_demangle
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int(-1)
    out = fn(symbol.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not out:
        return symbol
    free = ctypes.CDLL(None).free
    free.argtypes, free.restype = [ctypes.c_void_p], None
    try:
        return ctypes.string_at(out).decode()
    finally:
        free(out)


# a device activity whose launch the trace does not hold
NO_LAUNCH = "(no launch recorded)"
# one whose launch ran outside every span
OUTSIDE = "(outside every span)"


def span_path(ranges, t: float) -> str | None:
    """The path ("outer/inner/...") of the ranges [(name, start, end)] that
    hold time `t`, outermost first; None where none does."""
    held = sorted((r for r in ranges if r[1] <= t <= r[2]), key=lambda r: (r[1], -r[2]))
    return "/".join(r[0] for r in held) or None


def attribute(ranges, launches: dict, activities) -> dict:
    """{span path: {"launches", "device_ms", "kernels": {name: count}}} of
    the device `activities` [(name, start_s, end_s, correlation)], each put
    down to the path of `ranges` [(name, start_s, end_s)] that holds its
    launch's start (`launches`: {correlation: start_s}, the host calls that
    enqueued them). Memory copies and fills count as launches of
    "(memcpy)" and "(memset)"."""
    out = {}
    for name, s, e, corr in activities:
        t = launches.get(corr)
        key = NO_LAUNCH if t is None else (span_path(ranges, t) or OUTSIDE)
        row = out.setdefault(key, {"launches": 0, "device_ms": 0.0, "kernels": Counter()})
        row["launches"] += 1
        row["device_ms"] += (e - s) * 1e3
        row["kernels"][activity_name(name)] += 1
    return {k: {**v, "kernels": dict(v["kernels"])} for k, v in sorted(out.items())}


def activity_name(name: str) -> str:
    """A device activity's name as `graph_kernels` names the graph node
    that launches it."""
    if name.startswith("Memcpy"):
        return "(memcpy)"
    if name.startswith("Memset"):
        return "(memset)"
    return name


def _trace_records(prof):
    """(hnumo ranges, {correlation: launch start}, device activities) of a
    finished torch.profiler run, in seconds on the profiler's clock."""
    from torch.autograd import DeviceType

    ranges, launches, activities = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns() / 1e9
        end = s + e.duration_ns() / 1e9
        if e.device_type() == DeviceType.CPU:
            if name.startswith(spans.PREFIX):
                ranges.append((name, s, end))
            elif name.startswith("cu"):          # a CUDA runtime or driver call
                launches.setdefault(e.correlation_id(), s)
        elif not (e.is_user_annotation() or name.startswith(spans.PREFIX) or "Sync" in name):
            # a kernel, a memory copy or a fill: not a span's copy on the
            # device's timeline, not a synchronization record
            activities.append((name, s, end, e.correlation_id()))
    return ranges, launches, activities


def kernels_by_span(model, state) -> dict:
    """The device activities of one eager step (`model._step_eager`) of a
    graphed model that has captured its step with its nodes kept
    (`Model.keep_graph`), by the span that launched each (`attribute`):
    launches that no baroclinic span holds are the self time of
    "hnumo.step". Once the capture's caches are filled, the eager step
    launches what a replay launches, so the step's launches must be the
    captured graph's kernel, memcpy and memset nodes, name for name (the
    graph's symbols demangled as the profiler names kernels); else it
    raises."""
    from torch.profiler import ProfilerActivity, profile

    if model.step_impl != "graph" or model._graph is None:
        raise ValueError("kernels_by_span takes a graphed model that has captured its step")
    want = Counter()
    for name, n in graph_kernels(model._graph[0]).items():
        want[demangle(name)] += n
    torch.cuda.synchronize(model.device)
    with torch.no_grad(), torch.cuda.device(model.device):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with spans.span("hnumo.step"):
                model._step_eager(state)
            torch.cuda.synchronize(model.device)
    table = attribute(*_trace_records(prof))
    got = Counter()
    for row in table.values():
        got.update(row["kernels"])
    if got != want:
        extra, missing = got - want, want - got
        raise AssertionError(
            f"the eager step launched {sum(got.values())} activities, the captured graph "
            f"holds {sum(want.values())} kernel, memcpy and memset nodes; the step's "
            f"beyond the graph's: {dict(list(extra.items())[:5])}; the graph's beyond the "
            f"step's: {dict(list(missing.items())[:5])}")
    return table


def graph_path_counts(nodes: dict) -> dict:
    """The five kernels' nodes among `graph_kernels` (mangled symbols)."""
    return {name: sum(n for k, n in nodes.items() if sym in k)
            for name, sym in KERNEL_SYMBOLS.items()}


def device_rows(prof):
    """Rows of device activities (kernels, memcpys) only: the operator rows
    repeat their kernels' device time."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def replay_profile(m, state, out_path=None, title=None, check=True):
    """torch.profiler over one replay of a graphed model's step: the five
    kernels counted by name in the trace (with `check`, each must be its
    path's per-step count and the others none), their device ms, and the
    replay's device activities and busy ms."""
    from torch.profiler import ProfilerActivity, profile

    if m.step_impl != "graph" or m._graph is None:
        raise ValueError("replay_profile takes a graphed model that has captured its step")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        m.step(state)
        torch.cuda.synchronize()
    dev = device_rows(prof)
    rows = {name: [e for e in dev if re.search(rf"\b{sym}\b", e.key)]
            for name, sym in KERNEL_SYMBOLS.items()}
    counts = {name: sum(e.count for e in r) for name, r in rows.items()}
    want = {name: path_launches_per_step(m).get(name, 0) for name in KERNEL_SYMBOLS}
    if check and counts != want:
        raise AssertionError(f"one replayed step ran {counts}, expected {want}")
    if out_path:
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
        with open(out_path, "a") as f:
            f.write(f"==== {title} ====\n{table}\n")
    return {"replay_kernels": counts,
            "replay_kernel_ms": {name: sum(e.self_device_time_total for e in r) / 1e3
                                 for name, r in rows.items() if r},
            "replay_device_busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "replay_device_activities": sum(e.count for e in dev)}


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


def volume_bound(m):
    """Least time the card could take for one volume stage at this model's
    shapes: bytes once over the HBM rate vs flops over the f32 peak."""
    ngl, nq = m.g.psiq.shape
    npts, nqq = ngl * ngl, nq * nq
    E = m.cfg.nelx * m.cfg.nely
    itemsize = 8 if m.cfg.dtype == "float64" else 4
    # in: qb 4, pbp 1, accn 3 (nodal); qpl 3, met 5, ptab 8, coup 4, accv 12 (quad)
    # out: rhs 3, accn 3 (nodal); accv 12 (quad); operators 3*npts*nqq once
    nbytes = itemsize * (E * (14 * npts + 44 * nqq) + 3 * npts * nqq)
    # 4 interpolations + 8 scatter rows, 2 flops per multiply-add; ~110 pointwise per quad point
    flops = E * (2 * 12 * npts * nqq + 110 * nqq + 8 * npts)
    return _bound(nbytes, flops)


def mega_bound(m):
    """Least time the card could take for one barotropic solve at this
    model's shapes: every operand read once and every result written once
    over the HBM rate, against the solve's flops over the f32 peak. The
    flops are counted from the kernel's loops (2 per multiply-add) and its
    pointwise blocks (counted by hand from the source: ~80 per volume quad
    point, ~110 per face quad point, ~45 per viscous edge node, ~20 per
    updated node). The grid barriers (one per stage) are not in the bound."""
    n, q = m.g.psiq.shape
    npts, nqq = n * n, q * q
    E = m.cfg.nelx * m.cfg.nely
    nsub = m.static.n_btp * m.static.kstages
    visc = m.static.use_visc
    itemsize = 8 if m.cfg.dtype == "float64" else 4
    # in: qb 4, ref3 3, massinv/pbp/opbp/masks 5 (nodal); qplq 3, coup 4, ptab 8
    # (quad); qe 4, ftab 13 (side x nq); ntab 3 (side x ngl); nbr; with
    # viscosity pvisc 1, bdg 4 (nodal), bgf 10 (side x ngl).
    # out: qb 4, accn 3, agr 4 (nodal); accv 12 (quad); aff 16; agt 8
    nodal = 4 + 3 + 5 + 4 + 3 + (1 + 4 + 4 if visc else 0)
    quad = 3 + 4 + 8 + 12
    side_q = 4 + 13 + 16
    side_n = 3 + (10 + 8 if visc else 0)
    values = E * (nodal * npts + quad * nqq + side_q * 4 * q + side_n * 4 * n)
    nbytes = itemsize * values + 4 * 4 * E
    macs = (4 * n * q * n + 4 * nqq * n          # interpolation, two passes
            + 5 * q * n * q + 2 * q * n * q      # scatter, first pass
            + 3 * npts * 2 * q                   # scatter, second pass
            + 2 * 16 * q * n + 12 * n * q)       # face interpolation and scatter
    pointwise = 80 * nqq + 110 * 4 * q + 20 * 3 * npts + 8 * npts
    if visc:
        macs += 4 * npts * n + 16 * n * n + 2 * npts * 2 * n
        pointwise += 45 * 4 * n + 3 * 4 * npts
    flops = E * nsub * (2 * macs + pointwise)
    return {**_bound(nbytes, flops), "barriers": nsub}


def fused_bounds(m, grad=None):
    """Least time the card could take for one launch of each of A, F and U at
    this model's shapes: the values each function must read and write once
    (counted from its operands; of the three SSPRK registers the update reads
    rows 1..3 only) over the HBM rate, against its flops (2 per multiply-add
    of the sum-factorised loops, plus the pointwise blocks counted by hand
    from the sources) over the f32 peak. `grad`: whether A also takes the
    nodal velocity gradient (default: with the viscosity, as on the fused
    path; the per-stage path's uniform-geometry stage takes none)."""
    n, q = m.g.psiq.shape
    npts, nqq = n * n, q * q
    E = m.cfg.nelx * m.cfg.nely
    F = m.cfg.nely * (m.cfg.nelx + 1) + (m.cfg.nely + 1) * m.cfg.nelx
    visc = m.static.use_visc
    grad = visc if grad is None else grad
    rows = 6 if m.static.flat_bottom else 8
    itemsize = 8 if m.cfg.dtype == "float64" else 4
    # A in: qb 4, qpln 3, pbp 1, accn 3 [, agr 4] nodal; ptab 6|8, coup 4, accv 12 quad
    #   out: rhs 3, accn 3 [, gv 4, agr 4] nodal; accv 12 quad
    a_vals = E * ((17 + (12 if grad else 0)) * npts + (rows + 28) * nqq)
    a_flops = E * (2 * (7 * n * q * n + 7 * nqq * n + 5 * q * n * q + 3 * npts * 2 * q
                        + (4 * npts * n if grad else 0)) + 80 * nqq + 8 * npts)
    # F in: trL, trR 2*(4|8), ntab 5 [, bgf 10, ag 8] nodal; ftab 15, af 16 quad
    #   out: S 3 [, Sv 2, ag 8] nodal; af 16 quad
    f_vals = F * ((16 + (36 if visc else 0)) * n + 47 * q)
    f_flops = F * (2 * (10 * q * n + 3 * n * q) + 110 * q + (45 * n if visc else 0))
    # U in: rhs 3, qb rows 3*3, ref 3, pbdf 1, mask 2 [, gv 4, pbpv 1, bdg 4] nodal;
    #       edges 3 [, vedges 2] x 4*ngl;  out: qb 4 nodal
    u_vals = E * ((22 + (9 if visc else 0)) * npts + (3 + (2 if visc else 0)) * 4 * n)
    u_flops = E * (20 * 3 * npts + (2 * 2 * npts * 2 * n + 3 * 4 * npts if visc else 0))
    return {name: _bound(vals * itemsize, flops)
            for name, vals, flops in (("btp_volume_uni", a_vals, a_flops),
                                      ("btp_faces", f_vals, f_flops),
                                      ("btp_update", u_vals, u_flops))}


def path_bounds(m) -> dict:
    """{kernel: `_bound` of one launch} of the kernels on this model's path."""
    st = m.static
    if st.mega:
        return {"btp_mega": mega_bound(m)}
    if st.fused_tail:
        return fused_bounds(m)
    if st.uni_volume:
        return {"btp_volume_uni": fused_bounds(m, grad=False)["btp_volume_uni"]}
    return {"btp_volume": volume_bound(m)}
