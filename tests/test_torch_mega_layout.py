"""The redesigned whole-solve megakernel (hnumo_tpu_torch/ops/csrc/btp_mega.cu)
as a numpy model, against `barotropic_solve_mega_plain`.

The kernel cannot run without a card; this model repeats what its blocks do,
for all elements at once: one array per block with the source's layout (the
operators, the per-element tables, the five running averages and the
element's own SSPRK registers, then the stage's scratch, aliased by
liveness), the five phases A-E of a stage with the source's item-to-thread
mapping, the neighbours' values read from the global state buffers, and the
two routes: "resident" (tables and running averages loaded into the block's
array once and stored once, the own registers kept there, two rotating
global buffers) and "streamed" (tables copied in every stage, the running
averages updated in the global arrays, four rotating buffers whose roles
follow from the stage index). Scratch starts as NaN, and so do the
neighbours' values a stage does not need (the interior nodes of pb' and,
without viscosity, everything but the facing edge; the kernel copies whole
padded channels) and the padding, so a read of anything that was not written
or is not needed spoils the result.

What it shows: the layout rule of the source (shared memory per block,
blocks per SM, the route a grid takes) at f32/f64 and p=4/6; the liveness
table of the aliased scratch (no two buffers live in one phase share bytes,
and the model touches each buffer only inside its live phases); every
running-average value updated exactly once per element and stage, by the
same thread in every stage; every table value loaded once per element (per
stage on the streamed route); and the model's solve against the plain
version within 1e-11 in f64 at 6x5 (the parity matrix of
tests/test_torch_mega.py) and 25x25; and that chip_smoke.py's sheared state
makes a fault in the neighbours' viscous gradient visible, where its other
states do not. The kernel itself is held against the plain version on the
card by chip_smoke.py."""
import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hnumo_tpu_torch.config import Config
from hnumo_tpu_torch.core.bcl import extract_qprime_faces
from hnumo_tpu_torch.core.coupling import btp_bcl_coeffs
from hnumo_tpu_torch.model import Model
from hnumo_tpu_torch.ops import mega as mg
from test_torch_common import assert_close, leaves

SOURCE = Path(mg.__file__).resolve().parent / "csrc" / "btp_mega.cu"
SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"

# ---- the layout rule of the source ----------------------------------------------

THREADS = {"resident": 128, "streamed": 64}     # kThreads<ROUTE>
MIN_BLOCKS = {4: 8, 8: 4}         # kMinBlocks<T>: the register bound's blocks per SM
SMEM_LIMIT = 232448               # btp_volume_common.cuh kSmemLimit
SM_SHARED, BLOCK_RESERVED = 233472, 1024   # 228 KB an SM, 1 KB of it per block
SMS = 132                         # H100 SXM
Q_ROWS, F_ROWS, N_ROWS, D_ROWS = 15, 17, 13, 13
# rows of the tables: quad, side-quad, side-nodal, nodal (enums QuadRow, ...)
Q = dict(cor=0, tau_u=1, tau_v=2, gzx=3, gzy=4, opbp=5, ppref=6, href=7, ppq=8, up=9,
         vp=10, quu=11, quv=12, qvv=13, dhbcl=14)
F_QE, N_BGF = 13, 3
D = dict(ref3=0, massinv=3, pbp=4, opbp=5, masku=6, maskv=7, pvisc=8, bdg=9)

PHASES = "ABCDE"
# scratch buffer -> (phase written, phase last read): the source's note on `Lay`
LIVE = {"nb": "AB", "uv": "AB", "tmp": "AB", "t1": "CD", "t2": "CD", "sq": "CD",
        "qq": "CD", "sv": "CE", "f": "BC", "lq": "BC", "rq": "BC", "nbuv": "BC", "g": "BC",
        "rhs": "DE", "se": "DE", "lap": "DE"}


def padded(npts, itemsize):
    """`padded`: values of one channel in the exchange buffers and in `nb`,
    npts rounded up to 16 bytes."""
    per = 16 // itemsize
    return -(-npts // per) * per


def layout(n, m, itemsize):
    """{buffer: (offset, size)} in values of T and the total: `layout` of the
    source, written out again."""
    npts, nqq, pn = n * n, m * m, padded(n * n, itemsize)
    sizes = [("psiq", n * m), ("dpsiq", n * m), ("dpsi", n * n), ("wq3", 3 * nqq),
             ("wn2", 2 * npts), ("mirq", 16), ("mirg", 16), ("tq", Q_ROWS * nqq),
             ("tf", F_ROWS * 4 * m), ("tn", N_ROWS * 4 * n), ("td", D_ROWS * npts),
             ("accv", 12 * nqq), ("aff", 64 * m), ("agt", 32 * n), ("accn", 3 * npts),
             ("agr", 4 * npts), ("q1", 4 * npts), ("q0", 3 * npts), ("q2", 3 * npts)]
    lay, o = {}, 0
    for name, size in sizes:
        lay[name] = (o, size)
        o += size

    def run(start, names_sizes):
        out, p = {}, start
        for name, size in names_sizes:
            out[name] = (p, size)
            p += size
        return out, p

    o = padded(o, itemsize)        # nb starts 16-byte aligned
    slab1a, e1a = run(o, [("nb", 16 * pn), ("uv", 2 * npts), ("tmp", 4 * n * m)])
    slab1b, e1b = run(o, [("t1", 3 * m * n), ("t2", 3 * m * n), ("sq", 12 * m),
                          ("qq", 4 * npts), ("sv", 8 * n)])
    s2 = max(e1a, e1b)
    slab2a, e2a = run(s2, [("f", 8 * nqq), ("lq", 16 * m), ("rq", 16 * m),
                           ("nbuv", 8 * npts), ("g", 4 * npts)])
    slab2b, e2b = run(s2, [("rhs", 3 * npts), ("se", 12 * n), ("lap", 2 * npts)])
    for part in (slab1a, slab1b, slab2a, slab2b):
        lay.update(part)
    return lay, max(e2a, e2b)


def smem_bytes(itemsize, n, m):
    return itemsize * layout(n, m, itemsize)[1] + 4 * 4      # + the four neighbour indices


def blocks_per_sm(itemsize, n, m):
    """What the occupancy query gives: the register bound's blocks, or fewer
    where the shared memory allows fewer."""
    return min(MIN_BLOCKS[itemsize], SM_SHARED // (smem_bytes(itemsize, n, m) + BLOCK_RESERVED),
               2048 // THREADS["resident"])


def route(itemsize, E, n, m):
    return "resident" if E <= SMS * blocks_per_sm(itemsize, n, m) else "streamed"


def test_the_layout_rule_gives_what_the_source_states():
    """27,624 bytes a block at f32 p=4, 8 blocks per SM (1,056 resident
    blocks: 32x32 takes the resident route, 64x64 the streamed one); f64 and
    p=6 fit the card's limit with fewer blocks per SM."""
    text = SOURCE.read_text()
    assert "constexpr int kThreads = ROUTE == kResident ? 128 : 64;" in text
    assert "kMinBlocks = sizeof(T) == 4 ? 8 : 4;" in text
    assert f"At f32 p=4 it is {smem_bytes(4, 5, 9):,} bytes" in text
    assert re.search(r"Q_DHBCL, Q_ROWS \}", text) and "F_ROWS = 17" in text
    assert "N_ROWS = 13" in text and "D_ROWS = D_BDG + 4" in text
    assert [smem_bytes(s, n, m) for s in (4, 8) for n, m in ((5, 9), (7, 13))] == [
        27624, 51448, 54960, 102608]
    assert [blocks_per_sm(s, n, m) for s in (4, 8) for n, m in ((5, 9), (7, 13))] == [
        8, 4, 4, 2]
    for itemsize in (4, 8):
        for n in range(2, 9):      # nop 1..7, exact integration nq = 2 nop + 1
            assert smem_bytes(itemsize, n, 2 * n - 1) <= SMEM_LIMIT
    assert route(4, 32 * 32, 5, 9) == "resident" and route(4, 64 * 64, 5, 9) == "streamed"
    assert route(4, 25 * 25, 5, 9) == "resident" and route(8, 32 * 32, 5, 9) == "streamed"
    assert route(8, 30, 5, 9) == "resident" and route(8, 25 * 25, 5, 9) == "streamed"
    assert SMS * blocks_per_sm(4, 5, 9) == 1056


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n,m", [(5, 9), (7, 13), (8, 15), (2, 3)])
def test_no_two_buffers_live_in_one_phase_share_bytes(n, m, itemsize):
    lay, total = layout(n, m, itemsize)
    assert lay["nb"][0] * itemsize % 16 == 0
    assert all(0 <= o and o + s <= total for o, s in lay.values())
    persistent = [k for k in lay if k not in LIVE]
    for phase in PHASES:
        live = persistent + [k for k, (a, b) in LIVE.items()
                             if PHASES.index(a) <= PHASES.index(phase) <= PHASES.index(b)]
        for i, x in enumerate(live):
            for y in live[i + 1:]:
                (ox, sx), (oy, sy) = lay[x], lay[y]
                assert ox + sx <= oy or oy + sy <= ox, (phase, x, y)
    # the aliasing is real: the scratch takes less than its buffers laid end to end
    scratch = sum(lay[k][1] for k in LIVE)
    assert total - lay["nb"][0] < scratch


# ---- the model ------------------------------------------------------------------


def edge_nodes(s, n):
    """Nodes of side s (east, west, north, south), k = 0..n-1: edge_node."""
    k = np.arange(n)
    return (k * n + n - 1, k * n, (n - 1) * n + k, k)[s]


def on_side(s, nn, n):
    j, i = nn // n, nn % n
    return (i == n - 1, i == 0, j == n - 1, j == 0)[s]


def rot_thread(t, off, threads):
    """The thread of item t in a loop that starts at rot<threads>(off)."""
    return (t + off) % threads


class Block:
    """Every element's block array at once, (E, total), with the accesses of
    each phase logged per buffer."""

    def __init__(self, E, n, m):
        self.lay, total = layout(n, m, 8)
        self.S = np.full((E, total), np.nan)
        self.phase = None
        self.log = {}

    def __call__(self, name, *shape):
        if self.phase is not None:
            self.log.setdefault(name, set()).add(self.phase)
        o, s = self.lay[name]
        return self.S[:, o:o + s].reshape((self.S.shape[0],) + (shape or (s,)))


class Counts:
    """Per running-average value: updates in this stage and the thread of each."""

    def __init__(self):
        self.n, self.owner = {}, {}

    def add(self, name, shape, thread):
        thread = np.broadcast_to(thread, shape)
        self.n[name] = self.n.get(name, np.zeros(shape, int)) + 1
        first = self.owner.setdefault(name, thread.copy())
        assert np.array_equal(first, thread), f"{name}: another thread than in stage 0"

    def end_stage(self, names):
        for name in names:
            assert np.all(self.n.pop(name) == 1), f"{name}: not updated exactly once"
        assert not self.n, f"updated without being owned: {sorted(self.n)}"


class MegaModel:
    """csrc/btp_mega.cu in numpy, for one solve. `route` is "resident" or
    "streamed"."""

    UV_CHANNELS = (2, 3)     # the neighbours' pb*u, pb*v in their state

    def __init__(self, static, mops, op, acc, route):
        self.st, self.route = static, route
        self.n, self.m = mops.psiq.shape
        self.E = op.qb.shape[1]
        npf = lambda t: None if t is None else t.detach().cpu().numpy().astype(np.float64)
        self.g = {k: npf(getattr(op, k)) for k in op._fields}
        self.g.update({k: npf(getattr(mops, k)) for k in mops._fields
                       if isinstance(getattr(mops, k), torch.Tensor)})
        self.acc = [npf(a).copy() for a in acc]       # accv, accn, agr, aff, agt
        self.nbr = mops.nbr.numpy().astype(np.int64)
        self.kx, self.ey = mops.kx_df, mops.ey_df
        self.a_tab, self.b_tab = mops.a_tab, mops.b_tab
        self.B = Block(self.E, self.n, self.m)
        self.nt = THREADS[route]
        self.counts = Counts()
        self.loads = {}

    # -- loads ---------------------------------------------------------------
    def load(self, name, rows, src, length):
        """Rows of a per-element table (C, E, length) into the block arrays."""
        view = self.B(name)
        view[:, rows * length:(rows + src.shape[0]) * length] = (
            src.reshape(src.shape[0], self.E, length).transpose(1, 0, 2).reshape(self.E, -1))
        key = (name, rows)
        self.loads[key] = self.loads.get(key, 0) + 1

    def load_tables(self):
        g, n, m, visc = self.g, self.n, self.m, self.st.use_visc
        npts, nqq = n * n, m * m
        self.load("tq", Q["cor"], g["ptab"], nqq)
        self.load("tq", Q["ppq"], g["qplq"], nqq)
        self.load("tq", Q["quu"], g["coup"], nqq)
        self.load("tf", 0, g["ftab"], 4 * m)
        self.load("tf", F_QE, g["qe"], 4 * m)
        self.load("td", D["ref3"], g["btp_ref3"], npts)
        for key, name in (("massinv", "massinv"), ("pbp", "pbprime_df"), ("opbp", "opbp_df"),
                          ("masku", "masku"), ("maskv", "maskv")):
            self.load("td", D[key], g[name][None], npts)
        if visc:
            self.load("tn", 0, g["ntab"], 4 * n)
            self.load("tn", N_BGF, g["bgf"], 4 * n)
            self.load("td", D["pvisc"], g["pvisc"][None], npts)
            self.load("td", D["bdg"], g["bdg"], npts)

    def acc_view(self, k):
        """Running average k (0 accv, 1 accn, 2 agr, 3 aff, 4 agt) as (E, C, len):
        the block's array (resident) or the global array (streamed)."""
        name = ("accv", "accn", "agr", "aff", "agt")[k]
        if self.route == "resident":
            C = self.acc[k].shape[0]
            return self.B(name, C, self.acc[k].size // (C * self.E))
        a = self.acc[k]
        return a.reshape(a.shape[0], self.E, -1).transpose(1, 0, 2)

    # -- one stage -----------------------------------------------------------
    def stage(self, ik, nsrc, dst):
        B, E, n, m = self.B, self.E, self.n, self.m
        npts, nqq = n * n, m * m
        st, visc = self.st, self.st.use_visc
        psiq, dpsiq, dpsi = (B(k, *s) for k, s in (("psiq", (n, m)), ("dpsiq", (n, m)),
                                                   ("dpsi", (n, n))))
        nbr = self.nbr
        wall = nbr < 0
        cnt = self.counts

        # ---- phase A
        B.phase = "A"
        q1 = B("q1", 4, npts)
        t = np.arange(16 * npts)
        sd, c, nn = t // (4 * npts), (t // npts) % 4, t % npts
        need = (visc & (c != 1)) | np.array([on_side(s ^ 1, x, n) for s, x in zip(sd, nn)])
        nb_e = nbr[:, sd]                                                # (E, 16 npts)
        loaded = (nb_e >= 0) & need[None]
        nbv = np.where(loaded, nsrc[c[None], np.maximum(nb_e, 0), nn[None]], np.nan)
        pn = padded(npts, 8)
        if self.route == "resident" and ik == 0:
            B("q0", 3, npts)[:] = q1[:, 1:]
        inv_pb = 1.0 / q1[:, 0]
        t_df = q1[:, 1] * B("td", D_ROWS, npts)[:, D["opbp"]]
        u, v = q1[:, 2] * inv_pb, q1[:, 3] * inv_pb
        self.acc_view(1)[:] += np.stack([t_df * (2.0 + t_df), u, v], axis=1)
        cnt.add("accn", (E, 3, npts), rot_thread(np.arange(npts), 52, self.nt))
        B("uv", 2, npts)[:] = np.stack([u, v], axis=1)
        B("tmp", 4, n, m)[:] = np.einsum("ecji,iI->ecjI", q1.reshape(E, 4, n, n), psiq[0])
        B("nb", 4, 4, pn)[..., :npts] = nbv.reshape(E, 4, 4, npts)

        # ---- phase B
        B.phase = "B"
        tmp = B("tmp", 4, n, m)
        dp, dpp, udp, vdp = np.einsum("ecjI,jJ->ecJI", tmp, psiq[0]).reshape(E, 4, nqq).transpose(1, 0, 2)
        tq = B("tq", Q_ROWS, nqq)
        row = lambda k: tq[:, Q[k]]
        pp = row("ppref") + row("ppq")
        ub, vb = udp / dp, vdp / dp
        up, vp = row("up"), row("vp")
        if st.botfr == 1:
            spd = (st.cd_mlswe / st.gravity) * pp
            tb_u, tb_v = spd * (up + ub), spd * (vp + vb)
        elif st.botfr == 2:
            ubot, vbot = up + ub, vp + vb
            spd = (st.cd_mlswe / st.alpha_bot) * np.sqrt(ubot * ubot + vbot * vbot)
            tb_u, tb_v = spd * ubot, spd * vbot
        else:
            tb_u = tb_v = np.zeros_like(dp)
        gr = st.gravity
        sc_x = row("cor") * vdp + gr * (row("tau_u") - tb_u) - gr * dpp * row("gzx")
        sc_y = -row("cor") * udp + gr * (row("tau_v") - tb_v) - gr * dpp * row("gzy")
        mu = dpp * row("opbp")
        mu2 = mu * (2.0 + mu)
        ope = 1.0 + mu
        dHq = row("dhbcl") + mu2 * (row("href") + row("dhbcl"))
        qu = ub * udp + ope * row("quu")
        quv = ub * vdp + ope * row("quv")
        qv = vb * vdp + ope * row("qvv")
        self.acc_view(0)[:] += np.stack([dHq, qu, qv, quv, mu, mu2, ub, vb, udp, vdp,
                                         tb_u, tb_v], axis=1)
        cnt.add("accv", (E, 12, nqq), rot_thread(np.arange(nqq), 0, self.nt))
        wkx, wey, w = B("wq3", 3, nqq)[0]
        B("f", 8, nqq)[:] = np.stack([wkx * udp, wey * vdp, wkx * (dHq + qu), wey * quv,
                                      wkx * quv, wey * (dHq + qv), w * sc_x, w * sc_y], axis=1)
        # face traces at the quad points: (channel, side, q)
        nb4 = B("nb", 4, 4, padded(npts, 8))[..., :npts]
        own = np.stack([q1[:, :, edge_nodes(s, n)] for s in range(4)], axis=2)    # (E,c,s,k)
        oth = np.stack([nb4[:, s][:, :, edge_nodes(s ^ 1, n)] for s in range(4)], axis=2)
        mirq = B("mirq", 4, 4)[0].T                                                 # (c, s)
        wl = wall[:, None, :, None]
        first = (np.arange(4) % 2 == 0)[None, None, :, None]
        left = np.where(wl | first, own, oth)
        right = np.where(wl, mirq[None, :, :, None] * own, np.where(first, oth, own))
        B("lq", 4, 4, m)[:] = np.einsum("ecsk,kq->ecsq", left, psiq[0])
        B("rq", 4, 4, m)[:] = np.einsum("ecsk,kq->ecsq", right, psiq[0])
        uv = B("uv", 2, n, n)
        if visc:
            nbuv = B("nbuv", 4, 2, npts)
            cu, cv = self.UV_CHANNELS
            for s in range(4):
                inside = ~wall[:, s]
                inv = 1.0 / nb4[inside, s, 0]
                nbuv[inside, s, 0] = nb4[inside, s, cu] * inv
                nbuv[inside, s, 1] = nb4[inside, s, cv] * inv
            g = self.grad(uv, dpsi[0])
            B("g", 4, npts)[:] = g
            self.acc_view(2)[:] += g
            cnt.add("agr", (E, 4, npts),
                    rot_thread(np.arange(4 * npts), 5, self.nt).reshape(4, npts))

        # ---- phase C
        B.phase = "C"
        f = B("f", 8, m, m)
        t1 = np.einsum("ecJI,iI->ecJi", f[:, 0:6:2], dpsiq[0])
        t1[:, 1:] += np.einsum("ecJI,iI->ecJi", f[:, 6:8], psiq[0])
        B("t1", 3, m, n)[:] = t1
        B("t2", 3, m, n)[:] = np.einsum("ecJI,iI->ecJi", f[:, 1:6:2], psiq[0])
        ft = B("tf", F_ROWS, 4 * m)
        (nx, ny, jacf, cpL, cpR, cpub, cmL, cmR, cmLR, opbe, Hedge, pbl, pbr) = ft.transpose(1, 0, 2)[:13]
        Qe_uu, Qe_uv, Qe_vv, dHe = ft.transpose(1, 0, 2)[F_QE:]
        l0, l1, l2, l3 = B("lq", 4, 4 * m).transpose(1, 0, 2)
        r0, r1, r2, r3 = B("rq", 4, 4 * m).transpose(1, 0, 2)
        pU_L = nx * l2 + ny * l3
        pU_R = -(nx * r2 + ny * r3)
        mue = (cpL * l1 + cpR * r1 + cpub * (pU_L + pU_R)) * opbe
        mue2 = mue * (2.0 + mue)
        ope_e = 1.0 + mue
        flux_ex = cmL * l2 + cmR * r2 + cmLR * nx * (l1 - r1)
        flux_ey = cmL * l3 + cmR * r3 + cmLR * ny * (l1 - r1)
        ul, ur, vl, vr = l2 / l0, r2 / r0, l3 / l0, r3 / r0
        quu = 0.5 * (ul * l2 + ur * r2) + ope_e * Qe_uu
        quv_f = 0.5 * (vl * l2 + vr * r2) + ope_e * Qe_uv
        qvu = 0.5 * (ul * l3 + ur * r3) + ope_e * Qe_uv
        qvv = 0.5 * (vl * l3 + vr * r3) + ope_e * Qe_vv
        dH_f = dHe + mue2 * (Hedge + dHe)
        fl_x = nx * quu + ny * quv_f - 0.5 * cmLR * (r2 - l2)
        fl_y = nx * qvu + ny * qvv - 0.5 * cmLR * (r3 - l3)
        muL, muR = l1 / pbl, r1 / pbr
        self.acc_view(3)[:] += np.stack(
            [dH_f, quu, quv_f, qvu, qvv, muL, muR, muL * (2.0 + muL), muR * (2.0 + muR),
             flux_ex, flux_ey, mue2, ul, ur, vl, vr], axis=1)
        cnt.add("aff", (E, 16, 4 * m), rot_thread(np.arange(4 * m), 0, self.nt))
        B("sq", 3, 4 * m)[:] = np.stack([jacf * (nx * flux_ex + ny * flux_ey),
                                         jacf * (nx * dH_f + fl_x), jacf * (ny * dH_f + fl_y)],
                                        axis=1)
        if visc:
            g = B("g", 4, npts)
            nbuv = B("nbuv", 4, 2, n, n)
            tn = B("tn", N_ROWS, 4, n)
            mirg = B("mirg", 4, 4)[0]
            lft = np.empty((E, 4, 4, n))
            rgt = np.empty((E, 4, 4, n))
            for s in range(4):
                on = edge_nodes(s, n)
                other = np.stack([self.grad(nbuv[:, s], dpsi[0])[:, c][:, edge_nodes(s ^ 1, n)]
                                  for c in range(4)], axis=1)                   # (E, c, k)
                own_g = g[:, :, on]
                w = wall[:, s, None, None]
                if s % 2 == 0:
                    lft[:, :, s], rgt[:, :, s] = own_g, np.where(w, mirg[s][None, :, None] * own_g, other)
                else:
                    lft[:, :, s] = np.where(w, own_g, other)
                    rgt[:, :, s] = np.where(w, mirg[s][None, :, None] * own_g, own_g)
            self.acc_view(4)[:] += np.concatenate([lft, rgt], axis=1).reshape(E, 8, 4 * n)
            cnt.add("agt", (E, 8, 4 * n), rot_thread(np.arange(4 * n), 36, self.nt))
            bg = tn[:, N_BGF:]
            fl = bg[:, 4][:, None] * lft + bg[:, 0:4]
            fr = bg[:, 9][:, None] * rgt + bg[:, 5:9]
            nxdf, nydf, jacdf = tn[:, 0], tn[:, 1], tn[:, 2]
            flux_qu = (0.5 * (fl[:, 0] + fr[:, 0]) - fl[:, 0] * nxdf) + (
                0.5 * (fl[:, 1] + fr[:, 1]) - fl[:, 1] * nydf)
            flux_qv = (0.5 * (fl[:, 2] + fr[:, 2]) - fl[:, 2] * nxdf) + (
                0.5 * (fl[:, 3] + fr[:, 3]) - fl[:, 3] * nydf)
            sign = np.where(wall | (np.arange(4) % 2 == 0)[None], 1.0, -1.0)[:, :, None]
            B("sv", 2, 4, n)[:] = np.stack([sign * (jacdf * flux_qu), sign * (jacdf * flux_qv)],
                                           axis=1)
            td = B("td", D_ROWS, npts)
            wn2 = B("wn2", 2, npts)[0]
            B("qq", 4, npts)[:] = wn2[[0, 1, 0, 1]][None] * (
                td[:, D["pvisc"], None] * g + td[:, D["bdg"]:D["bdg"] + 4])

        # ---- phase D
        B.phase = "D"
        t1, t2 = B("t1", 3, m, n), B("t2", 3, m, n)
        B("rhs", 3, npts)[:] = (np.einsum("ecJi,jJ->ecji", t1, psiq[0])
                                + np.einsum("ecJi,jJ->ecji", t2, dpsiq[0])).reshape(E, 3, npts)
        sq = B("sq", 3, 4, m)
        sgn = np.where(wall | (np.arange(4) % 2 == 0)[None], -1.0, 1.0)[:, None, :, None]
        B("se", 3, 4, n)[:] = sgn * np.einsum("ecsq,kq->ecsk", sq, psiq[0])
        if visc:
            qq = B("qq", 4, n, n)
            X, Y = qq[:, 0::2], qq[:, 1::2]
            B("lap", 2, npts)[:] = -(np.einsum("ecjk,ik->ecji", X, dpsi[0])
                                     + np.einsum("ecki,jk->ecji", Y, dpsi[0])).reshape(E, 2, npts)

        # ---- phase E
        B.phase = "E"
        a0, a1, a2 = self.a_tab[ik]
        dtb = st.dt_btp * self.b_tab[ik]
        r = B("rhs", 3, npts) + self.edge_sum(B("se", 3, 4, n))
        if visc:
            r[:, 1:] += st.visc_mlswe * (B("lap", 2, npts) + self.edge_sum(B("sv", 2, 4, n)))
        td = B("td", D_ROWS, npts)
        r = td[:, D["massinv"], None] * (r + td[:, D["ref3"]:D["ref3"] + 3])
        q1 = B("q1", 4, npts)
        vnew = a0 * B("q0", 3, npts) + a1 * q1[:, 1:] + a2 * B("q2", 3, npts) + dtb * r
        out = np.stack([vnew[:, 0] + td[:, D["pbp"]], vnew[:, 0],
                        td[:, D["masku"]] * vnew[:, 1], td[:, D["maskv"]] * vnew[:, 2]], axis=1)
        dst[:] = out.transpose(1, 0, 2)
        if self.route == "resident":
            q1[:] = out
            if st.kstages == 5 and ik == 1:
                B("q2", 3, npts)[:] = out[:, 1:]
        B.phase = None
        cnt.end_stage(["accv", "accn", "aff"] + (["agr", "agt"] if visc else []))

    def grad(self, uv, dpsi):
        """(E, 2, n, n) nodal u, v -> (E, 4, npts) grad_uv."""
        E, n = uv.shape[0], self.n
        gx = self.kx * np.einsum("ecjk,ki->ecji", uv, dpsi)
        gy = self.ey * np.einsum("ecki,kj->ecji", uv, dpsi)
        return np.stack([gx[:, 0], gy[:, 0], gx[:, 1], gy[:, 1]], axis=1).reshape(E, 4, n * n)

    def edge_sum(self, e):
        """(E, C, 4 sides, n) -> (E, C, npts): edge_sum at every node."""
        n = self.n
        out = np.zeros(e.shape[:2] + (n, n))
        out[:, :, :, n - 1] += e[:, :, 0]
        out[:, :, :, 0] += e[:, :, 1]
        out[:, :, n - 1, :] += e[:, :, 2]
        out[:, :, 0, :] += e[:, :, 3]
        return out.reshape(e.shape[:2] + (n * n,))

    # -- the launch ------------------------------------------------------------
    def solve(self):
        B, E, n, m = self.B, self.E, self.n, self.m
        npts = n * n
        g = self.g
        for name in ("psiq", "dpsiq", "dpsi", "wq3", "wn2"):
            B(name)[:] = g[name].reshape(-1)[None]
        B("mirq")[:] = g["mir_q"].reshape(-1)[None]
        B("mirg")[:] = g["mir_g"].reshape(-1)[None]
        nsub = self.st.n_btp * self.st.kstages
        qb_in = g["qb"]
        qb_out = np.full_like(qb_in, np.nan)
        ws = np.zeros((4,) + qb_in.shape)
        if self.route == "resident":
            self.load_tables()
            for k, name in enumerate(("accv", "accn", "agr", "aff", "agt")):
                if k in (2, 4) and not self.st.use_visc:
                    continue
                a = self.acc[k]
                B(name)[:] = a.reshape(a.shape[0], E, -1).transpose(1, 0, 2).reshape(E, -1)
            B("q1", 4, npts)[:] = qb_in.transpose(1, 0, 2)
            B("q2")[:] = 0.0
            for s in range(nsub):
                nsrc = qb_in if s == 0 else ws[(s - 1) % 2]
                dst = qb_out if s == nsub - 1 else ws[s % 2]
                self.stage(s % self.st.kstages, nsrc, dst)
            for k, name in enumerate(("accv", "accn", "agr", "aff", "agt")):
                if k in (2, 4) and not self.st.use_visc:
                    continue
                a = self.acc[k]
                a[:] = B(name).reshape(E, a.shape[0], -1).transpose(1, 0, 2).reshape(a.shape)
        else:
            bufs = list(ws) + [qb_in]
            i0, i1, i2 = 4, 4, 0
            for s in range(nsub):
                ik = s % self.st.kstages
                if ik == 0:
                    i0 = i1
                io = min({0, 1, 2, 3} - {i0, i1, i2})
                dst = qb_out if s == nsub - 1 else bufs[io]
                self.load_tables()
                B("q1", 4, npts)[:] = bufs[i1].transpose(1, 0, 2)
                B("q0", 3, npts)[:] = bufs[i0][1:].transpose(1, 0, 2)
                B("q2", 3, npts)[:] = bufs[i2][1:].transpose(1, 0, 2)
                self.stage(ik, bufs[i1], dst)
                if self.st.kstages == 5 and ik == 1:
                    i2 = io
                i1 = io
        return qb_out, self.acc


# ---- the cases ------------------------------------------------------------------

FREE = ((4, 4), (4, 4))
WALLS0420 = ((0, 4), (2, 0))     # copy west and north, no-slip south


def config(nel_x, nel_y, visc=True, botfr=1, kstages=5, nop=4, walls=FREE):
    return Config(nelx=nel_x, nely=nel_y, nopx=nop, nopy=nop, xdims=(0.0, 2e6),
                  ydims=(0.0, 2e6), nlayers=2, dt=400.0, dt_btp=20.0, time_final=1e9,
                  test_case="double_gyre", f0=9.3e-5, beta=2e-11, botfr=botfr,
                  cd_mlswe=1e-7, kstages=kstages, x_boundary=walls[0], y_boundary=walls[1],
                  method_visc=2 if visc else 0, visc_mlswe=100.0 if visc else 0.0,
                  dtype="float64", mega="on")


@functools.lru_cache(maxsize=None)
def _solved_plain(cfg):
    """The model on the CPU, a state off the rest state with its coupling,
    and the plain solve."""
    m = Model(cfg, device="cpu")
    assert m.static.mega and m.mega_ops is not None
    rng = np.random.default_rng(3)
    s = m.state0
    qb = s.qb_df + torch.tensor(1e-3 * np.abs(rng.normal(size=tuple(s.qb_df.shape))))
    qp = s.qprime_df + torch.tensor(1e-4 * rng.normal(size=tuple(s.qprime_df.shape)))
    zq = torch.zeros(qp.shape[1:-2] + m.g.wjac.shape[-2:], dtype=qp.dtype)
    coup = btp_bcl_coeffs(m.static, m.P, m.g, m.bc, qp, extract_qprime_faces(m.bc, qp),
                          qp[0], zq)
    want = mg.barotropic_solve_mega_plain(m.static, m.P, m.g, m.bc, coup, qb, qp, m.mega_ops)
    return m, qb, qp, coup, want


def model_solve(m, qb, qp, coup, route, cls=MegaModel):
    """(model, (qb at t+dt, averages)) of one solve through the numpy model."""
    E, (ngl, nq) = m.cfg.nelx * m.cfg.nely, m.g.psiq.shape
    op = mg.solve_operands(m.static, m.g, coup, qb, qp, m.mega_ops)
    acc = mg.new_accumulators(E, ngl, nq, dtype=torch.float64)
    model = cls(m.static, m.mega_ops, op, acc, route)
    qb_out, acc_out = model.solve()
    got = (torch.tensor(qb_out).view(4, m.cfg.nely, m.cfg.nelx, ngl, ngl),
           mg.averages_from_accumulators(m.static, m.mega_ops,
                                         *(torch.tensor(a) for a in acc_out)))
    return model, got


def run_model(cfg, route):
    m, qb, qp, coup, want = _solved_plain(cfg)
    model, got = model_solve(m, qb, qp, coup, route)
    return model, got, want


def check(model, got, want, nsub):
    (qb_g, avg_g), (qb_w, avg_w) = got, want
    assert np.isfinite(qb_g.numpy()).all()
    for c in range(4):
        assert_close(qb_g[c], qb_w[c].numpy(), 1e-11, f"qb[{c}]")
    for (name, a), (_, b) in zip(leaves(avg_g), leaves(avg_w)):
        assert np.isfinite(a.numpy()).all(), name
        assert_close(a, b.numpy(), 1e-11, name)
    # every buffer touched only inside its live phases
    for name, phases in model.B.log.items():
        if name in LIVE:
            a, b = LIVE[name]
            assert phases <= set(PHASES[PHASES.index(a):PHASES.index(b) + 1]), (name, phases)
    # tables: once per element (resident) or once per element and stage (streamed)
    want_loads = 1 if model.route == "resident" else nsub
    assert set(model.loads.values()) == {want_loads}


CASES = [dict(visc=False), dict(), dict(botfr=2), dict(visc=False, botfr=0, kstages=3),
         dict(nop=6), dict(walls=WALLS0420)]


@pytest.mark.parametrize("route", ["resident", "streamed"])
@pytest.mark.parametrize("case", CASES, ids=["inviscid", "visc", "botfr2", "k3-botfr0",
                                             "nop6", "walls0420"])
def test_model_matches_plain_at_6x5(case, route):
    cfg = config(6, 5, **case)
    model, got, want = run_model(cfg, route)
    check(model, got, want, cfg.kstages * model.st.n_btp)


@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_model_matches_plain_at_25x25(route):
    """The main path's order and viscosity at 625 elements (one block each on
    the resident route at f32)."""
    cfg = config(25, 25)
    model, got, want = run_model(cfg, route)
    check(model, got, want, cfg.kstages * model.st.n_btp)


# ---- chip_smoke.py's sheared state ---------------------------------------------


@functools.lru_cache(maxsize=None)
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class SwappedUV(MegaModel):
    """The kernel with a fault in the neighbours' viscous gradient: their u
    and v read from each other's channel (a channel-stride fault)."""

    UV_CHANNELS = (3, 2)


def qb_error(got, want):
    """Max over qb's four channels of max|got - want| / max|want|."""
    return max(float((got[0][c] - want[0][c]).abs().max() / want[0][c].abs().max())
               for c in range(4))


@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_the_sheared_state_sees_the_neighbours_viscous_gradient(route):
    """chip_smoke.py phase 7 holds the kernel against the plain version on
    its sheared state (u, v ~ 1 m/s, viscosity SHEAR_VISC) at 6x5: there the
    model matches the plain version within 1e-11 and the faulty model misses
    it by far more, while on the perturbed state at the model's viscosity the
    same fault stays inside the tolerance."""
    cs = _smoke()
    sheared = Model(cs.small_config(6, 5, "float64", 1, mega="on", visc_mlswe=cs.SHEAR_VISC),
                    device="cpu")
    plain = Model(cs.small_config(6, 5, "float64", 1, mega="on"), device="cpu")
    errors = {}
    for name, m, inputs in (("sheared", sheared, cs.sheared_inputs),
                            ("perturbed", plain, cs.perturbed_inputs)):
        _, qb, qp, coup = inputs(m, seed=3)
        want = mg.barotropic_solve_mega_plain(m.static, m.P, m.g, m.bc, coup, qb, qp,
                                              m.mega_ops)
        if name == "sheared":
            model, got = model_solve(m, qb, qp, coup, route)
            check(model, got, want, m.static.kstages * m.static.n_btp)
        errors[name] = qb_error(model_solve(m, qb, qp, coup, route, SwappedUV)[1], want)
    assert errors["sheared"] > 1e3 * 1e-11, errors
    assert errors["perturbed"] < 1e-11, errors
