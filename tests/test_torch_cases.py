"""The reference's test cases other than the double gyre, selected by a
namelist and stepped end to end: two float64 steps of the port against two
of the JAX package, from the same namelist, at 1e-11 of each field's max
(the port's steps are held to the JAX package's at that level everywhere;
measured here at most 2e-13, on the lake at rest whose momenta are the
rounding of a rest state). Their tables are gated already
(tests/test_torch_precomputed.py); this is their step.

Each case runs on a 6x6 brick at p=3 with 2 layers, on the domain and time
step of the JAX package's own tests of it (tests/test_io.py, tests/test_gmsh.py,
tests/test_options.py), so the port takes its default path there: the
megakernel's plain version on the CPU, the JAX package its XLA path.
"""
import numpy as np
import pytest

from hnumo_tpu.config import config_from_namelist as jax_from_namelist
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.config import config_from_namelist
from hnumo_tpu_torch.model import Model as TorchModel
from test_torch_common import assert_close, one_thread  # noqa: F401  (autouse)

CASES = {
    "bump": dict(xdims=(0.0, 2e3), ydims=(0.0, 2e3), dt=20.0, dt_btp=2.0),
    "lakeatrest": dict(xdims=(0.0, 1e3), ydims=(0.0, 1e3), dt=50.0, dt_btp=2.0),
    # the sloping-shelf part of the dam basin: over the crest the reference's
    # geometry leaves layers of zero thickness (tests/test_options.py)
    "dam": dict(xdims=(0.0, 9e5), ydims=(0.0, 4.5e5), dt=30.0, dt_btp=3.0),
    "seamount": dict(xdims=(0.0, 4e5), ydims=(0.0, 4e5), dt=40.0, dt_btp=4.0),
}
FIELDS = ("qb_df", "q_df", "qprime_df")


def namelist(path, case):
    c = CASES[case]
    path.write_text(
        "&gridnl\n nelx = 6\n nely = 6\n nopx = 3\n nopy = 3\n"
        f" xdims = {c['xdims'][0]}, {c['xdims'][1]}\n"
        f" ydims = {c['ydims'][0]}, {c['ydims'][1]}\n nlayers = 2\n/\n"
        f"&input\n dt = {c['dt']}\n dt_btp = {c['dt_btp']}\n time_final = 1.0d9\n"
        f" test_case = '{case}'\n/\n")
    return path


@pytest.mark.parametrize("case", CASES)
def test_two_steps_against_jax(tmp_path, case):
    nml = namelist(tmp_path / "numo3d.in", case)
    tcfg, jcfg = config_from_namelist(nml), jax_from_namelist(nml)
    assert tcfg.test_case == jcfg.test_case == case
    assert (tcfg.dtype, tcfg.xdims, tcfg.dt) == ("float64", CASES[case]["xdims"],
                                                 CASES[case]["dt"])
    jm = JaxModel(jcfg)
    tm = TorchModel(tcfg, device="cpu")
    assert tm.static.mega and tm.static.mega_impl == "plain"
    sj, st = jm.state0, tm.state0
    for _ in range(2):
        sj, st = jm.step(sj), tm.step(st)
    assert bool(sj.ok) and bool(st.ok)
    assert float(st.t) == float(sj.t) == 2 * CASES[case]["dt"]
    for name in FIELDS:
        assert_close(getattr(st, name), np.asarray(getattr(sj, name)), 1e-11, name)
    # not two rest states: the barotropic momentum moved (at rest cases, by
    # the rounding of the rest state; in the bump, by the bump)
    assert float(st.qb_df[2:].abs().max()) > 0.0
