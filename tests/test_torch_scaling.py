"""hnumo_tpu_torch/tools/scaling.py on the CPU: its runs, its configuration
and its refusals. The runs themselves need one GPU per rank (the chip
tool's four-GPU call); a run on a host with fewer GPUs than ranks raises
before any rank starts, and this host shows none."""
import pytest

from hnumo_tpu_torch.tools import scaling


def test_the_runs_are_strong_then_weak():
    assert scaling.runs([1, 2, 4]) == [
        ("strong", 1, (1, 1), (256, 256)), ("strong", 2, (1, 2), (256, 256)),
        ("strong", 4, (2, 2), (256, 256)),
        ("weak", 1, (1, 1), (128, 128)), ("weak", 2, (1, 2), (128, 256)),
        ("weak", 4, (2, 2), (256, 256))]


@pytest.mark.parametrize("gpus", [[3], [1, 8], [0]])
def test_a_gpu_count_without_a_split_is_refused(gpus):
    with pytest.raises(ValueError, match="GPU counts"):
        scaling.runs(gpus)


@pytest.mark.parametrize("gpus,available", [([1, 2, 4], 2), ([2], 1), ([1], 0)])
def test_fewer_gpus_than_ranks_is_refused(gpus, available):
    with pytest.raises(RuntimeError, match="share a card"):
        scaling.check_gpus(gpus, available)
    scaling.check_gpus(gpus, max(gpus))          # enough: no error


def test_the_command_refuses_to_share_a_card():
    """This host shows no CUDA device: the command raises before it starts
    a rank, whatever the counts."""
    with pytest.raises(RuntimeError, match="share a card"):
        scaling.main(["--gpus", "1", "2"])
    with pytest.raises(ValueError, match="--steps"):
        scaling.main(["--steps", "0"])
    with pytest.raises(ValueError, match="GPU counts"):
        scaling.main(["--gpus", "3"])


@pytest.mark.parametrize("grid", [(128, 128), (128, 256), (256, 256)])
def test_the_configuration_keeps_the_bench_element(grid):
    """Every grid has the 128x128 basin's element (80 km a side at 25x25
    scaled) and its time step scaled as bench.py scales it."""
    cfg = scaling.bench_config(*grid)
    assert (cfg.nely, cfg.nelx) == grid
    dx = (cfg.xdims[1] - cfg.xdims[0]) / cfg.nelx
    dy = (cfg.ydims[1] - cfg.ydims[0]) / cfg.nely
    assert dx == pytest.approx(dy) == pytest.approx(2.0e6 / grid[0])
    assert cfg.dt == pytest.approx(500.0 * 25.0 / grid[0])
    assert cfg.fused_tail == "on" and cfg.mega == "off" and cfg.dtype == "float32"
