"""On the card: the control (the reference at float8 in the program's
place), judged by the cell's limits as a run judges the program, comes
out not correct at the cell's own size, on one seed, while the program
comes out correct.  The full readings, a dozen seeds and more, come from
``bench/calibrate.py`` (PERF.md).

    python -m pytest -q bench/tests/test_bench_control.py      # on the card
"""
import pytest
import torch

from bench.lib import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their own size only on the card")
    import repro_torch
    repro_torch.set_device("cuda")
    yield torch.device("cuda", 0)
    repro_torch.set_device(None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(cuda, name):
    from bench.calibrate import readings
    r = readings(name, 2**31 + 977, device=cuda)
    assert r["program_correct"] is True, r
    assert r["control_correct"] is False, r
