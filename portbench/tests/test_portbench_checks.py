"""The comparison that decides `correct`, driven through the harness on the
CPU at small sizes (no card: `harness.run(device=cpu)` skips the look for
one): a sound run passes; the control, and a run whose timed path is broken
underneath, fail.  The `gpu` test reads the control at the cell's own size
on the card."""

import pytest
import torch

from portbench import calibrate, faults, harness

CELL = "eunet_tiled_2048"
SMALL = dict(image_size=160, tile=96, overlap=32, pool=2, check_requests=2)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def small(cell):
    cell.traffic.update(SMALL)
    cell.config["calibration"]["size"] = 96


def limits():
    return harness.Cell(harness.manifest(), CELL).limits


def run(seconds=0.3):
    return harness.run(CELL, SEED, seconds, False, 0.0, device=CPU, adjust=small)


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def test_the_control_fails():
    """The reference in the program's place, its convs in fp8: over a limit
    on three seeds."""
    for r in calibrate.readings(CELL, [], [1, 2, 3], 0.0, device=CPU, adjust=small):
        assert any(r[k] > v for k, v in limits().items()), r


@pytest.mark.parametrize("fault", faults.TILED)
def test_a_broken_timed_path_fails(fault, monkeypatch):
    getattr(faults, fault)(monkeypatch.setattr)
    r = run()
    assert not r["correct"], (fault, r["checks"])


def test_patches_undo_a_fault():
    from enhanced_unet_tpu_torch.train import evaluator as ev

    before = ev.cut_tiles
    patches = faults.Patches()
    faults.swapped_tiles(patches)
    assert ev.cut_tiles is not before
    patches.undo()
    assert ev.cut_tiles is before


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_size(card):
    for r in calibrate.readings(CELL, [], [11, 12, 13], 0.0):
        assert any(r[k] > v for k, v in limits().items()), r


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
