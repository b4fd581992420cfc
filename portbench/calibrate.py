"""Readings from which a cell's comparison limits are set (not part of a
benchmark run):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --faults stale_image,dropped_flip \
        --fault-seeds 4,5,6 --seconds 3

For each of `--seeds`, the program as a run drives it (set-up, a short
window of `--seconds`) and the run's comparison with the reference; for
each of `--control-seeds`, the control in the program's place (the
reference computed one precision below the configuration's, see the
kind's `control`); for each of `--faults` (`portbench/faults.py`) and each
of `--fault-seeds`, the program with that fault planted, driven as a run.
One JSON line a reading on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults as FAULTS, harness  # noqa: E402


def readings(workload: str, seeds, control_seeds, seconds: float, device=None, adjust=None,
             faults=(), fault_seeds=()):
    import torch

    cell = harness.Cell(harness.manifest(), workload)
    if adjust is not None:
        adjust(cell)
    if device is None:
        harness.require_cards(int(cell.workload["chips"]))
        device = torch.device("cuda")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    kind = cell.kind_module()

    def program(seed, side):
        work = kind.Workload(cell, seed, device)
        work.setup()
        window = harness.measure(work, seconds, sync)
        t0 = time.perf_counter()
        checks = work.check(window)
        return {"workload": workload, "side": side, "seed": seed, "steps": window["steps"],
                "check_s": time.perf_counter() - t0,
                **{k: v["value"] for k, v in checks.items()}, **getattr(work, "details", {})}

    for seed in seeds:
        yield program(seed, "program")
    for fault in faults:
        for seed in fault_seeds:
            patches = FAULTS.Patches()
            getattr(FAULTS, fault)(patches)
            try:
                yield program(seed, fault)
            finally:
                patches.undo()
    for seed in control_seeds:
        work = kind.Workload(cell, seed, device)
        checks = work.check(work.control())
        yield {"workload": workload, "side": "control", "seed": seed,
               **{k: v["value"] for k, v in checks.items()}, **getattr(work, "details", {})}
        del work


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args()

    def ints(s):
        return [int(v) for v in s.split(",") if v]

    harness.cache_environment()
    for r in readings(a.workload, ints(a.seeds), ints(a.control_seeds), a.seconds,
                      faults=[f for f in a.faults.split(",") if f],
                      fault_seeds=ints(a.fault_seeds)):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
