"""The readings that set a cell's limits for ``correct``, many seeds in one
process (the kernels build once):

    python bench_port/calibrate.py --workload <cell> \
        --plan program:1,2,3 control:101,102,103 half_batch:201,202,203

``program``: the program as the configuration states it; ``control``:
the reference computed with its operands rounded to the lower precision
that the cell's ``workloads/<cell>.json`` names (``rounding``); a fault of
``faults.py``.  Each seed of the program or a fault runs set-up (the first
epoch) and a window of one epoch, then the reference, and prints one JSON
line of readings (``--detail``: every step's and every leaf's gap).
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from bench_port import cell as C  # noqa: E402
from bench_port import faults  # noqa: E402


def side_readings(cell, side: str, seed: int, device,
                  detail: bool = False) -> dict:
    if side == "control":
        return C.reference_readings(cell, seed, None, device,
                                    rounding=cell.spec["control"]["rounding"],
                                    detail=detail)
    with (faults.planted(side) if side in faults.FAULTS
          else contextlib.nullcontext()):
        prog = C.set_up(cell, seed, device)
        window = C.run_window(prog, 0.0, device)
    produced = C.readout(prog, window, cell)
    del prog, window
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return C.reference_readings(cell, seed, produced, device, detail=detail)


def _printable(values: dict) -> dict:
    """Leaf paths as ``a/b/c`` strings, so the detail prints as JSON."""
    return {k: ({"/".join(map(str, leaf)): g for leaf, g in v.items()}
                if isinstance(v, dict) else v) for k, v in values.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--plan", nargs="+", required=True,
                        help="side:seed,seed,... (side: program, control, "
                        + ", ".join(faults.FAULTS) + ")")
    parser.add_argument("--detail", action="store_true",
                        help="print every leaf's gaps, not the worst")
    args = parser.parse_args(argv)
    cell = C.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for item in args.plan:
        side, seeds = item.split(":")
        for seed in (int(s) for s in seeds.split(",")):
            t0 = time.perf_counter()
            values = side_readings(cell, side, seed, device, args.detail)
            print(json.dumps({"cell": cell.name, "side": side, "seed": seed,
                              "readings": _printable(values),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
