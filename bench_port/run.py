"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It builds the cell's training run from the
seed (corpus and weights on the card), runs its first epoch as set-up,
trains whole epochs for ``--seconds``, then checks the first steps against
the plain reference, and prints the result as the last line of standard
output: ``--trace 0`` the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a device trace of the window.  Each number compared
for ``correct`` is printed beside its limit as the last lines of standard
error and under ``checks``, the result's last key.

It exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, without the program beside it, or when JAX or the JAX
package is loaded in the process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port import cell as cell_mod

    cell = cell_mod.load_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{cards} available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                          device, T_START)
    loaded = cell_mod.forbidden_modules()
    if loaded:
        print(f"run.py: loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        verdict = "ok" if check["value"] <= check["limit"] else "FAIL"
        print(f"check {name} {check['value']!r} limit {check['limit']!r} "
              f"{verdict}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
