"""Instruction-count bound of a kernel: the SASS a kernel of the package's
library was compiled to, counted by class, and the time the card's issue
slots need for it at a shape.

    python -m rawaudiovae_kelsey_tpu_torch.probes.sass_count
        [--kernel reparameterize_kernel] [--elements 4096x256]
        [--bytes 12] [--library PATH]

It builds the library (``ops/_build.py``) unless ``--library`` names one,
disassembles it with the toolkit's ``cuobjdump -sass``, and takes the
function whose name holds ``--kernel``.  A kernel with one thread an
element and no loop (the sampler of ``csrc/rng.cu``: ten unrolled Philox
rounds, a 64-bit ``idx / latent``, precise ``logf`` / ``cosf`` / ``expf``)
runs, for each element, the instructions from its entry to its first
unpredicated ``EXIT``: the code after that is the out-of-line special cases
of the math library (arguments that (0, 1] never gives) and the padding.
That path is the count; the whole function is printed beside it.

The issue bound: an SM's four schedulers issue one warp instruction a
clock each, so the elements' warps times the path's instructions over
4 · SMs · the SM clock (``nvidia-smi``'s maximum) is the least time those
instructions take, whatever pipe each goes to.  The bytes bound is
``--bytes`` an element over the H100's 3.35 TB/s.  One JSON line, naming
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

HBM_BYTES_S = 3.35e12      # H100 SXM data sheet
ISSUE_PER_SM = 4           # warp instructions a clock: one a scheduler

# one SASS instruction: /*offset*/ [@[!]P predicate] OPCODE[.modifiers] ...
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_.]+)?)")
_FUNCTION = re.compile(r"Function : (\S+)")


def functions(sass: str) -> Dict[str, List[Tuple[str, str]]]:
    """``cuobjdump -sass`` text → {mangled name: [(predicate, opcode)]}, in
    address order (the encoding's second line of each instruction
    skipped)."""
    out: Dict[str, List[Tuple[str, str]]] = {}
    current: Optional[List[Tuple[str, str]]] = None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            current.append(((m.group(2) or "").strip(), m.group(3)))
    return out


def main_path(instrs: Sequence[Tuple[str, str]]) -> List[Tuple[str, str]]:
    """The instructions from the entry to the first unpredicated ``EXIT``,
    that one included."""
    for i, (pred, op) in enumerate(instrs):
        if op == "EXIT" and not pred:
            return list(instrs[:i + 1])
    return list(instrs)


def by_class(instrs: Sequence[Tuple[str, str]]) -> Dict[str, int]:
    """Counts by opcode without its modifiers (``IMAD.WIDE.U32`` →
    ``IMAD``), largest first."""
    counts = Counter(op.split(".")[0] for _, op in instrs)
    return dict(counts.most_common())


def issue_bound_ms(instructions: int, elements: int, sms: int,
                   clock_mhz: float) -> float:
    """The least time ``instructions`` a thread take for ``elements``
    threads (one an element) on ``sms`` SMs at ``clock_mhz``: their warps'
    instructions over :data:`ISSUE_PER_SM` a clock an SM."""
    warps = -(-elements // 32)
    return warps * instructions / (ISSUE_PER_SM * sms * clock_mhz * 1e6) \
        * 1e3


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / name
    if not path.exists():
        raise RuntimeError(f"{name} not found (PATH, CUDA_HOME, "
                           "/usr/local/cuda)")
    return str(path)


def _card() -> Tuple[str, float]:
    """The card's name and power limit, and its maximum SM clock (MHz)."""
    smi = _tool("nvidia-smi")
    card = subprocess.run([smi, "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    mhz = subprocess.run([smi, "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    return card.strip(), float(mhz)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="reparameterize_kernel")
    ap.add_argument("--elements", default="4096x256",
                    help="threads launched, as a product (one an element)")
    ap.add_argument("--bytes", type=float, default=12.0,
                    help="bytes an element moves (the sampler: mu, logvar "
                         "in, z out, fp32)")
    ap.add_argument("--library", default="",
                    help="a built library; default: build the package's")
    args = ap.parse_args(argv)

    import torch

    from rawaudiovae_kelsey_tpu_torch.ops import _build

    library = Path(args.library) if args.library else _build.build()
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    found = {name: body for name, body in functions(sass).items()
             if args.kernel in name}
    if len(found) != 1:
        print(f"sass_count: {len(found)} functions hold {args.kernel!r}: "
              f"{sorted(found)}", file=sys.stderr)
        return 1
    (name, body), = found.items()
    path = main_path(body)
    elements = 1
    for part in args.elements.split("x"):
        elements *= int(part)
    card, mhz = _card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_ms = issue_bound_ms(len(path), elements, sms, mhz)
    bytes_ms = elements * args.bytes / HBM_BYTES_S * 1e3
    print(json.dumps({
        "kernel": name, "card": card, "sms": sms, "clock_max_mhz": mhz,
        "elements": elements, "path_instructions": len(path),
        "function_instructions": len(body), "path_by_class": by_class(path),
        "issue_bound_ms": issue_ms, "bytes_bound_ms": bytes_ms,
        "bound_ms": max(issue_ms, bytes_ms)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
