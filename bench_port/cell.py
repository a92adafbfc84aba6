"""One run of one cell: set-up, the measured window, the trace and the
check of ``correct``.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; each is a data file of its own, found by
name:

* ``configs/<config>.json``: the model's widths and training settings, the
  module of its plain reference (``reference/<reference>.py``), and the
  program's settings that hold for every run of it (``program``);
* ``traffic/<traffic>.json``: the job — the corpus the engine trains on,
  the precision tier, and the program's settings that go with it;
* ``workloads/<cell>.json``: the cell's limits for ``correct``, and how
  its control and faults are read (``calibrate.py``).

What the window drives is the program's resident-epoch engine, built as
its epoch trainer builds it (``train/epoch.py`` ``_run_resident``): the
registry's model, ``choose_layout`` under the shipped
``resident_budget_gb``, ``put_resident`` of the corpus, and
``build_resident_epoch``'s ``run_epochs``, called an epoch at a time.
Set-up runs the first epoch through that same call.  The reference
follows the first three steps of set-up's epoch and the first three steps
of the window (the first of its second epoch).  The optimizer handed to
the engine is the one the program builds (``train/optim.py``
``build_optimizer``), passed through a :class:`Recording` that keeps copies
of the moments after the first update and of the parameters after the
third; that is the only thing the benchmark adds to the object the window
runs.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench_port import corpus as corpus_mod
from bench_port import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACES = HERE / "traces"    # git-ignored; a run overwrites its cell's file
FORBIDDEN = ("jax", "jaxlib", "flax", "rawaudiovae_kelsey_tpu")
CHECKED_STEPS = 3    # of set-up's epoch, and of the window's


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict = field(default_factory=dict)   # workloads/<cell>.json

    @property
    def precision(self) -> str:
        return self.traffic["program"]["tpu"]["precision"]


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> dict:
    return _read(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its data files."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(name=name, chips=entry["chips"],
                config=_read(root / conf["file"]),
                traffic=_read(HERE / "traffic" / f"{entry['traffic']}.json"),
                spec=_read(HERE / "workloads" / f"{name}.json"))


def reference_module(cell: Cell):
    return importlib.import_module(
        f"bench_port.reference.{cell.config['reference']}")


# ----------------------------------------------------------- the program

def port_config(cell: Cell, seed: int):
    """The program's ``Config`` of ``cell`` for a run of ``seed``."""
    from rawaudiovae_kelsey_tpu_torch.config.schema import Config
    c = cell.config
    cfg = Config()
    cfg.audio.segment_length = c["segment_length"]
    cfg.audio.hop_length = c["hop_length"]
    cfg.audio.sampling_rate = c["sampling_rate"]
    cfg.vae.arch = c["arch"]
    cfg.vae.latent_dim = c["latent_dim"]
    cfg.vae.kl_beta = c["kl_beta"]
    if c["arch"] == "dense":
        (cfg.vae.n_units,) = c["hidden_dims"]
    else:
        cfg.vae.hidden_dims = ",".join(str(d) for d in c["hidden_dims"])
    cfg.training.batch_size = c["batch_size"]
    cfg.training.learning_rate = c["learning_rate"]
    cfg.training.loss_reduction = c["loss_reduction"]
    for settings in (c["program"], cell.traffic["program"]):
        for section, values in settings.items():
            target = getattr(cfg, section.lower())
            for key, value in values.items():
                if not hasattr(target, key):
                    raise KeyError(f"{section}.{key} is no setting of the "
                                   "program's Config")
                setattr(target, key, value)
    cfg.tpu.seed = seed
    cfg.validate()
    return cfg


class Recording:
    """The optimizer the program built, passed through: each update is the
    program's own, after which a copy is kept of the first moments after
    the first update and of the parameters after the third."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.kept: dict = {}

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    def update(self, state, grads):
        from rawaudiovae_kelsey_tpu_torch.train.state import clone
        self.optimizer.update(state, grads)
        if state.count == 1:
            self.kept["mu"] = clone(state.mu)
        elif state.count == CHECKED_STEPS:
            self.kept["params"] = clone(state.params)


@dataclass
class Program:
    """The object set-up builds and the window runs."""
    run_epochs: object
    state: object
    data: torch.Tensor
    optimizer: object
    n_batches: int
    batch: int
    first_losses: torch.Tensor   # the warm-up epoch's losses, on the device


def set_up(cell: Cell, seed: int, device: torch.device) -> Program:
    """Build the resident engine of ``cell`` from ``seed`` and run its first
    epoch (which builds and warms every kernel of the cell's shapes)."""
    from rawaudiovae_kelsey_tpu_torch.models.registry import (
        build_model,
        resident_model,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel import resident
    from rawaudiovae_kelsey_tpu_torch.train.optim import build_optimizer
    from rawaudiovae_kelsey_tpu_torch.train.state import TrainState

    cfg = port_config(cell, seed)
    model = resident_model(cfg, build_model(cfg, device))
    job = cell.traffic["corpus"]
    samples = corpus_mod.synth(job["samples"], job["files"],
                               cell.config["sampling_rate"], seed, device)
    host = samples.cpu().numpy()
    del samples
    dtype_bytes = 2 if cfg.tpu.precision == "bfloat16" else 4
    layout = resident.choose_layout(
        len(host), cfg.audio.segment_length, cfg.audio.hop_length,
        dtype_bytes, int(cfg.tpu.resident_budget_gb * (1 << 30)))
    if layout is None:
        raise ValueError("the corpus does not fit resident_budget_gb")
    optimizer = Recording(build_optimizer(cfg))
    run_epochs, n_batches = resident.build_resident_epoch(
        model, cfg, optimizer, len(host), layout=layout)
    data = resident.put_resident(host, cfg, layout, device)
    del host
    params = reference_module(cell).init_params(cell.config, seed, device)
    state = TrainState.create(params, seed=seed)
    state, losses = run_epochs(state, data, 0, k=1)
    _sync(device)
    return Program(run_epochs=run_epochs, state=state, data=data,
                   optimizer=optimizer, n_batches=n_batches,
                   batch=cfg.training.batch_size, first_losses=losses[0])


def readout(prog: Program, window: "Window", cell: Cell) -> dict:
    """What the program produced, by the reference's leaf paths: the
    losses of set-up's first steps and of the window's, the first gradient
    as the optimizer got it (the first moment after one update is
    (1 − b1)·g) and the parameters after the third step."""
    ref = reference_module(cell)
    kept = prog.optimizer.kept
    b1 = cell.config["b1"]
    mu = ref.leaves(kept["mu"], cell.config)
    return {"losses": prog.first_losses[:CHECKED_STEPS].tolist(),
            "window_losses": window.losses[0][0, :CHECKED_STEPS].tolist(),
            "grads": {k: v / (1.0 - b1) for k, v in mu.items()},
            "params": ref.leaves(kept["params"], cell.config)}


# ------------------------------------------------------------ the window

@dataclass
class Window:
    seconds: float
    epochs: int
    steps: int
    frames: int
    losses: List[torch.Tensor]


def run_window(prog: Program, seconds: float, device: torch.device
               ) -> Window:
    """Whole epochs after set-up's epoch 0, from a device sync to a device
    sync, until ``seconds`` have passed (at least one epoch)."""
    _sync(device)
    t0 = time.perf_counter()
    epoch, losses = 1, []
    while True:
        prog.state, rows = prog.run_epochs(prog.state, prog.data, epoch, k=1)
        losses.append(rows)
        epoch += 1
        _sync(device)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    epochs = epoch - 1
    steps = epochs * prog.n_batches
    return Window(seconds=elapsed, epochs=epochs, steps=steps,
                  frames=steps * prog.batch, losses=losses)


# ------------------------------------------------------------- correct

def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: Dict[tuple, float], ref: Dict[tuple, float]
              ) -> Dict[tuple, float]:
    """Each leaf's gap between the program's and the reference's norm, over
    the larger of that leaf's reference norm and the median leaf's."""
    median = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in ref}


def gaps(prog: dict, ref: dict, params0: Dict[tuple, torch.Tensor],
         n_batches: int) -> dict:
    """The relative gap of each checked step's loss, of set-up's and of the
    window's, and by leaf those of the first gradient's norm and of the
    change over set-up's checked steps."""
    ref_g = {k: _norm(v) for k, v in ref["grads"].items()}

    def loss_gaps(got, want):
        return [abs(p - r) / abs(r) for p, r in zip(got, want)]

    return {
        "loss": loss_gaps(prog["losses"], ref["losses"][:CHECKED_STEPS]),
        "window_loss": loss_gaps(prog["window_losses"],
                                 ref["losses"][n_batches:]),
        "grad": leaf_gaps({k: _norm(prog["grads"][k]) for k in ref_g},
                          ref_g),
        "change": leaf_gaps(
            {k: _norm(prog["params"][k] - params0[k]) for k in ref_g},
            {k: _norm(ref["params"][k] - params0[k]) for k in ref_g})}


def readings(gap: dict) -> Dict[str, float]:
    """The numbers a cell's limits may name: the worst of :func:`gaps`,
    and the median leaf's change gap, which the noise of one leaf's
    rounding under Adam does not move."""
    return {"loss_gap": max(gap["loss"]),
            "window_loss_gap": max(gap["window_loss"]),
            "grad_gap": max(gap["grad"].values()),
            "change_gap": max(gap["change"].values()),
            "change_median": statistics.median(gap["change"].values())}


def reference_readings(cell: Cell, seed: int, prog: dict,
                       device: torch.device, rounding: Optional[str] = None,
                       detail: bool = False) -> Dict[str, float]:
    """Run the reference from ``seed`` through set-up's epoch and the
    window's first steps, and compare ``prog`` with it; ``prog = None``
    compares the reference computed with ``rounding`` in the program's
    place (the control).  ``detail`` returns every gap (:func:`gaps`)
    instead of the worst."""
    ref_mod = reference_module(cell)
    c = cell.config
    job = cell.traffic["corpus"]
    samples = corpus_mod.synth(job["samples"], job["files"],
                               c["sampling_rate"], seed, device)
    n_batches = ref_mod.frame_count(
        samples.numel(), c["segment_length"], c["hop_length"]
        ) // c["batch_size"]
    steps = n_batches + CHECKED_STEPS
    ref = ref_mod.train(c, seed, samples, steps, CHECKED_STEPS)
    if prog is None:
        run = ref_mod.train(c, seed, samples, steps, CHECKED_STEPS,
                            rounding=rounding)
        prog = dict(run, losses=run["losses"][:CHECKED_STEPS],
                    window_losses=run["losses"][n_batches:])
    del samples
    params0 = ref_mod.leaves(ref_mod.init_params(c, seed, device), c)
    gap = gaps(prog, ref, params0, n_batches)
    return gap if detail else readings(gap)


def judge(cell: Cell, values: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit, in the cell's order."""
    limits = cell.spec["limits"]
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


# ------------------------------------------------------------- a run

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def per_layer_metrics(cell: Cell, bench: dict) -> List[dict]:
    """The per-layer metrics this cell reports."""
    return [m for m in bench["per_layer"]
            if cell.name in m.get("workloads", [cell.name])]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process, compared by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> dict:
    """One run of ``cell``: the object of the result line, ``checks`` its
    last key."""
    bench = load_benchmark()
    prog = set_up(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    view = None
    if trace:
        TRACES.mkdir(parents=True, exist_ok=True)
        path = TRACES / f"{cell.name}.json"
        with trace_mod.profiled(path):
            window = run_window(prog, seconds, device)
        view = trace_mod.read(path, cell, window)
    else:
        window = run_window(prog, seconds, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    window_losses = torch.cat([rows.flatten() for rows in window.losses])
    failed = int((~torch.isfinite(window_losses)).sum())
    produced = readout(prog, window, cell)
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(cell, reference_readings(cell, seed, produced, device))
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = {}
        for m in per_layer_metrics(cell, bench):
            value = load_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"train_frames_per_s": {
                       "value": window.frames / window.seconds,
                       "unit": "frames/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    result = {"correct": correct, "attempted": window.steps,
              "failed": failed, "metrics": metrics,
              "device": device_record(device, cell.chips, peak)}
    if view is not None:
        result["device"]["busy_s"] = view.busy_s
        result["device"]["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
    result["window"] = {"seconds": window.seconds, "epochs": window.epochs,
                        "steps": window.steps, "setup_s": setup_s}
    result["checks"] = checks
    return result


def device_record(device: torch.device, count: int, peak: int) -> dict:
    """The result's ``device`` record, with the card's power limit beside it
    (a card set below 700 W runs slower under load)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": peak,
            "power_limit": _smi("power.limit", device)}


def _smi(query: str, device: torch.device) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() if out.returncode == 0 else "not read"
