"""The benchmark's span readers (bench_port/spans.py and the five metrics
that read it) on a hand-built Chrome trace, on the CPU.

The trace: a ``bench_window`` of 3945 µs holding two epochs of two steps
each.  Step j starts at o = 1000·j µs; its device operations are

====  ===================  ==============================  ===============
op    device (µs from o)   launched (µs from o)            spans around it
====  ===================  ==============================  ===============
a     200-400              150, ``cudaLaunchKernel``       step, forward,
                                                           row01
b     400-450              300, ``cuLaunchKernel``         step, forward
c     500-700              500 on autograd's thread        step, backward
d     700-760              650 on autograd's thread        step, backward,
                                                           row07
e     850-900              850, ``cudaLaunchKernel``       step, adam
f     900+10j-920+10j      900, ``cudaMemcpyAsync``        step, adam
====  ===================  ==============================  ===============

and step 3's copy f (3930-3950) straddles the window's end (3945).  Each
epoch's permutation runs before its first step (``rvk.epoch``), the losses'
stack between the epochs in no span, and a ``gpu_user_annotation`` mirrors
a step on the device.  By hand:

* step intervals 720, 730, 740, 745 µs → p90 = 740 + 0.7·5 = 743.5 µs;
* unions 580, 580, 580, 575 → idle 140, 150, 160, 170, mean 155 µs;
* the boundary: step 1's last op ends at 1930, step 2's first starts at
  2200 → 270 µs;
* Adam: e + f = 70, 70, 70, 65 → 68.75 µs a step;
* PyTorch's own: b + c = 250 µs a step.
"""

import json
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import cell as cell_mod  # noqa: E402
from bench_port import spans  # noqa: E402
from bench_port import trace as trace_mod  # noqa: E402

CELL = "dense-bf16-b131072"
NEW = {"step_ms_p90": 0.7435, "step_idle_ms": 0.155,
       "epoch_boundary_ms": 0.27, "adam_ms": 0.06875,
       "torch_ops_ms": 0.25}
OLD = ("step_mfu", "launches_per_step", "kernels_roofline",
       "device_idle_pct")
MAIN, AUTOGRAD = 1, 2


def _x(name, cat, ts, dur, tid=MAIN, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


class _Trace:
    def __init__(self):
        self.events = [_x("bench_window", "user_annotation", 0, 3945)]
        self.corr = 0

    def launch(self, api, cat, at, device_cat, name, start, end,
               tid=MAIN):
        self.corr += 1
        self.events.append(_x(api, cat, at, 5, tid, correlation=self.corr))
        self.events.append(_x(name, device_cat, start, end - start, 7,
                              correlation=self.corr))

    def kernel(self, at, start, end, name="k", tid=MAIN,
               api="cudaLaunchKernel", cat="cuda_runtime"):
        self.launch(api, cat, at, "kernel", name, start, end, tid)

    def span(self, name, start, end, tid=MAIN):
        self.events.append(_x(name, "user_annotation", start, end - start,
                              tid))


def _trace() -> list:
    t = _Trace()
    for epoch in (0, 2000):
        t.span("rvk.epoch", epoch + 10, epoch + 40)
        t.kernel(epoch + 20, epoch + 50, epoch + 70, "randperm")
    t.kernel(2005, 2005, 2008, "stack")          # in no span
    for j in range(4):
        o, d = 1000 * j, 10 * j
        t.span("rvk.step", o + 100, o + 1000)
        t.span("rvk.forward", o + 110, o + 400)
        t.span("rvk.row01.encoder_fwd", o + 120, o + 200)
        t.kernel(o + 150, o + 200, o + 400, "encoder")
        t.kernel(o + 300, o + 400, o + 450, "mul", api="cuLaunchKernel",
                 cat="cuda_driver")
        t.span("rvk.backward", o + 400, o + 800)
        t.kernel(o + 500, o + 500, o + 700, "where", tid=AUTOGRAD)
        t.span("rvk.row07.grad_accum", o + 600, o + 700, tid=AUTOGRAD)
        t.kernel(o + 650, o + 700, o + 760, "wgrad", tid=AUTOGRAD)
        t.span("rvk.adam", o + 800, o + 990)
        t.kernel(o + 850, o + 850, o + 900, "adam")
        t.launch("cudaMemcpyAsync", "cuda_runtime", o + 900, "gpu_memcpy",
                 "Memcpy DtoD", o + 900 + d, o + 920 + d)
        t.events.append(_x("rvk.step", "gpu_user_annotation", o + 200,
                           720 + d, 7))
    return t.events


def _without(events, pred) -> list:
    return [e for e in events if not pred(e)]


def _rvk(e) -> bool:
    return e["name"].startswith("rvk.") and "annotation" in e["cat"]


def _device(e) -> bool:
    return e["cat"] in trace_mod.DEVICE_CATS


def _view(tmp_path, monkeypatch, events):
    tmp_path.mkdir(parents=True, exist_ok=True)
    monkeypatch.setattr(cell_mod, "TRACES", tmp_path)
    cell = cell_mod.load_cell(CELL)
    path = tmp_path / f"{CELL}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    window = types.SimpleNamespace(steps=4,
                                   frames=4 * cell.config["batch_size"])
    return trace_mod.read(path, cell, window)


def _read(name, view):
    return cell_mod.load_reader(name)(view)


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_gives_the_value_worked_out_by_hand(name, tmp_path,
                                                   monkeypatch):
    view = _view(tmp_path, monkeypatch, _trace())
    assert _read(name, view) == pytest.approx(NEW[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(NEW))
@pytest.mark.parametrize("cut", ["no_device_op", "no_rvk_span"])
def test_reader_gives_none_without_ops_or_spans(name, cut, tmp_path,
                                                monkeypatch):
    pred = _device if cut == "no_device_op" else _rvk
    view = _view(tmp_path, monkeypatch, _without(_trace(), pred))
    assert _read(name, view) is None


@pytest.mark.parametrize("name", OLD)
def test_existing_readers_do_not_see_the_spans(name, tmp_path, monkeypatch):
    with_spans = _read(name, _view(tmp_path / "a", monkeypatch, _trace()))
    plain = _read(name, _view(tmp_path / "b", monkeypatch,
                              _without(_trace(), _rvk)))
    assert with_spans is not None and with_spans == plain


def test_table_attributes_every_op_and_names_every_span(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    s = spans.read(path)
    assert s.steps == 4
    assert s.window_ms == pytest.approx(3.945)
    # the losses' stack alone is in no span
    assert s.unattributed_ms == pytest.approx(0.003)
    count, total, own = s.table["rvk.row07.grad_accum"]
    assert (count, total, own) == (4, pytest.approx(0.24),
                                   pytest.approx(0.24))
    count, total, own = s.table["rvk.backward"]
    assert (count, total, own) == (4, pytest.approx(1.04),
                                   pytest.approx(0.8))
    assert s.table["rvk.epoch"] == (2, pytest.approx(0.04),
                                    pytest.approx(0.04))
    assert s.table["rvk.step"][0] == 4


def test_command_prints_the_table(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    assert spans.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "rvk.row01.encoder_fwd" in out and "step_ms_p90 " in out
    assert spans.main([]) == 2
