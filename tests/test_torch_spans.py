"""The program's spans (rawaudiovae_kelsey_tpu_torch/observe/spans.py) in
the resident engine, the train step, Adam and the ops wrappers, on the CPU.

A tiny dense engine under ``backend = pallas`` trains two epochs.  With no
profiler recording no span is entered (``record_function`` made to raise
changes nothing); under ``torch.profiler`` (CPU activity) the exported
Chrome trace holds one ``rvk.epoch`` an epoch and one ``rvk.step`` a step,
each step with its forward, backward and Adam nested inside it by time,
and the rows of the dense path's wrappers (their plain versions on the
CPU) inside the forward and the backward; and the losses and parameters
are bit for bit those of the untraced run.  No JAX: the engine is the
port's alone.
"""

import json

import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.data.framing import overlapping_frames
from rawaudiovae_kelsey_tpu_torch.models import build_model
from rawaudiovae_kelsey_tpu_torch.observe import span, spanned
from rawaudiovae_kelsey_tpu_torch.ops import mlp
from rawaudiovae_kelsey_tpu_torch.parallel import resident as R
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import make_mesh
from rawaudiovae_kelsey_tpu_torch.train import TrainState
from rawaudiovae_kelsey_tpu_torch.tree import leaves

SEG, HOP, UNITS, LATENT, BATCH, SEED = 64, 32, 32, 8, 64, 11
EPOCHS = 2

# the rows each mode of the dense backward runs (ops/mlp.py BWD_FUSION)
BACKWARD_ROWS = {
    "highest": {"rvk.row04.matmul_nt", "rvk.row05.matmul_nt_mask",
                "rvk.row06.matmul_nt2_mask", "rvk.row07.grad_accum"},
    "bfloat16": {"rvk.row07.grad_accum", "rvk.row08.enc_bwd_dw1",
                 "rvk.row09.grad_accum2", "rvk.row10.dec_bwd_fused"},
}
FORWARD_ROWS = {"rvk.row01.encoder_fwd", "rvk.row02.decoder_fwd"}


def _cfg(precision: str) -> Config:
    cfg = Config()
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = HOP
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.training.batch_size = BATCH
    cfg.training.learning_rate = 1e-3
    cfg.tpu.precision = precision
    cfg.tpu.backend = "pallas"
    cfg.tpu.seed = SEED
    return cfg


def _corpus() -> np.ndarray:
    rng = np.random.default_rng(4)
    return (0.4 * np.sin(np.arange(8_000) / 21.0)
            + 0.05 * rng.standard_normal(8_000)).astype(np.float32)


def _train(precision: str, layout: str):
    """Two epochs of a fresh engine: ``(losses, params, n_batches)``."""
    cfg = _cfg(precision)
    corpus = _corpus()
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(SEED))
    if layout == "sharded":
        mesh = make_mesh()
        frames = overlapping_frames(corpus, SEG, HOP)
        run, n_batches = R.build_resident_epoch_sharded(
            model, cfg, None, len(frames), mesh)
        data = R.put_frames_sharded(frames, cfg, mesh)
    else:
        run, n_batches = R.build_resident_epoch(model, cfg, None,
                                                len(corpus), layout=layout)
        data = R.put_resident(corpus, cfg, layout, "cpu")
    state, losses = run(TrainState.create(params, SEED), data, 0, k=EPOCHS)
    return losses, state.params, n_batches


def _spans(path) -> list:
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("rvk.")),
                  key=lambda s: s[1])


def _inside(spans, outer, prefix: str) -> list:
    return [s for s in spans if s[0].startswith(prefix)
            and outer[1] <= s[1] and s[2] <= outer[2]]


CASES = [("highest", "frames"), ("bfloat16", "corpus"),
         ("highest", "sharded")]


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert span("rvk.a") is span("rvk.b")
    with span("rvk.a"):
        pass


def test_spanned_keeps_the_wrappers_name_and_counters():
    assert mlp.encoder_fwd.__name__ == "encoder_fwd"
    assert mlp.encoder_fwd.span_name == "rvk.row01.encoder_fwd"
    assert mlp.encoder_fwd_partial.span_name == "rvk.row01.encoder_fwd"
    assert isinstance(mlp.encoder_fwd.launches, int)

    @spanned("rvk.test")
    def f(x, y=1):
        return x + y

    assert f(1, y=2) == 3 and f.span_name == "rvk.test"


@pytest.mark.parametrize("precision,layout", CASES)
def test_no_span_is_entered_without_a_profiler(precision, layout,
                                               monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    losses, _, n = _train(precision, layout)
    assert losses.shape == (EPOCHS, n)
    assert bool(torch.isfinite(losses).all())


@pytest.mark.parametrize("precision,layout", CASES)
def test_traced_engine_records_epochs_steps_phases_and_rows(
        precision, layout, tmp_path):
    plain_losses, plain_params, n = _train(precision, layout)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        losses, params, _ = _train(precision, layout)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = _spans(path)
    names = [s[0] for s in spans]

    assert names.count("rvk.epoch") == EPOCHS
    steps = [s for s in spans if s[0] == "rvk.step"]
    assert len(steps) == EPOCHS * n
    assert names.count("rvk.gather") == (EPOCHS * n if layout == "corpus"
                                         else 0)
    assert names.count("rvk.allreduce") == (EPOCHS * n
                                            if layout == "sharded" else 0)
    epochs = [s for s in spans if s[0] == "rvk.epoch"]
    for e, nxt in zip(epochs, epochs[1:] + [("", float("inf"), 0.0)]):
        assert sum(e[2] <= s[1] < nxt[1] for s in steps) == n
    for step in steps:
        for phase in ("rvk.forward", "rvk.backward", "rvk.adam"):
            assert len(_inside(spans, step, phase)) == 1, (phase, step)
        (fwd,) = _inside(spans, step, "rvk.forward")
        (bwd,) = _inside(spans, step, "rvk.backward")
        assert {s[0] for s in _inside(spans, fwd, "rvk.row")} == FORWARD_ROWS
        assert ({s[0] for s in _inside(spans, bwd, "rvk.row")}
                == BACKWARD_ROWS[precision])
    # the bits do not depend on the profiler
    assert torch.equal(losses, plain_losses)
    for got, want in zip(leaves(params), leaves(plain_params)):
        assert torch.equal(got, want)
