"""The port's device-resident stream (rawaudiovae_kelsey_tpu_torch/train/
stream.py ``_run_resident``) on the CPU: against the port's host-fed
stream, against itself across layouts, chunkings and boundary writers, and
against the JAX package's ``_run_resident`` on its single-device path.

The folder, the sizes and the JAX parity (the JAX init carried across, the
JAX step's threefry ``eps`` injected into the port's step) are those of
tests/test_torch_stream.py.  The JAX side runs on the suite's 8 virtual CPU
devices with its context built by ``train/loop.py`` ``setup(cfg,
use_mesh=False)``, so that its ``_run_resident`` takes the plain
single-device branch.

Tolerances: the port against itself, bit for bit (the resident engine runs
the host-fed loop's step on the same rows); against JAX, per-batch losses
rel 1e-5 and final params atol 1e-5 at ``highest``, as for the host-fed
stream.
"""

import contextlib
import io
import itertools
import re

import numpy as np
import pytest
import torch

from test_torch_stream import (  # noqa: F401  (fixtures and helpers)
    BATCH,
    N_FRAMES,
    SEG,
    _datasets,
    _losses_close,
    _params_close,
    batch_losses,
    jax_parity,
    port_train,
    small_cfg,
    stream_folder,
)

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.train import restore_checkpoint, stream
from rawaudiovae_kelsey_tpu_torch.tree import leaves as tree_leaves

# hop-padded samples of the usable files (test_torch_stream.py)
SAMPLES = 704 + 512 + 1808 + 336


def resident_cfg(cls, folder, batches=12, interval=0, hist=0,
                 layout="samples", precision="highest", **tpu):
    cfg = small_cfg(cls(), folder, batches=batches, interval=interval,
                    hist=hist)
    cfg.tpu.device_resident = "always"
    cfg.tpu.resident_layout = layout
    cfg.tpu.precision = precision
    for key, value in tpu.items():
        setattr(cfg.tpu, key, value)
    return cfg


def host_fed(cfg):
    cfg.tpu.device_resident = "never"
    if cfg.tpu.precision == "bfloat16":
        cfg.tpu.feed_dtype = "bfloat16"   # the resident corpus's targets
    return cfg


def jax_resident(cfg, verbose=False):
    """JAX ``stream._run`` on a single-device context; its stdout."""
    from rawaudiovae_kelsey_tpu.train import loop as JL
    from rawaudiovae_kelsey_tpu.train import stream as jstream

    buf = io.StringIO()
    ctx = JL.setup(cfg, use_mesh=False)
    try:
        with contextlib.redirect_stdout(buf):
            ctx = jstream._run(ctx, cfg, verbose=verbose)
    finally:
        JL.finish(ctx)
    return ctx, buf.getvalue()


def _same_state(a, b):
    assert a.step == b.step and a.count == b.count
    for p, q in zip(tree_leaves((a.params, a.mu, a.nu)),
                    tree_leaves((b.params, b.mu, b.nu))):
        assert torch.equal(p, q)


def _chunks(out):
    """The batch ids the resident loop reported after each chunk."""
    return [int(m) for m in re.findall(r"^Batch (\d+)/\d+$", out, re.M)]


# ------------------------------------------------ against the host-fed loop

@pytest.mark.parametrize("precision", ["highest", "bfloat16"])
def test_resident_equals_host_fed_bit_for_bit(stream_folder, jax_parity,
                                              capsys, precision):
    """Same batches (the index plan replays the host loader's order), same
    step, same noise: equal losses and state, bit for bit.  Under bf16 the
    host feed casts its batches to bf16 as the resident corpus is."""
    ctx = port_train(resident_cfg(Config, stream_folder, interval=4, hist=3,
                                  precision=precision))
    out = capsys.readouterr().out
    assert (f"Device-resident stream: {N_FRAMES} frames" in out
            and "samples layout), 4 steps/dispatch" in out)
    ref = port_train(host_fed(resident_cfg(
        Config, stream_folder, interval=4, hist=3, precision=precision)))
    assert "Device-resident" not in capsys.readouterr().out
    got, want = (batch_losses(c.workspace.log_dir) for c in (ctx, ref))
    assert sorted(got) == list(range(12)) and got == want
    _same_state(ctx.state, ref.state)
    assert ctx.state.step == 12
    names = sorted(p.name for p in ctx.workspace.checkpoint_dir.glob("*.npz"))
    assert names == ["ckpt_00004.npz", "ckpt_00008.npz", "ckpt_00012.npz"]
    assert (ctx.workspace.model_dir / "best_model.npz").exists()


def test_layouts_give_equal_bits(stream_folder, jax_parity, capsys):
    runs = {}
    for layout in ("samples", "frames"):
        runs[layout] = port_train(resident_cfg(Config, stream_folder,
                                               interval=5, layout=layout))
        out = capsys.readouterr().out
        assert f"on device, {layout} layout)" in out
        mb = {"samples": 4 * SAMPLES + 4 * N_FRAMES,
              "frames": 4 * N_FRAMES * SEG}[layout] / 1e6
        assert f"({mb:,.0f} MB on device" in out
    a, b = runs["samples"], runs["frames"]
    assert batch_losses(a.workspace.log_dir) == \
        batch_losses(b.workspace.log_dir)
    _same_state(a.state, b.state)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_resident_under_the_sampler_equals_host_fed(stream_folder, backend):
    """``rng = tpu_prng``: the sampler (its plain version on the CPU) draws
    from the step's seed words, the same in both engines."""
    runs = []
    for resident in (True, False):
        cfg = resident_cfg(Config, stream_folder, batches=6, rng="tpu_prng",
                           backend=backend)
        runs.append(port_train(cfg if resident else host_fed(cfg)))
    a, b = runs
    assert batch_losses(a.workspace.log_dir) == \
        batch_losses(b.workspace.log_dir)
    _same_state(a.state, b.state)


def test_pregather_gives_the_per_step_gathers_rows(stream_folder,
                                                   monkeypatch):
    runs = []
    for limit in (stream.PREGATHER_BYTES, 0):
        monkeypatch.setattr(stream, "PREGATHER_BYTES", limit)
        runs.append(port_train(resident_cfg(Config, stream_folder,
                                            batches=7, interval=4)))
    a, b = runs
    assert batch_losses(a.workspace.log_dir) == \
        batch_losses(b.workspace.log_dir)
    _same_state(a.state, b.state)


def test_rows_are_the_host_loaders_batches(stream_folder, monkeypatch):
    """Every batch the resident step takes equals the host loader's batch
    at the same position of the stream, in both layouts and both gathers."""
    _, ds = _datasets(stream_folder)
    want = [torch.from_numpy(b) for b in itertools.islice(
        ds.batches(BATCH), 9)]
    real = stream.L.build_train_step
    for layout, limit in (("samples", stream.PREGATHER_BYTES),
                          ("frames", 0), ("samples", 0)):
        monkeypatch.setattr(stream, "PREGATHER_BYTES", limit)
        seen = []

        def spy(model, cfg, *a, **kw):
            step = real(model, cfg, *a, **kw)

            def wrapped(state, batch):
                seen.append(batch.clone())
                return step(state, batch)

            return wrapped

        monkeypatch.setattr(stream.L, "build_train_step", spy)
        port_train(resident_cfg(Config, stream_folder, batches=9,
                                interval=4, layout=layout))
        assert len(seen) == 9
        for g, w in zip(seen, want):
            assert g.dtype == torch.float32 and g.is_contiguous()
            assert torch.equal(g, w)


# ----------------------------------------------------- against the JAX engine

@pytest.mark.parametrize("layout", ["samples", "frames"])
def test_resident_matches_the_jax_resident_stream(stream_folder, jax_parity,
                                                  layout):
    jctx, jout = jax_resident(resident_cfg(JConfig, stream_folder,
                                           interval=5, layout=layout))
    assert ("samples layout" in jout) == (layout == "samples")
    ctx = port_train(resident_cfg(Config, stream_folder, interval=5,
                                  layout=layout))
    want = batch_losses(jctx.workspace.log_dir)
    assert len(want) == 12
    _losses_close(batch_losses(ctx.workspace.log_dir), want)
    _params_close(ctx, jctx)


@pytest.mark.parametrize("interval,hist,batches", [
    (8, 0, 20), (5, 3, 17), (0, 7, 30), (0, 0, 70), (6, 4, 6)])
def test_k_schedule_matches_the_jax_engine(stream_folder, capsys, interval,
                                           hist, batches):
    """The chunks (at most 64 steps, cut at checkpoint and histogram
    boundaries and at the budget's end) are the JAX engine's: the batch ids
    both loops report after each chunk agree, and so does
    :func:`stream.k_schedule`."""
    _, jout = jax_resident(resident_cfg(JConfig, stream_folder,
                                        batches=batches, interval=interval,
                                        hist=hist), verbose=True)
    want = _chunks(jout)
    assert want and want[-1] == batches
    capsys.readouterr()
    port_train(resident_cfg(Config, stream_folder, batches=batches,
                            interval=interval, hist=hist))
    assert _chunks(capsys.readouterr().out) == want
    chunk = min(64, interval or 64, batches)
    ks = stream.k_schedule(0, batches, chunk, interval, hist)
    assert list(itertools.accumulate(ks)) == want


# ------------------------------------------------------ resume and interrupt

def test_resume_mid_chunk_equals_a_straight_run(stream_folder, jax_parity):
    """Six batches, then a resume to twenty: the resumed run's chunks
    (2, 8, 4) cut the straight run's (8, 8, 4) elsewhere, and its losses
    and final state equal the straight run's bit for bit."""
    straight = port_train(resident_cfg(Config, stream_folder, batches=20,
                                       interval=8))
    port_train(resident_cfg(Config, stream_folder, batches=6, interval=8))
    cfg = resident_cfg(Config, stream_folder, batches=20, interval=8)
    cfg.training.resume = True
    resumed = port_train(cfg)
    assert resumed.start_step == 6
    want = {k: v for k, v in batch_losses(straight.workspace.log_dir).items()
            if k >= 6}
    assert batch_losses(resumed.workspace.log_dir) == want
    _same_state(resumed.state, straight.state)


def test_a_host_fed_checkpoint_resumes_resident(stream_folder, jax_parity):
    """The checkpoints are the host-fed loop's: a host-fed run of six
    batches resumes in the resident engine and ends where a straight
    host-fed run does."""
    straight = port_train(host_fed(resident_cfg(Config, stream_folder)))
    port_train(host_fed(resident_cfg(Config, stream_folder, batches=6)))
    cfg = resident_cfg(Config, stream_folder)
    cfg.training.resume = True
    resumed = port_train(cfg)
    assert resumed.start_step == 6
    want = {k: v for k, v in batch_losses(straight.workspace.log_dir).items()
            if k >= 6}
    assert batch_losses(resumed.workspace.log_dir) == want
    _same_state(resumed.state, straight.state)


def test_interrupt_checkpoints_at_its_batch_id(stream_folder, monkeypatch,
                                               capsys):
    class StopAfter:
        """Stands in for GracefulInterrupt: set at the second check (the
        loop checks once a chunk)."""

        def __init__(self):
            self.checks = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def __bool__(self):
            self.checks += 1
            return self.checks >= 2

    monkeypatch.setattr(stream, "GracefulInterrupt", StopAfter)
    ctx = port_train(resident_cfg(Config, stream_folder, interval=3))
    out = capsys.readouterr().out
    assert "Interrupted at batch 6; checkpointing." in out
    assert re.search(r"Resident stream e2e: 6 batches in", out)
    ckpts = sorted(p.name for p in ctx.workspace.checkpoint_dir.glob("*.npz"))
    assert ckpts == ["ckpt_00003.npz", "ckpt_00006.npz"]
    state, meta = restore_checkpoint(
        ctx.workspace.checkpoint_dir / "ckpt_00006.npz", ctx.state)
    assert meta["batch_id"] == 6 and state.step == 6
    # every trained batch's loss was drained before the checkpoint
    assert sorted(batch_losses(ctx.workspace.log_dir)) == list(range(6))


# --------------------------------------------------------- the boundaries

def test_async_boundary_writer_matches_the_synchronous_one(stream_folder):
    runs = {}
    for mode in (True, False):
        cfg = resident_cfg(Config, stream_folder, batches=20, interval=8,
                           hist=4, async_checkpoint=mode)
        cfg.extra.description = f"async_{mode}"
        runs[mode] = port_train(cfg)
    a, b = runs[True], runs[False]
    _same_state(a.state, b.state)
    names = sorted(p.name for p in a.workspace.checkpoint_dir.glob("*.npz"))
    assert names == sorted(
        p.name for p in b.workspace.checkpoint_dir.glob("*.npz"))
    assert names == ["ckpt_00008.npz", "ckpt_00016.npz", "ckpt_00020.npz"]
    for name in names:
        assert (a.workspace.checkpoint_dir / name).read_bytes() == \
            (b.workspace.checkpoint_dir / name).read_bytes()
    for model in ("best_model.npz", "last_model.npz"):
        assert (a.workspace.model_dir / model).read_bytes() == \
            (b.workspace.model_dir / model).read_bytes()


def test_best_gate_sees_real_losses(stream_folder):
    import json

    ctx = port_train(resident_cfg(Config, stream_folder, batches=24,
                                  interval=8))
    assert np.isfinite(ctx.best_loss) and ctx.best_loss > 0.0
    metas = sorted(ctx.workspace.checkpoint_dir.glob("ckpt_*.json"))
    best = [json.loads(m.read_text()).get("best_loss") for m in metas]
    assert len(best) == 3 and all(b is not None and b > 0.0 for b in best)
    assert len(batch_losses(ctx.workspace.log_dir)) == 24
    out = ctx.workspace.console_log_path.read_text()
    assert re.search(r"Resident stream e2e: 24 batches in [\d.]+s = "
                     r"[\d,]+ frames/s", out)
    recs = sorted(p.name for p in
                  ctx.workspace.audio_log_dir.glob("test_reconst_*.wav"))
    assert recs == ["test_reconst_00008.wav", "test_reconst_00016.wav",
                    "test_reconst_00024.wav"]


# --------------------------------------------------------------- the gate

def test_always_over_budget_raises(stream_folder):
    cfg = resident_cfg(Config, stream_folder, batches=4,
                       resident_budget_gb=1e-9)
    with pytest.raises(ValueError, match="device_resident=always") as err:
        port_train(cfg)
    assert "samples layout" in str(err.value)
    assert "does not fit" in str(err.value)
    cfg = resident_cfg(Config, stream_folder, batches=4,
                       microbatch_size=BATCH // 2)
    with pytest.raises(ValueError, match="microbatch_size"):
        port_train(cfg)


def test_the_layout_aware_gate_trains_resident_where_jax_would_not(
        stream_folder, capsys):
    """A budget between the samples layout's size and the frames
    layout's: the port trains resident in the samples layout; the JAX gate
    sizes the frames matrix whatever the layout and raises."""
    samples_need = 4 * SAMPLES + 4 * N_FRAMES
    frames_need = 4 * N_FRAMES * SEG
    budget_gb = (samples_need + frames_need) / 2 / (1 << 30)
    ctx = port_train(resident_cfg(Config, stream_folder, batches=3,
                                  resident_budget_gb=budget_gb))
    assert "samples layout), 3 steps/dispatch" in capsys.readouterr().out
    assert ctx.state.step == 3
    with pytest.raises(ValueError, match="device_resident=always"):
        jax_resident(resident_cfg(JConfig, stream_folder, batches=3,
                                  resident_budget_gb=budget_gb))
    # the frames layout does not fit that budget: auto trains host-fed
    cfg = resident_cfg(Config, stream_folder, batches=3, layout="frames",
                       resident_budget_gb=budget_gb)
    cfg.tpu.device_resident = "auto"
    port_train(cfg)
    out = capsys.readouterr().out
    assert "Device-resident" not in out
    assert "frames layout" in out and "does not fit" in out
    assert "training host-fed" in out


def test_the_card_caps_the_budget_by_its_free_memory(stream_folder,
                                                     monkeypatch):
    _, ds = _datasets(stream_folder)
    cfg = resident_cfg(Config, stream_folder, resident_budget_gb=4.0)
    free = stream.RESIDENT_STEP_BYTES + 10_000
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 << 30))
    plan = stream.resident_plan(ds, cfg, torch.device("cuda"))
    assert plan.budget_bytes == 10_000 and not plan.fits
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 << 30, 80 << 30))
    plan = stream.resident_plan(ds, cfg, torch.device("cuda"))
    assert plan.budget_bytes == 4 << 30 and plan.fits
