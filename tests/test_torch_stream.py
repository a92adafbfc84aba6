"""The port's streaming dataset and streaming trainer
(rawaudiovae_kelsey_tpu_torch/data/datasets.py ``StreamingFrameDataset``,
train/stream.py) against the JAX package's, on a scratch folder of five
wavs of unequal length — one shorter than a segment, one at another sample
rate — on the CPU.

The dataset is numpy on both sides and seeded alike, so its batches are
held bit for bit.  For the trainers to be comparable both start from the
JAX init and the port's step gets the threefry ``eps`` the JAX step draws
(as tests/test_torch_train_e2e.py does), at ``precision = highest``,
``backend = xla``.  The JAX trainer runs host-fed over the test suite's 8
virtual CPU devices; batch 32 divides that mesh.

Tolerances: per-batch losses rel 1e-5 and final params atol 1e-5 over 12
coupled fp32 steps.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu.data.datasets import (
    StreamingFrameDataset as JStreamingFrameDataset,
)
from rawaudiovae_kelsey_tpu_torch.config import Config, load_config
from rawaudiovae_kelsey_tpu_torch.data.datasets import (
    StreamingFrameDataset,
    _rebatch,
)
from rawaudiovae_kelsey_tpu_torch.io import write_wav
from rawaudiovae_kelsey_tpu_torch.train import restore_checkpoint, stream

SEG, HOP, UNITS, LATENT, BATCH, SEED, SR = 64, 16, 96, 16, 32, 0, 44100
# samples (rate) per training file; frames: 41, 29, 0, 110, 18 = 198
FILES = [(700, SR), (500, SR), (40, SR), (900, SR // 2), (333, SR)]
N_FRAMES = 198
LOSS_REL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture
def stream_folder(tmp_path):
    rng = np.random.default_rng(7)
    (tmp_path / "audio").mkdir()
    (tmp_path / "test_audio").mkdir()
    for i, (n, sr) in enumerate(FILES):
        wave = (0.5 * np.sin(np.linspace(0, 9 * (i + 1), n))
                + 0.1 * rng.standard_normal(n)).astype(np.float32)
        write_wav(tmp_path / "audio" / f"train{i}.wav", wave, sr)
    for i in range(2):
        wave = rng.uniform(-0.3, 0.3, 300).astype(np.float32)
        write_wav(tmp_path / "test_audio" / f"test{i}.wav", wave, SR)
    return tmp_path


def _datasets(folder, **kw):
    args = (folder / "audio", SR, HOP, SEG)
    kw = dict(shuffle=True, mono="first", seed=SEED, **kw)
    return JStreamingFrameDataset(*args, **kw), StreamingFrameDataset(
        *args, **kw)


# --------------------------------------------------------------- the dataset

@pytest.mark.parametrize("workers", [0, 2])
def test_batches_equal_the_jax_dataset_bit_for_bit(stream_folder, workers):
    jds, ds = _datasets(stream_folder, decode_workers=workers)
    n = 3 * N_FRAMES // BATCH      # the first three passes over the folder
    want = list(itertools.islice(jds.batches(BATCH), n))
    got = list(itertools.islice(ds.batches(BATCH), n))
    assert len(got) == n == 18
    for g, w in zip(got, want):
        assert g.shape == (BATCH, SEG) and g.dtype == np.float32
        assert g.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(g, w)
    # passes differ (the file list is reshuffled) and batches cross files
    assert not np.array_equal(got[0], got[6])


def test_index_batches_equal_the_jax_dataset_and_replay_the_stream(
        stream_folder):
    jds, ds = _datasets(stream_folder)
    n = 3 * N_FRAMES // BATCH
    want = list(itertools.islice(jds.index_batches(BATCH), n))
    got = list(itertools.islice(ds.index_batches(BATCH), n))
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    # the index plan consumes the shuffle as the audio stream does: a fresh
    # dataset's audio batches are all_frames()[index batches]
    _, fresh = _datasets(stream_folder)
    frames = fresh.all_frames()
    assert frames.shape == (N_FRAMES, SEG)
    for idx, batch in zip(got, itertools.islice(fresh.batches(BATCH), n)):
        np.testing.assert_array_equal(frames[idx], batch)


def test_frame_counts_and_all_samples_reproduce_all_frames(stream_folder):
    jds, ds = _datasets(stream_folder)
    assert ds.frame_counts() == jds.frame_counts() == [41, 29, 0, 110, 18]
    frames = ds.all_frames()
    np.testing.assert_array_equal(frames, jds.all_frames())
    samples, starts = ds.all_samples()
    jsamples, jstarts = jds.all_samples()
    np.testing.assert_array_equal(samples, jsamples)
    np.testing.assert_array_equal(starts, jstarts)
    assert starts.dtype == np.int32 and len(starts) == N_FRAMES
    windows = samples[starts[:, None] + np.arange(SEG)[None, :]]
    np.testing.assert_array_equal(windows, frames)
    # the samples layout is hop/segment of the frames' footprint
    assert samples.nbytes < frames.nbytes / 3


def test_cache_stays_under_its_budget_and_releases(stream_folder):
    budget = 9000   # two of the decoded files, not all four
    ds = StreamingFrameDataset(stream_folder / "audio", SR, HOP, SEG,
                               seed=SEED, decode_workers=0,
                               cache_budget_bytes=budget)
    want = list(itertools.islice(
        _datasets(stream_folder)[0].batches(BATCH), 12))
    for got, w in zip(itertools.islice(ds.batches(BATCH), 12), want):
        np.testing.assert_array_equal(got, w)   # eviction changes nothing
        assert ds._cache_used <= budget
        assert ds._cache_used == sum(
            ds._frames_bytes(f) for f in ds._cache.values())
    assert 0 < len(ds._cache) < 4
    ds.release_cache()
    assert ds._cache_used == 0 and not ds._cache


def test_too_short_and_empty_folders_raise(tmp_path):
    (tmp_path / "audio").mkdir()
    ds = StreamingFrameDataset(tmp_path / "audio", SR, HOP, SEG, seed=0)
    with pytest.raises(FileNotFoundError, match="no wav files"):
        next(ds.batches(4))
    for i in range(3):
        write_wav(tmp_path / "audio" / f"s{i}.wav",
                  np.zeros(SEG - HOP - 1, np.float32), SR)
    for workers in (0, 2):
        ds = StreamingFrameDataset(tmp_path / "audio", SR, HOP, SEG, seed=0,
                                   decode_workers=workers)
        with pytest.raises(FileNotFoundError, match="shorter than one"):
            next(ds.batches(4))
    with pytest.raises(FileNotFoundError):
        ds.all_frames()
    with pytest.raises(FileNotFoundError):
        ds.all_samples()
    with pytest.raises(FileNotFoundError):
        next(ds.index_plan())


def test_rebatch_crosses_input_boundaries():
    parts = [np.arange(5), np.arange(5, 7), np.arange(7, 20)]
    got = list(_rebatch(iter(parts), 6))
    assert [g.tolist() for g in got] == [list(range(6)), list(range(6, 12)),
                                         list(range(12, 18))]


# --------------------------------------------------------------- the trainer

def small_cfg(cfg, folder, batches=12, interval=0, hist=0):
    cfg.dataset.datapath = str(folder)
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = HOP
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.training.batch_size = BATCH
    cfg.training.total_num_frames = batches * BATCH
    cfg.training.checkpoint_interval = interval
    cfg.training.learning_rate = 1e-3
    cfg.extra.description = "stream_test"
    cfg.tpu.seed = SEED
    cfg.tpu.precision = "highest"
    cfg.tpu.backend = "xla"
    cfg.tpu.histogram_interval = hist
    cfg.tpu.device_resident = "never"
    return cfg


def jax_eps(step, i, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    if i is not None:
        key = jax.random.fold_in(key, i)
    return torch.from_numpy(np.array(
        jax.random.normal(key, shape, dtype=jnp.float32)))


@pytest.fixture
def jax_parity(monkeypatch):
    """The port's trainer starts from the JAX trainer's initial weights and
    builds its step with the JAX package's noise."""
    from rawaudiovae_kelsey_tpu.models import vae as jvae
    from rawaudiovae_kelsey_tpu_torch.compat import params_from_jax
    from rawaudiovae_kelsey_tpu_torch.models import registry
    from rawaudiovae_kelsey_tpu_torch.parallel import step
    from rawaudiovae_kelsey_tpu_torch.train import loop

    def build_model(cfg, device):
        model = registry.build_model(cfg, device)
        params = jax.device_get(jvae.init_dense(
            jax.random.PRNGKey(cfg.tpu.seed), SEG, UNITS, LATENT))
        return dataclasses.replace(
            model, init=lambda _g: params_from_jax(params, device))

    monkeypatch.setattr(loop, "build_model", build_model)
    monkeypatch.setattr(loop, "build_train_step", functools.partial(
        step.build_train_step, noise=jax_eps))


def port_train(cfg):
    return stream.train(cfg, verbose=True, device="cpu")


def jax_train(cfg):
    from rawaudiovae_kelsey_tpu.train.stream import train

    return train(cfg, verbose=False)


def batch_losses(log_dir):
    loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    out = {}
    for f in sorted(log_dir.glob("events.out.tfevents.*")):
        for e in loader.LegacyEventFileLoader(str(f)).Load():
            for v in e.summary.value:
                if v.tag == "Loss/Batch":
                    out[e.step] = v.simple_value
    return out


def _losses_close(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=LOSS_REL), k


def _params_close(ctx, jctx):
    want = jax.device_get(jctx.state.params)
    for name, layer in ctx.state.params.items():
        for k, t in layer.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[name][k]),
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name}.{k}")


def test_stream_trainer_full_contract(stream_folder, capsys):
    cfg = small_cfg(Config(), stream_folder, interval=4, hist=4)
    ctx = port_train(cfg)
    ws = ctx.workspace
    out = capsys.readouterr().out
    assert "Total number of batches: 12" in out
    assert "Batch 0/12 - Cumulative loss:" in out
    assert "Checkpoint - Batch 4 (" in out and "Checkpoint - Batch 8 (" in out
    assert "Last Checkpoint - Batch 12" in out
    # stdout is teed to the run's console log (train_iterable.py:117-133)
    assert "Total number of batches: 12" in ws.console_log_path.read_text()
    # checkpoints keyed on batch_id, plus the final one; best / last models
    assert sorted(p.name for p in ws.checkpoint_dir.glob("ckpt_*.npz")) == [
        "ckpt_00004.npz", "ckpt_00008.npz", "ckpt_00012.npz"]
    state, meta = restore_checkpoint(ws.checkpoint_dir / "ckpt_00008.npz",
                                     ctx.state)
    assert meta["batch_id"] == 8 and meta["step"] == state.step == 9
    assert np.isfinite(meta["best_loss"])
    assert (ws.model_dir / "best_model.npz").exists()
    assert (ws.model_dir / "last_model.npz").exists()
    names = sorted(r.name for r in ws.audio_log_dir.glob("test_reconst_*"))
    assert names == ["test_reconst_00004.wav", "test_reconst_00008.wav",
                     "test_reconst_00012.wav"]
    losses = batch_losses(ws.log_dir)
    assert sorted(losses) == list(range(12))
    assert all(np.isfinite(v) for v in losses.values())
    assert ctx.state.step == 12
    snap = load_config(ws.config_path)
    assert snap.dataset.total_frames == str(12 * BATCH)
    assert snap.extra.end


def test_loss_history_and_params_match_the_jax_stream_trainer(stream_folder,
                                                              jax_parity):
    jctx = jax_train(small_cfg(JConfig(), stream_folder))
    ctx = port_train(small_cfg(Config(), stream_folder))
    want = batch_losses(jctx.workspace.log_dir)
    assert len(want) == 12
    _losses_close(batch_losses(ctx.workspace.log_dir), want)
    _params_close(ctx, jctx)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_stream_checkpoint_resumes_across_packages(stream_folder, jax_parity,
                                                   first):
    """Six batches in one package (its last checkpoint carries ``batch_id``
    6), then ``resume`` in the other up to twelve: the resumed run skips
    the first six batches of the stream, logs the losses a straight
    twelve-batch JAX run logs for batches 6-11, and ends at its params."""
    straight = jax_train(small_cfg(JConfig(), stream_folder))
    want = {k: v for k, v in batch_losses(straight.workspace.log_dir).items()
            if k >= 6}
    runs = {"jax": (JConfig, jax_train), "port": (Config, port_train)}
    cls, run = runs[first]
    half = run(small_cfg(cls(), stream_folder, batches=6))
    meta_path = half.workspace.checkpoint_dir / "ckpt_00006.json"
    assert '"batch_id": 6' in meta_path.read_text()
    cls, run = runs["port" if first == "jax" else "jax"]
    cfg = small_cfg(cls(), stream_folder)
    cfg.training.resume = True
    resumed = run(cfg)
    assert resumed.start_step == 6
    _losses_close(batch_losses(resumed.workspace.log_dir), want)
    if first == "jax":
        _params_close(resumed, straight)
    else:
        got = jax.device_get(resumed.state.params)
        ref = jax.device_get(straight.state.params)
        for name in ref:
            for k in ref[name]:
                np.testing.assert_allclose(got[name][k], ref[name][k],
                                           atol=PARAM_ATOL, rtol=0)


def test_resume_past_the_budget_does_nothing(stream_folder, capsys):
    port_train(small_cfg(Config(), stream_folder, batches=3))
    cfg = small_cfg(Config(), stream_folder, batches=3)
    cfg.training.resume = True
    ctx = port_train(cfg)
    assert "Nothing to do" in capsys.readouterr().out
    assert ctx.state.step == 3


# ------------------------------------------------------------------ the gate

def test_resident_gate_auto_trains_host_fed_and_says_so(stream_folder,
                                                        capsys):
    """``auto`` trains resident where the plan fits, and host-fed where it
    does not, printing the plan."""
    cfg = small_cfg(Config(), stream_folder, batches=2)
    cfg.tpu.device_resident = "auto"
    ctx = port_train(cfg)
    out = capsys.readouterr().out
    # the gate sized the layout it picks: overlapping windows → samples
    assert (f"Device-resident stream: {N_FRAMES} frames" in out
            and "samples layout" in out)
    assert "training host-fed" not in out
    assert ctx.state.step == 2
    cfg = small_cfg(Config(), stream_folder, batches=2)
    cfg.tpu.device_resident = "auto"
    cfg.tpu.resident_budget_gb = 1e-6
    ctx = port_train(cfg)
    out = capsys.readouterr().out
    assert "device_resident=auto" in out and "training host-fed" in out
    assert f"{N_FRAMES} frames, samples layout" in out
    assert "does not fit" in out and "Device-resident" not in out
    assert ctx.state.step == 2


def test_resident_gate_always_raises_naming_the_roadmap(stream_folder):
    """``always`` raises, naming the plan, where the stream does not fit;
    where it fits, it trains resident."""
    cfg = small_cfg(Config(), stream_folder, batches=2)
    cfg.tpu.device_resident = "always"
    cfg.tpu.resident_budget_gb = 1e-6
    with pytest.raises(ValueError, match="samples layout.*does not fit"):
        port_train(cfg)
    cfg = small_cfg(Config(), stream_folder, batches=2)
    cfg.tpu.device_resident = "always"
    assert port_train(cfg).state.step == 2


def test_resident_plan_sizes_the_layout_it_would_pick(stream_folder):
    _, ds = _datasets(stream_folder)
    cfg = small_cfg(Config(), stream_folder)
    cpu = torch.device("cpu")
    samples = 704 + 512 + 1808 + 336      # hop-padded, usable files only
    assert stream._estimate_stream_frames(ds, cfg) == (N_FRAMES, samples)
    plan = stream.resident_plan(ds, cfg, cpu)
    assert plan.layout == "samples" and plan.frames == N_FRAMES
    assert plan.need_bytes == 4 * samples + 4 * N_FRAMES and plan.fits
    cfg.tpu.resident_layout = "frames"
    plan = stream.resident_plan(ds, cfg, cpu)
    assert plan.layout == "frames"
    assert plan.need_bytes == 4 * N_FRAMES * SEG
    cfg.tpu.precision = "bfloat16"
    assert stream.resident_plan(ds, cfg, cpu).need_bytes == \
        2 * N_FRAMES * SEG
    # the budget decides: here, off the card, resident_budget_gb
    cfg.tpu.resident_budget_gb = 1e-6
    assert not stream.resident_plan(ds, cfg, cpu).fits
    cfg.tpu.resident_budget_gb = 4.0
    cfg.tpu.microbatch_size = BATCH // 2    # the resident step can't do it
    assert not stream.resident_plan(ds, cfg, cpu).fits


# -------------------------------------------------------------- the interrupt

def test_interrupt_checkpoints_at_the_current_batch_id(stream_folder,
                                                       monkeypatch, capsys):
    class StopAfter:
        """Stands in for GracefulInterrupt: set after the fourth check."""

        def __init__(self):
            self.checks = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def __bool__(self):
            self.checks += 1
            return self.checks >= 4

    monkeypatch.setattr(stream, "GracefulInterrupt", StopAfter)
    ctx = port_train(small_cfg(Config(), stream_folder))
    assert "Interrupted at batch 3; checkpointing." in capsys.readouterr().out
    ckpts = sorted(p.name for p in ctx.workspace.checkpoint_dir.glob("*.npz"))
    assert ckpts == ["ckpt_00003.npz"]
    state, meta = restore_checkpoint(
        ctx.workspace.checkpoint_dir / "ckpt_00003.npz", ctx.state)
    assert meta["batch_id"] == 3 and state.step == 4
    # every trained batch's loss was drained before the checkpoint
    assert sorted(batch_losses(ctx.workspace.log_dir)) == [0, 1, 2, 3]


def test_stream_commands_refuse_to_start_without_a_card(monkeypatch):
    from rawaudiovae_kelsey_tpu_torch.eval import cli as eval_cli
    from rawaudiovae_kelsey_tpu_torch.train import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main_stream(["--config", "nowhere.ini"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        eval_cli.main(["--run", "nowhere"])
