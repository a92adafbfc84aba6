"""The port's epoch trainer (rawaudiovae_kelsey_tpu_torch/train/epoch.py) on
a scratch wav dataset, on the CPU: the workspace contract of
tests/test_train_e2e.py, the same ``Loss/Batch`` history as the JAX
trainer, and checkpoints that resume across the two packages.

For the histories to be comparable both trainers see the same batches —
the same corpus, ``np.random.default_rng(seed + epoch)`` shuffles — and
the same initial weights and the same noise: the port's trainer starts
from the JAX init (``init_dense(PRNGKey(seed))``) and its step gets the
threefry ``eps`` the JAX step draws (``fold_in(fold_in(PRNGKey(seed),
step), i)``), both injected.  The JAX
trainer runs host-fed (``device_resident = never``) over the test suite's
8 virtual CPU devices; the corpus gives 80 frames, so with batch 32 the
ragged last batch (16 rows) divides the mesh and is not wrap-padded.

Tolerance: the losses of ``highest`` steps agree to rel 1e-5 after one
step (tests/test_torch_train_step.py); over the ~10 coupled steps here the
fp32 differences compound slowly, and the per-batch losses are held at rel
1e-4 (measured ≤ 3.5e-7).
"""

import dataclasses
from pathlib import Path
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawaudiovae_kelsey_tpu.config import Config as JConfig
from rawaudiovae_kelsey_tpu_torch.config import Config, load_config
from rawaudiovae_kelsey_tpu_torch.io import read_wav, write_wav

SEG, HOP, UNITS, LATENT, BATCH, SEED = 512, 128, 64, 16, 32, 0
LOSS_REL = 1e-4


@pytest.fixture
def scratch_dataset(tmp_path):
    """80 training frames (10624 samples), 6000 test samples."""
    rng = np.random.default_rng(7)
    (tmp_path / "audio").mkdir()
    (tmp_path / "test_audio").mkdir()
    for i, n in enumerate((3000, 3500, 4124)):
        wave = (0.5 * np.sin(np.linspace(0, 50 * (i + 1), n))
                ).astype(np.float32)
        write_wav(tmp_path / "audio" / f"train{i}.wav", wave, 44100)
    for i in range(2):
        wave = rng.uniform(-0.3, 0.3, 3000).astype(np.float32)
        write_wav(tmp_path / "test_audio" / f"test{i}.wav", wave, 44100)
    return tmp_path


def small_cfg(cfg, tmp_path, epochs=4, interval=2):
    cfg.dataset.datapath = str(tmp_path)
    cfg.audio.segment_length = SEG
    cfg.audio.hop_length = HOP
    cfg.vae.n_units = UNITS
    cfg.vae.latent_dim = LATENT
    cfg.training.batch_size = BATCH
    cfg.training.epochs = epochs
    cfg.training.checkpoint_interval = interval
    cfg.training.save_best_model_after = 0
    cfg.training.learning_rate = 1e-3
    cfg.extra.description = "e2e_test"
    cfg.tpu.seed = SEED
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
    """The port's trainer starts from the JAX trainer's initial weights
    (``init(PRNGKey(seed))``) and builds its step with the JAX package's
    noise."""
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
    from rawaudiovae_kelsey_tpu_torch.train.epoch import train

    return train(cfg, verbose=False, device="cpu")


def jax_train(cfg):
    from rawaudiovae_kelsey_tpu.train.epoch import train

    return train(cfg, verbose=False)


def batch_losses(log_dir):
    """``Loss/Batch`` scalars of a run, {step: value}, read with the
    official TensorBoard reader."""
    loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    out = {}
    for f in sorted(log_dir.glob("events.out.tfevents.*")):
        for e in loader.LegacyEventFileLoader(str(f)).Load():
            for v in e.summary.value:
                if v.tag == "Loss/Batch":
                    out[e.step] = v.simple_value
    return out


def _close(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=LOSS_REL), k


def test_epoch_trainer_full_contract(scratch_dataset):
    cfg = small_cfg(Config(), scratch_dataset)
    ctx = port_train(cfg)
    ws = ctx.workspace

    # workspace layout (train.py:93-149, tests.py:17-18)
    assert ws.workdir.name == "run-000"
    assert (ws.workdir / "config.ini").exists()
    assert ws.checkpoint_dir.is_dir()
    assert ws.log_dir.is_dir()
    assert ws.audio_log_dir.is_dir()

    # config mutated + persisted (train.py:109,130,304-305)
    snap = load_config(ws.config_path)
    assert snap.dataset.workspace == str(ws.workdir.resolve())
    assert int(snap.dataset.total_frames) > 0
    assert snap.vae.device_name == "cpu"
    assert snap.extra.start and snap.extra.end and snap.extra.time_elapsed

    # eval fixture (tests.py:24-41)
    assert (ws.audio_log_dir / "test_audio.txt").exists()
    orig, sr = read_wav(ws.audio_log_dir / "test_original.wav")
    assert sr == 44100 and len(orig) == 6000

    # periodic + final reconstructions (train.py:218-237, 261-286)
    names = [r.name for r in sorted(ws.audio_log_dir.glob("test_reconst_*"))]
    assert names == ["test_reconst_00002.wav", "test_reconst_00004.wav"]
    rec, _ = read_wav(ws.audio_log_dir / names[-1])
    assert np.abs(rec).max() > 0 and len(rec) == 12 * SEG

    # checkpoints + best/last models; a TB event file with every batch
    assert sorted(p.name for p in ws.checkpoint_dir.glob("ckpt_*")) == [
        "ckpt_00002.json", "ckpt_00002.npz", "ckpt_00004.json",
        "ckpt_00004.npz"]
    assert (ws.model_dir / "best_model.npz").exists()
    assert (ws.model_dir / "last_model.npz").exists()
    losses = batch_losses(ws.log_dir)
    assert sorted(losses) == list(range(12))     # 4 epochs x 3 batches
    assert all(np.isfinite(v) for v in losses.values())
    assert ctx.state.step == 12


def test_missing_test_dir_raises(scratch_dataset):
    import shutil

    shutil.rmtree(scratch_dataset / "test_audio")
    with pytest.raises(FileNotFoundError):
        port_train(small_cfg(Config(), scratch_dataset))


@pytest.mark.parametrize("key,value", [
    ("multihost", True),
    ("data_parallel", 2), ("model_parallel", 2),
    ("checkpoint_format", "orbax")])
def test_unported_trainer_options_raise(scratch_dataset, key, value,
                                        monkeypatch, tmp_path):
    """Once options the port lacked (``model_parallel > 1`` and orbax
    raised naming ROADMAP.md); every one now trains: ``multihost`` joins
    the group torchrun's environment names (one rank here);
    ``data_parallel = 2`` and ``model_parallel = 2`` train on two ranks
    (CPU processes on gloo, tests/torch_ranks.py) and one rank alone
    refuses them; ``checkpoint_format = orbax`` writes the port's sharded
    directories."""
    import socket

    import torch.distributed as dist

    import torch_ranks

    cfg = small_cfg(Config(), scratch_dataset, epochs=1, interval=0)
    setattr(cfg.tpu, key, value)
    if key == "multihost":
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        for name, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                        ("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", str(port))):
            monkeypatch.setenv(name, v)
        try:
            ctx = port_train(cfg)
            assert dist.is_initialized() and dist.get_world_size() == 1
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        assert ctx.state.step == 3 and ctx.mesh is None
    elif key in ("data_parallel", "model_parallel"):
        with pytest.raises(ValueError, match="not part of a group"):
            port_train(cfg)
        runs = torch_ranks.launch(torch_ranks.train_cfg, 2, tmp_path, cfg)
        assert runs[0] == runs[1]
        step, workdir = runs[0]
        # a mesh drops a short last batch: two data ranks take 1 full
        # global batch, two model ranks of one data index the 2 full ones
        # of the 3
        assert step == (1 if key == "data_parallel" else 2)
        assert workdir.endswith("run-000")
        assert (Path(workdir) / "model" / "last_model.npz").is_file()
    else:
        ctx = port_train(cfg)
        assert ctx.state.step == 3
        found = sorted(p.name for p in ctx.workspace.checkpoint_dir.iterdir())
        assert found == ["orbax_00001"]
        assert (ctx.workspace.checkpoint_dir / "orbax_00001" /
                "index.json").is_file()


def test_loss_history_matches_the_jax_trainer(scratch_dataset, jax_parity):
    jctx = jax_train(small_cfg(JConfig(), scratch_dataset, epochs=3,
                               interval=0))
    ctx = port_train(small_cfg(Config(), scratch_dataset, epochs=3,
                               interval=0))
    want = batch_losses(jctx.workspace.log_dir)
    assert len(want) == 9
    _close(batch_losses(ctx.workspace.log_dir), want)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(scratch_dataset, jax_parity,
                                            first):
    """Two epochs in one package, then ``resume`` in the other for a third:
    the resumed epoch's losses are the ones a straight three-epoch JAX run
    logs."""
    straight = jax_train(small_cfg(JConfig(), scratch_dataset, epochs=3,
                                   interval=0))
    want = {k: v for k, v in batch_losses(straight.workspace.log_dir).items()
            if k >= 6}
    runs = {"jax": (JConfig, jax_train), "port": (Config, port_train)}
    cls, run = runs[first]
    run(small_cfg(cls(), scratch_dataset, epochs=2, interval=0))
    cls, run = runs["port" if first == "jax" else "jax"]
    cfg = small_cfg(cls(), scratch_dataset, epochs=3, interval=0)
    cfg.training.resume = True
    resumed = run(cfg)
    assert resumed.start_step == 6
    _close(batch_losses(resumed.workspace.log_dir), want)
