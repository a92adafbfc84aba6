"""The port's trainers on 2 CPU ranks over gloo, end to end
(tests/torch_ranks.py): the epoch trainer (train/epoch.py) host-fed and
resident, the stream (train/stream.py) host-fed and resident, and the
``train`` command starting its own ranks — the counterparts of the JAX
package's multihost tests (tests/test_multihost.py:72, :146, :252, :423),
with a rank for a JAX process.

Each rank reads its own file shard of a 4-file folder of uneven sizes
(the ranks' corpora differ), and the checks are the JAX tests': one
``run-NNN`` for both ranks, written by rank 0 alone (TensorBoard,
checkpoints, wavs, the best and last models, the config); replicas equal
bit for bit; ``--resume`` on both ranks from rank 0's checkpoint; a stop
flag raised on rank 1 alone stops both at the same step; the stream's
resident run gives the host-fed run's losses bit for bit (JAX
``:252-289`` holds it at rtol 1e-4: here both engines feed a rank the same
rows to the same step).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_ranks as R
from rawaudiovae_kelsey_tpu_torch.config import Config, save_config
from rawaudiovae_kelsey_tpu_torch.io import write_wav

REPO = Path(__file__).resolve().parents[1]


def batch_losses(log_dir):
    """``Loss/Batch`` scalars of a run, {step: value}, read with the
    official TensorBoard reader."""
    loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    out = {}
    for f in sorted(Path(log_dir).glob("events.out.tfevents.*")):
        for e in loader.LegacyEventFileLoader(str(f)).Load():
            for v in e.summary.value:
                if v.tag == "Loss/Batch":
                    out[e.step] = v.simple_value
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp")
    (root / "audio").mkdir()
    (root / "test_audio").mkdir()
    rng = np.random.default_rng(7)
    # 4 files of different sizes: the two ranks' shards differ
    for i, n in enumerate([11000, 7000, 15000, 5000]):
        write_wav(root / "audio" / f"t{i}.wav",
                  rng.uniform(-0.5, 0.5, n).astype(np.float32), 44100)
    write_wav(root / "test_audio" / "x.wav",
              rng.uniform(-0.3, 0.3, 3000).astype(np.float32), 44100)
    return root


def _one_writer(runs):
    """Both ranks in one workspace, and only rank 0 wrote to it."""
    r0, r1 = runs
    assert r0["workdir"] == r1["workdir"]
    assert r1["writer"] is None and r0["writer"] is not None
    ws = Path(r0["workdir"])
    assert [p.name for p in (ws / "logs").glob("events.*")] == [
        Path(r0["writer"]).name]
    for name in r0["params"]:
        np.testing.assert_array_equal(r0["params"][name],
                                      r1["params"][name])
    assert r0["step"] == r1["step"]
    return ws


def _artifacts(ws):
    ckpts = sorted(p.name for p in (ws / "model" / "checkpoints").glob(
        "ckpt_*.npz"))
    assert not list(ws.rglob("*.tmp*"))
    assert (ws / "config.ini").is_file()
    assert (ws / "model" / "best_model.npz").is_file()
    assert (ws / "model" / "last_model.npz").is_file()
    return ckpts, sorted(p.name for p in (ws / "audio_logs").glob(
        "test_reconst_*.wav"))


@pytest.fixture(scope="module")
def epoch_runs(corpus, tmp_path_factory):
    never = {"tpu": {"device_resident": "never"}}
    always = {"tpu": {"device_resident": "always"},
              "extra": {"description": "mp_epoch_res"}}
    jobs = [
        ("trainer_run", (corpus, "epoch", never)),
        ("trainer_run", (corpus, "epoch", {
            **never, "training": {"epochs": 4, "resume": True}})),
        ("trainer_run", (corpus, "epoch", always)),
        ("trainer_run", (corpus, "epoch", {
            "tpu": {"device_resident": "never"},
            "extra": {"description": "mp_epoch_stop"}}, (1, 5))),
        # checkpoints every epoch: a group ends after epoch 1, where the
        # flag is read
        ("trainer_run", (corpus, "epoch", {
            "tpu": {"device_resident": "always"},
            "training": {"checkpoint_interval": 1},
            "extra": {"description": "mp_epoch_res_stop"}}, (1, 1))),
    ]
    return R.launch(R.run_jobs, 2, tmp_path_factory.mktemp("epoch"), jobs)


def _job(runs, i):
    return [r[i] for r in runs]


def test_epoch_trainer_host_fed_writes_one_workspace_from_rank_0(epoch_runs):
    runs = _job(epoch_runs, 0)
    ws = _one_writer(runs)
    ckpts, wavs = _artifacts(ws)
    # 3 epochs of the smallest rank's full batches of 8 rows
    n_batches = runs[0]["step"] // 3
    assert runs[0]["step"] == 3 * n_batches and n_batches > 0
    assert ckpts == ["ckpt_00002.npz", "ckpt_00003.npz"]
    assert wavs == ["test_reconst_00002.wav", "test_reconst_00003.wav"]
    losses = batch_losses(ws / "logs")
    assert sorted(losses) == list(range(3 * n_batches))
    assert all(np.isfinite(v) for v in losses.values())


def test_epoch_trainer_resumes_on_every_rank(epoch_runs):
    first, resumed = _job(epoch_runs, 0), _job(epoch_runs, 1)
    ws = _one_writer(resumed)
    assert ws != Path(first[0]["workdir"])
    n_batches = first[0]["step"] // 3
    # both ranks restored epoch 3's checkpoint and trained one more epoch
    assert resumed[0]["step"] == resumed[1]["step"] == 4 * n_batches
    assert resumed[0]["steps_taken"] == resumed[1]["steps_taken"] \
        == n_batches
    assert sorted(batch_losses(ws / "logs")) == list(
        range(3 * n_batches, 4 * n_batches))


def test_epoch_trainer_resident_shards_the_frames(epoch_runs):
    runs = _job(epoch_runs, 2)
    ws = _one_writer(runs)
    ckpts, _ = _artifacts(ws)
    assert ckpts == ["ckpt_00002.npz", "ckpt_00003.npz"]
    losses = batch_losses(ws / "logs")
    n_batches = runs[0]["step"] // 3
    # the wrap-padded matrix over the global batch of 16
    assert sorted(losses) == list(range(3 * n_batches))
    assert runs[0]["steps_taken"] == runs[1]["steps_taken"] == runs[0][
        "step"]


@pytest.mark.parametrize("job", [3, 4], ids=["host-fed", "resident"])
def test_epoch_trainer_stops_every_rank_on_one_ranks_flag(epoch_runs, job):
    full = _job(epoch_runs, 0 if job == 3 else 2)[0]["step"]
    runs = _job(epoch_runs, job)
    ws = _one_writer(runs)
    assert 0 < runs[0]["step"] < full
    ckpts = sorted(p.name for p in (ws / "model" / "checkpoints").glob(
        "ckpt_*.npz"))
    assert len(ckpts) == 1                      # the interrupt checkpoint
    assert not (ws / "model" / "last_model.npz").exists()


@pytest.fixture(scope="module")
def stream_runs(corpus, tmp_path_factory):
    never = {"tpu": {"device_resident": "never"}}
    always = {"tpu": {"device_resident": "always"}}
    jobs = [
        ("trainer_run", (corpus, "stream", never)),
        ("trainer_run", (corpus, "stream", always)),
        ("trainer_run", (corpus, "stream", {
            **always, "training": {"total_num_frames": 16 * 12,
                                   "resume": True}})),
        ("trainer_run", (corpus, "stream", {
            **never, "extra": {"description": "mp_stream_stop"}}, (1, 3))),
        ("trainer_run", (corpus, "stream", {
            **always, "extra": {"description": "mp_stream_res_stop"}},
            (1, 3))),
        ("trainer_run", (corpus, "stream", {
            **always, "training": {"batch_size": 15,
                                   "total_num_frames": 15 * 8},
            "extra": {"description": "mp_stream_odd"}})),
        ("trainer_error", (corpus, "stream", {
            **never, "training": {"batch_size": 15},
            "extra": {"description": "mp_stream_odd_host"}})),
    ]
    return R.launch(R.run_jobs, 2, tmp_path_factory.mktemp("stream"), jobs)


def test_stream_resident_equals_host_fed_bit_for_bit(stream_runs):
    host, res = _job(stream_runs, 0), _job(stream_runs, 1)
    for runs in (host, res):
        ws = _one_writer(runs)
        ckpts, wavs = _artifacts(ws)
        assert ckpts == [f"ckpt_{b:05d}.npz" for b in (2, 4, 6, 8)]
        assert runs[0]["step"] == 8
    lh = batch_losses(Path(host[0]["workdir"]) / "logs")
    lr = batch_losses(Path(res[0]["workdir"]) / "logs")
    assert sorted(lh) == list(range(8)) and lh == lr
    for name in host[0]["params"]:
        np.testing.assert_array_equal(host[0]["params"][name],
                                      res[0]["params"][name])


def test_stream_resumes_on_every_rank(stream_runs):
    first, resumed = _job(stream_runs, 1), _job(stream_runs, 2)
    ws = _one_writer(resumed)
    assert resumed[0]["step"] == 12
    assert resumed[0]["steps_taken"] == resumed[1]["steps_taken"] == 4
    assert sorted(batch_losses(ws / "logs")) == list(range(8, 12))
    assert Path(first[0]["workdir"]) != ws


@pytest.mark.parametrize("job", [3, 4], ids=["host-fed", "resident"])
def test_stream_stops_every_rank_on_one_ranks_flag(stream_runs, job):
    runs = _job(stream_runs, job)
    ws = _one_writer(runs)
    assert 3 <= runs[0]["step"] < 8
    assert not (ws / "model" / "last_model.npz").exists()
    assert len(list((ws / "model" / "checkpoints").glob("ckpt_*.npz"))) >= 1


def test_stream_resident_pads_an_odd_batch_with_weightless_rows(
        stream_runs):
    runs = _job(stream_runs, 5)
    ws = _one_writer(runs)
    losses = batch_losses(ws / "logs")
    assert sorted(losses) == list(range(8))
    assert all(np.isfinite(v) for v in losses.values())
    # host-fed: an odd batch does not divide the ranks, raised up front
    errors = _job(stream_runs, 6)
    assert all("divisible by the world size (2)" in e for e in errors)


def test_every_rank_fails_where_rank_0_cannot_make_the_workspace(corpus,
                                                                  tmp_path):
    """A run dir rank 0 cannot create fails every rank (the path's
    broadcast carries the failure) instead of leaving them waiting."""
    (corpus / "mp_blocked").write_text("a file where the runs go")
    errors = R.launch(R.trainer_error, 2, tmp_path, corpus, "epoch", {
        "tpu": {"device_resident": "never"},
        "extra": {"description": "mp_blocked"}})
    assert errors[0].startswith("NotADirectoryError"), errors
    assert errors[1] == ("RuntimeError: rank 0 could not create the run "
                         "workspace")


def _ini(tmp_path, corpus, **tpu):
    cfg = R._trainer_cfg(corpus, "epoch", {
        "tpu": dict(device_resident="never", **tpu),
        "training": {"epochs": 1},
        "extra": {"description": "mp_cli"}})
    path = tmp_path / "run.ini"
    save_config(cfg, path)
    return path


def _command(args, tmp_path):
    return subprocess.run(
        [sys.executable, "-m", "rawaudiovae_kelsey_tpu_torch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_train_command_starts_its_ranks(corpus, tmp_path):
    ini = _ini(tmp_path, corpus, data_parallel=2)
    proc = _command(["train", "--config", str(ini), "--device", "cpu"],
                    tmp_path)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "train: starting 2 ranks (cpu, gloo)" in out
    assert "(rank 0 of 2)" in out and "(rank 1 of 2)" in out
    runs = sorted((corpus / "mp_cli").glob("run-*"))
    assert len(runs) == 1
    assert (runs[0] / "model" / "last_model.npz").is_file()


def test_train_command_fails_when_a_rank_fails(tmp_path):
    cfg = Config()
    cfg.dataset.datapath = str(tmp_path / "missing")
    cfg.tpu.data_parallel = 2
    ini = tmp_path / "bad.ini"
    save_config(cfg, ini)
    proc = _command(["train", "--config", str(ini), "--device", "cpu"],
                    tmp_path)
    assert proc.returncode != 0
    assert "a rank failed" in proc.stderr
