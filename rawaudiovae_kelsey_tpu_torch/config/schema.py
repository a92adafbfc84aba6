"""Typed configuration schema — the same dataclasses and validation as the
JAX package's ``config/schema.py``, so every ``configs/*.ini`` parses to
equal values in both packages.

Covers the reference INI surface verbatim — sections ``[audio] [dataset] [VAE]
[training] [notes] [extra]`` as enumerated in the reference's
``default.ini:1-43`` — plus the optional ``[tpu]`` section.  It keeps its
name and keys in the port; of its knobs the serving path reads ``backend``
(``pallas`` = the hand-written CUDA kernels, ``xla`` = the plain PyTorch
ops, ``best`` = the kernels for ``arch=dense`` on a CUDA device, the plain
ops otherwise) and ``seed``.  ``[VAE] device`` stays a dead reference key:
the serving device comes from the command line.

Reference quirks handled here (SURVEY.md appendix):
  * ``generate_test`` was read with ``.get()`` in the reference
    (``train.py:65``), so the string ``"False"`` was truthy and the flag could
    never be disabled.  We parse it as a real boolean (quirk #8, fixed).
  * Dead reference keys (``loss_reduction``, ``check_audio``, ``check_dataset``,
    ``device``, ``example_length``, ``normalize_examples``, ``plot_model`` —
    quirk #9) are accepted and carried so reference configs round-trip, and
    ``loss_reduction`` is actually honored by our loss (mean/sum).
  * ``IterableAudioDataset`` hard-coded ``segment_length = 1024``
    (``dataset.py:66``, quirk #2): our streaming path honors the config value.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class AudioConfig:
    """``[audio]`` — default.ini:2-5."""

    sampling_rate: int = 44100
    hop_length: int = 128
    segment_length: int = 1024

    def validate(self) -> None:
        if self.segment_length <= 0 or self.hop_length <= 0:
            raise ValueError("segment_length and hop_length must be positive")
        # AudioDataset contract: dataset.py:97-98.
        if self.segment_length % self.hop_length != 0:
            raise ValueError(
                f"segment_length {self.segment_length} is not a multiple of "
                f"hop_size {self.hop_length}"
            )


@dataclass
class DatasetConfig:
    """``[dataset]`` — default.ini:8-15."""

    datapath: str = ""
    test_dataset: str = "test_audio"
    generate_test: bool = True          # parsed as a true boolean (quirk #8 fix)
    check_audio: bool = True            # dead in reference; accepted
    check_dataset: bool = True          # dead in reference; accepted
    workspace: str = ""                 # written back at run start (train.py:109)
    run_number: int = 0
    total_frames: str = ""              # written back after ingest (train.py:130)
    # How stereo is collapsed to mono.  The reference differs between its two
    # ingest paths: librosa.load averages channels (train.py:120) while the
    # streaming loader keeps the first channel (dataset.py:54-55).
    mono: str = "mean"                  # "mean" | "first"

    @property
    def datapath_path(self) -> Path:
        return Path(self.datapath)


@dataclass
class VAEConfig:
    """``[VAE]`` — default.ini:17-21."""

    latent_dim: int = 256
    n_units: int = 2048
    kl_beta: float = 1e-4
    device: str = "tpu"                 # reference key (dead there, train.py:88)
    device_name: str = ""               # written back at run start (train.py:91)
    # Model family: "dense" (reference rawvae/model.py:5-35), "deep" (4-layer
    # encoder/decoder wide variant), "conv1d" (strided conv / transpose-conv).
    arch: str = "dense"
    # deep variant: hidden widths outermost→innermost, e.g. "4096,2048,1024".
    hidden_dims: str = ""
    # conv1d variant: channel progression and kernel/stride config.
    conv_channels: str = "32,64,128,256"
    conv_kernel: int = 9
    conv_stride: int = 4
    # Port-only keys (the JAX package has neither): the oobleck variant's
    # per-stage strides, and the channels a frame interleaves (2: stereo,
    # L, R, L, R, ... as a WAV stores them).  Written by save_config only
    # when they differ from these defaults (config/ini.py PORT_ONLY).
    conv_strides: str = "2,4,4,8,8"
    io_channels: int = 1


@dataclass
class TrainingConfig:
    """``[training]`` — default.ini:23-29 and default_iterable.ini:24-28."""

    epochs: int = 500
    save_best_model_after: int = 80
    learning_rate: float = 1e-4
    batch_size: int = 131072
    checkpoint_interval: int = 90
    loss_reduction: str = "mean"        # dead in reference; honored here
    # Streaming trainer (train_iterable.py:70-74): bounds the run by frames.
    total_num_frames: int = 0
    # Resume from the latest checkpoint in the workspace (reference wrote
    # checkpoints but never loaded them — SURVEY.md §5.3; new capability).
    resume: bool = False
    # Keep only the newest N periodic checkpoints (0 = keep all, the
    # reference behavior — its long runs accumulated every ckpt_NNNNN.pt).
    # best/last model artifacts are never pruned.  See DIVERGENCES.md.
    keep_checkpoints: int = 0
    best_epoch: str = ""                # written back (train.py:246)


@dataclass
class NotesConfig:
    """``[notes]`` — default.ini:31-32."""

    additional_notes: str = ""


@dataclass
class ExtraConfig:
    """``[extra]`` — default.ini:34-43."""

    normalize_examples: bool = False    # dead in reference; accepted
    example_length: int = 10            # dead in reference; accepted
    plot_model: bool = True             # dead in reference; accepted
    description: str = "tpu_run"
    start: str = ""
    end: str = ""
    time_elapsed: str = ""


@dataclass
class TPUConfig:
    """``[tpu]`` — new section; absent from reference configs (all defaults).
    The port keeps the section's name and keys so the same INI files parse;
    the training knobs are read once training is ported."""

    # Matmul/computation precision tier of the training step: "float32" |
    # "bfloat16" | "high" | "highest".  Serving sets no tier: it runs fp32.
    precision: str = "highest"
    # Kernel backend for the hot path: "xla" (the plain PyTorch ops) |
    # "pallas" (the hand-written CUDA kernels; on CPU tensors their plain
    # versions) | "best" (the measured winner per family and tier: the
    # plain ops, which won every cell measured on a CUDA device).
    backend: str = "xla"
    # Microbatch size for gradient accumulation; 0 disables.  Lets the
    # reference's default batch_size=131072 (default.ini:27, reduced to 4096
    # "due to memory issues" in kelsey_iterable.ini:36) run on one chip.
    microbatch_size: int = 0
    # Mesh: number of data-parallel and model-parallel shards. 0 = all devices
    # on the data axis.
    data_parallel: int = 0
    model_parallel: int = 1
    # Host-side prefetch depth for the device feed queue.
    prefetch: int = 2
    # Device-resident corpus mode for the epoch trainer: upload the raw
    # sample array once and run whole epochs on-chip (shuffle + gather-
    # framing + every step inside one jit; zero per-step host transfers).
    # "auto" uses it when the corpus fits resident_budget_gb.
    device_resident: str = "auto"     # auto | always | never
    resident_budget_gb: float = 4.0
    # Shuffle scope for mesh-sharded resident epochs: "global" mixes frames
    # across shards each epoch (two-pass all_to_all block-transpose shuffle
    # riding ICI, parallel/resident.py); "local" permutes only within each
    # chip's shard (the locality-restricted shuffle sharded loaders use).
    # "block" (single-device epoch trainer, frames layout) shuffles in
    # contiguous multi-row blocks so the per-epoch gather runs at DMA
    # bandwidth instead of the descriptor-bound row-gather path — a
    # perf-first tradeoff documented in DIVERGENCES.md; on a mesh it
    # behaves like "global".
    resident_shuffle: str = "global"  # global | local | block
    # Device layout for the RESIDENT STREAM trainer's corpus: "frames"
    # uploads the materialized (n_frames, segment) window matrix;
    # "samples" uploads the hop-padded per-file sample arrays plus an
    # int32 start-offset per frame and gathers each window with a strided
    # dynamic-slice — identical values and identical per-row gather
    # traffic, at hop/segment of the footprint (hop 128 / seg 1024 → 8×
    # less HBM and host→device upload; the reference's real erokia corpus
    # is 6.3 GB as frames, 0.8 GB as samples).  "auto" picks samples on
    # the single-device path whenever windows overlap (hop < segment);
    # mesh/multihost paths keep the frames layout.
    resident_layout: str = "auto"     # auto | frames | samples
    # Reparameterization sampler: "threefry" (jax.random, reproducible
    # across platforms — the default contract) or "tpu_prng" (the Pallas
    # on-chip PRNG kernel, ops/rng.py: eps never touches HBM; stream is
    # platform-specific).
    rng: str = "threefry"
    # Rematerialize the forward pass in the backward (torch.utils.checkpoint
    # here, jax.checkpoint in the JAX package):
    # trades ~1/3 more FLOPs for not storing activations — lets deep/wide
    # variants train at batch sizes that would otherwise OOM HBM.
    remat: bool = False
    # Dtype batches travel to the device in.  "bfloat16" halves host->device
    # bandwidth (PCIe/DCN/tunnel) at the cost of bf16-quantized loss targets;
    # only meaningful with precision=bfloat16.
    feed_dtype: str = "float32"
    # Log parameter histograms every N steps (reference logged every batch in
    # the iterable trainer, train_iterable.py:216-217 — quirk #10).
    # 0 = checkpoint-cadence only (per-epoch pulls every parameter through
    # the host link and re-serializes the device-resident fast path)
    histogram_interval: int = 0
    # PRNG seed for init + reparameterization.
    seed: int = 0
    # Deterministic inference (z = mu, no sampling) — quirk #13 extension.
    deterministic_inference: bool = False
    # Checkpoint format: "npz" (flat pytree leaves + json sidecar) |
    # "orbax" (sharded, multi-host friendly).
    checkpoint_format: str = "npz"
    # Never block the training loop on checkpoint-boundary host I/O.  npz
    # (single-process): the state fetch plus the histogram/best/periodic
    # writes run on a background worker thread.  orbax: save() returns
    # after the device→host copy and orbax's own background threads finish
    # the write — including the multihost commit protocol, so this works
    # across hosts.  Multihost npz boundary actions contain collectives and
    # stay synchronous.  Artifacts are byte-identical; an I/O error surfaces
    # at the next boundary/flush instead of instantly.  See DIVERGENCES.md.
    async_checkpoint: bool = True
    # Multi-host (DCN): initialize jax.distributed at trainer start.  On TPU
    # pods the coordinator/process info comes from the environment.
    multihost: bool = False
    coordinator_address: str = ""
    # Capture a torch.profiler Chrome trace, with the program's rvk.* spans
    # (observe/spans.py), for steps [profile_start, profile_start +
    # profile_steps) into <workdir>/logs/profile (0 = off).
    profile_steps: int = 0
    profile_start: int = 10


@dataclass
class Config:
    """Full framework configuration (all INI sections)."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    notes: NotesConfig = field(default_factory=NotesConfig)
    extra: ExtraConfig = field(default_factory=ExtraConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)
    # Unknown keys from user INIs, preserved for round-tripping:
    # {(section, key): raw string}
    unknown: dict = field(default_factory=dict)

    def validate(self) -> None:
        self.audio.validate()
        if self.training.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.tpu.precision not in ("float32", "bfloat16", "high",
                                      "highest"):
            raise ValueError(f"unknown precision {self.tpu.precision!r}")
        if self.tpu.backend not in ("best", "xla", "pallas"):
            raise ValueError(f"unknown backend {self.tpu.backend!r}")
        if self.tpu.feed_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown feed_dtype {self.tpu.feed_dtype!r}")
        if self.tpu.rng not in ("threefry", "tpu_prng"):
            raise ValueError(f"unknown rng {self.tpu.rng!r}")
        if self.tpu.checkpoint_format not in ("npz", "orbax"):
            raise ValueError(
                f"unknown checkpoint_format {self.tpu.checkpoint_format!r}"
            )
        if self.tpu.resident_shuffle not in ("global", "local", "block"):
            raise ValueError(
                f"unknown resident_shuffle {self.tpu.resident_shuffle!r}"
            )
        if self.tpu.resident_layout not in ("auto", "frames", "samples"):
            raise ValueError(
                f"unknown resident_layout {self.tpu.resident_layout!r}"
            )
        if self.tpu.device_resident not in ("auto", "always", "never"):
            raise ValueError(
                f"unknown device_resident {self.tpu.device_resident!r}"
            )
        if self.vae.arch not in ("dense", "deep", "conv1d", "oobleck"):
            raise ValueError(f"unknown arch {self.vae.arch!r}")
        if self.vae.io_channels < 1:
            raise ValueError(
                f"io_channels must be positive, got {self.vae.io_channels}")
        if self.dataset.mono not in ("mean", "first"):
            raise ValueError(
                f"unknown mono mode {self.dataset.mono!r} (expected 'mean' — "
                "average channels like librosa.load, or 'first' — keep the "
                "first channel like the reference's streaming loader)"
            )
        tokens = self.training.loss_reduction.split()
        if not tokens or tokens[0] not in ("mean", "sum"):
            raise ValueError(
                f"unknown loss_reduction {self.training.loss_reduction!r}"
            )

    # -- convenience accessors ------------------------------------------------
    @property
    def segment_length(self) -> int:
        return self.audio.segment_length

    @property
    def hop_length(self) -> int:
        return self.audio.hop_length

    @property
    def sampling_rate(self) -> int:
        return self.audio.sampling_rate

    def stamp_start(self, t: Optional[float] = None) -> None:
        """Record run start time (train.py:85-86 semantics)."""
        t = time.time() if t is None else t
        self.extra.start = time.asctime(time.localtime(t))
        self._start_time = t

    def stamp_end(self, t: Optional[float] = None) -> None:
        """Record run end + elapsed (keys existed in default.ini:41-42 but were
        never written by the reference — SURVEY.md §5.1; we write them)."""
        t = time.time() if t is None else t
        self.extra.end = time.asctime(time.localtime(t))
        start = getattr(self, "_start_time", None)
        if start is not None:
            self.extra.time_elapsed = f"{t - start:.3f}s"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
