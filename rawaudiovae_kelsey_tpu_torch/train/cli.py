"""The training commands of the PyTorch port — the counterparts of the JAX
package's ``train/cli.py`` entry points (``python train.py --config
default.ini`` and ``python train_iterable.py --config x.ini``):

    python -m rawaudiovae_kelsey_tpu_torch train --config x.ini [--resume]
        [--device cuda]
    python -m rawaudiovae_kelsey_tpu_torch stream --config x.ini [--resume]
        [--device cuda]

Both train on a CUDA device and refuse to start without one unless
``--device cpu`` asks for the plain PyTorch path on the CPU.

Several GPUs (``parallel/mesh.py``): JAX reads ``[tpu] data_parallel = 0``
as "every device on the data axis", so on a host with several visible
cards the command starts one rank a card (:func:`plan_ranks`), each a
process of its own (``torch.multiprocessing``, start method ``spawn``, a
file store in a temporary directory, NCCL), joins them, and exits non-zero
if any fails.  ``data_parallel = n`` starts n × ``model_parallel`` ranks
(CPU processes on gloo under ``--device cpu``) and raises where fewer
cards are visible; under ``data_parallel = 0`` the cards are cut into
``model_parallel`` ranks a data index (tensor parallelism).  A process that is already a rank — torchrun set ``RANK``, or
``[tpu] multihost`` / ``coordinator_address`` ask to join a group — starts
nothing and trains as that rank (``--device cuda`` takes
``cuda:LOCAL_RANK``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import torch
import torch.distributed as dist

from rawaudiovae_kelsey_tpu_torch.config import load_config
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT,
    default_backend,
)


def _parse(argv, prog: str):
    """``(cfg, device)`` of a training command's arguments."""
    parser = argparse.ArgumentParser(prog=prog)
    parser.add_argument("--config", type=str, default="./default.ini",
                        help="path to the config file")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint of the most "
                             "recent run")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"{prog}: --device cuda but no CUDA device is available (pass "
            "--device cpu to train with the plain PyTorch path on the CPU)")
    try:
        cfg = load_config(args.config)
    except FileNotFoundError:
        print(f"Config File Not Found at {args.config}")
        sys.exit(1)
    if args.resume:
        cfg.training.resume = True
    return cfg, device


def plan_ranks(cfg, device: torch.device) -> int:
    """How many ranks the command starts on this host: 1 means "train in
    this process" (as one rank of an existing or joined group, or alone).
    ``data_parallel = 0`` on a bare ``cuda`` device is one rank a visible
    card (``make_mesh`` then cuts them into ``model_parallel`` a data
    index); ``data_parallel = n`` is n × ``model_parallel``, and more than
    the visible cards raise (JAX's ``mesh AxB != N devices``).  A named
    card (``cuda:1``) trains alone unless the config asks for more ranks,
    which raises."""
    if (dist.is_initialized() or "RANK" in os.environ
            or cfg.tpu.multihost or cfg.tpu.coordinator_address):
        return 1
    dp = cfg.tpu.data_parallel
    mp = max(cfg.tpu.model_parallel, 1)
    if device.type != "cuda":
        return max(dp, 1) * mp
    if device.index is not None:
        if dp > 1 or mp > 1:
            n = max(dp, 1) * mp
            raise ValueError(
                f"[tpu] data_parallel = {dp}, model_parallel = {mp} with "
                f"--device {device}: pass --device cuda to train on cards "
                f"0..{n - 1}")
        return 1
    visible = torch.cuda.device_count()
    n = dp * mp if dp > 0 else visible
    if n > visible:
        raise ValueError(
            f"[tpu] data_parallel = {dp}, model_parallel = {mp} asks for "
            f"{n} ranks, one a card, but {visible} CUDA devices are visible")
    return max(n, 1)


def _trainer(command: str):
    if command == "stream":
        from rawaudiovae_kelsey_tpu_torch.train.stream import train
    else:
        from rawaudiovae_kelsey_tpu_torch.train.epoch import train
    return train


def _rank_main(local_rank: int, command: str, argv, world: int,
               init_method: str, device_type: str) -> None:
    """One rank started by the command: join the group, train, leave."""
    os.environ["LOCAL_RANK"] = str(local_rank)
    device = (torch.device("cuda", local_rank) if device_type == "cuda"
              else torch.device("cpu"))
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(default_backend(device), init_method=init_method,
                            rank=local_rank, world_size=world,
                            timeout=DEFAULT_TIMEOUT, **kwargs)
    try:
        cfg, _ = _parse(argv, command)
        _trainer(command)(cfg, device=device)
    finally:
        dist.destroy_process_group()


def start_ranks(command: str, argv, n: int, device_type: str) -> None:
    """Start ``n`` ranks of ``command`` on this host, join them; a rank's
    failure ends the others and exits non-zero."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    store = tempfile.mkdtemp(prefix="rvk_ranks_")
    print(f"{command}: starting {n} ranks ({device_type}, "
          f"{default_backend(torch.device(device_type))})")
    try:
        mp.start_processes(
            _rank_main,
            args=(command, list(argv), n, f"file://{store}/store",
                  device_type),
            nprocs=n, join=True, start_method="spawn")
    except ProcessException as err:
        print(f"{command}: a rank failed: {err}", file=sys.stderr)
        raise SystemExit(1) from err
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _main(command: str, argv) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg, device = _parse(argv, command)
    n = plan_ranks(cfg, device)
    if n > 1:
        start_ranks(command, argv, n, device.type)
        return
    _trainer(command)(cfg, device=device)


def main(argv=None) -> None:
    _main("train", argv)


def main_stream(argv=None) -> None:
    _main("stream", argv)


if __name__ == "__main__":
    main()
