"""The choice between the two hand-written kernels of ``linear_ksplit_fwd``
and ``matmul_nt`` (rawaudiovae_kelsey_tpu_torch/ops/tensor_cores.py): a pure
function of dtype, shape and alignment, checked here on the CPU.  The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

from pathlib import Path

import pytest
import torch

from rawaudiovae_kelsey_tpu_torch.config import load_config
from rawaudiovae_kelsey_tpu_torch.ops import linear, mlp, tensor_cores

ROOT = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32
BATCH = 4096


def _deep_layers():
    """(k, n) of every linear layer of configs/deep_wide.ini, encoder, heads
    and decoder."""
    cfg = load_config(ROOT / "configs" / "deep_wide.ini")
    hidden = [int(d) for d in cfg.vae.hidden_dims.split(",")]
    seg, latent = cfg.audio.segment_length, cfg.vae.latent_dim
    assert cfg.training.batch_size == BATCH
    enc = [seg, *hidden]
    dec = [latent, *reversed(hidden), seg]
    return (list(zip(enc[:-1], enc[1:])) + [(hidden[-1], latent)] * 2
            + list(zip(dec[:-1], dec[1:])))


KSPLIT_LAYERS = [(4096, 4096), (4096, 2048), (2048, 1024), (1024, 512),
                 (1024, 2048), (2048, 4096), (4096, 4096)]


def test_the_deep_config_has_seven_ksplit_layers():
    layers = _deep_layers()
    assert len(layers) == 11
    assert [kn for kn in layers
            if linear.takes_ksplit(BATCH, *kn)] == KSPLIT_LAYERS


@pytest.mark.parametrize("k,n", KSPLIT_LAYERS)
def test_ksplit_layers_take_the_tensor_cores_in_bf16(k, n):
    assert tensor_cores.takes_tensor_cores(BF16, BATCH, k, n)
    assert not tensor_cores.takes_tensor_cores(F32, BATCH, k, n)
    assert tensor_cores.resolve_kernel("op", "auto", BF16, BATCH, k, n) == \
        tensor_cores.KERNEL_CODES["tensor_cores"]
    assert tensor_cores.resolve_kernel("op", "auto", F32, BATCH, k, n) == \
        tensor_cores.KERNEL_CODES["cuda_cores"]


@pytest.mark.parametrize("rows,k,m", [(8192, 2048, 256), (8192, 2048, 1024)],
                         ids=["dz", "dx"])
def test_matmul_nt_shapes_take_the_tensor_cores_in_bf16(rows, k, m):
    assert tensor_cores.takes_tensor_cores(BF16, rows, k, m)
    assert not tensor_cores.takes_tensor_cores(F32, rows, k, m)


@pytest.mark.parametrize("dtype,rows,k,n,aligned", [
    (F32, 4096, 4096, 4096, True),       # fp32 promises IEEE products
    (torch.float16, 4096, 4096, 4096, True),
    (BF16, 1000, 70, 33, True),          # chip_smoke's ragged layer
    (BF16, 4096, 1028, 512, True),       # k % 8 != 0
    (BF16, 4096, 1024, 516, True),       # n % 8 != 0
    (BF16, 0, 1024, 512, True),          # a zero-row batch
    (BF16, 4096, 1024, 0, True),
    (BF16, 4096, 1024, 512, False),      # an unaligned view
], ids=["fp32", "fp16", "ragged", "k%8", "n%8", "no-rows", "no-columns",
        "unaligned"])
def test_what_keeps_the_cuda_cores(dtype, rows, k, n, aligned):
    assert not tensor_cores.takes_tensor_cores(dtype, rows, k, n, aligned)
    assert tensor_cores.resolve_kernel("op", "auto", dtype, rows, k, n,
                                       aligned) == 0
    assert tensor_cores.resolve_kernel("op", "cuda_cores", dtype, rows, k, n,
                                       aligned) == 0
    for name, code in tensor_cores.KERNEL_CODES.items():
        if code:
            with pytest.raises(ValueError, match="takes bf16 operands"):
                tensor_cores.resolve_kernel("op", name, dtype, rows, k, n,
                                            aligned)


@pytest.mark.parametrize("rows,k,n", [(4097, 1088, 544), (1000, 1096, 520),
                                      (1, 24, 8), (1, 8, 8)])
def test_ragged_shapes_tma_can_take(rows, k, n):
    assert tensor_cores.takes_tensor_cores(BF16, rows, k, n)
    for name, code in tensor_cores.KERNEL_CODES.items():
        assert tensor_cores.resolve_kernel("op", name, BF16, rows, k,
                                           n) == code


def test_kernel_codes_are_the_c_side_codes():
    """KERNEL_CODES mirrors ``enum Kernel`` of csrc/wgmma.cuh."""
    import re

    text = (ROOT / "rawaudiovae_kelsey_tpu_torch" / "csrc"
            / "wgmma.cuh").read_text()
    body = re.search(r"enum Kernel : int \{(.*?)\};", text, re.S).group(1)
    codes = [int(v) for v in re.findall(r"=\s*(\d+)", body)]
    assert codes == sorted(tensor_cores.KERNEL_CODES.values()) == \
        list(range(len(codes)))
    assert tensor_cores.KERNEL_CODES == {"cuda_cores": 0, "tensor_cores": 1}


@pytest.mark.parametrize("batch,k,n,want", [
    (4096, 4096, 4096, True), (1024, 1024, 512, True),
    (1023, 1024, 512, False), (4096, 1023, 512, False),
    (4096, 512, 4096, False), (4096, 1024, 511, False),
    (256, 4096, 4096, False),
])
def test_takes_ksplit_is_unchanged(batch, k, n, want):
    assert (linear.KSPLIT_BLOCK_B, linear.KSPLIT_BLOCK,
            linear.KSPLIT_BLOCK_K) == (1024, 512, 512)
    assert linear.takes_ksplit(batch, k, n) is want


@pytest.mark.parametrize("kernel", ["tensor-cores", "tensor_cores:n128", "wgmma", "", None])
def test_an_unknown_kernel_raises_on_any_device(kernel):
    x, w, b = torch.zeros((4, 8)), torch.zeros((8, 8)), torch.zeros((8,))
    with pytest.raises(ValueError, match="unknown kernel"):
        linear.linear_ksplit_fwd(x, w, b, "relu", kernel=kernel)
    with pytest.raises(ValueError, match="unknown kernel"):
        mlp.matmul_nt(x, w, kernel=kernel)


@pytest.mark.parametrize("kernel", ["auto", *tensor_cores.KERNEL_CODES])
def test_a_cpu_tensor_takes_the_plain_version_whatever_the_kernel(kernel):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 16), generator=g).to(BF16)
    w = torch.randn((16, 8), generator=g).to(BF16)
    b = torch.randn((8,), generator=g).to(BF16)
    before = (linear.linear_ksplit_fwd.launches, mlp.matmul_nt.launches,
              linear.linear_ksplit_fwd.tensor_core_launches,
              mlp.matmul_nt.tensor_core_launches)
    assert torch.equal(linear.linear_ksplit_fwd(x, w, b, "tanh",
                                                kernel=kernel),
                       linear.linear_ksplit_fwd_ref(x, w, b, "tanh"))
    assert torch.equal(mlp.matmul_nt(x, w.t().contiguous(), kernel=kernel),
                       mlp.matmul_nt_ref(x, w.t().contiguous()))
    assert before == (linear.linear_ksplit_fwd.launches,
                      mlp.matmul_nt.launches,
                      linear.linear_ksplit_fwd.tensor_core_launches,
                      mlp.matmul_nt.tensor_core_launches)


def test_wrappers_refuse_what_is_neither_cpu_nor_cuda():
    x = torch.empty((8, 16), device="meta", dtype=BF16)
    w = torch.empty((16, 8), device="meta", dtype=BF16)
    b = torch.empty((8,), device="meta", dtype=BF16)
    with pytest.raises(ValueError, match="CUDA"):
        linear.linear_ksplit_fwd(x, w, b, "relu", kernel="tensor_cores")
    with pytest.raises(ValueError, match="CUDA"):
        mlp.matmul_nt(x, w, kernel="tensor_cores")


def _stand_in(monkeypatch):
    """The device check stood in for and the launch recorded, so that the
    checks a CUDA tensor passes through run on ``meta`` tensors."""
    launched = []
    monkeypatch.setattr(mlp, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(linear, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: True)
    monkeypatch.setattr(
        mlp._build, "launch",
        lambda name, dev, *args: launched.append((name, args)))
    return launched


def test_wrappers_check_dtype_shape_and_contiguity(monkeypatch):
    launched = _stand_in(monkeypatch)
    x = torch.empty((8, 16), device="meta", dtype=BF16)
    w = torch.empty((16, 24), device="meta", dtype=BF16)
    b = torch.empty((24,), device="meta", dtype=BF16)
    for kernel in ("auto", "tensor_cores", "cuda_cores"):
        with pytest.raises(TypeError, match="dtype"):
            linear.linear_ksplit_fwd(x.to(torch.float16), w, b, "relu",
                                     kernel=kernel)
        with pytest.raises(TypeError, match="dtype"):
            linear.linear_ksplit_fwd(x, w.float(), b, "relu", kernel=kernel)
        with pytest.raises(ValueError, match="shape"):
            linear.linear_ksplit_fwd(x, w[:8], b, "relu", kernel=kernel)
        with pytest.raises(ValueError, match="shape"):
            linear.linear_ksplit_fwd(x, w, b[:8], "relu", kernel=kernel)
        with pytest.raises(ValueError, match="contiguous"):
            linear.linear_ksplit_fwd(x, w.t().contiguous().t(), b, "relu",
                                     kernel=kernel)
        with pytest.raises(ValueError, match="unknown activation"):
            linear.linear_ksplit_fwd(x, w, b, "gelu", kernel=kernel)
        a, wt = x, torch.empty((24, 16), device="meta", dtype=BF16)
        with pytest.raises(TypeError, match="dtype"):
            mlp.matmul_nt(a, wt.float(), kernel=kernel)
        with pytest.raises(TypeError, match="dtype"):
            mlp.matmul_nt(a.to(torch.int8), wt.to(torch.int8), kernel=kernel)
        with pytest.raises(ValueError, match="shape"):
            mlp.matmul_nt(a, wt[:, :8], kernel=kernel)
        with pytest.raises(ValueError, match="contiguous"):
            mlp.matmul_nt(a.t().contiguous().t(), wt, kernel=kernel)
    assert launched == []


def test_the_wrappers_pass_the_kernel_code_and_no_workspace(monkeypatch):
    """What reaches the C entry points: the code of the kernel chosen, and
    for the tensor-core k-split no ``(slices, batch, n)`` workspace."""
    launched = _stand_in(monkeypatch)
    x = torch.empty((8, 1024), device="meta", dtype=BF16)
    w = torch.empty((1024, 24), device="meta", dtype=BF16)
    b = torch.empty((24,), device="meta", dtype=BF16)
    counts = (linear.linear_ksplit_fwd.launches,
              linear.linear_ksplit_fwd.tensor_core_launches)
    y = linear.linear_ksplit_fwd(x, w, b, "relu")
    assert y.shape == (8, 24) and y.dtype == BF16
    name, args = launched.pop()
    assert name == "rvk_linear_ksplit_fwd"
    assert args[4] is None and args[-1] == 1        # ws, kernel
    assert args[5:8] == (8, 1024, 24)
    linear.linear_ksplit_fwd(x, w, b, "relu", kernel="cuda_cores")
    name, args = launched.pop()
    assert tuple(args[4].shape) == (2, 8, 24) and args[4].dtype == F32
    assert args[-1] == 0
    linear.linear_ksplit_fwd(x.float(), w.float(), b.float(), "relu")
    assert launched.pop()[1][-1] == 0               # fp32: the first version
    assert (linear.linear_ksplit_fwd.launches - counts[0],
            linear.linear_ksplit_fwd.tensor_core_launches - counts[1]) \
        == (3, 1)

    wt = torch.empty((24, 1024), device="meta", dtype=BF16)
    counts = (mlp.matmul_nt.launches, mlp.matmul_nt.tensor_core_launches)
    out = mlp.matmul_nt(x, wt, kernel="tensor_cores")
    assert out.shape == (8, 24)
    name, args = launched.pop()
    assert name == "rvk_matmul_nt" and args[3:] == (8, 1024, 24, 1, 1)
    mlp.matmul_nt(x[:, :1016].contiguous(), wt[:, :1016].contiguous())
    assert launched.pop()[1][-1] == 1               # k = 1016: 8 | k
    xs = torch.empty((8, 1020), device="meta", dtype=BF16)
    mlp.matmul_nt(xs, torch.empty((24, 1020), device="meta", dtype=BF16))
    assert launched.pop()[1][-1] == 0               # k = 1020: the first
    assert (mlp.matmul_nt.launches - counts[0],
            mlp.matmul_nt.tensor_core_launches - counts[1]) == (3, 2)


def test_a_named_tensor_core_kernel_raises_on_what_tma_cannot_take(
        monkeypatch):
    launched = _stand_in(monkeypatch)
    x = torch.empty((8, 70), device="meta", dtype=BF16)
    w = torch.empty((70, 33), device="meta", dtype=BF16)
    b = torch.empty((33,), device="meta", dtype=BF16)
    with pytest.raises(ValueError, match="takes bf16 operands"):
        linear.linear_ksplit_fwd(x, w, b, "relu", kernel="tensor_cores")
    with pytest.raises(ValueError, match="takes bf16 operands"):
        mlp.matmul_nt(x, torch.empty((33, 70), device="meta", dtype=BF16),
                      kernel="tensor_cores")
    with pytest.raises(ValueError, match="takes bf16 operands"):
        linear.linear_ksplit_fwd(
            *(torch.empty(s, device="meta") for s in ((8, 64), (64, 32),
                                                      (32,))),
            "relu", kernel="tensor_cores")
    # an unaligned view
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: False)
    xa = torch.empty((8, 64), device="meta", dtype=BF16)
    wa = torch.empty((64, 32), device="meta", dtype=BF16)
    ba = torch.empty((32,), device="meta", dtype=BF16)
    with pytest.raises(ValueError, match="aligned = False"):
        linear.linear_ksplit_fwd(xa, wa, ba, "relu", kernel="tensor_cores")
    assert launched == []
    linear.linear_ksplit_fwd(xa, wa, ba, "relu")
    assert launched.pop()[1][-1] == 0


def test_pointers_aligned_reads_the_data_pointers():
    buf = torch.zeros(64, dtype=BF16)
    assert tensor_cores.pointers_aligned(buf, buf[8:], buf[16:])
    assert not tensor_cores.pointers_aligned(buf, buf[1:])
    assert not tensor_cores.pointers_aligned(buf[4:])
