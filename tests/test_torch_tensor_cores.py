"""The choice between the two hand-written kernels of ``linear_fwd``,
``linear_ksplit_fwd``, ``matmul_nt`` and ``toeplitz_fwd``
(rawaudiovae_kelsey_tpu_torch/ops/tensor_cores.py, ops/toeplitz.py): a pure
function of dtype, shape and alignment; the tensor-core kernel's tile width
and the Toeplitz tile plan; what the wrappers hand the C entry points.
Checked here on the CPU; the kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rawaudiovae_kelsey_tpu_torch.config import load_config
from rawaudiovae_kelsey_tpu_torch.ops import linear, mlp, tensor_cores, \
    toeplitz

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
    with pytest.raises(ValueError, match="takes bf16 operands"):
        tensor_cores.resolve_kernel("op", "tensor_cores", dtype, rows, k, n,
                                    aligned)
    # an op with no fp32 form has no "sgemm" to ask for
    with pytest.raises(ValueError, match="no kernel 'sgemm'"):
        tensor_cores.resolve_kernel("op", "sgemm", dtype, rows, k, n, aligned)


@pytest.mark.parametrize("rows,k,n", [(4097, 1088, 544), (1000, 1096, 520),
                                      (1, 24, 8), (1, 8, 8)])
def test_ragged_shapes_tma_can_take(rows, k, n):
    assert tensor_cores.takes_tensor_cores(BF16, rows, k, n)
    for name in ("cuda_cores", "tensor_cores"):
        assert tensor_cores.resolve_kernel("op", name, BF16, rows, k,
                                           n) == tensor_cores.KERNEL_CODES[name]


def test_kernel_codes_are_the_c_side_codes():
    """KERNEL_CODES mirrors ``enum Kernel`` of csrc/wgmma.cuh."""
    import re

    text = (ROOT / "rawaudiovae_kelsey_tpu_torch" / "csrc"
            / "wgmma.cuh").read_text()
    body = re.search(r"enum Kernel : int \{(.*?)\};", text, re.S).group(1)
    codes = [int(v) for v in re.findall(r"=\s*(\d+)", body)]
    assert codes == sorted(tensor_cores.KERNEL_CODES.values()) == \
        list(range(len(codes)))
    assert tensor_cores.KERNEL_CODES == {"cuda_cores": 0, "tensor_cores": 1,
                                         "sgemm": 2}


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
    checks a CUDA tensor passes through run on ``meta`` tensors (an H100's
    132 SMs for the tile width)."""
    launched = []
    monkeypatch.setattr(mlp, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(linear, "cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: True)
    monkeypatch.setattr(tensor_cores, "sm_count", lambda device: 132)
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
    # batch, n, m, dtype, tile width (one tile row, 24 columns: 64), kernel
    assert name == "rvk_matmul_nt" and args[3:] == (8, 1024, 24, 1, 64, 1)
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


# ------------------------------------------------ linear_fwd and toeplitz_fwd
#
# The whole-k linear layer and the block-Toeplitz product take the same
# tensor-core mainloop in bf16 (csrc/wgmma.cuh); its tile width comes from
# tensor_cores.tile_n, the Toeplitz tile walk from toeplitz.tile_plan.


def test_the_deep_config_has_four_whole_k_layers():
    """The layers below the k-split gate at batch 4096: the two heads (512
    -> 256) and the decoder's first two (256 -> 512, 512 -> 1024)."""
    layers = _deep_layers()
    whole = [kn for kn in layers if not linear.takes_ksplit(BATCH, *kn)]
    assert whole == [(512, 256), (512, 256), (256, 512), (512, 1024)]


@pytest.mark.parametrize("rows,k,n", [(BATCH, 512, 256), (BATCH, 256, 512),
                                      (BATCH, 512, 1024), (256, 4096, 4096),
                                      (256, 512, 256)])
def test_whole_k_layers_take_the_tensor_cores_in_bf16(rows, k, n):
    """The deep model's four whole-k layers at its batch and the server's
    layers at batch 256 (every layer whole-k there)."""
    assert tensor_cores.resolve_kernel("linear_fwd", "auto", BF16, rows, k,
                                       n) == 1
    # fp32: the register-tiled kernel (csrc/sgemm.cuh)
    assert tensor_cores.resolve_kernel("linear_fwd", "auto", F32, rows, k,
                                       n) == tensor_cores.KERNEL_CODES["sgemm"]
    assert not linear.takes_ksplit(rows, k, n)


@pytest.mark.parametrize("rows,n,width", [
    (4096, 4096, 256),      # row 15's shape: four waves of 128 x 256
    (4096, 512, 128),       # 4096 x 1024 -> 512: one wave either way
    (8192, 256, 128),       # matmul_nt's dz: 128 tiles, one wave
    (8192, 1024, 256),      # matmul_nt's dx
    (4096, 256, 64),        # the deep heads 512 -> 256: 128 tiles of 64
    (4096, 512, 128),       # 256 -> 512
    (4096, 1024, 256),      # 512 -> 1024
    (256, 4096, 64),        # the server's largest layer
    (1, 8, 64),             # one ragged row, 8 columns
])
def test_tile_width_rule_at_the_main_path_shapes(rows, n, width):
    assert tensor_cores.tile_n(-(-rows // tensor_cores.TILE_M), n,
                               132) == width


@settings(max_examples=300, deadline=None)
@given(tiles_m=st.integers(1, 5000), n=st.integers(1, 9000),
       sms=st.integers(1, 200))
def test_tile_width_rule_takes_the_fewest_waves_times_width(tiles_m, n, sms):
    def cost(width):
        return -(-tiles_m * -(-n // width) // sms) * width

    width = tensor_cores.tile_n(tiles_m, n, sms)
    assert width in tensor_cores.TILE_WIDTHS
    assert cost(width) == min(map(cost, tensor_cores.TILE_WIDTHS))
    # the widest of those that cost the least
    assert width == max(w for w in tensor_cores.TILE_WIDTHS
                        if cost(w) == cost(width))


def _conv1d_toeplitz_calls(dtype, passes=1):
    """The Toeplitz launches of one forward and backward of the conv1d
    model at configs/conv1d.ini's widths (batch 2), recorded as
    ``(dtype, B, nb, t_out, G, N, passes)`` through the plain versions."""
    from rawaudiovae_kelsey_tpu_torch.models import variants
    from rawaudiovae_kelsey_tpu_torch.ops import conv
    from rawaudiovae_kelsey_tpu_torch.tree import tree_map

    cfg = load_config(ROOT / "configs" / "conv1d.ini")
    channels = [int(c) for c in cfg.vae.conv_channels.split(",")]
    seg, k, s = (cfg.audio.segment_length, cfg.vae.conv_kernel,
                 cfg.vae.conv_stride)
    params = tree_map(lambda t: t.to(dtype).requires_grad_(),
                      variants.init_conv1d(torch.Generator().manual_seed(0),
                                           seg, channels, k, s,
                                           cfg.vae.latent_dim))
    calls = []
    real = toeplitz.toeplitz_fwd

    def record(x, w, b, act="none", t_out=None, shift=0, passes=1, **kw):
        t = toeplitz._t_out(x, w, t_out)
        calls.append((x.dtype, x.shape[0], x.shape[1], t, x.shape[2],
                      w.shape[2], passes))
        return real(x, w, b, act, t_out, shift, passes, **kw)

    x = torch.zeros((2, seg), dtype=dtype)
    width = variants.conv_latent_width(seg, len(channels), s)
    mp = pytest.MonkeyPatch()
    mp.setattr(toeplitz, "toeplitz_fwd", record)
    try:
        mu, _ = conv.conv_encode_pallas(params, x, s, passes)
        y = conv.conv_decode_pallas(params, mu, s, width, channels[-1],
                                    passes)
        y.float().square().sum().backward()
    finally:
        mp.undo()
    return calls


def test_twelve_of_the_fifteen_conv1d_launches_take_the_tensor_cores():
    """bf16: 8 forward + 7 dx launches; all but the first encoder layer (G
    = 4), the last decoder layer (N = 4) and its dx (G = 4) take them; fp32
    one pass and four, none."""
    calls = _conv1d_toeplitz_calls(BF16)
    assert len(calls) == 15
    takes = [toeplitz.takes_tensor_cores(*c[:6], passes=c[6]) for c in calls]
    assert sum(takes) == 12
    for call, took in zip(calls, takes):
        assert took == (call[4] % 8 == 0 and call[5] % 8 == 0), call
    assert sorted(c[4] for c, t in zip(calls, takes) if not t) == [4, 4, 32]
    for passes in (1, 4):
        calls = _conv1d_toeplitz_calls(F32, passes)
        assert len(calls) == 15
        assert not any(toeplitz.takes_tensor_cores(*c[:6], passes=c[6])
                       for c in calls)


@pytest.mark.parametrize("dtype,B,nb,t_out,G,N,passes,aligned", [
    (F32, 64, 64, 64, 128, 64, 1, True),      # fp32 promises IEEE products
    (F32, 64, 64, 64, 128, 64, 4, True),      # the 4-pass hi/lo mode
    (BF16, 64, 256, 256, 4, 32, 1, True),     # the first encoder layer
    (BF16, 64, 256, 256, 32, 4, 1, True),     # the last decoder layer
    (BF16, 64, 64, 64, 124, 64, 1, True),     # G % 8 != 0
    (BF16, 64, 64, 64, 128, 60, 1, True),     # N % 8 != 0
    (BF16, 64, 0, 4, 128, 64, 1, True),       # no input rows
    (BF16, 0, 64, 64, 128, 64, 1, True),      # no batch
    (BF16, 64, 64, 64, 128, 64, 1, False),    # an unaligned view
], ids=["fp32", "4-pass", "G=4", "N=4", "G%8", "N%8", "nb=0", "B=0",
        "unaligned"])
def test_what_keeps_the_first_toeplitz_kernel(dtype, B, nb, t_out, G, N,
                                               passes, aligned):
    assert not toeplitz.takes_tensor_cores(dtype, B, nb, t_out, G, N, passes,
                                           aligned)
    assert toeplitz.takes_tensor_cores(BF16, 64, 64, 64, 128, 64)


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 70), t_out=st.integers(1, 300))
def test_toeplitz_tile_plan_covers_every_row_once(B, t_out):
    """Every output row (b, t) lies in exactly one half tile; a half never
    runs from one batch row into the next (it holds b_half whole rows, or
    positions of one); its box dims stay within TMA's 256 and its rows
    within a warpgroup's 64."""
    t_half, b_half = toeplitz.tile_plan(t_out)
    assert 1 <= t_half <= 256 and 1 <= b_half <= 256
    assert t_half * b_half <= 64
    assert b_half == 1 or t_half >= t_out
    covered = np.zeros((B, t_out), dtype=np.int64)
    halves = toeplitz.tile_halves(B, t_out, t_half, b_half)
    for h in range(halves):
        b0, t0 = toeplitz.half_origin(h, t_out, t_half, b_half)
        assert b0 < B and t0 < t_out           # no half lies wholly outside
        covered[b0:b0 + b_half, t0:t0 + t_half] += 1
    assert (covered == 1).all()
    # two halves a 128-row tile
    assert -(-halves // 2) * 2 >= halves


def test_toeplitz_tile_plan_at_the_conv1d_layers():
    """t_out 64, 16 and 4: every row of a half used."""
    assert [toeplitz.tile_plan(t) for t in (256, 64, 16, 4)] == \
        [(64, 1), (64, 1), (16, 4), (4, 16)]
    assert toeplitz.tile_halves(4096, 16, 16, 4) == 1024


@pytest.mark.parametrize("G", [8, 64, 72, 128, 512])
def test_toeplitz_k_steps_walk_every_tap_in_64_channel_steps(G):
    steps = [toeplitz.k_step(kb, G) for kb in range(3 * -(-G // 64))]
    assert steps == [(j, g0) for j in range(3) for g0 in range(0, G, 64)]


def _toeplitz_stand_in(monkeypatch):
    launched = _stand_in(monkeypatch)
    monkeypatch.setattr(toeplitz, "kernel_device", lambda x: x.device)
    return launched


def test_linear_fwd_and_toeplitz_pass_the_kernel_code_and_plan(monkeypatch):
    """What reaches rvk_linear_fwd and rvk_toeplitz_fwd: the tile width and
    the kernel code last, the Toeplitz plan before them; the first version
    gets zeros for what it does not read."""
    launched = _toeplitz_stand_in(monkeypatch)
    x = torch.empty((4096, 512), device="meta", dtype=BF16)
    w = torch.empty((512, 256), device="meta", dtype=BF16)
    b = torch.empty((256,), device="meta", dtype=BF16)
    counts = (linear.linear_fwd.launches,
              linear.linear_fwd.tensor_core_launches)
    y = linear.linear_fwd(x, w, b, "relu")
    assert y.shape == (4096, 256) and y.dtype == BF16
    name, args = launched.pop()
    # batch, k, n, act, dtype, tile width, kernel
    assert name == "rvk_linear_fwd" and args[4:] == (4096, 512, 256, 1, 1,
                                                     64, 1)
    linear.linear_fwd(x, w, b, "relu", kernel="cuda_cores")
    assert launched.pop()[1][-2:] == (0, 0)
    linear.linear_fwd(x.float(), w.float(), b.float(), "tanh")
    # fp32: the register-tiled kernel (code 2) on its 128 x 64 tile (index 1)
    assert launched.pop()[1][4:] == (4096, 512, 256, 2, 0, 1, 2)
    assert (linear.linear_fwd.launches - counts[0],
            linear.linear_fwd.tensor_core_launches - counts[1]) == (3, 1)

    # encoder layer 2 of configs/conv1d.ini at batch 4096
    xs = torch.empty((4096, 64, 128), device="meta", dtype=BF16)
    ws = torch.empty((3, 128, 64), device="meta", dtype=BF16)
    bs = torch.empty((64,), device="meta", dtype=BF16)
    counts = (toeplitz.toeplitz_fwd.launches,
              toeplitz.toeplitz_fwd.tensor_core_launches)
    y = toeplitz.toeplitz_fwd(xs, ws, bs, "relu", 64, 1)
    assert y.shape == (4096, 64, 64)
    name, args = launched.pop()
    # B, nb, G, KB, N, t_out, shift, act, passes, dtype | t_half, b_half,
    # tile width, kernel
    assert name == "rvk_toeplitz_fwd"
    assert args[4:14] == (4096, 64, 128, 3, 64, 64, 1, 1, 1, 1)
    assert args[14:] == (64, 1, 64, 1)
    toeplitz.toeplitz_fwd(xs[:, :16].contiguous(), ws, bs, "relu", 16, 1)
    assert launched.pop()[1][14:] == (16, 4, 64, 1)
    toeplitz.toeplitz_fwd(xs, ws, bs, "relu", 64, 1, kernel="cuda_cores")
    assert launched.pop()[1][14:] == (0, 0, 0, 0)
    toeplitz.toeplitz_fwd(xs.float(), ws.float(), bs.float(), "relu", 64, 1,
                          4)
    assert launched.pop()[1][12:] == (4, 0, 0, 0, 0, 0)
    assert (toeplitz.toeplitz_fwd.launches - counts[0],
            toeplitz.toeplitz_fwd.tensor_core_launches - counts[1]) == (4, 2)


def test_named_tensor_cores_raise_for_linear_fwd_and_toeplitz(monkeypatch):
    launched = _toeplitz_stand_in(monkeypatch)
    x = torch.empty((8, 70), device="meta", dtype=BF16)
    w = torch.empty((70, 33), device="meta", dtype=BF16)
    b = torch.empty((33,), device="meta", dtype=BF16)
    with pytest.raises(ValueError, match="takes bf16 operands"):
        linear.linear_fwd(x, w, b, "relu", kernel="tensor_cores")
    for shapes, dtype, passes in (
            (((8, 256, 4), (3, 4, 32), (32,)), BF16, 1),        # G = 4
            (((8, 256, 32), (3, 32, 4), (4,)), BF16, 1),        # N = 4
            (((8, 64, 128), (3, 128, 64), (64,)), F32, 1),
            (((8, 64, 128), (3, 128, 64), (64,)), F32, 4)):
        xs, ws, bs = (torch.empty(sh, device="meta", dtype=dtype)
                      for sh in shapes)
        with pytest.raises(ValueError, match="takes bf16 operands"):
            toeplitz.toeplitz_fwd(xs, ws, bs, "relu", xs.shape[1], 1,
                                  passes, kernel="tensor_cores")
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: False)
    xs, ws, bs = (torch.empty(sh, device="meta", dtype=BF16)
                  for sh in ((8, 64, 128), (3, 128, 64), (64,)))
    with pytest.raises(ValueError, match="aligned = False"):
        toeplitz.toeplitz_fwd(xs, ws, bs, "relu", 64, 1,
                              kernel="tensor_cores")
    assert launched == []
    toeplitz.toeplitz_fwd(xs, ws, bs, "relu", 64, 1)
    assert launched.pop()[1][-1] == 0


@pytest.mark.parametrize("kernel", ["tensor-cores", "wgmma", "", None])
def test_an_unknown_kernel_raises_for_linear_fwd_and_toeplitz(kernel):
    x, w, b = torch.zeros((4, 8)), torch.zeros((8, 8)), torch.zeros((8,))
    with pytest.raises(ValueError, match="unknown kernel"):
        linear.linear_fwd(x, w, b, "relu", kernel=kernel)
    with pytest.raises(ValueError, match="unknown kernel"):
        toeplitz.toeplitz_fwd(torch.zeros((2, 6, 8)), torch.zeros((3, 8, 8)),
                              b, kernel=kernel)


@pytest.mark.parametrize("kernel", ["auto", *tensor_cores.KERNEL_CODES])
def test_cpu_tensors_take_the_plain_linear_fwd_and_toeplitz(kernel):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((5, 16), generator=g).to(BF16)
    w = torch.randn((16, 8), generator=g).to(BF16)
    b = torch.randn((8,), generator=g).to(BF16)
    xs = torch.randn((3, 9, 16), generator=g).to(BF16)
    ws = torch.randn((3, 16, 8), generator=g).to(BF16)
    before = (linear.linear_fwd.launches, toeplitz.toeplitz_fwd.launches,
              linear.linear_fwd.tensor_core_launches,
              toeplitz.toeplitz_fwd.tensor_core_launches)
    assert torch.equal(linear.linear_fwd(x, w, b, "tanh", kernel=kernel),
                       linear.linear_fwd_ref(x, w, b, "tanh"))
    assert torch.equal(
        toeplitz.toeplitz_fwd(xs, ws, b, "relu", 9, 1, kernel=kernel),
        toeplitz.toeplitz_fwd_ref(xs, ws, b, "relu", 9, 1))
    assert before == (linear.linear_fwd.launches,
                      toeplitz.toeplitz_fwd.launches,
                      linear.linear_fwd.tensor_core_launches,
                      toeplitz.toeplitz_fwd.tensor_core_launches)


# ------------------------------------------------ fp32: csrc/sgemm.cuh
#
# fp32 operands of linear_fwd and matmul_nt take the register-tiled fp32
# kernel when k and n are multiples of 4 and every pointer is on a 16-byte
# boundary; its tile is one of SGEMM_TILES (tensor_cores.sgemm_tile).

SGEMM = tensor_cores.KERNEL_CODES["sgemm"]


def _server_layers():
    """(k, n) of the deep server's eleven launches: every layer of
    configs/deep_wide.ini, at the server's batch of 256 all whole-k."""
    layers = _deep_layers()
    assert not any(linear.takes_ksplit(256, *kn) for kn in layers)
    return layers


@pytest.mark.parametrize("k,n", _server_layers())
def test_the_deep_server_takes_the_fp32_kernel(k, n):
    assert tensor_cores.takes_sgemm(F32, 256, k, n)
    assert tensor_cores.resolve_kernel("linear_fwd", "auto", F32, 256, k,
                                       n) == SGEMM
    assert tensor_cores.resolve_kernel("linear_fwd", "sgemm", F32, 256, k,
                                       n) == SGEMM
    # bf16 stays on the tensor cores; the k-split op has no fp32 form
    assert tensor_cores.resolve_kernel("linear_fwd", "auto", BF16, 256, k,
                                       n) == 1
    assert tensor_cores.resolve_kernel("linear_ksplit_fwd", "auto", F32, 256,
                                       k, n) == 0


@pytest.mark.parametrize("rows,k,m", [(8192, 2048, 256), (8192, 2048, 1024)],
                         ids=["dz", "dx"])
def test_matmul_nt_shapes_take_the_fp32_kernel(rows, k, m):
    assert tensor_cores.resolve_kernel("matmul_nt", "auto", F32, rows, k,
                                       m) == SGEMM
    assert tensor_cores.resolve_kernel("matmul_nt", "auto", BF16, rows, k,
                                       m) == 1


@pytest.mark.parametrize("op", sorted(tensor_cores.SGEMM_OPS))
@pytest.mark.parametrize("dtype,rows,k,n,aligned", [
    (BF16, 256, 4096, 4096, True),       # bf16: the tensor cores
    (torch.float16, 256, 4096, 4096, True),
    (F32, 1000, 70, 36, True),           # k % 4 != 0
    (F32, 1000, 72, 33, True),           # n % 4 != 0
    (F32, 0, 1024, 512, True),           # a zero-row batch
    (F32, 256, 1024, 0, True),
    (F32, 256, 1024, 512, False),        # an unaligned view
], ids=["bf16", "fp16", "k%4", "n%4", "no-rows", "no-columns", "unaligned"])
def test_what_keeps_the_fp32_kernel_away(op, dtype, rows, k, n, aligned):
    assert not tensor_cores.takes_sgemm(dtype, rows, k, n, aligned)
    assert tensor_cores.resolve_kernel(op, "auto", dtype, rows, k, n,
                                       aligned) != SGEMM
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        tensor_cores.resolve_kernel(op, "sgemm", dtype, rows, k, n, aligned)


@pytest.mark.parametrize("rows,k,n", [(4097, 1088, 544), (1000, 1096, 520),
                                      (1, 4, 4), (7, 12, 20), (130, 64, 264)])
def test_ragged_fp32_shapes_the_kernel_takes(rows, k, n):
    for op in tensor_cores.SGEMM_OPS:
        assert tensor_cores.resolve_kernel(op, "auto", F32, rows, k,
                                           n) == SGEMM


@pytest.mark.parametrize("rows,n,tile", [
    (4096, 4096, (128, 128)),   # 4096 x 4096 -> 4096: 1024 tiles
    (8192, 256, (128, 128)),    # matmul_nt's dz: 128 tiles, one wave
    (8192, 1024, (128, 128)),   # matmul_nt's dx
    (4096, 256, (128, 64)),     # the deep heads 512 -> 256
    (256, 4096, (128, 64)),     # the server's widest layers
    (256, 2048, (64, 64)),
    (256, 1024, (64, 64)),
    (256, 512, (64, 64)),
    (256, 256, (64, 64)),
    (1, 8, (64, 64)),
])
def test_sgemm_tile_rule_at_the_main_path_shapes(rows, n, tile):
    assert tensor_cores.sgemm_tile(rows, n, 132) == tile


def test_the_server_takes_narrower_tiles_than_4096_cubed():
    big = tensor_cores.sgemm_tile(4096, 4096, 132)
    for k, n in _server_layers():
        bm, bn = tensor_cores.sgemm_tile(256, n, 132)
        assert bm * bn < big[0] * big[1], (k, n)


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 20000), n=st.integers(1, 9000),
       sms=st.integers(1, 200))
def test_sgemm_tile_rule_takes_the_fewest_waves_times_area(rows, n, sms):
    def cost(tile):
        bm, bn = tile
        return -(-(-(-rows // bm) * -(-n // bn)) // sms) * bm * bn

    tile = tensor_cores.sgemm_tile(rows, n, sms)
    assert tile in tensor_cores.SGEMM_TILES
    assert cost(tile) == min(map(cost, tensor_cores.SGEMM_TILES))
    # the largest of those that cost the least
    assert tile[0] * tile[1] == max(t[0] * t[1]
                                    for t in tensor_cores.SGEMM_TILES
                                    if cost(t) == cost(tile))


def test_the_fp32_wrappers_pass_the_kernel_code_and_tile(monkeypatch):
    """What reaches rvk_linear_fwd and rvk_matmul_nt for fp32 operands:
    kernel code 2 and the index of the rule's tile, or the first version
    (code 0, tile 0) by name or for what the kernel cannot take; the
    counters follow."""
    launched = _stand_in(monkeypatch)
    counts = (linear.linear_fwd.launches, linear.linear_fwd.sgemm_launches,
              linear.linear_fwd.tensor_core_launches)
    for n, tile in ((4096, 1), (2048, 2), (256, 2)):
        x = torch.empty((256, 4096), device="meta", dtype=F32)
        w = torch.empty((4096, n), device="meta", dtype=F32)
        b = torch.empty((n,), device="meta", dtype=F32)
        y = linear.linear_fwd(x, w, b, "tanh")
        assert y.shape == (256, n) and y.dtype == F32
        name, args = launched.pop()
        # batch, k, n, act, dtype, tile, kernel
        assert name == "rvk_linear_fwd"
        assert args[4:] == (256, 4096, n, 2, 0, tile, SGEMM)
    linear.linear_fwd(x, w, b, "relu", kernel="cuda_cores")
    assert launched.pop()[1][-2:] == (0, 0)
    xs = torch.empty((256, 70), device="meta", dtype=F32)
    linear.linear_fwd(xs, torch.empty((70, 256), device="meta", dtype=F32),
                      b, "relu")
    assert launched.pop()[1][-2:] == (0, 0)        # k % 4: the first version
    assert (linear.linear_fwd.launches - counts[0],
            linear.linear_fwd.sgemm_launches - counts[1],
            linear.linear_fwd.tensor_core_launches - counts[2]) == (5, 3, 0)

    counts = (mlp.matmul_nt.launches, mlp.matmul_nt.sgemm_launches)
    for m, tile in ((256, 0), (1024, 0)):
        a = torch.empty((8192, 2048), device="meta", dtype=F32)
        wt = torch.empty((m, 2048), device="meta", dtype=F32)
        out = mlp.matmul_nt(a, wt)
        assert out.shape == (8192, m) and out.dtype == F32
        name, args = launched.pop()
        # batch, n, m, dtype, tile, kernel
        assert name == "rvk_matmul_nt"
        assert args[3:] == (8192, 2048, m, 0, tile, SGEMM)
    mlp.matmul_nt(a, wt, kernel="cuda_cores")
    assert launched.pop()[1][-2:] == (0, 0)
    assert (mlp.matmul_nt.launches - counts[0],
            mlp.matmul_nt.sgemm_launches - counts[1]) == (3, 2)


def test_a_named_fp32_kernel_raises_on_what_it_cannot_take(monkeypatch):
    launched = _stand_in(monkeypatch)
    x = torch.empty((8, 64), device="meta", dtype=BF16)
    w = torch.empty((64, 32), device="meta", dtype=BF16)
    b = torch.empty((32,), device="meta", dtype=BF16)
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        linear.linear_fwd(x, w, b, "relu", kernel="sgemm")
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        mlp.matmul_nt(x, w.t().contiguous(), kernel="sgemm")
    # the k-split op and the Toeplitz product have no fp32 form
    with pytest.raises(ValueError, match="no kernel 'sgemm'"):
        linear.linear_ksplit_fwd(x.float(), w.float(), b.float(), "relu",
                                 kernel="sgemm")
    monkeypatch.setattr(toeplitz, "kernel_device", lambda x: x.device)
    with pytest.raises(ValueError, match="no kernel 'sgemm'"):
        toeplitz.toeplitz_fwd(
            *(torch.empty(sh, device="meta") for sh in ((8, 64, 128),
                                                        (3, 128, 64), (64,))),
            "relu", 64, 1, kernel="sgemm")
    # an unaligned view
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: False)
    xf, wf, bf = x.float(), w.float(), b.float()
    with pytest.raises(ValueError, match="aligned = False"):
        linear.linear_fwd(xf, wf, bf, "relu", kernel="sgemm")
    with pytest.raises(ValueError, match="aligned = False"):
        mlp.matmul_nt(xf, wf.t().contiguous(), kernel="sgemm")
    assert launched == []
    linear.linear_fwd(xf, wf, bf, "relu")
    assert launched.pop()[1][-1] == 0
    mlp.matmul_nt(xf, wf.t().contiguous())
    assert launched.pop()[1][-1] == 0
