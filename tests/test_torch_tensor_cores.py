"""The choice between the hand-written kernels of ``linear_fwd``,
``linear_ksplit_fwd``, ``matmul_nt``, ``toeplitz_fwd``, ``encoder_fwd``,
``decoder_fwd`` and ``dec_bwd_fused`` (rawaudiovae_kelsey_tpu_torch/ops/
tensor_cores.py, ops/toeplitz.py, ops/mlp.py): a pure function of dtype,
shape and alignment; the tensor-core kernel's tile width, the Toeplitz tile
plan and the encoder heads' tile walk; what the wrappers hand the C entry
points (tests/test_torch_wgrad.py: the weight gradient's walk).
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
                                         "sgemm": 2, "narrow": 3}


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
    args = launched.pop()[1]
    assert args[4] is None and args[-1] == 2        # fp32: csrc/sgemm.cuh
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
    in one pass none, in four passes the same twelve (on their bf16
    halves)."""
    calls = _conv1d_toeplitz_calls(BF16)
    assert len(calls) == 15
    takes = [toeplitz.takes_tensor_cores(*c[:6], passes=c[6]) for c in calls]
    assert sum(takes) == 12
    for call, took in zip(calls, takes):
        assert took == (call[4] % 8 == 0 and call[5] % 8 == 0), call
    assert sorted(c[4] for c, t in zip(calls, takes) if not t) == [4, 4, 32]
    calls = _conv1d_toeplitz_calls(F32, 1)
    assert len(calls) == 15
    assert not any(toeplitz.takes_tensor_cores(*c[:6], passes=c[6])
                   for c in calls)
    calls = _conv1d_toeplitz_calls(F32, 4)
    assert [toeplitz.takes_tensor_cores(*c[:6], passes=c[6])
            for c in calls] == takes


@pytest.mark.parametrize("dtype,B,nb,t_out,G,N,passes,aligned", [
    (F32, 64, 64, 64, 128, 64, 1, True),      # fp32 promises IEEE products
    (F32, 64, 64, 64, 128, 60, 4, True),      # the 4-pass mode, N % 8
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
    # B, nb, G, KB, N, t_out, shift, act, passes, dtype | the contraction
    # window (k0, k_len) | t_half, b_half, tile width, kernel
    # (after x, w, b, y and the workspace, None but in four passes)
    assert name == "rvk_toeplitz_fwd" and args[4] is None
    assert args[5:15] == (4096, 64, 128, 3, 64, 64, 1, 1, 1, 1)
    assert args[15:] == (0, 384, 64, 1, 64, 1)
    toeplitz.toeplitz_fwd(xs[:, :16].contiguous(), ws, bs, "relu", 16, 1)
    assert launched.pop()[1][15:] == (0, 384, 16, 4, 64, 1)
    toeplitz.toeplitz_fwd(xs, ws, bs, "relu", 64, 1, kernel="cuda_cores")
    assert launched.pop()[1][15:] == (0, 384, 0, 0, 0, 0)
    # fp32, 4 passes: the tensor cores on the bf16 halves, 64 wide, the
    # halves' workspace (x's then w's, hi and lo) passed
    toeplitz.toeplitz_fwd(xs.float(), ws.float(), bs.float(), "relu", 64, 1,
                          4)
    args = launched.pop()[1]
    assert args[13:] == (4, 0, 0, 384, 64, 1, 64, 1)
    assert args[4].dtype == BF16 and args[4].shape == (
        2 * (4096 * 64 * 128 + 3 * 128 * 64),)
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
            (((8, 64, 128), (3, 128, 60), (60,)), F32, 4)):     # N % 8
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
    # bf16 stays on the tensor cores; the k-split op takes the fp32 kernel
    # too (the same launch)
    assert tensor_cores.resolve_kernel("linear_fwd", "auto", BF16, 256, k,
                                       n) == 1
    assert tensor_cores.resolve_kernel("linear_ksplit_fwd", "auto", F32, 256,
                                       k, n) == SGEMM


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
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        linear.linear_ksplit_fwd(x, w, b, "relu", kernel="sgemm")
    # the encoder's fp32 form takes latent widths of multiples of 4 only;
    # the Toeplitz product's takes one pass of fp32 operands
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        mlp.encoder_fwd(*_encoder_operands(8, 64, 32, 18, F32),
                        kernel="sgemm")
    monkeypatch.setattr(toeplitz, "kernel_device", lambda x: x.device)
    for dtype, passes in ((BF16, 1), (F32, 4)):
        with pytest.raises(ValueError, match="'sgemm' takes fp32 operands "
                                             "with one pass"):
            toeplitz.toeplitz_fwd(
                *(torch.empty(sh, device="meta", dtype=dtype)
                  for sh in ((8, 64, 128), (3, 128, 64), (64,))),
                "relu", 64, 1, passes, kernel="sgemm")
    # an unaligned view
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: False)
    xf, wf, bf = x.float(), w.float(), b.float()
    with pytest.raises(ValueError, match="aligned = False"):
        linear.linear_fwd(xf, wf, bf, "relu", kernel="sgemm")
    with pytest.raises(ValueError, match="aligned = False"):
        mlp.matmul_nt(xf, wf.t().contiguous(), kernel="sgemm")
    with pytest.raises(ValueError, match="aligned = False"):
        linear.linear_ksplit_fwd(xf, wf, bf, "relu", kernel="sgemm")
    assert launched == []
    linear.linear_fwd(xf, wf, bf, "relu")
    assert launched.pop()[1][-1] == 0
    mlp.matmul_nt(xf, wf.t().contiguous())
    assert launched.pop()[1][-1] == 0
    linear.linear_ksplit_fwd(xf, wf, bf, "relu")
    assert launched.pop()[1][-1] == 0


# ------------------------------------------- linear_ksplit_fwd in fp32 (row 15)
#
# fp32 k-split layers take the register-tiled fp32 kernel of linear_fwd
# (csrc/sgemm.cuh, code 2) under the same rule: the two ops launch the same
# kernel on the same operands.

@pytest.mark.parametrize("k,n", KSPLIT_LAYERS)
def test_the_deep_ksplit_layers_take_the_fp32_kernel(k, n):
    assert tensor_cores.resolve_kernel("linear_ksplit_fwd", "auto", F32,
                                       BATCH, k, n) == SGEMM
    assert tensor_cores.resolve_kernel("linear_ksplit_fwd", "sgemm", F32,
                                       BATCH, k, n) == SGEMM
    assert tensor_cores.resolve_kernel("linear_ksplit_fwd", "cuda_cores",
                                       F32, BATCH, k, n) == 0
    assert tensor_cores.resolve_kernel("linear_ksplit_fwd", "auto", BF16,
                                       BATCH, k, n) == 1


@pytest.mark.parametrize("kernel", ["auto", "cuda_cores", "tensor_cores",
                                    "sgemm"])
@pytest.mark.parametrize("dtype,rows,k,n,aligned", [
    (F32, 4096, 4096, 4096, True),
    (F32, 4097, 1088, 544, True),
    (F32, 1000, 70, 36, True),           # k % 4 != 0
    (F32, 1000, 72, 33, True),           # n % 4 != 0
    (F32, 4096, 1024, 512, False),       # an unaligned view
    (F32, 0, 1024, 512, True),
    (BF16, 4096, 1024, 512, True),       # bf16 named "sgemm" raises
    (BF16, 1000, 70, 33, True),
], ids=["4096^3", "ragged", "k%4", "n%4", "unaligned", "no-rows", "bf16",
        "bf16-ragged"])
def test_the_ksplit_rule_is_linear_fwds(kernel, dtype, rows, k, n, aligned):
    """Whatever linear_fwd resolves to (or raises), linear_ksplit_fwd does
    too, with its own name in the message."""
    def outcome(op):
        try:
            return tensor_cores.resolve_kernel(op, kernel, dtype, rows, k, n,
                                               aligned)
        except ValueError as err:
            return str(err).split(":", 1)[1]

    assert outcome("linear_ksplit_fwd") == outcome("linear_fwd")


def test_fp32_ksplit_passes_code_2_and_no_workspace(monkeypatch):
    """What reaches rvk_linear_ksplit_fwd for fp32 operands the fp32 kernel
    takes: no workspace, the tile's index in SGEMM_TILES, code 2; the
    first version by name keeps its (slices, batch, n) workspace; the
    counters follow."""
    launched = _stand_in(monkeypatch)
    counts = (linear.linear_ksplit_fwd.launches,
              linear.linear_ksplit_fwd.sgemm_launches,
              linear.linear_ksplit_fwd.tensor_core_launches)
    x = torch.empty((BATCH, 4096), device="meta", dtype=F32)
    for n, tile in ((4096, 0), (2048, 0), (512, 0)):
        w = torch.empty((4096, n), device="meta", dtype=F32)
        b = torch.empty((n,), device="meta", dtype=F32)
        y = linear.linear_ksplit_fwd(x, w, b, "relu")
        assert y.shape == (BATCH, n) and y.dtype == F32
        name, args = launched.pop()
        # x, w, b, y, ws | batch, k, n, slices, kslice, act, dtype, tile,
        # kernel
        assert name == "rvk_linear_ksplit_fwd" and args[4] is None
        assert args[5:] == (BATCH, 4096, n, 8, 512, 1, 0, tile, SGEMM)
    linear.linear_ksplit_fwd(x, w, b, "relu", kernel="cuda_cores")
    args = launched.pop()[1]
    assert tuple(args[4].shape) == (8, BATCH, 512) and args[-2:] == (0, 0)
    assert (linear.linear_ksplit_fwd.launches - counts[0],
            linear.linear_ksplit_fwd.sgemm_launches - counts[1],
            linear.linear_ksplit_fwd.tensor_core_launches - counts[2]) \
        == (4, 3, 0)


# ------------------------------------------------------ encoder_fwd (row 1)
#
# bf16 encoder_fwd takes the tensor-core mainloop when both of its products
# fit it: the hidden layer (k = seg, n = units) and the heads (k = units,
# n = latent, two outputs side by side in one launch).

def _encoder_operands(batch, seg, units, latent, dtype, device="meta"):
    """(w1, b1, w21, b21, w22, b22, x), empty, of the given widths."""
    shapes = ((seg, units), (units,), (units, latent), (latent,),
              (units, latent), (latent,), (batch, seg))
    return tuple(torch.empty(s, device=device, dtype=dtype) for s in shapes)


DENSE = (1024, 2048, 256)      # configs/default.ini: seg, units, latent
MICROBATCH = 8192


def test_the_dense_config_is_the_encoders_main_path():
    cfg = load_config(ROOT / "configs" / "default.ini")
    assert (cfg.audio.segment_length, cfg.vae.n_units,
            cfg.vae.latent_dim) == DENSE
    assert cfg.tpu.microbatch_size == MICROBATCH
    assert cfg.tpu.precision == "bfloat16" and cfg.tpu.backend == "pallas"


@pytest.mark.parametrize("batch", [MICROBATCH, 1000, 1, 256])
def test_the_dense_encoder_takes_the_tensor_cores_in_bf16(batch):
    assert mlp.resolve_encoder("auto", BF16, batch, *DENSE) == 1
    assert mlp.resolve_encoder("tensor_cores", BF16, batch, *DENSE) == 1
    assert mlp.resolve_encoder("cuda_cores", BF16, batch, *DENSE) == 0
    # fp32 (the server, the fp32 tiers) takes the fp32 kernel
    assert mlp.resolve_encoder("auto", F32, batch, *DENSE) == SGEMM


@pytest.mark.parametrize("dtype,batch,seg,units,latent,aligned", [
    (F32, MICROBATCH, 1024, 2048, 38, True),     # fp32, latent % 4 != 0
    (BF16, MICROBATCH, 1024, 2048, 36, True),    # latent % 8 != 0
    (BF16, MICROBATCH, 1024, 2044, 256, True),   # units % 8 != 0
    (BF16, MICROBATCH, 1020, 2048, 256, True),   # seg % 8 != 0
    (BF16, 1000, 70, 130, 18, True),             # the GPU tests' odd widths
    (BF16, MICROBATCH, 1024, 2048, 256, False),  # an unaligned view
    (BF16, 0, 1024, 2048, 256, True),            # no rows
    (torch.float16, MICROBATCH, 1024, 2048, 256, True),
], ids=["fp32", "latent%8", "units%8", "seg%8", "odd", "unaligned",
        "no-rows", "fp16"])
def test_what_keeps_the_encoder_on_the_cuda_cores(dtype, batch, seg, units,
                                                  latent, aligned):
    widths = (batch, seg, units, latent, aligned)
    assert mlp.resolve_encoder("auto", dtype, *widths) == 0
    assert mlp.resolve_encoder("cuda_cores", dtype, *widths) == 0
    with pytest.raises(ValueError, match="encoder_fwd: kernel "
                       "'tensor_cores' takes bf16 operands"):
        mlp.resolve_encoder("tensor_cores", dtype, *widths)
    with pytest.raises(ValueError, match="encoder_fwd: kernel 'sgemm' "
                       "takes fp32 operands"):
        mlp.resolve_encoder("sgemm", dtype, *widths)


def test_the_encoder_passes_the_kernel_code_and_both_tile_widths(
        monkeypatch):
    """What reaches rvk_encoder_fwd: the dtype, one slice of each product,
    the hidden product's tile width, the heads' tile width (both heads'
    tile columns counted), the kernel code, no workspace; the first version
    gets zeros for the slices and widths; fp32 takes the fp32 kernel's
    plans (``tensor_cores.sgemm_fwd_plan``)."""
    launched = _stand_in(monkeypatch)
    counts = (mlp.encoder_fwd.launches, mlp.encoder_fwd.tensor_core_launches,
              mlp.encoder_fwd.sgemm_launches)
    # batch → (hidden width, heads width) on 132 SMs: at 8192, 64 tile rows
    # x 8 columns of 256 (four waves, fewest waves x width ties, the wider
    # wins) and 64 x 2 heads' columns of 256, one wave (128 tiles); at the
    # server's 256, 2 tile rows: 64-wide tiles in both
    for batch, widths in ((MICROBATCH, (256, 256)), (256, (64, 64)),
                          (1, (64, 64))):
        ops = _encoder_operands(batch, *DENSE, BF16)
        mu, logvar, h = mlp.encoder_fwd(*ops)
        assert (mu.shape, logvar.shape, h.shape) == (
            (batch, 256), (batch, 256), (batch, 2048))
        name, args = launched.pop()
        # x, w1, b1, w21, b21, w22, b22, mu, logvar, h, workspace | batch,
        # seg, units, latent, dtype, split_hidden, split_heads, tile_hidden,
        # tile_heads, kernel
        assert name == "rvk_encoder_fwd" and args[0] is ops[-1]
        assert args[10] is None
        assert args[11:] == (batch, *DENSE, 1, 1, 1, *widths, 1)
    mlp.encoder_fwd(*_encoder_operands(MICROBATCH, *DENSE, BF16),
                    kernel="cuda_cores")
    assert launched.pop()[1][15:] == (1, 0, 0, 0, 0, 0)
    mlp.encoder_fwd(*_encoder_operands(256, *DENSE, F32))
    (tile_h, split_h), (tile_o, split_o) = (
        tensor_cores.sgemm_fwd_plan(256, 1024, 2048, 132),
        tensor_cores.sgemm_fwd_plan(256, 2048, 256, 132, 2))
    args = launched.pop()[1]
    assert args[15:] == (0, split_h, split_o, tile_h, tile_o, SGEMM)
    mlp.encoder_fwd(*_encoder_operands(100, 1024, 2048, 36, BF16))
    assert launched.pop()[1][15:] == (1, 0, 0, 0, 0, 0)   # latent % 8
    mlp.encoder_fwd(*_encoder_operands(100, 1024, 2048, 38, F32))
    assert launched.pop()[1][15:] == (0, 0, 0, 0, 0, 0)   # latent % 4
    assert (mlp.encoder_fwd.launches - counts[0],
            mlp.encoder_fwd.tensor_core_launches - counts[1],
            mlp.encoder_fwd.sgemm_launches - counts[2]) == (7, 3, 1)
    # nothing to compute: no launch
    mlp.encoder_fwd(*_encoder_operands(0, *DENSE, BF16))
    assert launched == []


def test_a_named_tensor_core_encoder_raises_on_what_it_cannot_take(
        monkeypatch):
    launched = _stand_in(monkeypatch)
    with pytest.raises(ValueError, match="latent 36"):
        mlp.encoder_fwd(*_encoder_operands(8, 1024, 2048, 36, BF16),
                        kernel="tensor_cores")
    with pytest.raises(ValueError, match="takes bf16 operands"):
        mlp.encoder_fwd(*_encoder_operands(8, *DENSE, F32),
                        kernel="tensor_cores")
    with pytest.raises(ValueError, match="unknown kernel"):
        mlp.encoder_fwd(*_encoder_operands(8, *DENSE, BF16), kernel="wgmma")
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: False)
    with pytest.raises(ValueError, match="aligned = False"):
        mlp.encoder_fwd(*_encoder_operands(8, *DENSE, BF16),
                        kernel="tensor_cores")
    assert launched == []
    mlp.encoder_fwd(*_encoder_operands(8, *DENSE, BF16))
    assert launched.pop()[1][-1] == 0


def test_the_encoder_checks_every_pointer_for_alignment(monkeypatch):
    """The rule reads all seven operands' pointers, biases included (the
    epilogue loads bias pairs)."""
    _stand_in(monkeypatch)
    seen = []
    monkeypatch.setattr(tensor_cores, "pointers_aligned",
                        lambda *t: seen.append(t) or True)
    ops = _encoder_operands(8, *DENSE, BF16)
    mlp.encoder_fwd(*ops)
    assert len(seen) == 1 and len(seen[0]) == 7
    assert {id(t) for t in seen[0]} == {id(t) for t in ops}


def test_a_cpu_encoder_takes_the_plain_version_whatever_the_kernel():
    g = torch.Generator().manual_seed(0)
    ops = [torch.randn(t.shape, generator=g).to(BF16)
           for t in _encoder_operands(5, 16, 24, 8, BF16, "cpu")]
    before = (mlp.encoder_fwd.launches, mlp.encoder_fwd.tensor_core_launches)
    want = mlp.encoder_fwd_ref(*ops)
    for kernel in ("auto", "cuda_cores", "tensor_cores", "sgemm"):
        for got, w in zip(mlp.encoder_fwd(*ops, kernel=kernel), want):
            assert torch.equal(got, w)
    assert before == (mlp.encoder_fwd.launches,
                      mlp.encoder_fwd.tensor_core_launches)


# The heads' tile walk (csrc/wgmma.cuh HeadsTiles, the mainloop's column
# split), modelled in Python: the joined output has 2 · ceil(latent / BN)
# tile columns; column tn belongs to head tn // per_out at n0 = (tn mod
# per_out) · BN, stores the 64-wide boxes that start below latent (TMA clips
# the last), and its epilogue reads the bias of the joined column; tile_origin
# walks groups of eight tile rows.

def _tile_origin(tile, tiles_m, tiles_n):
    group = tile // (8 * tiles_n)
    first = group * 8
    rows = min(tiles_m - first, 8)
    in_group = tile - group * 8 * tiles_n
    return first + in_group % rows, in_group // rows


def _heads_column(tn, latent, bn):
    per_out = -(-latent // bn)
    out = tn // per_out
    return out, (tn - out * per_out) * bn


def _stored_columns(tn, latent, bn):
    """Joined columns tile column tn writes: its head's boxes of 64 that
    start below latent, each clipped at latent."""
    out, n0 = _heads_column(tn, latent, bn)
    cols = []
    for c in range(bn // 64):
        start = n0 + 64 * c
        if start < latent:
            cols += [out * latent + n
                     for n in range(start, min(start + 64, latent))]
    return out, cols


@settings(max_examples=300, deadline=None)
@given(latent=st.integers(1, 160).map(lambda v: 8 * v),
       bn=st.sampled_from(tensor_cores.TILE_WIDTHS))
def test_every_heads_column_is_written_by_exactly_one_tile(latent, bn):
    per_out = -(-latent // bn)
    written = np.zeros(2 * latent, dtype=np.int64)
    for tn in range(2 * per_out):
        out, cols = _stored_columns(tn, latent, bn)
        assert cols, tn                      # no tile column lies outside
        # no tile crosses the heads: its columns and its bias all lie in one
        assert {c // latent for c in cols} == {out}
        assert all(c % 2 == 0 or c - 1 in cols for c in cols)
        written[cols] += 1
    assert (written == 1).all()


@settings(max_examples=200, deadline=None)
@given(tiles_m=st.integers(1, 200), latent=st.integers(1, 80).map(
    lambda v: 8 * v), bn=st.sampled_from(tensor_cores.TILE_WIDTHS))
def test_the_tile_walk_visits_each_heads_tile_once(tiles_m, latent, bn):
    """tile_origin over the joined grid is a bijection onto (tile row, tile
    column): every (row, head, column) of both heads is one tile."""
    tiles_n = 2 * -(-latent // bn)
    seen = {_tile_origin(t, tiles_m, tiles_n)
            for t in range(tiles_m * tiles_n)}
    assert seen == {(tm, tn) for tm in range(tiles_m)
                    for tn in range(tiles_n)}


def test_the_heads_launch_at_the_microbatch_is_one_wave():
    """8192 rows, latent 256: 64 tile rows x 2 heads' columns of 256 = 128
    tiles for 132 SMs; a launch a head would be 64 tiles twice."""
    tiles_m = MICROBATCH // tensor_cores.TILE_M
    width = tensor_cores.tile_n(2 * tiles_m, 256, 132)
    assert width == 256
    assert tiles_m * 2 * -(-256 // width) == 128 <= 132


def _emulate_heads(h, w21, b21, w22, b22, bn):
    """mu and logvar as the heads' tile walk computes them: each tile
    column's (h · its head's W columns) in fp32 from bf16 values, plus the
    bias of the joined column, rounded once."""
    latent = w21.shape[1]
    out = [torch.empty((h.shape[0], latent), dtype=h.dtype)
           for _ in range(2)]
    hf = h.float()
    for tn in range(2 * -(-latent // bn)):
        head, n0 = _heads_column(tn, latent, bn)
        w, b = ((w21, b21), (w22, b22))[head]
        n1 = min(n0 + bn, latent)
        out[head][:, n0:n1] = (hf @ w[:, n0:n1].float()
                               + b[n0:n1].float()).to(h.dtype)
    return out


@pytest.mark.parametrize("latent,bn", [(64, 64), (72, 64), (200, 128),
                                       (24, 256)])
def test_the_heads_tile_walk_computes_the_plain_heads(latent, bn):
    """The emulated walk against the plain version and against the JAX
    kernel in interpret mode, bf16, at a latent that is and ones that are
    not a multiple of the tile width."""
    import jax.numpy as jnp

    from rawaudiovae_kelsey_tpu.ops import pallas_mlp as jmlp

    rng = np.random.default_rng(latent)
    seg, units, batch = 64, 128, 40
    arrays = [rng.standard_normal((seg, units)) / seg ** 0.5,
              rng.standard_normal(units) * 0.1,
              rng.standard_normal((units, latent)) / units ** 0.5,
              rng.standard_normal(latent) * 0.1,
              rng.standard_normal((units, latent)) / units ** 0.5,
              rng.standard_normal(latent) * 0.1,
              rng.uniform(-1, 1, (batch, seg))]
    ops = [torch.from_numpy(a.astype(np.float32)).to(BF16) for a in arrays]
    mu, logvar, h = mlp.encoder_fwd_ref(*ops)
    got = _emulate_heads(h, *ops[2:6], bn)
    for g, w in zip(got, (mu, logvar)):
        # the same fp32 sums, cut along n: at most one bf16 ulp apart
        assert float((g.float() - w.float()).abs().max()) \
            <= 2.0 ** -8 * float(w.float().abs().max())
    jax_ops = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for t in ops]
    want = jmlp.encoder_fwd(*jax_ops)
    for g, w in zip((*got, h), want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert g.shape == w.shape
        assert float((g.float() - w).abs().max()) \
            <= 2.0 ** -6 * float(w.abs().max())


# ---- bf16 decoder_fwd and dec_bwd_fused on the tensor cores
#
# decoder_fwd takes the tensor-core mainloop when both of its products fit
# it (h3: k = latent, n = units; y: k = units, n = seg); dec_bwd_fused when
# dh3 (k = seg, n = units) and dz (k = units, n = latent) do, the weight
# gradient contracting the batch, of any length.

def _decoder_operands(batch, latent, units, seg, dtype, device="meta"):
    """(w3, b3, w4, b4, z), empty, of the given widths."""
    shapes = ((latent, units), (units,), (units, seg), (seg,),
              (batch, latent))
    return tuple(torch.empty(s, device=device, dtype=dtype) for s in shapes)


def _dec_bwd_operands(batch, seg, units, latent, dtype, device="meta"):
    """(da, h3, z, w4, w3), empty, of the given widths."""
    shapes = ((batch, seg), (batch, units), (batch, latent), (units, seg),
              (latent, units))
    return tuple(torch.empty(s, device=device, dtype=dtype) for s in shapes)


DECODER = (256, 2048, 1024)    # configs/default.ini: latent, units, seg


@pytest.mark.parametrize("batch", [MICROBATCH, 1000, 1, 256])
def test_the_dense_decoder_and_its_backward_take_the_tensor_cores(batch):
    for resolve, widths in ((mlp.resolve_decoder, DECODER),
                            (mlp.resolve_dec_bwd, DENSE)):
        assert resolve("auto", BF16, batch, *widths) == 1
        assert resolve("tensor_cores", BF16, batch, *widths) == 1
        assert resolve("cuda_cores", BF16, batch, *widths) == 0
    # fp32 (the server, the fp32 tiers): the decoder takes the fp32 kernel,
    # and so does its fused backward (on no fp32 path: sgemm.cuh's launches
    # one after another)
    assert mlp.resolve_decoder("auto", F32, batch, *DECODER) == SGEMM
    assert mlp.resolve_dec_bwd("auto", F32, batch, *DENSE) == SGEMM


@pytest.mark.parametrize("op", ["decoder_fwd", "dec_bwd_fused"])
@pytest.mark.parametrize("dtype,batch,a,b,c,aligned", [
    (F32, MICROBATCH, 1024, 2048, 38, True),     # fp32, latent % 4 != 0
    (BF16, MICROBATCH, 1024, 2048, 36, True),    # latent % 8 != 0
    (BF16, MICROBATCH, 1024, 2044, 256, True),   # units % 8 != 0
    (BF16, MICROBATCH, 1020, 2048, 256, True),   # seg % 8 != 0
    (BF16, 1000, 70, 130, 18, True),             # the GPU tests' odd widths
    (BF16, MICROBATCH, 1024, 2048, 256, False),  # an unaligned view
    (BF16, 0, 1024, 2048, 256, True),            # no rows
    (torch.float16, MICROBATCH, 1024, 2048, 256, True),
], ids=["fp32", "latent%8", "units%8", "seg%8", "odd", "unaligned",
        "no-rows", "fp16"])
def test_what_keeps_the_decoder_on_the_cuda_cores(op, dtype, batch, a, b, c,
                                                  aligned):
    """(a, b, c) = (seg, units, latent); the decoder takes them as (latent,
    units, seg)."""
    if op == "decoder_fwd":
        resolve, widths = mlp.resolve_decoder, (batch, c, b, a, aligned)
    else:
        resolve, widths = mlp.resolve_dec_bwd, (batch, a, b, c, aligned)
    assert resolve("auto", dtype, *widths) == 0
    assert resolve("cuda_cores", dtype, *widths) == 0
    with pytest.raises(ValueError, match=f"{op}: kernel 'tensor_cores' "
                       "takes bf16 operands"):
        resolve("tensor_cores", dtype, *widths)
    # both have an fp32 form, which these operands do not fit
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        resolve("sgemm", dtype, *widths)


def test_the_decoder_passes_the_kernel_code_and_both_tile_widths(
        monkeypatch):
    """What reaches rvk_decoder_fwd: 18 arguments, the dtype, one slice
    of each product, h3's tile width, y's tile width, the kernel code, no
    workspace; the first version gets zeros for the slices and widths;
    fp32 takes the fp32 kernel's plans (``tensor_cores.sgemm_fwd_plan``)."""
    launched = _stand_in(monkeypatch)
    counts = (mlp.decoder_fwd.launches, mlp.decoder_fwd.tensor_core_launches,
              mlp.decoder_fwd.sgemm_launches)
    # batch → (h3 width, y width) on 132 SMs: at 8192, 64 tile rows x 8
    # columns of 256 for h3 (four waves; fewest waves x width ties, the
    # wider wins) and x 4 for y (two waves); at 256, 2 tile rows: 64 wide
    for batch, widths in ((MICROBATCH, (256, 256)), (256, (64, 64)),
                          (1, (64, 64))):
        ops = _decoder_operands(batch, *DECODER, BF16)
        y, h3 = mlp.decoder_fwd(*ops)
        assert (y.shape, h3.shape) == ((batch, 1024), (batch, 2048))
        name, args = launched.pop()
        # z, w3, b3, w4, b4, y, h3, workspace | batch, latent, units, seg,
        # dtype, split_hidden, split_out, tile_hidden, tile_out, kernel
        assert name == "rvk_decoder_fwd" and len(args) == 18
        assert args[0] is ops[-1] and args[5] is y and args[6] is h3
        assert args[7] is None
        assert args[8:] == (batch, *DECODER, 1, 1, 1, *widths, 1)
    mlp.decoder_fwd(*_decoder_operands(MICROBATCH, *DECODER, BF16),
                    kernel="cuda_cores")
    assert launched.pop()[1][12:] == (1, 0, 0, 0, 0, 0)
    mlp.decoder_fwd(*_decoder_operands(256, *DECODER, F32))
    (tile_h, split_h), (tile_o, split_o) = (
        tensor_cores.sgemm_fwd_plan(256, 256, 2048, 132),
        tensor_cores.sgemm_fwd_plan(256, 2048, 1024, 132))
    assert launched.pop()[1][12:] == (0, split_h, split_o, tile_h, tile_o,
                                      SGEMM)
    mlp.decoder_fwd(*_decoder_operands(100, 36, 2048, 1024, BF16))
    assert launched.pop()[1][12:] == (1, 0, 0, 0, 0, 0)   # latent % 8
    mlp.decoder_fwd(*_decoder_operands(100, 38, 2048, 1024, F32))
    assert launched.pop()[1][12:] == (0, 0, 0, 0, 0, 0)   # latent % 4
    assert (mlp.decoder_fwd.launches - counts[0],
            mlp.decoder_fwd.tensor_core_launches - counts[1],
            mlp.decoder_fwd.sgemm_launches - counts[2]) == (7, 3, 1)
    mlp.decoder_fwd(*_decoder_operands(0, *DECODER, BF16))
    assert launched == []


def test_dec_bwd_passes_the_kernel_code_tiles_split_and_workspace(
        monkeypatch):
    """What reaches rvk_dec_bwd_fused: 20 arguments, the dtype, the tile
    widths of dh3, dz and dW3, the batch split, the kernel code, and a
    (split, latent·units + units) fp32 workspace where the split is more
    than one; the first version gets zeros and no workspace."""
    launched = _stand_in(monkeypatch)
    counts = (mlp.dec_bwd_fused.launches,
              mlp.dec_bwd_fused.tensor_core_launches)
    # batch → (dh3, dz, dW3 widths, split): at 8192 dh3 is 64 x 8 tiles of
    # 256, dz 64 tile rows x 2 of 128 (one wave), dW3 32 tiles of 128 x 4
    # slices of 2048 rows; at 4096, dz 32 x 4 tiles of 64 (one wave) and
    # dW3 64 tiles of 64 x 2 slices
    for batch, plan in ((MICROBATCH, (256, 128, 128, 4)),
                        (4096, (256, 64, 64, 2)), (1, (64, 64, 64, 1))):
        ops = _dec_bwd_operands(batch, *DENSE, BF16)
        dz, dw3, db3 = mlp.dec_bwd_fused(*ops)
        assert (dz.shape, dw3.shape, db3.shape) == (
            (batch, 256), (256, 2048), (2048,))
        assert dz.dtype == BF16 and dw3.dtype == db3.dtype == F32
        name, args = launched.pop()
        # da, h3, z, w4, w3, dh3, dz, dw3, db3, workspace | batch, seg,
        # units, latent, dtype, tile_dh3, tile_dz, tile_dw, split, kernel
        assert name == "rvk_dec_bwd_fused" and len(args) == 20
        assert args[:5] == ops and args[6] is dz and args[7] is dw3
        assert args[5].shape == (batch, 2048) and args[5].dtype == BF16
        assert args[10:] == (batch, *DENSE, 1, *plan, 1)
        split = plan[-1]
        if split > 1:
            assert args[9].shape == (split, 256 * 2048 + 2048)
            assert args[9].dtype == F32
        else:
            assert args[9] is None
    mlp.dec_bwd_fused(*_dec_bwd_operands(MICROBATCH, *DENSE, BF16),
                      kernel="cuda_cores")
    args = launched.pop()[1]
    assert args[9] is None and args[14:] == (1, 0, 0, 0, 0, 0)
    # fp32: sgemm.cuh's launches, each at its own op's plan
    mlp.dec_bwd_fused(*_dec_bwd_operands(256, *DENSE, F32))
    args = launched.pop()[1]
    plan = tensor_cores.sgemm_wgrad_plan(256, 2048, 256, 132)
    assert args[14:] == (
        0, tensor_cores.SGEMM_TILES.index(tensor_cores.sgemm_tile(256, 2048,
                                                                  132)),
        tensor_cores.SGEMM_TILES.index(tensor_cores.sgemm_tile(256, 256,
                                                               132)),
        *plan, SGEMM)
    assert (args[9] is None) == (plan[1] == 1)
    # no rows: the first version, which writes zero gradients
    mlp.dec_bwd_fused(*_dec_bwd_operands(0, *DENSE, BF16))
    assert launched.pop()[1][14:] == (1, 0, 0, 0, 0, 0)
    assert (mlp.dec_bwd_fused.launches - counts[0],
            mlp.dec_bwd_fused.tensor_core_launches - counts[1]) == (6, 3)


@pytest.mark.parametrize("op", ["decoder_fwd", "dec_bwd_fused"])
def test_a_named_tensor_core_decoder_raises_on_what_it_cannot_take(
        monkeypatch, op):
    launched = _stand_in(monkeypatch)
    if op == "decoder_fwd":
        fn = mlp.decoder_fwd
        odd = _decoder_operands(8, 36, 2048, 1024, BF16)
        dense = _decoder_operands(8, *DECODER, BF16)
    else:
        fn = mlp.dec_bwd_fused
        odd = _dec_bwd_operands(8, 1024, 2048, 36, BF16)
        dense = _dec_bwd_operands(8, *DENSE, BF16)
    with pytest.raises(ValueError, match="latent 36"):
        fn(*odd, kernel="tensor_cores")
    with pytest.raises(ValueError, match="takes bf16 operands"):
        fn(*[t.float() for t in dense], kernel="tensor_cores")
    with pytest.raises(ValueError, match="unknown kernel"):
        fn(*dense, kernel="wgmma")
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        fn(*dense, kernel="sgemm")
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: False)
    with pytest.raises(ValueError, match="aligned = False"):
        fn(*dense, kernel="tensor_cores")
    assert launched == []
    fn(*dense)
    assert launched.pop()[1][-1] == 0


@pytest.mark.parametrize("op", ["decoder_fwd", "dec_bwd_fused"])
def test_the_decoder_checks_every_pointer_for_alignment(monkeypatch, op):
    """The rule reads all five operands' pointers (the decoder's biases
    too: the epilogue loads bias pairs)."""
    _stand_in(monkeypatch)
    seen = []
    monkeypatch.setattr(tensor_cores, "pointers_aligned",
                        lambda *t: seen.append(t) or True)
    if op == "decoder_fwd":
        ops = _decoder_operands(8, *DECODER, BF16)
        mlp.decoder_fwd(*ops)
    else:
        ops = _dec_bwd_operands(8, *DENSE, BF16)
        mlp.dec_bwd_fused(*ops)
    assert len(seen) == 1 and len(seen[0]) == 5
    assert {id(t) for t in seen[0]} == {id(t) for t in ops}


def test_a_cpu_decoder_takes_the_plain_version_whatever_the_kernel():
    g = torch.Generator().manual_seed(0)
    dec = [torch.randn(t.shape, generator=g).to(BF16)
           for t in _decoder_operands(5, 8, 24, 16, BF16, "cpu")]
    bwd = [torch.randn(t.shape, generator=g).to(BF16)
           for t in _dec_bwd_operands(5, 16, 24, 8, BF16, "cpu")]
    before = (mlp.decoder_fwd.launches, mlp.decoder_fwd.tensor_core_launches,
              mlp.dec_bwd_fused.launches,
              mlp.dec_bwd_fused.tensor_core_launches)
    want = mlp.decoder_fwd_ref(*dec)
    want_bwd = mlp.dec_bwd_fused_ref(*bwd)
    for kernel in ("auto", "cuda_cores", "tensor_cores", "sgemm"):
        for got, w in zip(mlp.decoder_fwd(*dec, kernel=kernel), want):
            assert torch.equal(got, w)
        for got, w in zip(mlp.dec_bwd_fused(*bwd, kernel=kernel), want_bwd):
            assert torch.equal(got, w)
    assert before == (mlp.decoder_fwd.launches,
                      mlp.decoder_fwd.tensor_core_launches,
                      mlp.dec_bwd_fused.launches,
                      mlp.dec_bwd_fused.tensor_core_launches)


# ---- bf16 grad_accum and enc_bwd_dw1 on the tensor cores
#
# grad_accum takes the tensor-core weight gradient (csrc/wgmma.cuh
# launch_wgrad) when its operands' rows are TMA's 16-byte rows (n and m
# multiples of 8) and there is a row, and the fp32 weight gradient of
# csrc/sgemm.cuh on fp32 rows of 16 bytes (n and m multiples of 4);
# enc_bwd_dw1 the tensor cores when dh, two products joined along k, fits
# (k = latent, n = units) and seg is a multiple of 8.  The step's uses: dW4
# = h3ᵀ da (n = units, m = seg) and dW1 = xᵀ dh.

DW4 = (2048, 1024)             # configs/default.ini: units, seg


def _grad_accum_operands(batch, n, m, dtype, device="meta"):
    """(a, b), empty, of the given widths."""
    return tuple(torch.empty(s, device=device, dtype=dtype)
                 for s in ((batch, n), (batch, m)))


def _enc_bwd_operands(batch, seg, units, latent, dtype, device="meta"):
    """(x, h, dmu, dlogvar, w21, w22), empty, of the given widths."""
    shapes = ((batch, seg), (batch, units), (batch, latent), (batch, latent),
              (units, latent), (units, latent))
    return tuple(torch.empty(s, device=device, dtype=dtype) for s in shapes)


@pytest.mark.parametrize("batch", [MICROBATCH, 1000, 1, 256])
def test_the_dense_weight_gradients_take_the_tensor_cores(batch):
    for resolve, widths in ((mlp.resolve_grad_accum, DW4),
                            (mlp.resolve_enc_bwd_dw1, DENSE)):
        assert resolve("auto", BF16, batch, *widths) == 1
        assert resolve("tensor_cores", BF16, batch, *widths) == 1
        assert resolve("cuda_cores", BF16, batch, *widths) == 0
    # fp32 (the `float32` / `highest` tiers): grad_accum takes the fp32
    # kernel, and so does enc_bwd_dw1 (on no fp32 path: sgemm.cuh's
    # launches one after another)
    assert mlp.resolve_grad_accum("auto", F32, batch, *DW4) == SGEMM
    assert mlp.resolve_grad_accum("sgemm", F32, batch, *DW4) == SGEMM
    assert mlp.resolve_enc_bwd_dw1("auto", F32, batch, *DENSE) == SGEMM


def _kept_off_the_tensor_cores(op, resolve, dtype, widths,
                               sgemm="no kernel 'sgemm'"):
    assert resolve("auto", dtype, *widths) == 0
    assert resolve("cuda_cores", dtype, *widths) == 0
    with pytest.raises(ValueError, match=f"{op}: kernel 'tensor_cores' "
                       "takes bf16 operands"):
        resolve("tensor_cores", dtype, *widths)
    with pytest.raises(ValueError, match=sgemm):
        resolve("sgemm", dtype, *widths)
    with pytest.raises(ValueError, match="unknown kernel"):
        resolve("wgmma", dtype, *widths)


@pytest.mark.parametrize("dtype,batch,n,m,aligned", [
    (F32, MICROBATCH, 2048, 1022, True),      # fp32, m % 4 != 0
    (BF16, MICROBATCH, 2044, 1024, True),     # n % 8 != 0
    (BF16, MICROBATCH, 2048, 1020, True),     # m % 8 != 0
    (BF16, 1000, 70, 18, True),               # odd widths
    (BF16, MICROBATCH, 2048, 1024, False),    # an unaligned view
    (BF16, 0, 2048, 1024, True),              # no rows
    (torch.float16, MICROBATCH, 2048, 1024, True),
], ids=["fp32", "n%8", "m%8", "odd", "unaligned", "no-rows", "fp16"])
def test_what_keeps_grad_accum_on_the_cuda_cores(dtype, batch, n, m,
                                                 aligned):
    # grad_accum has an fp32 form, which none of these operands fit
    _kept_off_the_tensor_cores("grad_accum", mlp.resolve_grad_accum, dtype,
                               (batch, n, m, aligned),
                               "'sgemm' takes fp32 operands")


@pytest.mark.parametrize("dtype,batch,seg,units,latent,aligned", [
    (F32, MICROBATCH, 1024, 2048, 38, True),      # fp32, latent % 4 != 0
    (BF16, MICROBATCH, 1024, 2048, 36, True),     # latent % 8 != 0
    (BF16, MICROBATCH, 1024, 2044, 256, True),    # units % 8 != 0
    (BF16, MICROBATCH, 1020, 2048, 256, True),    # seg % 8 != 0
    (BF16, 1000, 70, 130, 18, True),              # odd widths
    (BF16, MICROBATCH, 1024, 2048, 256, False),   # an unaligned view
    (BF16, 0, 1024, 2048, 256, True),             # no rows
    (torch.float16, MICROBATCH, 1024, 2048, 256, True),
], ids=["fp32", "latent%8", "units%8", "seg%8", "odd", "unaligned",
        "no-rows", "fp16"])
def test_what_keeps_enc_bwd_dw1_on_the_cuda_cores(dtype, batch, seg, units,
                                                  latent, aligned):
    # enc_bwd_dw1 has an fp32 form, which none of these operands fit
    _kept_off_the_tensor_cores("enc_bwd_dw1", mlp.resolve_enc_bwd_dw1, dtype,
                               (batch, seg, units, latent, aligned),
                               "'sgemm' takes fp32 operands")


def test_grad_accum_passes_the_kernel_code_plan_and_workspace(monkeypatch):
    """What reaches rvk_grad_accum: 12 arguments, the workspace ((split,
    n·m + m) fp32 where the plan has more than one slice), the dtype, the
    weight gradient's tile width and split (tensor_cores.wgrad_plan), the
    kernel code; the first version gets zeros and no workspace."""
    launched = _stand_in(monkeypatch)
    counts = (mlp.grad_accum.launches, mlp.grad_accum.tensor_core_launches,
              mlp.grad_accum.sgemm_launches)
    for batch in (MICROBATCH, 4096, 1000, 1):
        ops = _grad_accum_operands(batch, *DW4, BF16)
        dw, db = mlp.grad_accum(*ops)
        assert (dw.shape, db.shape) == ((2048, 1024), (1024,))
        assert dw.dtype == db.dtype == F32
        name, args = launched.pop()
        # a, b, dw, db, workspace | batch, n, m, dtype, tile_dw, split,
        # kernel
        assert name == "rvk_grad_accum" and len(args) == 12
        assert args[:2] == ops and args[2] is dw and args[3] is db
        plan = tensor_cores.wgrad_plan(*DW4, batch, 132)
        assert args[5:] == (batch, *DW4, 1, *plan, 1)
        if plan[1] > 1:
            assert args[4].shape == (plan[1], 2048 * 1024 + 1024)
            assert args[4].dtype == F32
        else:
            assert args[4] is None
    mlp.grad_accum(*_grad_accum_operands(MICROBATCH, *DW4, BF16),
                   kernel="cuda_cores")
    args = launched.pop()[1]
    assert args[4] is None and args[8:] == (1, 0, 0, 0)
    # fp32: the fp32 kernel, its tile's index and slices
    mlp.grad_accum(*_grad_accum_operands(256, *DW4, F32))
    args = launched.pop()[1]
    plan = tensor_cores.sgemm_wgrad_plan(*DW4, 256, 132)
    assert args[8:] == (0, *plan, SGEMM)
    assert (args[4] is None) == (plan[1] == 1)
    # no rows: the first version, which writes zero gradients
    mlp.grad_accum(*_grad_accum_operands(0, *DW4, BF16))
    assert launched.pop()[1][8:] == (1, 0, 0, 0)
    # a plan of more than one slice: the workspace holds each slice's dW
    # and column sums
    monkeypatch.setattr(tensor_cores, "wgrad_plan",
                        lambda m, n, k, sms, outputs=1: (256, 2))
    mlp.grad_accum(*_grad_accum_operands(MICROBATCH, *DW4, BF16))
    args = launched.pop()[1]
    assert args[4].shape == (2, 2048 * 1024 + 1024) and args[4].dtype == F32
    assert args[9:] == (256, 2, 1)
    assert (mlp.grad_accum.launches - counts[0],
            mlp.grad_accum.tensor_core_launches - counts[1],
            mlp.grad_accum.sgemm_launches - counts[2]) == (8, 5, 1)


def test_enc_bwd_dw1_passes_the_kernel_code_tiles_plan_and_workspace(
        monkeypatch):
    """What reaches rvk_enc_bwd_dw1: 19 arguments, the scratch dh, the
    workspace ((split, seg·units + units) fp32 where the plan has more
    than one slice), the dtype, dh's tile width, the weight gradient's
    tile width and split, the kernel code; the first version gets zeros
    and no workspace."""
    launched = _stand_in(monkeypatch)
    counts = (mlp.enc_bwd_dw1.launches, mlp.enc_bwd_dw1.tensor_core_launches)
    # dh at 8192 is 64 tile rows x 8 of 256 (as dh3), at 1 one tile row of
    # 64
    for batch, tile_dh in ((MICROBATCH, 256), (4096, 256), (1, 64)):
        ops = _enc_bwd_operands(batch, *DENSE, BF16)
        dw1, db1 = mlp.enc_bwd_dw1(*ops)
        assert (dw1.shape, db1.shape) == ((1024, 2048), (2048,))
        name, args = launched.pop()
        # x, h, dmu, dlogvar, w21, w22, dh, dw1, db1, workspace | batch,
        # seg, units, latent, dtype, tile_dh, tile_dw, split, kernel
        assert name == "rvk_enc_bwd_dw1" and len(args) == 19
        assert args[:6] == ops and args[7] is dw1 and args[8] is db1
        assert args[6].shape == (batch, 2048) and args[6].dtype == BF16
        plan = tensor_cores.wgrad_plan(1024, 2048, batch, 132)
        assert args[10:] == (batch, *DENSE, 1, tile_dh, *plan, 1)
        if plan[1] > 1:
            assert args[9].shape == (plan[1], 1024 * 2048 + 2048)
        else:
            assert args[9] is None
    mlp.enc_bwd_dw1(*_enc_bwd_operands(MICROBATCH, *DENSE, BF16),
                    kernel="cuda_cores")
    args = launched.pop()[1]
    assert args[9] is None and args[14:] == (1, 0, 0, 0, 0)
    # fp32: sgemm.cuh's launches, each at its own op's plan
    mlp.enc_bwd_dw1(*_enc_bwd_operands(256, *DENSE, F32))
    args = launched.pop()[1]
    plan = tensor_cores.sgemm_wgrad_plan(1024, 2048, 256, 132)
    assert args[14:] == (
        0, tensor_cores.SGEMM_TILES.index(tensor_cores.sgemm_tile(256, 2048,
                                                                  132)),
        *plan, SGEMM)
    assert (args[9] is None) == (plan[1] == 1)
    monkeypatch.setattr(tensor_cores, "wgrad_plan",
                        lambda m, n, k, sms, outputs=1: (64, 3))
    mlp.enc_bwd_dw1(*_enc_bwd_operands(MICROBATCH, *DENSE, BF16))
    args = launched.pop()[1]
    assert args[9].shape == (3, 1024 * 2048 + 2048) and args[9].dtype == F32
    assert args[15:] == (256, 64, 3, 1)
    assert (mlp.enc_bwd_dw1.launches - counts[0],
            mlp.enc_bwd_dw1.tensor_core_launches - counts[1]) == (6, 4)


@pytest.mark.parametrize("op", ["grad_accum", "enc_bwd_dw1"])
def test_a_named_tensor_core_weight_gradient_raises_on_what_it_cannot_take(
        monkeypatch, op):
    launched = _stand_in(monkeypatch)
    if op == "grad_accum":
        fn = mlp.grad_accum
        odd, what = _grad_accum_operands(8, 2048, 1020, BF16), "m 1020"
        dense = _grad_accum_operands(8, *DW4, BF16)
    else:
        fn = mlp.enc_bwd_dw1
        odd, what = _enc_bwd_operands(8, 1024, 2048, 36, BF16), "latent 36"
        dense = _enc_bwd_operands(8, *DENSE, BF16)
    with pytest.raises(ValueError, match=what):
        fn(*odd, kernel="tensor_cores")
    with pytest.raises(ValueError, match="takes bf16 operands"):
        fn(*[t.float() for t in dense], kernel="tensor_cores")
    with pytest.raises(ValueError, match="unknown kernel"):
        fn(*dense, kernel="wgmma")
    # neither fp32 form takes bf16 operands
    with pytest.raises(ValueError, match="'sgemm' takes fp32 operands"):
        fn(*dense, kernel="sgemm")
    monkeypatch.setattr(tensor_cores, "pointers_aligned", lambda *t: False)
    with pytest.raises(ValueError, match="aligned = False"):
        fn(*dense, kernel="tensor_cores")
    assert launched == []
    fn(*dense)
    assert launched.pop()[1][-1] == 0


@pytest.mark.parametrize("op", ["grad_accum", "enc_bwd_dw1"])
def test_the_weight_gradients_check_every_pointer_for_alignment(monkeypatch,
                                                                op):
    _stand_in(monkeypatch)
    seen = []
    monkeypatch.setattr(tensor_cores, "pointers_aligned",
                        lambda *t: seen.append(t) or True)
    if op == "grad_accum":
        ops = _grad_accum_operands(8, *DW4, BF16)
        mlp.grad_accum(*ops)
    else:
        ops = _enc_bwd_operands(8, *DENSE, BF16)
        mlp.enc_bwd_dw1(*ops)
    assert len(seen) == 1 and len(seen[0]) == len(ops)
    assert {id(t) for t in seen[0]} == {id(t) for t in ops}


def test_cpu_weight_gradients_take_the_plain_version_whatever_the_kernel():
    g = torch.Generator().manual_seed(0)
    acc = [torch.randn(t.shape, generator=g).to(BF16)
           for t in _grad_accum_operands(5, 24, 16, BF16, "cpu")]
    enc = [torch.randn(t.shape, generator=g).to(BF16)
           for t in _enc_bwd_operands(5, 16, 24, 8, BF16, "cpu")]
    ops_ = (mlp.grad_accum, mlp.enc_bwd_dw1)
    before = [(f.launches, f.tensor_core_launches) for f in ops_]
    want = mlp.grad_accum_ref(*acc)
    want_enc = mlp.enc_bwd_dw1_ref(*enc)
    for kernel in ("auto", "cuda_cores", "tensor_cores", "sgemm"):
        for got, w in zip(mlp.grad_accum(*acc, kernel=kernel), want):
            assert torch.equal(got, w)
        for got, w in zip(mlp.enc_bwd_dw1(*enc, kernel=kernel), want_enc):
            assert torch.equal(got, w)
    with pytest.raises(ValueError, match="unknown kernel"):
        mlp.grad_accum(*acc, kernel="wgmma")
    with pytest.raises(ValueError, match="unknown kernel"):
        mlp.enc_bwd_dw1(*enc, kernel="wgmma")
    assert before == [(f.launches, f.tensor_core_launches) for f in ops_]


@pytest.mark.parametrize("m,n", [DW4, DW4[::-1]], ids=["dW4", "dW1"])
@pytest.mark.parametrize("batch", [MICROBATCH, 4096, 1000, 1])
def test_the_weight_gradient_plan_at_dw4_and_dw1(m, n, batch):
    """dW4 (2048 x 1024) and dW1 (1024 x 2048) on 132 SMs: no empty slice,
    one wave, and at the microbatch the plan chip_smoke.py phase 3b's sweep
    confirms."""
    width, split = tensor_cores.wgrad_plan(m, n, batch, 132)
    total = -(-batch // 64)
    steps = -(-total // split)
    assert -(-total // steps) == split
    tiles = -(-m // 128) * -(-n // width)
    assert tiles * split <= max(132, tiles)
    assert (width, split) == WGRAD_PLANS[batch]


# the rule's plans (tile width, slices) for dW4 and dW1 by batch: one slice
# of 128 x 128 tiles, 128 of them at 8192 (one wave); the sweep on the card
# found it 5.8 % (dW4) and 3.9 % (dW1) ahead of 2 slices of 128 x 256,
# which ties it on the rule's cost
WGRAD_PLANS = {MICROBATCH: (128, 1), 4096: (128, 1), 1000: (128, 1),
               1: (128, 1)}
