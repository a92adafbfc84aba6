"""The plain reference of the Oobleck VAE's training step (the
``stable_audio_vae`` configuration): fp32 PyTorch with TF32 off, written
from the model's equations, importing nothing of the program.

With C the configuration's ``conv_channels`` C0..Cn, s its ``conv_strides``
and k its ``conv_kernel``; every convolution weight-normalised, w = g · v /
‖v‖ over every dim of v but the first:

    snake(x)  = x + 1 / (e^beta + 1e-9) · sin²(e^alpha · x), per channel
    RU(c, d)  = x + conv1(snake(conv_k,d(snake(x))))       (padding d·(k−1)/2)
    encoder   = conv7(io→C0) · [RU(Ci,1) RU(Ci,3) RU(Ci,9) snake
                conv_2si,stride si,pad ⌈si/2⌉(Ci→Ci+1)] · snake ·
                conv3(Cn→2·latent)
    mean, scale = the two halves of the encoder's channels
    std       = softplus(scale) + 1e-4,  logvar = 2 · log(std),  mu = mean
    z         = mu + eps · exp(logvar / 2)
    decoder   = conv7(latent→Cn) · [snake convT_2si,stride si,pad ⌈si/2⌉
                (Ci+1→Ci) RU(Ci,1) RU(Ci,3) RU(Ci,9)] · snake ·
                conv7(C0→io, no bias)
    loss      = mean((recon − x)²) + β · (−½ · mean(1 + logvar − mu² −
                e^logvar))

over interleaved frames (sample t of channel c at io · t + c), mu and logvar
flattened channel-major; then Adam as ``mlp_vae.py`` takes it.  A batch is
computed in chunks of at most ``CHUNK`` frames, each chunk's loss weighted
by its share of the batch and the gradients added, so the fp32 activations
of autograd fit the card with nothing else on it.

The weights come from the seed (:func:`init_params`: one draw of U(−1, 1)
on the device for every ``v`` and ``b`` in forward order, each scaled by
1/sqrt(fan_in) with fan_in ``v.shape[1]`` times the kernel, as
``nn.Conv1d`` and ``nn.ConvTranspose1d`` draw them; ``g = ‖v‖``, so w = v
at the start; SnakeBeta's ``alpha`` and ``beta`` 0), the permutations and
the noise by ``mlp_vae.py``'s rules.

``rounding`` puts a lower precision in place of fp32, for the control of
``correct``, wherever the program's bf16 step holds bf16: the frames, every
parameter and every weight-normalised weight, the output of every
convolution, SnakeBeta and residual add, ``z`` and the reconstruction, each
rounded to ``tf32`` or ``fp8`` (e4m3, scaled per tensor) and the gradient
reaching each of them rounded alike on the way back; ``mu``, ``logvar``,
the loss and Adam stay fp32, as the program keeps them.  The products
between the rounded tensors are fp32, as the program's accumulate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.mlp_vae import (  # noqa: F401 (the interface)
    ROUNDINGS,
    epoch_rows,
    frame_count,
)
from bench_port.seeds import WEIGHTS_TAG, noise_seed, stream_seed

Tensor = torch.Tensor

DILATIONS = (1, 3, 9)
CHUNK = 4    # frames of a batch computed at a time

# --------------------------------------------------------------- widths

def _ints(text) -> List[int]:
    return [int(t) for t in str(text).split(",")]


def _prod(values) -> int:
    out = 1
    for v in values:
        out *= v
    return out


def widths(config: dict) -> dict:
    """The widths the configuration gives the program (``program.vae``)."""
    vae = config["program"]["vae"]
    return {"channels": _ints(vae["conv_channels"]),
            "strides": _ints(vae["conv_strides"]),
            "kernel": int(vae["conv_kernel"]), "io": int(vae["io_channels"]),
            "latent": config["latent_dim"]}


def layer_paths(config: dict) -> List[Tuple[str, tuple, tuple]]:
    """Every layer in forward order: ``("conv", path, (in, out, kernel,
    transposed, bias))`` or ``("snake", path, (channels,))``, the path
    naming it in the program's params tree."""
    w = widths(config)
    ch, k = w["channels"], w["kernel"]
    out: List[Tuple[str, tuple, tuple]] = []

    def conv(path, a, b, kernel, transposed=False, bias=True):
        out.append(("conv", path, (a, b, kernel, transposed, bias)))

    def snake(path, c):
        out.append(("snake", path, (c,)))

    def units(base, c):
        for r in range(len(DILATIONS)):
            snake(base + ("res", r, "act1"), c)
            conv(base + ("res", r, "conv1"), c, c, k)
            snake(base + ("res", r, "act2"), c)
            conv(base + ("res", r, "conv2"), c, c, 1)

    conv(("encoder", "conv_in"), w["io"], ch[0], 7)
    for i, s in enumerate(w["strides"]):
        units(("encoder", "blocks", i), ch[i])
        snake(("encoder", "blocks", i, "act"), ch[i])
        conv(("encoder", "blocks", i, "down"), ch[i], ch[i + 1], 2 * s)
    snake(("encoder", "act"), ch[-1])
    conv(("encoder", "conv_out"), ch[-1], 2 * w["latent"], 3)
    conv(("decoder", "conv_in"), w["latent"], ch[-1], 7)
    for j, i in enumerate(reversed(range(len(w["strides"])))):
        s = w["strides"][i]
        snake(("decoder", "blocks", j, "act"), ch[i + 1])
        conv(("decoder", "blocks", j, "up"), ch[i + 1], ch[i], 2 * s,
             transposed=True)
        units(("decoder", "blocks", j), ch[i])
    snake(("decoder", "act"), ch[0])
    conv(("decoder", "conv_out"), ch[0], w["io"], 7, bias=False)
    return out


def _leaf_names(kind: str, dims: tuple) -> Tuple[str, ...]:
    if kind == "snake":
        return ("alpha", "beta")
    return ("g", "v", "b") if dims[4] else ("g", "v")


# --------------------------------------------------------------- params

def init_params(config: dict, seed: int, device) -> dict:
    """The params tree of ``config`` from ``seed`` (the module's
    docstring)."""
    convs = [(path, d) for kind, path, d in layer_paths(config)
             if kind == "conv"]

    def v_shape(d):
        a, b, k, transposed, _ = d
        return (a, b, k) if transposed else (b, a, k)

    total = sum(_prod(v_shape(d)) + (d[1] if d[4] else 0)
                for _, d in convs)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, WEIGHTS_TAG))
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=g)
    by_path: Dict[tuple, Tensor] = {}
    at = 0
    for path, d in convs:
        shape = v_shape(d)
        bound = 1.0 / (shape[1] * shape[2]) ** 0.5
        n = _prod(shape)
        v = (flat[at:at + n].view(shape) * bound).contiguous()
        at += n
        by_path[path + ("v",)] = v
        by_path[path + ("g",)] = torch.linalg.vector_norm(
            v, dim=(1, 2), keepdim=True)
        if d[4]:
            by_path[path + ("b",)] = (flat[at:at + d[1]] * bound).contiguous()
            at += d[1]
    for kind, path, d in layer_paths(config):
        if kind == "snake":
            for name in ("alpha", "beta"):
                by_path[path + (name,)] = torch.zeros(d[0], device=device)
    return tree_of(by_path, config)


def tree_of(by_path: Dict[tuple, Tensor], config: dict) -> dict:
    """The params-shaped tree of leaves given by path (:func:`leaves`'
    inverse); the tree holds the same tensors."""
    tree: dict = {}
    for kind, path, d in layer_paths(config):
        node = tree
        for key, nxt in zip(path, path[1:]):
            empty = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                if key == len(node):   # layers come in forward order
                    node.append(empty)
                node = node[key]
            else:
                node = node.setdefault(key, empty)
        node[path[-1]] = {n: by_path[path + (n,)]
                          for n in _leaf_names(kind, d)}
    return tree


def _node(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def leaves(tree: dict, config: dict) -> Dict[tuple, Tensor]:
    """Every leaf of a params-shaped tree (params, gradients, moments) by
    its path, in forward order."""
    out = {}
    for kind, path, d in layer_paths(config):
        node = _node(tree, path)
        for name in _leaf_names(kind, d):
            out[path + (name,)] = node[name]
    return out


# -------------------------------------------------------------- the step

class _Rounded(torch.autograd.Function):
    """A tensor rounded to a lower precision, and the gradient that
    reaches it rounded alike."""

    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return ROUNDINGS[fmt](t)

    @staticmethod
    def backward(ctx, grad):
        return ROUNDINGS[ctx.fmt](grad.contiguous()), None


def _rounder(rounding: Optional[str]):
    """``t → t`` rounded (:class:`_Rounded`), or the identity."""
    if rounding is None:
        return lambda t: t
    return lambda t: _Rounded.apply(t, rounding)


def _conv(layer: dict, x: Tensor, r, stride=1, padding=0, dilation=1,
          transposed=False) -> Tensor:
    v, g = layer["v"], layer["g"]
    w = r(g * v / torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True)))
    b = layer.get("b")
    if transposed:
        return r(F.conv_transpose1d(x, w, b, stride, padding))
    return r(F.conv1d(x, w, b, stride, padding, dilation))


def _snake(layer: dict, x: Tensor, r) -> Tensor:
    a = torch.exp(layer["alpha"])[:, None]
    inv = 1.0 / (torch.exp(layer["beta"])[:, None] + 1e-9)
    return r(x + inv * torch.sin(a * x) ** 2)


def _units(block: dict, x: Tensor, k: int, r) -> Tensor:
    for unit, d in zip(block["res"], DILATIONS):
        y = _conv(unit["conv1"], _snake(unit["act1"], x, r), r,
                  padding=d * (k - 1) // 2, dilation=d)
        x = r(x + _conv(unit["conv2"], _snake(unit["act2"], y, r), r))
    return x


def forward(params: dict, x: Tensor, eps: Tensor, config: dict,
            rounding: Optional[str] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """``(recon, mu, logvar)`` of interleaved frames ``x`` with noise
    ``eps``; ``x`` is taken as the caller rounded it."""
    w = widths(config)
    k, io, n = w["kernel"], w["io"], x.shape[0]
    r = _rounder(rounding)
    if rounding is not None:
        params = tree_of({key: r(leaf) for key, leaf
                          in leaves(params, config).items()}, config)
    enc, dec = params["encoder"], params["decoder"]
    h = _conv(enc["conv_in"], x.view(n, -1, io).transpose(1, 2), r,
              padding=3)
    for block, s in zip(enc["blocks"], w["strides"]):
        h = _units(block, h, k, r)
        h = _conv(block["down"], _snake(block["act"], h, r), r,
                  stride=s, padding=(s + 1) // 2)
    h = _conv(enc["conv_out"], _snake(enc["act"], h, r), r, padding=1)
    mean, scale = h[:, :w["latent"]], h[:, w["latent"]:]
    std = F.softplus(scale) + 1e-4
    mu = mean.reshape(n, -1)
    logvar = (2.0 * torch.log(std)).reshape(n, -1)
    z = r(mu + eps * torch.exp(0.5 * logvar))
    h = _conv(dec["conv_in"], z.view(n, w["latent"], -1), r, padding=3)
    for block, s in zip(dec["blocks"], reversed(w["strides"])):
        h = _conv(block["up"], _snake(block["act"], h, r), r, stride=s,
                  padding=(s + 1) // 2, transposed=True)
        h = _units(block, h, k, r)
    h = _conv(dec["conv_out"], _snake(dec["act"], h, r), r, padding=3)
    return h.transpose(1, 2).reshape(n, -1), mu, logvar


def loss(params: dict, x: Tensor, eps: Tensor, config: dict,
         rounding: Optional[str] = None) -> Tensor:
    """The training loss of interleaved frames ``x`` with noise ``eps``."""
    x = _rounder(rounding)(x)
    recon, mu, logvar = forward(params, x, eps, config, rounding)
    mse = torch.mean(torch.square(recon - x))
    kld = -0.5 * torch.mean(1.0 + logvar - torch.square(mu)
                            - torch.exp(logvar))
    return mse + config["kl_beta"] * kld


def train(config: dict, seed: int, corpus: Tensor, steps: int,
          keep_params: int, rounding: Optional[str] = None) -> dict:
    """The first ``steps`` steps of training from the seed's weights on
    ``corpus`` (fp32 interleaved samples on the run's device), epoch after
    epoch as the engine runs them (``mlp_vae.py`` ``train``'s contract):
    ``losses``, ``grads`` (the first step's, by leaf) and ``params`` (by
    leaf, after step ``keep_params``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = corpus.device
    seg, hop = config["segment_length"], config["hop_length"]
    batch, latent = config["batch_size"], config["latent_dim"]
    latent_flat = latent * seg // (widths(config)["io"]
                                   * _prod(widths(config)["strides"]))
    lr, b1, b2, adam_eps = (config["learning_rate"], config["b1"],
                            config["b2"], config["eps"])
    padded = F.pad(corpus, (0, -corpus.numel() % hop))
    windows = padded.unfold(0, seg, hop)
    n_frames = frame_count(corpus.numel(), seg, hop)
    n_batches = n_frames // batch
    tree = init_params(config, seed, device)
    by_path = leaves(tree, config)
    for p in by_path.values():
        p.requires_grad_(True)
    mu = {k: torch.zeros_like(v) for k, v in by_path.items()}
    nu = {k: torch.zeros_like(v) for k, v in by_path.items()}
    losses, first, kept, rows = [], None, None, None
    for step in range(steps):
        if step % n_batches == 0:
            rows = epoch_rows(n_frames, batch, seed, step // n_batches,
                              device)
        x = windows[rows[step % n_batches]]
        g = torch.Generator(device=device)
        g.manual_seed(noise_seed(seed, step))
        eps = torch.randn((batch, latent_flat), generator=g, device=device)
        value = 0.0
        grads = [torch.zeros_like(p) for p in by_path.values()]
        for a in range(0, batch, CHUNK):
            part = loss(tree, x[a:a + CHUNK], eps[a:a + CHUNK], config,
                        rounding) * (min(CHUNK, batch - a) / batch)
            for acc, gr in zip(grads, torch.autograd.grad(
                    part, list(by_path.values()))):
                acc.add_(gr)
            value += part.item()
            del part
        losses.append(value)
        if first is None:
            first = {k: gr.clone() for k, gr in zip(by_path, grads)}
        bc1, bc2 = (float(1.0 - torch.tensor(b, dtype=torch.float32)
                          ** (step + 1)) for b in (b1, b2))
        with torch.no_grad():
            for (k, p), gr in zip(by_path.items(), grads):
                mu[k] = (1.0 - b1) * gr + b1 * mu[k]
                nu[k] = (1.0 - b2) * (gr * gr) + b2 * nu[k]
                p.add_(-lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                               + adam_eps)))
        if step + 1 == keep_params:
            kept = {k: p.detach().clone() for k, p in by_path.items()}
        del x, eps, grads
    return {"losses": losses, "grads": first, "params": kept}
