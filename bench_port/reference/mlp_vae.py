"""The plain reference of the MLP VAEs' training step (the ``dense`` and
``deep_wide`` configurations): fp32 PyTorch with TF32 off, written from
the model's equations, importing nothing of the program.

    h      = relu(· @ W + b) through the encoder's layers
    mu     = h @ W_mu + b_mu          logvar = h @ W_lv + b_lv
    z      = mu + eps · exp(logvar / 2)
    recon  = tanh(relu(… relu(z @ W + b) …) @ W_out + b_out)
    loss   = mean((recon − x)²) + β · (−½ · mean(1 + logvar − mu² − e^logvar))

then Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments with the
corrections 1 − b^t taken in fp32, eps outside the square root) on fp32
parameters.

The benchmark's inputs are made here from the seed, and handed to both
sides: the weights (:func:`init_params`, ``nn.Linear``'s init,
U(±1/sqrt(fan_in)), drawn on the device in one call) and the rules by
which a run draws its epoch permutations and its noise (:func:`perm_seed`,
:func:`noise_seed`: the program's rules, copied here and frozen).  The
frames come from the corpus the benchmark synthesised, in fp32: what the
program derives from it (a bf16 copy on the card) is its own.

``rounding`` puts a lower precision in place of fp32, for the control of
``correct``: every product's two operands, in the forward and in both
products of the backward, are rounded to ``tf32`` (10 mantissa bits) or
``fp8`` (e4m3, scaled per tensor so its largest magnitude maps to 448)
before an fp32 product.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from bench_port.seeds import WEIGHTS_TAG, noise_seed, perm_seed, stream_seed

Tensor = torch.Tensor


# --------------------------------------------------------------- params

def layer_paths(config: dict) -> List[Tuple[tuple, int, int]]:
    """``(path, fan_in, fan_out)`` of every layer in forward order, the
    path naming the layer in the program's params tree."""
    seg, latent = config["segment_length"], config["latent_dim"]
    hidden = list(config["hidden_dims"])
    if config["arch"] == "dense":
        (units,) = hidden
        return [(("fc1",), seg, units), (("fc21",), units, latent),
                (("fc22",), units, latent), (("fc3",), latent, units),
                (("fc4",), units, seg)]
    enc, dec = [seg, *hidden], [latent, *reversed(hidden), seg]
    return ([(("enc", i), a, b) for i, (a, b) in enumerate(zip(enc, enc[1:]))]
            + [(("mu_head",), hidden[-1], latent),
               (("logvar_head",), hidden[-1], latent)]
            + [(("dec", i), a, b)
               for i, (a, b) in enumerate(zip(dec, dec[1:]))])


def init_params(config: dict, seed: int, device) -> dict:
    """The params tree of ``config`` from ``seed``: one draw of U(−1, 1)
    for every weight and bias on the device, each leaf then scaled by its
    layer's 1/sqrt(fan_in) into a tensor of its own."""
    specs = layer_paths(config)
    total = sum(n * m + m for _, n, m in specs)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, WEIGHTS_TAG))
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=g)
    by_path = {}
    at = 0
    for path, n, m in specs:
        bound = 1.0 / n ** 0.5
        by_path[path + ("w",)] = (flat[at:at + n * m].view(n, m)
                                  * bound).contiguous()
        at += n * m
        by_path[path + ("b",)] = (flat[at:at + m] * bound).contiguous()
        at += m
    return tree_of(by_path, config)


def tree_of(by_path: Dict[tuple, Tensor], config: dict) -> dict:
    """The params-shaped tree of leaves given by path (:func:`leaves`'
    inverse); the tree holds the same tensors."""
    tree: dict = {}
    for path, _, _ in layer_paths(config):
        layer = {"w": by_path[path + ("w",)], "b": by_path[path + ("b",)]}
        if len(path) == 1:
            tree[path[0]] = layer
        else:
            tree.setdefault(path[0], []).append(layer)
    return tree


def leaves(tree: dict, config: dict) -> Dict[tuple, Tensor]:
    """Every leaf of a params-shaped tree (params, gradients, moments) by
    its path, in forward order."""
    out = {}
    for path, _, _ in layer_paths(config):
        node = tree
        for key in path:
            node = node[key]
        out[path + ("w",)] = node["w"]
        out[path + ("b",)] = node["b"]
    return out


# -------------------------------------------------------------- rounding

def _round_tf32(t: Tensor) -> Tensor:
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_fp8(t: Tensor) -> Tensor:
    scale = 448.0 / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


ROUNDINGS = {"tf32": _round_tf32, "fp8": _round_fp8}


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` on operands rounded to a lower precision, in the forward
    and in both products of the backward."""

    @staticmethod
    def forward(ctx, a, b, fmt):
        q = ROUNDINGS[fmt]
        qa, qb = q(a), q(b)
        ctx.save_for_backward(qa, qb)
        ctx.fmt = fmt
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = ROUNDINGS[ctx.fmt](grad)
        return qg @ qb.t(), qa.t() @ qg, None


def _linear(layer: dict, x: Tensor, rounding: Optional[str]) -> Tensor:
    if rounding is None:
        return x @ layer["w"] + layer["b"]
    return _RoundedMatmul.apply(x, layer["w"], rounding) + layer["b"]


# -------------------------------------------------------------- the step

def loss(params: dict, x: Tensor, eps: Tensor, config: dict,
         rounding: Optional[str] = None) -> Tensor:
    """The training loss of frames ``x`` with noise ``eps``."""
    specs = layer_paths(config)
    n_enc = len(config["hidden_dims"])

    def node(path):
        return params[path[0]] if len(path) == 1 else params[path[0]][path[1]]

    h = x
    for path, _, _ in specs[:n_enc]:
        h = torch.relu(_linear(node(path), h, rounding))
    mu = _linear(node(specs[n_enc][0]), h, rounding)
    logvar = _linear(node(specs[n_enc + 1][0]), h, rounding)
    h = mu + eps * torch.exp(0.5 * logvar)
    dec = specs[n_enc + 2:]
    for path, _, _ in dec[:-1]:
        h = torch.relu(_linear(node(path), h, rounding))
    recon = torch.tanh(_linear(node(dec[-1][0]), h, rounding))
    mse = torch.mean(torch.square(recon - x))
    kld = -0.5 * torch.mean(1.0 + logvar - torch.square(mu)
                            - torch.exp(logvar))
    return mse + config["kl_beta"] * kld


def frame_count(n_samples: int, seg: int, hop: int) -> int:
    """Overlapping frames of ``seg`` at ``hop`` in the corpus zero-padded
    to a multiple of ``hop``."""
    padded = n_samples + (-n_samples % hop)
    return padded // hop - seg // hop + 1


def epoch_rows(n_frames: int, batch: int, seed: int, epoch: int, device
               ) -> Tensor:
    """The first frame of every row of every batch of ``epoch``,
    ``(n_batches, batch)``: a permutation of the frames, its tail that
    fills no batch dropped."""
    g = torch.Generator(device=device)
    g.manual_seed(perm_seed(seed, epoch))
    n_batches = n_frames // batch
    sel = torch.randperm(n_frames, generator=g, device=device)
    return sel[:n_batches * batch].view(n_batches, batch)


def train(config: dict, seed: int, corpus: Tensor, steps: int,
          keep_params: int, rounding: Optional[str] = None) -> dict:
    """The first ``steps`` steps of training from the seed's weights on
    ``corpus`` (fp32 samples, on the device the run used), epoch after
    epoch as the engine runs them (``n_frames // batch`` steps an epoch,
    each epoch its own permutation, step ``s`` the noise of ``s``):
    ``losses`` (Python floats, one a step), ``grads`` (the first step's
    gradient by leaf) and ``params`` (by leaf, after step ``keep_params``).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = corpus.device
    seg, hop = config["segment_length"], config["hop_length"]
    batch, latent = config["batch_size"], config["latent_dim"]
    lr, b1, b2, adam_eps = (config["learning_rate"], config["b1"],
                            config["b2"], config["eps"])
    padded = torch.nn.functional.pad(corpus, (0, -corpus.numel() % hop))
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
        eps = torch.randn((batch, latent), generator=g, device=device)
        value = loss(tree, x, eps, config, rounding)
        grads = torch.autograd.grad(value, list(by_path.values()))
        losses.append(value.item())
        if first is None:
            first = {k: gr.detach().clone() for k, gr in zip(by_path, grads)}
        # the bias corrections in fp32, as an fp32 Adam (optax's) takes them
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
        del x, eps, value, grads
    return {"losses": losses, "grads": first, "params": kept}
