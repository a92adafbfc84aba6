"""Diagnosis probe: one fp32 ``highest`` step of a deep model through the
kernels (``backend = pallas``) against the plain backend (``xla``), and the
ReLU gates the two backends decide differently.

Two GPU checks hold such a step by the norm of Adam's first moment, ``‖μ_k
− μ_p‖ / ‖μ_p‖ ≤ 1e-4``.  Both backends compute each pre-activation in IEEE
fp32 in another order, so the two differ in the last bits.  Where a
pre-activation lies within that much of zero, one backend's ReLU passes it
and the other's does not: a tie.  The gradient of that sample then differs
by a whole term of the backward, 1e-4 to 4e-4 of the norm at these widths
on an H100, while without a tie the two agree to ~3e-7 (PERF.md section
7).  This probe runs the step on inputs from seeds (or from saved
generator states), counts the gates whose sign differs layer by layer, how
far from zero each lies, and the norm error before and after the tied rows
are replaced (:func:`untie`).

    python -m rawaudiovae_kelsey_tpu_torch.probes.gate_ties
        [--seeds 40] [--state FILE ...] [--kernel auto|cuda_cores|sgemm]
        [--device cuda]

The two configurations are those of the checks in ``tests/test_torch_cuda.py``
(``DEEP_CASES``); ``--kernel`` forces the forward products' kernel.  One JSON
line a case, then a summary line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.config import Config
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.ops import linear
from rawaudiovae_kelsey_tpu_torch.probes import common

Tensor = torch.Tensor

# the deep models of the two GPU checks: (name, hidden, seg, latent, batch)
DEEP_CASES = (("1024,512", "1024,512", 1024, 32, 1024),
              ("2048,1024,512", "2048,1024,512", 2048, 64, 1024))
# a flipped gate is a tie when its passed side is at most this far from
# zero, relative to the layer's largest output: the fp32 sums of two
# summation orders over k <= 2048 differ by ~1e-7 of it
TIE_REL = 1e-5


def deep_config(hidden: str, seg: int, latent: int) -> Config:
    cfg = Config()
    cfg.vae.arch, cfg.vae.hidden_dims = "deep", hidden
    cfg.audio.segment_length, cfg.vae.latent_dim = seg, latent
    cfg.tpu.precision = "highest"
    return cfg


def noise(step, i, shape) -> Tensor:
    """The checks' eps: one seeded draw, the same for both backends."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(1))


@contextlib.contextmanager
def forced_kernel(kernel: str):
    """``PallasLinear`` 's forward products on ``kernel`` (``auto``: the
    dispatch as it is)."""
    if kernel == "auto":
        yield
        return
    plain = linear.dispatch_fwd

    def dispatch(x, w, b, act="none"):
        if linear.takes_ksplit(x.shape[0], w.shape[0], w.shape[1]):
            return linear.linear_ksplit_fwd(x, w, b, act, kernel=kernel)
        return linear.linear_fwd(x, w, b, act, kernel=kernel)

    linear.dispatch_fwd = dispatch
    try:
        yield
    finally:
        linear.dispatch_fwd = plain


def step_moment(cfg: Config, backend: str, x: Tensor) -> List[Tensor]:
    """Adam's first moment, leaf by leaf, after one step from the seeded
    init on ``x`` (the checks' step)."""
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves

    cfg.tpu.backend = backend
    model = build_model(cfg, x.device)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)), 0)
    state, _ = build_train_step(model, cfg, noise=noise)(state, x)
    return [t.detach().clone() for t in leaves(state.mu)]


def relu_outputs(cfg: Config, backend: str, x: Tensor) -> List[Tensor]:
    """Every ReLU layer's output in the step's forward, encoder then
    decoder, computed as that backend's forward computes it (the kernels'
    ``dispatch_fwd`` or the plain ``x @ w + b``)."""
    from rawaudiovae_kelsey_tpu_torch.models import build_model

    plain = copy.deepcopy(cfg)
    plain.tpu.backend = "xla"
    params = build_model(plain, x.device).init(
        torch.Generator().manual_seed(0))

    def layer(p, h, act):
        if backend == "pallas":
            return linear.dispatch_fwd(h, p["w"], p["b"], act)
        v = vae.linear(p, h)
        return torch.relu(v) if act == "relu" else v

    outs = []
    with torch.no_grad():
        h = x
        for p in params["enc"]:
            h = layer(p, h, "relu")
            outs.append(h)
        mu = layer(params["mu_head"], h, "none")
        logvar = layer(params["logvar_head"], h, "none")
        eps = noise(0, None, tuple(mu.shape)).to(mu.device)
        h = vae.reparameterize(mu, logvar, eps=eps)
        for p in params["dec"][:-1]:
            h = layer(p, h, "relu")
            outs.append(h)
    return outs


def gate_flips(cfg: Config, x: Tensor, kernel: str = "auto"
               ) -> Tuple[Tensor, List[dict]]:
    """The rows of ``x`` with a ReLU gate that the two backends decide
    differently (a bool mask), and per layer: the flips, the largest passed
    side of a flip relative to the layer's largest output, and the largest
    difference of the two outputs relative to it."""
    with forced_kernel(kernel):
        kern = relu_outputs(cfg, "pallas", x)
    plain = relu_outputs(cfg, "xla", x)
    rows = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    layers = []
    for a, b in zip(kern, plain):
        flip = (a > 0) != (b > 0)
        scale = max(float(b.abs().max()), 1e-30)
        side = float(torch.maximum(a, b)[flip].max()) if bool(flip.any()) \
            else 0.0
        layers.append({"units": a.shape[1], "flips": int(flip.sum()),
                       "flip_rel": side / scale,
                       "max_rel": float((a - b).abs().max()) / scale})
        rows |= flip.any(dim=1)
    return rows, layers


def moment_error(mu_k: Sequence[Tensor], mu_p: Sequence[Tensor]) -> float:
    a = torch.cat([t.ravel() for t in mu_k])
    b = torch.cat([t.ravel() for t in mu_p])
    return float((a - b).norm() / b.norm())


def untie(cfg: Config, x: Tensor, generator: torch.Generator,
          kernel: str = "auto", rounds: int = 4) -> Tuple[Tensor, List[dict]]:
    """``x`` with every row that holds a tied gate replaced by a fresh row
    from ``generator`` (the same shape and batch, so the dispatch and the
    plans stay those of ``x``), until no gate differs; → the new input and
    the flips found in each round.  Raises where a flip is no tie (its
    passed side above :data:`TIE_REL` of the layer's largest output) or a
    layer's two outputs differ by more than that anywhere (a fault, not
    rounding), or where ``rounds`` do not clear the ties."""
    found = []
    for _ in range(rounds):
        rows, layers = gate_flips(cfg, x, kernel)
        found.append(layers)
        bad = [lay for lay in layers
               if max(lay["flip_rel"], lay["max_rel"]) > TIE_REL]
        if bad:
            raise AssertionError(f"the backends' ReLU outputs differ beyond "
                                 f"rounding: {bad}")
        if not bool(rows.any()):
            return x, found
        x = x.clone()
        fresh = torch.rand((int(rows.sum()), x.shape[1]), generator=generator,
                           device=x.device) * 2 - 1
        x[rows] = fresh
    raise AssertionError(f"tied gates left after {rounds} rounds: {found}")


def run_case(name: str, cfg: Config, x: Tensor, kernel: str,
             generator: torch.Generator) -> dict:
    with forced_kernel(kernel):
        mu_k = step_moment(cfg, "pallas", x)
    mu_p = step_moment(cfg, "xla", x)
    err = moment_error(mu_k, mu_p)
    leaf_err = [float((a - b).norm() / max(float(b.norm()), 1e-30))
                for a, b in zip(mu_k, mu_p)]
    rows, layers = gate_flips(cfg, x, kernel)
    out = {"model": name, "kernel": kernel, "err": err,
           "worst_leaf_err": max(leaf_err), "leaves_over_1e-4": sum(
               e > 1e-4 for e in leaf_err),
           "tied_rows": int(rows.sum()), "layers": layers}
    x2, _ = untie(cfg, x, generator, kernel)
    with forced_kernel(kernel):
        mu_k = step_moment(cfg, "pallas", x2)
    out["err_untied"] = moment_error(mu_k, step_moment(cfg, "xla", x2))
    return out


def tf32_settings() -> Dict[str, object]:
    """Every switch that could let an fp32 product take TF32."""
    out = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision()}
    for path in ("backends.fp32_precision",
                 "backends.cuda.matmul.fp32_precision",
                 "backends.cudnn.fp32_precision",
                 "backends.cudnn.conv.fp32_precision"):
        obj = torch
        for part in path.split("."):
            obj = getattr(obj, part, None)
        if obj is not None:
            out[path] = obj
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="gate_ties")
    ap.add_argument("--seeds", type=int, default=40,
                    help="inputs drawn from seeds 0 .. N - 1")
    ap.add_argument("--state", nargs="*", default=[],
                    help="CUDA generator states (torch.save of "
                         "torch.cuda.get_rng_state()) to draw x from, as "
                         "the checks draw it")
    ap.add_argument("--kernel", default="auto",
                    choices=["auto", "cuda_cores", "sgemm"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = common.resolve_device(args.device, "gate_ties")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"gate_ties on {common.device_name(device)}; TF32: "
          f"{tf32_settings()}")
    sources = [("state " + s, s) for s in args.state] + [
        (f"seed {i}", i) for i in range(args.seeds)]
    results = []
    for label, src in sources:
        for name, hidden, seg, latent, batch in DEEP_CASES:
            if isinstance(src, str):
                torch.cuda.set_rng_state(torch.load(src), device)
                x = torch.rand((batch, seg), device=device) * 2 - 1
            else:
                g = torch.Generator(device=device).manual_seed(src)
                x = torch.rand((batch, seg), generator=g, device=device) \
                    * 2 - 1
            out = run_case(name, deep_config(hidden, seg, latent), x,
                           args.kernel,
                           torch.Generator(device=device).manual_seed(7))
            out["x"] = label
            print(json.dumps(out))
            results.append(out)
    failing = [r for r in results if r["err"] > 1e-4]
    summary = {
        "probe": "gate_ties", "kernel": args.kernel, "cases": len(results),
        "over_1e-4": len(failing),
        "over_1e-4_with_ties": sum(r["tied_rows"] > 0 for r in failing),
        "with_ties": sum(r["tied_rows"] > 0 for r in results),
        "max_err_without_ties": max([r["err"] for r in results
                                     if r["tied_rows"] == 0] or [0.0]),
        "max_err_untied": max(r["err_untied"] for r in results)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
