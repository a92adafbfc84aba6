"""Model export — the JAX package's ``infer/export.py``, ported; the
replacement for the reference's export-onnx.ipynb.

The reference exported ``torch.onnx.export(raw_model, torch.randn(1024),
"rawaudiovae.onnx")`` (export-onnx cell 11): the full forward (encode +
stochastic reparameterize + decode) at a fixed (1024,) input.  Here:

  * :func:`export_program` serializes the forward with ``torch.export`` and
    ``torch.export.save`` — the counterpart of JAX's ``export_stablehlo``
    (StableHLO is JAX's own format, as an ``ExportedProgram`` is PyTorch's).
    The graph holds the **plain** forward (``models/vae.py``,
    ``models/variants.py``) whatever the model's backend: a traced graph
    cannot hold the hand-written kernels' ctypes launches.  Reload with
    :func:`load_program`;
  * :func:`export_npz` writes the weights as plain npz with torch-layout
    names, loadable by anything (including back into the reference's
    PyTorch code via ``compat.params_to_state_dict`` naming);
  * both a stochastic graph and a deterministic z = mu graph (quirk #13
    extension) are exported.  The stochastic graph draws its noise inside
    the graph (``torch.randn``) from PyTorch's default generator of the
    device it runs on — seed it with ``torch.manual_seed`` — where the JAX
    graph takes a threefry key as an input (ROADMAP.md queue C).
"""

from __future__ import annotations

from pathlib import Path
import numpy as np
import torch

from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.models.registry import ModelDef
from rawaudiovae_kelsey_tpu_torch.tree import flatten, tree_map, unflatten


def make_forward_fn(model: ModelDef, deterministic: bool = False):
    """The exported computation: flat (segment,) or (B, segment) audio in →
    ``(recon, mu, logvar)`` out — the reference VAE.forward contract
    (model.py:32-35) that torch.onnx.export serialized.  ``fwd(params, x)``
    when ``deterministic``, else ``fwd(params, generator, x)`` (a
    ``torch.Generator`` on the model's device, or None for the default
    one)."""
    if deterministic:
        def fwd(params, x):
            x = x.reshape(-1, model.segment_length)
            mu, logvar = model.encode(params, x)
            return model.decode(params, mu), mu, logvar
        return fwd

    def fwd(params, generator, x):
        x = x.reshape(-1, model.segment_length)
        mu, logvar = model.encode(params, x)
        z = vae.reparameterize(mu, logvar, generator)
        return model.decode(params, z), mu, logvar
    return fwd


class _Forward(torch.nn.Module):
    """The plain forward with the weights baked in as buffers (``enc.0.w``
    is buffer ``enc_0_w``)."""

    def __init__(self, model: ModelDef, params, deterministic: bool):
        super().__init__()
        self.template = tree_map(lambda _: None, params)   # the structure
        self.names = []
        for name, leaf in flatten(params):
            key = name.replace(".", "_")
            self.register_buffer(key, leaf.detach().clone())
            self.names.append(key)
        self.segment_length = model.segment_length
        self.deterministic = deterministic
        self.encode_fn = model.plain_encode
        self.decode_fn = model.plain_decode

    def forward(self, x: torch.Tensor):
        params = unflatten(self.template,
                           [getattr(self, k) for k in self.names])
        x = x.reshape(-1, self.segment_length)
        mu, logvar = self.encode_fn(params, x)
        z = vae.reparameterize(mu, logvar, None, self.deterministic)
        return self.decode_fn(params, z), mu, logvar


def export_program(model: ModelDef, params, path: Path, batch: int = 1,
                   deterministic: bool = False) -> Path:
    """Serialize the plain forward graph (weights baked in, input ``(batch,
    segment)`` fp32 on the params' device) to ``path``.  Reload with
    :func:`load_program`."""
    module = _Forward(model, params, deterministic).eval()
    device = flatten(params)[0][1].device
    x = torch.zeros((batch, model.segment_length), device=device)
    with torch.no_grad():
        program = torch.export.export(module, (x,))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(path))
    return path


def load_program(path: Path):
    """Deserialize an exported graph; returns a callable of ``x`` giving
    ``(recon, mu, logvar)``."""
    return torch.export.load(str(Path(path))).module()


def export_npz(model: ModelDef, params, path: Path) -> Path:
    """Weights-only export.  For the dense family the keys are the torch
    state-dict names (fc1.weight, …) in torch layout, so the file round-trips
    into the reference implementation; the deep and conv1d families take
    the tree's dotted names (``enc.0.w``), as the JAX package writes them."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if model.name == "dense":
        from rawaudiovae_kelsey_tpu_torch.compat import params_to_state_dict

        arrays = params_to_state_dict(params)
    else:
        arrays = {name: leaf.detach().cpu().numpy()
                  for name, leaf in flatten(params)}
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)
    return path
