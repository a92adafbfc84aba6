"""rawaudiovae_kelsey_tpu_torch — the PyTorch/CUDA port of
``rawaudiovae_kelsey_tpu``, for one NVIDIA H100.

The JAX package beside it stays the reference; every module here has its
counterpart at the same path there, and the tests run both on the same
inputs.  This first slice is the dense VAE's serving path:

==========  =====================================================================
subpackage  role
==========  =====================================================================
config      the same INI surface and dataclasses (every ``configs/*.ini``)
io          WAV codec and polyphase resampler (pure NumPy / SciPy, copied)
data        frame extraction (copied)
models      ``DenseVAE`` (``nn.Module``) + functional encode/decode on the JAX
            params layout; the registry (``arch = dense``)
ops         hand-written CUDA kernels (``csrc/``) for the encoder, decoder and
            int8 decoder, each beside its plain PyTorch version
train       params-only npz checkpoints in the JAX layout
compat      weights across the two packages
infer       resynthesis, the batched ``InferenceServer`` and its HTTP front end
==========  =====================================================================

Nothing here imports JAX or the JAX package.
"""

__version__ = "0.1.0"

from rawaudiovae_kelsey_tpu_torch.config import Config, load_config  # noqa: F401
