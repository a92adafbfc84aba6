"""Probes: small measuring programs of the port, each the counterpart of one
of the JAX repository's probe scripts under ``benchmarks/``.

* ``deep_bwd``    (``benchmarks/deep_bwd_probe.py``): the fused backward of
  one large linear layer (``dw_fused`` + ``dx_fused``) against the plain one;
* ``deep_step``   (``benchmarks/deep_step_probe.py``): one train step split
  into full / grads / Adam beside its analytic bounds;
* ``adam_fusion`` (``benchmarks/adam_fusion_ab.py``): the full train step
  with the plain Adam against the one-pass Adam (``fused_adam_apply``: one
  launch of the tree kernel a step);
* ``fusion_ab`` (``benchmarks/fusion_ab.py``): the dense train step under
  each backward-fusion mode (``ops/mlp.py`` ``BWD_FUSION``: "split" against
  "full") at ``bfloat16`` or ``high``;
* ``gate_ties`` (the port's own, no JAX counterpart): the deep model's fp32
  step through the kernels against the plain backend, and the ReLU gates
  the two decide differently by rounding (``tests/test_torch_cuda.py``'s
  deep checks replace the rows that hold one).

Run as ``python -m rawaudiovae_kelsey_tpu_torch.probes.<name>``.  Each runs
on a CUDA device and refuses to start without one unless ``--device cpu`` is
given (the plain versions, for checking the program, not for timing),
prints its lines and ends with one JSON line of results that names the
device.  ``common`` holds the configurations and the timing they share.
"""
