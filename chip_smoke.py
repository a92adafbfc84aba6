#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root
    python3 chip_smoke.py --host-cost   # only the wrappers' host time a call
    python3 chip_smoke.py --mesh   # the build and phases 13-14 alone
    python3 chip_smoke.py --oobleck   # the build and phase 15 alone

Drives ``rawaudiovae_kelsey_tpu_torch`` (never JAX) through its serving
and training paths on the card, in phases; each prints what it found, and
any failure exits non-zero with a traceback (no phase is caught):

1. the card (``nvidia-smi`` name and power limit); requires CUDA;
2. builds the CUDA kernels from ``rawaudiovae_kelsey_tpu_torch/csrc``;
3. the serving kernels against their plain PyTorch versions at full width
   (1024/2048/256), batch 256 (the server's) and a ragged batch of 100,
   fp32 with TF32 off, and both times at batch 256; fp32 ``encoder_fwd`` and
   ``decoder_fwd`` on the register-tiled fp32 kernel (``csrc/sgemm.cuh``:
   h, then both heads in one grid; h3, then y; each product's tile and
   slices of its contraction from ``tensor_cores.sgemm_fwd_plan``) also at
   batch 1 and 8192, against the first version (``kernel="cuda_cores"``),
   equal bits twice, a latent of 38 keeping the first version and raising
   for ``kernel="sgemm"``, timed in turns with the first version, the plain
   version and the library sequence (``addmm`` → ``relu`` → ``addmm`` →
   ``addmm``; ``addmm`` → ``relu`` → ``addmm`` → ``tanh``) at 256 and 8192
   with each launch's device time apart, and every product's plan (tile,
   slices) swept at both beside the rule's pick; the int8 decoder
   ``quantized_decoder_fwd`` on ``csrc/sgemm.cuh`` (h3, then y, each int8
   weight copied into shared memory as it lies and dequantized as its slab
   is read back, on the fp32 decoder's plans) at batch 256, 33, 1, 100 and
   8192 against the plain version and the first version, bit for bit
   against the fp32 ``decoder_fwd(kernel="sgemm")`` on the dequantized
   weights, a latent of 38 keeping the first version, timed at 256 in
   turns with the first version, the plain version, that fp32 decoder and
   the library sequence (dequantize → ``addmm`` → ``relu`` → ``addmm`` →
   ``tanh``), by device time with its parts apart, and every product's plan
   swept;
3b. the training kernels — the four backward kernels in fp32 and bf16, the
   two forward kernels in bf16 — against their plain versions at full
   width, batch 8192 (the training microbatch), a ragged 1000 and 1, and
   both times at 8192; bf16 ``encoder_fwd`` on the tensor cores
   (``csrc/wgmma.cuh``: h, then both heads in one launch) also at latent 72
   and a narrow 4097x256->512->200 model, against the first version
   (``kernel="cuda_cores"``), equal bits twice, timed in turns with the
   first version, the plain version and the library sequence ``addmm`` →
   ``relu`` → ``addmm`` → ``addmm``, each one's device time and that of the
   hidden and the heads' launch apart; the same for bf16 ``decoder_fwd``
   (h3, then y; beside ``addmm`` → ``relu`` → ``addmm`` → ``tanh``) and bf16
   ``dec_bwd_fused`` (dh3 with the gate in the epilogue, dz, then dW3 and db3
   over slices of the batch; beside ``da @ w4.t()`` → ``where`` → ``@
   w3.t()`` → ``z.t() @ dh3`` → ``dh3.float().sum(0)``) at the ragged width
   72->520->264 too, a latent of 36 keeping the first version, with dh3's
   launch timed beside the same product without the gate and with a simple
   gate (a 4-byte load a pair, built from a patched copy of ``bwd.cu``) and
   the weight gradient's plan swept; the same for bf16 ``grad_accum`` (the
   weight gradient's launch alone, dW4 and db4, then the slices' sum; beside
   ``a.t() @ b`` → ``b.float().sum(0)``) and bf16 ``enc_bwd_dw1`` (dh as one
   product joined along k with the gate in its epilogue, dW1 and db1, the
   slices' sum; beside ``addmm(dmu @ w21.t(), dlv, w22.t())`` → ``where`` →
   ``x.t() @ dh`` → ``dh.float().sum(0)``), each at the ragged width too,
   a width no multiple of 8 keeping the first version, with the plan swept
   at dW4 and dW1; the same for bf16 ``grad_accum2`` (dW21 and dW22 with
   their column sums in one launch, both outputs side by side, then the
   slices' sum; beside ``h.t() @ dmu`` → ``dmu.float().sum(0)`` → ``h.t() @
   dlv`` → ``dlv.float().sum(0)``) at latent 72 too, a latent of 36 keeping
   the first version, with the plan swept for two outputs; fp32
   ``enc_bwd_dw1``, ``grad_accum2`` and ``dec_bwd_fused`` on
   ``csrc/sgemm.cuh`` (the fp32 launches of ``matmul_nt2_mask`` /
   ``matmul_nt_mask``, ``matmul_nt`` and ``grad_accum`` one after
   another) at 8192, 1000 and 1 against the plain version and the first
   version, bit for bit against those launches called one by one, a latent
   of 38 keeping the first version, timed at 8192 in turns with the first
   version, the plain version and the fp32 library sequence (TF32 off) and
   by device time with each launch apart;
3c. the fp32 input-gradient kernels (``matmul_nt``, ``matmul_nt_mask``,
   ``matmul_nt2_mask``) in fp32 and bf16 at batch 8192, 1000 and 1, with
   the one PyTorch call ``a @ w.t()`` timed beside ``matmul_nt``; bf16
   ``matmul_nt`` on the tensor cores (``csrc/wgmma.cuh``) at its two
   main-path shapes (dz, dx), at ragged shapes and at shapes TMA cannot
   take (which keep the first version), against the plain version and the
   first version, with which kernel ran printed per shape, and timed in
   turns beside the first version, the plain version and ``a @ w.t()``; the
   same for fp32 ``matmul_nt`` on the register-tiled fp32 kernel
   (``csrc/sgemm.cuh``) at dz and dx, ragged shapes, batch 1 and shapes it
   cannot take (k or n no multiple of 4), with the device time of every
   tile beside the rule's pick (``tensor_cores.sgemm_tile``); fp32
   ``grad_accum`` on ``csrc/sgemm.cuh``'s weight gradient (aᵀ read M-major,
   the batch cut into slices) at the ``highest`` step's five
   weight-gradient shapes at 8192, the ragged 1000, batch 1 and an m no
   multiple of 4 (first version), dW4, dW21 and dW3 timed in turns beside
   the first version, the plain version and ``a.t() @ b`` → ``b.sum(0)``,
   the plan swept at dW4 and dW21; ``matmul_nt_mask`` and
   ``matmul_nt2_mask`` (rows 5 and 6) on their new forms — bf16 on the
   tensor cores (``dec_bwd_fused`` 's gated dh3 launch; ``enc_bwd_dw1`` 's
   dh launch, the two pairs joined along k), fp32 on ``csrc/sgemm.cuh`` 's
   gated product (the gate read where the output goes; the pairs joined as
   the slabs are copied) — at batch 8192, 1000 and 1, at the ragged width
   1000x264->520 and at a width neither takes (a pair's n of 36 in bf16, 38
   in fp32: the first version, and naming the new form raises), against
   the plain version and the first version, equal bits twice, timed at 8192
   in turns with the first version, the plain version and the library
   sequence (``(a @ w.t()) * (gate > 0)``; ``where(gate > 0, addmm(a1 @
   w1.t(), a2, w2.t()), 0)``) and by device time; the
   in-kernel sampler at (4096, 256), (1000, 256) and (1, 256): its Philox
   words bit for bit, ``z``, determinism, both seed words, moments over a
   million samples, its backward; ``dx`` through ``mlp.encode``;
4. the serving path: ``configs/default.ini`` (backend = pallas, dense
   1024/2048/256) → a run workspace with seeded random weights saved in the
   JAX npz layout → the HTTP server on 127.0.0.1 (warmup, deterministic)
   → real requests (healthz, reconstruct plain and hop+OLA, encode, decode,
   interpolate), then again with ``quantize=True``.  Responses are checked
   for shape and finiteness, /reconstruct against the plain-version path on
   the same card, and every serving kernel's launch counter must have risen;
5. the training path: a synthetic wav corpus (one full batch of 131072
   frames and a ragged one per epoch) → ``configs/default.ini`` (bf16,
   pallas, microbatch 8192) with only the datapath, epochs, checkpoint
   interval and best-model gate changed → ``python -m
   rawaudiovae_kelsey_tpu_torch train`` in-process → finite, falling
   losses, the workspace's artifacts, every training kernel launched; a
   ``--resume`` run that takes one more epoch; one step from the trained
   state through the kernels and through the plain ops, same noise, in
   bf16, in fp32 at ``high`` (the 3-pass "full" chains) and at ``highest``
   (the fp32 "primitive" kernels); training frames/s of both backends and
   the device's busy share; the bf16 step's ``encoder_fwd``,
   ``decoder_fwd`` and ``dec_bwd_fused`` launches, one each a microbatch,
   all on the tensor cores (none at ``high`` or ``highest``), the same for
   ``grad_accum``, ``enc_bwd_dw1`` and ``grad_accum2``; the ``highest``
   step's five ``grad_accum`` launches a microbatch and its
   ``matmul_nt_mask`` and ``matmul_nt2_mask`` launches, one each a
   microbatch, all on ``csrc/sgemm.cuh``, and the ``encoder_fwd`` and
   ``decoder_fwd`` launches of the ``highest`` step, one each a
   microbatch, all on ``csrc/sgemm.cuh``, those of the ``high`` step all
   on the 3-pass tensor-core chains (``split_launches``, phase 3g's forms;
   none on ``csrc/sgemm.cuh``); the ``high`` step's ``enc_bwd_full`` and
   ``dec_bwd_full`` launches, one each a microbatch, all on the tensor
   cores; the device time by kernel of one bf16 kernel step, of one
   ``high`` and of one ``highest`` kernel step;
6. the device-resident path: ``configs/perf_bf16.ini`` uncut (batch 4096,
   bf16, block shuffle, ``rng = tpu_prng``, ``device_resident = always``)
   on the corpus of phase 5, with only the datapath, epochs, checkpoint
   interval and best-model gate changed and ``backend = pallas`` named (the
   file's ``best`` resolves to the plain ops), so that a boundary fires
   mid-run;
   a ``--resume`` for one more epoch; the sampler launched once per step
   and the host loader never built; one resident epoch against a host-fed
   loop fed the same bf16 batches (equal losses, bit for bit); one
   resident epoch at ``highest`` through the primitive kernels (``matmul_nt``,
   ``matmul_nt_mask`` and ``matmul_nt2_mask`` on the fp32 kernel once a
   step each) against the plain backend; ``dx`` through the model's encoder
   in fp32 and bf16 (its dh on ``csrc/sgemm.cuh`` and on the tensor cores),
   and through the ``high`` step's encoder (the model under the tier,
   ``models/registry.py`` ``under_tier``: the forward, dh and dx in three
   passes on the tensor cores, one launch each, against the 3-pass plain
   version); the
   corpus layout under a small budget and the ``always`` error under none;
   resident and host-fed epoch frames/s of both backends and the device's
   busy share over a resident epoch;
3d. (run with the other kernel phases) ``enc_bwd_full`` and ``dec_bwd_full``
   with fp32 operands in the 3-pass mode and with bf16 operands in one
   pass, each on its tensor-core form (fp32: ``csrc/full.cu``, the split
   pass and three bf16 passes a product in three accumulators; bf16: the
   split backward's launches) and on its first version, named, at batch
   4096 (the stream's), 8192 and a ragged 4097, against their plain
   versions; timed in turns (new form, first version, plain) at 4096 and
   at 8192, and at 4096 by device time beside their library sequence (fp32:
   each operand split as the kernels split it, three ``torch.mm`` of bf16
   operands with an fp32 output a product; bf16: one such product a
   weight gradient; held against the plain version first), the IEEE fp32
   sequence (another function), the split pass alone and the new form's
   parts by kernel name, with a sweep of the 3-pass tile widths at 4096
   and 8192; both forms of the 3-pass chains bit
   for bit against their plain versions on operands built so that every
   sum has one non-zero term and many values sit on a rounding tie of the
   hi/lo split (a one-pass product or a split that rounds to nearest even
   gives other bits); ``loss_sums`` on fp32 and bf16 inputs at batch 4096
   and 25,810 (equal bits on a second launch) with both times;
   ``fused_loss`` and its closed-form backward against the plain loss;
   ``loss_sums`` (bf16 recon / x, fp32 mu / logvar) and ``loss_grads``
   (that pair and fp32) at the benchmark's batch of 131,072 against their
   plain versions, by device time against their bytes bound;
7. the streaming path: ``configs/default_iterable.ini`` (batch 4096, bf16,
   pallas) on a synthetic folder of five wavs of unequal length, one of
   them resampled, with only the datapath, the frame budget (40 batches)
   and the checkpoint and histogram intervals changed → ``python -m
   rawaudiovae_kelsey_tpu_torch stream`` in-process, once as written and
   once with ``precision = high`` → finite, falling losses, ``batch_id``
   checkpoints, the gate's line; per step the bf16 run launches the split
   kernels and the ``high`` run ``enc_bwd_full`` and ``dec_bwd_full`` once
   each, every one on the tensor cores, and no split kernel; one ``high``
   step against the plain backend
   from the same state and noise, and the plain loss on that step's
   tensors against its loss (row 14's kernels); ``loss_sums`` and
   ``loss_grads`` once a step in each run; ``--resume`` with a larger budget against a
   straight run of that budget (equal losses); ``eval`` on the run; the hot
   loop's frames/s and the device's busy share for both precisions.

3e. (run with the other kernel phases) the variants' kernels in fp32 and
   bf16: ``linear_ksplit_fwd`` at 4096x4096->4096, 4096x1024->512 and a
   ragged 4097x1088->544 (more than one k slice each, equal bits on a
   second launch); its bf16 tensor-core form at the deep model's layers,
   at ragged shapes and at shapes TMA cannot take, as in 3c, timed in
   turns beside the first version, the plain version and ``torch.addmm``;
   ``linear_fwd`` at 4096x512->256, 256x4096->4096 (the
   server's batch) and 96x384->640, the first beside ``torch.addmm``, and its
   bf16 tensor-core form as the k-split's at the deep model's four whole-k
   layers, 256x4096->4096, the ragged shapes and those TMA cannot take,
   with the device time of a deep forward's four whole-k launches; fp32
   ``linear_fwd`` on the fp32 kernel (``csrc/sgemm.cuh``) at the deep
   server's nine distinct shapes (batch 256), 4096x512->256, 4096^3,
   ragged shapes with every activation and shapes it cannot take, timed in
   turns with the first version, the plain version and ``torch.addmm``, the
   device time of the server's eleven launches, the tile sweep; the same
   for fp32 ``linear_ksplit_fwd`` on that kernel (the deep model's k-split
   layers, timed at 4096^3 and 4096x1024->512), equal bits with
   ``linear_fwd(kernel="sgemm")``;
   ``toeplitz_fwd`` through ``conv1d_pallas`` / ``conv1d_transpose_pallas``
   at the eight layers of ``configs/conv1d.ini``, batch 4096 (one also at
   4097), forward and the ``dx`` launch, against the plain convolutions,
   each layer's both launches on its form (the first and the last layer
   the narrow-channel kernel; the six between the tensor cores in bf16 and
   the fp32 kernel, over the packed stack's window, in fp32), the narrow
   and fp32 forms equal to the first version bit for bit (forward and dx),
   timed in turns with the first version, the plain version and
   ``F.conv1d`` / ``F.conv_transpose1d`` with each one's device time and
   the eight-layer sums; the narrow rule's sweep (each form at layers 0 and
   7 and their dx and at ragged shapes, the narrow kernel's column chunks
   and positions a thread), the fp32 tiles' sweep and the window against
   the whole packed stack at layers 1-3; the narrow and fp32 forms at
   ragged shapes (passes = 4 too); the tensor-core form at ragged tile
   plans (t_out 48, 100, 200,
   13; shift 0 and KB - 1; G 24, 72, 16; B = 1) against plain and the first
   version, equal bits twice; ``passes = 4`` against its plain version and
   against IEEE fp32; odd shifts and lengths; at each tensor-core shape of
   the deep and conv1d paths the device time of every tile width beside
   the rule's pick (``tensor_cores.tile_n``), and each tensor-core
   wrapper's host time a call;
8. the deep/wide model: ``configs/deep_wide.ini`` uncut (segment 4096,
   hidden 4096,2048,1024,512, latent 256, bf16, batch 4096) with ``backend
   = pallas`` and only the datapath, epochs, checkpoint interval and
   best-model gate changed → the ``train`` command, a ``--resume``; one
   step from the trained state through the kernels and through the plain
   ops, same noise, in bf16 and at ``highest``, with 7 k-split + 4 whole-k
   launches a forward, in bf16 all 11 on the tensor cores, at ``highest``
   all 11 on the fp32 kernel (0 + 11 at the server's
   batch 256, all on the tensor cores in bf16, all on the fp32 kernel in
   fp32); the HTTP server (fp32, every launch on the fp32 kernel) on the
   run's ``best_model.npz``
   against the plain backend; ``encode_trajectory`` / ``decode_trajectory``
   of the same weights through the kernels (11 whole-k launches, all on
   the fp32 kernel) against the plain backend; frames/s of both backends
   and the device's busy share;
9. the conv1d model: ``configs/conv1d.ini`` uncut (channels 32,64,128,256,
   kernel 9, stride 4, bf16, batch 4096) → the ``train`` command through
   the registry (plain convolutions, no kernel launched), a ``--resume``;
   one step through the op-level Toeplitz path (``conv_encode_pallas`` /
   ``conv_decode_pallas``) against the registry's model from the same state
   and noise, in bf16 and at ``highest``: 8 forward + 7 ``dx`` Toeplitz
   launches (the first layer's input is the batch, which needs no
   gradient), 12 of them on the tensor cores in bf16 and on the fp32
   kernel at ``highest``, the other 3 on the narrow-channel kernel, none on
   the first version, and 3 whole-k linear launches (bf16: all on the
   tensor cores); step time of both; each step's device time by kernel.

3g. (run with the other kernel phases) the ``high`` tier's 3-pass forms
   (``passes = 3``: ``csrc/full.cu``'s chains on the tensor cores, the split
   pass then one 3-pass ``csrc/wgmma.cuh`` launch a product) of
   ``encoder_fwd``, ``decoder_fwd``, ``matmul_nt2_mask`` (the encoder's dh),
   ``matmul_nt`` (its dx) and the row-parallel ``encoder_fwd_partial`` /
   ``decoder_fwd_partial`` (units 1024 of 2048) at full width, batch 8192,
   4096 and a ragged 4097, against their 3-pass plain versions (1e-4 ·
   max|plain|) and their first versions (``kernel="cuda_cores"``, gemm.cuh's
   3-pass mode), equal bits on a second launch, no launch on
   ``csrc/sgemm.cuh``; bit for bit on ``exact_forward_case`` (every sum one
   term; y within 8 ulps); timed at 8192 in turns with the plain version
   and the first version, by device time with the split pass apart, beside
   the 3-pass library sequence (``torch.mm(bf16, bf16,
   out_dtype=float32)``) and the bound with and without the split pass's
   bytes;
3h. (run with the other kernel phases) the backward-fusion switch
   (``ops/mlp.py`` ``BWD_FUSION``): the 3-pass forms of ``matmul_nt_mask``,
   ``grad_accum``, ``enc_bwd_dw1``, ``grad_accum2`` and ``dec_bwd_fused``
   (``csrc/full.cu``'s parts of the chains) and ``enc_bwd_full`` /
   ``dec_bwd_full`` in one fp32 pass (``csrc/sgemm.cuh``'s launches of the
   split kernels in turn) at batch 8192 and 4097, each new form and its
   first version against the plain version (1e-4 · max|plain|), equal bits
   twice; the 3-pass forms bit for bit on ``exact_split_case``, the
   one-pass chains bit for bit against the kernels they launch; timed at
   8192 in turns with the plain version and the first version, by device
   time beside the 3-pass library sequence or the IEEE one; then one step
   of ``configs/default.ini``'s model (two microbatches of 8192) for every
   mode forced (primitive, split, full) and tier (bfloat16, high,
   highest), kernels against the plain step of the same mode and pass
   count (the wrappers' plain versions on the card): the loss, the update
   outside Adam's eps zone and the gradient within PERF.md section 2's
   bound, every launch of the mode's kernels and of the forward on the
   tier's form, none of another mode's; then ``probes/fusion_ab.py`` at
   ``bfloat16`` and ``high`` (10 alternating pairs of 5 steps);
3f. (run with the other kernel phases) the probes' kernels: ``dw_fused`` and
   ``dx_fused`` in fp32 (on ``csrc/sgemm.cuh``) and bf16 (on the tensor
   cores), relu / tanh / none, at the four large layers of
   ``configs/deep_wide.ini`` at batch 4096 and at ragged sizes (batch 4097
   and 1000, k and n no multiples of a tile), against their plain versions
   and their first versions, equal bits on a second launch, each launch
   counted on the new form ((1000, 70, 33) keeps the first version, and
   naming the new form there raises), timed at 4096 x 4096 in turns with
   the first version, the plain version and the library sequence
   (cotangent -> product, -> sum for dW) and by device time beside the
   bare product, their plans swept at the deep layers; the library
   sequences of the sampler and the loss sums beside their kernels' device
   time; ``leaf_update`` (the tree kernel with a table of one leaf, and
   ``kernel="first"``, the first version) against its plain version
   BIT FOR BIT on leaves of 1, 255, 256 and 4,000,003 elements, a 3-D leaf
   and an unaligned view, in place; ``adam_tree`` bit for bit on a tree of
   aligned, unaligned and empty leaves (one launch) and on one of
   ``K_MAX_LEAVES + 3`` leaves (two launches);
   ``fused_adam_apply`` against ``Adam.update`` bit for bit over 5 coupled
   steps on the deep, dense and conv1d trees at full width, one launch a
   step; timed in turns (CUDA events over the host loop, and device time)
   on the deep and dense trees and a 4096x4096 leaf: the tree kernel
   through ``fused_adam_apply`` and alone, the first version, the plain
   version and ``torch.optim.Adam(fused=True)``, which is timed here and
   used nowhere in the package, in five rounds of turns, beside the bytes
   bound;
10. the probes through their ``main()`` at full width: ``deep_bwd --all``
   in bf16 (and the largest layer in fp32), ``deep_step`` on the deep
   model, ``adam_fusion`` on deep/``xla``, deep/``pallas`` and
   dense/``pallas``: every parity passes, ``dw_fused`` and ``dx_fused``
   launch once a fused backward, every launch on the new form (the tensor
   cores in bf16, ``csrc/sgemm.cuh`` in fp32), ``adam_tree`` once a step
   (22 leaves deep, 10 dense), ``leaf_update`` never, nothing under the
   plain optimizer, and the two optimizers' states are equal bit for bit;
   the two step rates printed;
11. the library path: ``configs/default.ini`` (dense 1024/2048/256,
   ``backend = pallas``) → a run workspace with seeded random weights and a
   synthetic folder of a dozen 1-3 s clips (mixed sines and noise, 44.1
   kHz) → the ``tutorial``, ``som --grid 8,8 --iters 200`` and ``export``
   commands in-process: every artifact exists, its audio finite and not
   silent, ``clusters.json`` read back through ``SomClusters`` and one
   cluster's audio concatenated; ``encode_trajectory`` of a 4 s clip and
   deterministic ``interpolate_stepwise`` / ``interpolate_timevarying``
   through the kernels against a ``backend = xla`` model of the same
   weights on the card, two stochastic calls of one seed equal bit for bit;
   every ``encoder_fwd`` / ``decoder_fwd`` launch of the phase on
   ``csrc/sgemm.cuh``; the deterministic ``.onnx`` through ``OnnxModel``
   against the deterministic forward on the card, the exported programs
   run on the card against the plain forward, the npz read back equal;
   ``encode_trajectory`` frames/s through the kernels and the plain ops at
   batch 256, in turns, and the SOM fit's time;
12. the resident stream: ``configs/default_iterable.ini`` (dense
   1024/2048/256, batch 4096, bf16, ``backend = pallas``) on a seeded
   folder of 24 wavs of 10-40 s (one at 22.05 kHz) and one shorter than a
   segment, with only the datapath, the frame budget (300 batches: the
   stream wraps the folder several times), both intervals (100) and the
   ``[tpu]`` keys each run names changed → the ``stream`` command
   in-process with ``device_resident = always`` in the samples and the
   frames layout, at ``precision = high``, and a ``--resume`` from the
   first checkpoint: the ``Device-resident stream`` line names the layout,
   the host-fed feed is never built, losses finite and falling, rows 1, 2
   and 7-10 once a step on the tensor cores (rows 11-12 under ``high``);
   the two layouts, the first 100 batches of a host-fed run with
   ``feed_dtype = bfloat16`` and the resumed run give equal bits; the gate
   (a budget between the layouts' sizes trains resident in the samples
   layout and host-fed in the frames layout, printing the plan; ``always``
   at 0 raises); the run's peak device memory with the corpus apart; both
   engines' hot-loop frames/s in turns, each with the device's busy share;
   whether the C++ wav codec (``io/native.py``) built;
13. data parallelism (``parallel/mesh.py``): two ranks, processes started
   with ``torch.multiprocessing`` (spawn), share the one card on a gloo
   group the phase initialises (the port uses it as it stands): which
   collectives gloo takes on CUDA tensors (the port's all_reduce,
   broadcast, all_gather and all_to_all_single must); the epoch trainer of
   ``configs/default.ini`` (bf16, pallas, batch 131072 = 65536 a rank,
   microbatch 8192), 2 steps, each rank on its file shard: one workspace,
   TensorBoard from rank 0 only, equal params, rows 1, 2 and 7-10 on the
   tensor cores on each rank; one 2-rank step at bf16 (timed beside the
   one-rank step on the same card: not a scaling figure), ``high`` (rows
   11-12) and ``highest`` (rows 4-7 on ``csrc/sgemm.cuh``), and of
   ``configs/deep_wide.ini`` (rows 15-16), each against the one-rank step
   at the same global batch and noise within the training-correctness
   bound (5e-2 bf16, 1e-3 fp32), the ranks' updates equal bit for bit; the
   sharded resident epochs of ``configs/perf_bf16.ini`` (pallas,
   ``tpu_prng``, the two-pass shuffle), each rank's first sampler seed
   folded by its rank and the kernel's words equal to the plain Philox;
   the stream of ``configs/default_iterable.ini``, 48 batches host-fed and
   resident (equal losses and params) and resident at batch 4095 (the
   weighted loss); ``encode_trajectory_sharded`` of 60 s against
   ``encode_trajectory``; then NCCL at one rank a card through
   ``maybe_initialize_distributed`` (backend None): the mesh step equals
   the plain step bit for bit.  With two cards or more every job above
   runs again with one rank a card over NCCL (the step's wall time then a
   scaling figure), and the ``train`` command with ``data_parallel = 0``
   starts one rank a card itself;
14. tensor parallelism (``parallel/sharding.py``,
   ``parallel/tensor_parallel.py``): the row-parallel forms of rows 1, 2,
   15 and 16 (``encoder_fwd_partial`` / ``decoder_fwd_partial`` at the
   dense model's shards in bf16 and fp32, ``linear_partial`` at
   deep_wide's five row-parallel layers in bf16: fp32 partial sums, no
   bias, no activation) against their plain versions, equal bits twice,
   timed in turns with the plain version and, for ``linear_partial``,
   ``torch.mm(out_dtype=float32)``; then two ranks at ``model_parallel =
   2`` share the card over gloo: one ``configs/default.ini`` step at bf16
   (timed beside the one-rank step: no scaling figure), with ``tpu_prng``,
   at ``high`` and at ``highest``, and one ``configs/deep_wide.ini`` step
   (pallas, bf16, batch 4096), each against the one-rank step from the
   same init and global noise (5e-2 bf16, 1e-3 fp32; ``tpu_prng`` only
   where there is one data index: the sampler folds it), every rank's
   gathered update equal bit for bit, rows 1, 2 and 7-10 on the tensor
   cores every microbatch with rows 1 and 2 in their row-parallel form,
   the fp32 forms on ``csrc/sgemm.cuh``, rows 15-16 on the tensor cores
   with row-parallel launches, row 13's seed words equal on the model
   ranks; the bf16 step's state saved in the sharded format at model 2
   and read back whole at model 1 with equal bits.  With four cards or
   more the same steps run on a 2x2 mesh over NCCL, one rank a card, and
   the ``train`` command with ``model_parallel = 2`` and
   ``checkpoint_format = orbax`` starts one rank a card, writes the
   sharded format and resumes from it;
15. the Oobleck model (``configs/port/stable_audio_vae.ini``): row 21
   (``snake_fwd`` / ``snake_bwd``, ``csrc/snake.cu``) in bf16 and fp32 at
   each stage's shape of the cell's step (batch 48, from (128, 65536) to
   (2048, 32)) against its plain versions in float64 on the same rounded
   operands (bounds that carry the arguments' size, d alpha and d beta
   included; a second backward equal bit for bit), timed against them
   beside the bytes bound; then one resident epoch of two steps
   (``build_model``, ``resident_model``, ``build_resident_epoch``) in bf16
   at the cell's batch and in fp32 (``highest``) at a batch of 4: finite
   losses, 72 + 72 launches of row 21 a step, row 20's ``adam_tree`` 8 a
   step (365 leaves), row 14's two kernels once a step in bf16.

Phases 5 and 8 also hold a bf16 kernel step with ``[tpu] remat = true``
against the same step without it (same state and noise): equal bits of
loss, params and moments; the forward kernels (rows 1-2; 15-16) launch
twice as often, the backward ones as often; both steps' times and peak
device memory.

``launches`` in the kernel line: the wrapper's count over the path where
that dtype runs, set to 0 just before it — fp32 forward kernels: serving
(phase 4; fp32 ``encoder_fwd`` / ``decoder_fwd`` and the int8
``quantized_decoder_fwd``: those on the fp32 kernel, every one); bf16 forward kernels: the training run of phase 5 (its
fp32 test-set reconstructions included); bf16 "split" backward kernels: that
run (bf16 ``encoder_fwd``, ``decoder_fwd``, ``dec_bwd_fused``,
``grad_accum``, ``enc_bwd_dw1`` and ``grad_accum2``: those on the tensor
cores; the run's fp32 reconstructions take ``csrc/sgemm.cuh``); fp32
``grad_accum``: the ``highest`` step of phase 5 (those on the fp32 kernel
of ``csrc/sgemm.cuh``; no path of the
package runs ``enc_bwd_dw1``, ``grad_accum2`` or ``dec_bwd_fused`` on fp32
operands since ``high`` takes the full chains: phase 3b still holds their
``csrc/sgemm.cuh`` forms against their plain versions and times them
beside their fp32 library sequences, and they stay out of the kernel line,
printed as "on no path");
``enc_bwd_full`` / ``dec_bwd_full``: the
``high`` stream run of phase 7 (those on the tensor cores, every one);
``loss_sums`` / ``loss_grads``: the steps of phase 7's stream runs
(``[fp32]``: the ``high`` run; ``[bf16-fp32]``: the bf16 run), whose loss
runs on them as every ``pallas`` step's on the card; fp32
``matmul_nt*``: the ``highest`` resident epoch of phase 6 (those on the
fp32 kernel); bf16
``matmul_nt`` / ``matmul_nt2_mask``: the bf16 ``dx`` of phase 6
(``matmul_nt2_mask``: those on the tensor cores; no path of the package
runs ``matmul_nt_mask`` in bf16; phase 3c still holds it against its
plain version and its first version); the sampler: the resident training run;
bf16 ``linear_ksplit_fwd`` / ``linear_fwd``: the deep training runs of
phase 8; fp32 ``linear_ksplit_fwd``: the deep ``highest`` step (those on
the fp32 kernel); fp32
``linear_fwd``: the deep server (those on the fp32 kernel);
``toeplitz_fwd``: the op-level conv1d step of phase 9 in bf16 (those on the
tensor cores) and at ``highest`` (those on the fp32 kernel);
``toeplitz_fwd_narrow``: the same two steps' launches on the
narrow-channel kernel; ``dw_fused`` / ``dx_fused``: the
``deep_bwd`` probe runs of phase 10 in each dtype (those on the new form,
every one); ``adam_tree``: the
three ``adam_fusion`` probe runs of phase 10; ``snake_fwd`` /
``snake_bwd``: phase 15's resident epochs (bf16 at the cell's batch, fp32
at 4), each row at the cell's stage-0 shape with every stage's numbers
under ``stages``.  A row on phase 13's path
also has ``mesh_launches_per_rank``: its launches on each of the two
ranks there (the bf16 step's rows 1, 2, 7-10, the ``high`` step's 11-12,
the ``highest`` step's fp32 rows 1, 2, 4-7, the deep step's bf16 15-16,
the resident epochs' 13); a row on phase 14's path
``tp_launches_per_rank``: its launches on each rank of the model-2 steps
there.  The row-parallel forms' rows (``encoder_fwd_partial``,
``decoder_fwd_partial``: bf16 on the tensor cores, fp32 on
``csrc/sgemm.cuh``; ``linear_ksplit_fwd_partial`` /
``linear_fwd_partial``: bf16 on the tensor cores at deep_wide's
4096x2048->2048 and 4096x512->512 shards) take their launches from phase
14's steps on rank 0 (bf16: the default.ini and deep_wide steps; fp32: the
``highest`` step).  The ``high`` tier's 3-pass rows (``<name>[3-pass]``,
phase 3g; ``device_ms``, ``parts_ms``, ``first_version_ms`` and
``split_bound_ms`` beside the contract's keys) take theirs from the
launches on the 3-pass tensor cores: ``encoder_fwd`` / ``decoder_fwd``
from phase 5's ``high`` step (and per rank from phase 13's),
``matmul_nt2_mask`` / ``matmul_nt`` from phase 6's ``high`` dx, the
row-parallel forms from phase 14's ``high`` model-2 step (rank 0, and per
rank).  Phase 3h's rows (``<name>[3-pass]`` for rows 5 and 7-10,
``<name>[fp32-1pass]`` for rows 11-12) and the rows the switch puts on a
path (fp32 ``enc_bwd_dw1``, ``grad_accum2``, ``dec_bwd_fused``; bf16
``matmul_nt_mask``, ``enc_bwd_full``, ``dec_bwd_full``) take theirs from
phase 3h's step of the tier and mode that runs them, on the form the row
describes (its ``path`` key names the step).
``bound_ms`` is the larger of bytes moved (each input read once, each
output written once) over 3.35 TB/s and operations over the peak of the
operand type (67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16:
NVIDIA's H100 SXM data sheet), at the shapes that were timed: those the
path named above gives the kernel.

The rows of bf16 ``matmul_nt``, ``matmul_nt2_mask``, ``linear_ksplit_fwd``,
``linear_fwd``, ``toeplitz_fwd``, ``encoder_fwd``, ``decoder_fwd``,
``dec_bwd_fused``, ``grad_accum``, ``enc_bwd_dw1`` and ``grad_accum2``
describe the tensor-core kernel, those of fp32 ``matmul_nt``,
``matmul_nt_mask``, ``matmul_nt2_mask``, ``linear_ksplit_fwd``,
``linear_fwd``, ``toeplitz_fwd``, ``grad_accum``, ``encoder_fwd``,
``decoder_fwd`` and ``quantized_decoder_fwd`` the fp32 kernel of
``csrc/sgemm.cuh`` (``toeplitz_fwd`` at conv1d.ini's layer 1, with the
window; the ``toeplitz_fwd_narrow`` rows the narrow-channel kernel of
``csrc/narrow.cuh`` at its layer 7; each with ``device_ms``,
``library_device_ms`` and ``first_version_device_ms``) (``ms``,
and ``launches``: those that took it; ``quantized_decoder_fwd`` with an
int8 B, at the server's batch, with the fp32 decoder's times on the
dequantized weights as ``fp32_decoder_ms`` / ``fp32_decoder_device_ms``; fp32 ``linear_fwd`` at the server's 256x4096->4096, fp32
``linear_ksplit_fwd`` at 4096^3, fp32 ``grad_accum`` at dW4,
8192x2048->1024, with dW21 and dW3 in keys of their own, fp32
``encoder_fwd`` / ``decoder_fwd`` at the server's batch of 256, with the
microbatch's numbers under ``at_8192``), and carry the first version's
time on the same inputs as ``first_version_ms``.  The ``library_ms`` of
bf16 ``encoder_fwd``, ``decoder_fwd``, ``dec_bwd_fused``, ``grad_accum``,
``enc_bwd_dw1`` and ``grad_accum2`` and of fp32 ``encoder_fwd``,
``decoder_fwd``, ``grad_accum``, ``matmul_nt_mask`` and ``matmul_nt2_mask``
(rows 5 and 6 at the microbatch, with ``first_version_ms``), of bf16
``matmul_nt2_mask``, of ``dw_fused`` and ``dx_fused`` in both
dtypes (whose rows describe the tensor-core form in bf16 and the
``csrc/sgemm.cuh`` form in fp32), of ``enc_bwd_full`` and ``dec_bwd_full``
in both dtypes (fp32: the 3-pass sequence, with the IEEE fp32 sequence's
time as ``fp32_sequence_ms`` and the split pass alone as
``split_pass_ms``; bf16: the one-pass sequence; their rows describe the
tensor-core form and carry the first version's time as
``first_version_ms``), of ``quantized_decoder_fwd``, of the
sampler and of ``loss_sums`` is the device time of a sequence of library
calls on the same inputs (its ``library`` key says which): no one PyTorch
call computes any of them.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import io
import json
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BATCH = 256              # InferenceServer's default batch
RAGGED = 100             # a batch that is no multiple of any tile
SR = 44100
CLIP_S = 3.0
# fp32 kernel vs fp32 plain (cuBLAS, TF32 off) on the same card: the same
# products, summed over K <= 2048 in another order.  Expected error is
# O(sqrt(K) * 2^-24 * |partial sums|) ~ 1e-6; 1e-4 leaves 100x headroom
# while any indexing or masking fault shows as O(1e-2..1).
KERNEL_ATOL = 1e-4
# the HTTP path returns float32 WAV bytes: no further rounding
HTTP_ATOL = 1e-4
# phase 3b.  The backward kernels contract the batch (K up to 8192) in
# fp32: their outputs are held relative to the output's largest value,
# 1e-4 * max|plain| (measured ~1e-6 relative).  bf16 outputs (activations,
# dz) may flip by one bf16 ulp (2^-8 relative) where the two fp32 sums
# straddle a rounding boundary, and a rounded hidden cotangent (dh, dh3)
# can carry one more into what follows: 2^-6 * max|plain| for every output
# of a bf16 call.  An indexing or masking fault shows as O(max|plain|).
TRAIN_BATCH, TRAIN_RAGGED = 8192, 1000
GRAD_REL = 1e-4
BF16_REL = 2.0 ** -6
# phase 3d.  The 3-pass chains split their operands exactly as their plain
# versions do and add the same bf16 x bf16 products (exact in fp32) in
# another order: 1e-4 * max|plain| as for the fp32 kernels (measured ~2e-6).
# That tolerance cannot tell three passes from one, or the split's rounding
# (both move a product by ~1e-5 of it), so the chains are also held bit for
# bit on built operands (exact_split_case); only the two bias gradients that
# sum a dense cotangent over the batch keep a tolerance there, EXACT_DB_REL.
# The loss sums add up to 26 M fp32 terms in another order than torch.sum:
# rel 1e-5; two launches on the same inputs must give the same bits.
STREAM_BATCH, FULL_RAGGED = 4096, 4097
FULL_REL = 1e-4
EXACT_DB_REL = 1e-5
LOSS_BATCH, LOSS_RAGGED = 4096, 25_810
SUMS_REL = 1e-5
# row 14's two kernels at the benchmark cells' whole batch (the dense
# model's 131,072 rows), in the pairs of dtypes the train steps pass: the
# gradient is the plain version's formula with its roundings, so d recon
# within one bf16 ulp (fp32: rel LOSS_GRAD_REL) and d mu, d logvar within
# rel LOSS_GRAD_REL (the precise expf beside torch.exp)
LOSS_STEP_ROWS = 131_072
LOSS_GRAD_REL = 1e-6
# phase 3e.  The variants' kernels: fp32 within 1e-4 * max|plain| (the same
# products summed in another order), bf16 within 2^-6 * max|plain| (a
# flipped bf16 ulp, and one more carried through an activation); the 4-pass
# Toeplitz product within 1e-5 * max|plain| of its 4-pass plain version
# (equal bf16 x bf16 products, exact in fp32, in another order); the k-split
# kernel: equal bits on a second launch.
DEEP_BATCH, SERVE_BATCH = 4096, 256
VARIANT_REL = {"fp32": 1e-4, "bf16": 2.0 ** -6}
FOUR_PASS_REL = 1e-5
# configs/conv1d.ini: kernel 9, stride 4, channels 32,64,128,256, segment
# 1024 → the eight layers as (direction, length in, channels in, out)
CONV_K, CONV_S = 9, 4
CONV_LAYERS = [("conv", 1024, 1, 32), ("conv", 256, 32, 64),
               ("conv", 64, 64, 128), ("conv", 16, 128, 256),
               ("convT", 4, 256, 128), ("convT", 16, 128, 64),
               ("convT", 64, 64, 32), ("convT", 256, 32, 1)]


# phase 3f.  dw_fused / dx_fused hold VARIANT_REL against their plain
# versions (the same products in another order; bf16: one flipped ulp of dx)
# and equal bits on a second launch; leaf_update and adam_tree hold no
# tolerance: equal bits.  Shapes: the deep model's four large layers (k, n) at its batch, and
# two ragged ones (batch, k, n).
DEEP_LAYERS = ((4096, 4096), (4096, 2048), (2048, 1024), (1024, 512))
# configs/deep_wide.ini's eleven layers (k, n, activation) in the order of
# a forward: the server's eleven whole-k launches at its batch
SERVER_LAYERS = ((4096, 4096, "relu"), (4096, 2048, "relu"),
                 (2048, 1024, "relu"), (1024, 512, "relu"),
                 (512, 256, "none"), (512, 256, "none"), (256, 512, "relu"),
                 (512, 1024, "relu"), (1024, 2048, "relu"),
                 (2048, 4096, "relu"), (4096, 4096, "tanh"))
RAGGED_LAYERS = ((4097, 1088, 544), (1000, 70, 33))
ADAM_LEAVES = ((1,), (255,), (256,), (4_000_003,), (7, 33, 5))
ADAM_BYTES = 28              # an element: read p, g, m, v; write p, m, v
ADAM_OPS = 14                # an element: 6 mul, 3 add, 3 div, 1 sqrt, +eps
DEEP_LEAVES, DENSE_LEAVES = 22, 10
# the three models' parameter trees at full width: (leaves, parameters)
ADAM_TREES = {"deep": (DEEP_LEAVES, 55_987_712),
              "dense": (DENSE_LEAVES, 5_772_800),
              "conv1d": (22, 1_563_393)}


# phases 3c / 3e, the bf16 tensor-core kernels.  Held within BF16_REL of
# the plain version and of the first version (the same products summed in
# another order: a flipped bf16 ulp), equal bits on a second launch.  Shapes
# (rows, k, n): ragged ones TMA takes (k and n multiples of 8: rows against
# the 128-row tile, k = 1096 against the 64-deep stage, k = 24 shorter than
# one, n = 544, 520 and 8 against the tile width) and ones it does not (k or
# n no multiple of 8), which must keep the first version.
TC_RAGGED = ((4097, 1088, 544), (1000, 1096, 520), (1, 24, 8))
NO_TMA = ((1000, 70, 33), (512, 1028, 520), (512, 1024, 516))
TC_SOURCE = "rawaudiovae_kelsey_tpu_torch/csrc/wgmma.cuh"
# phases 3c / 3e, the fp32 kernel (csrc/sgemm.cuh): held within GRAD_REL of
# the plain version (fp32 sums in another order), equal bits twice.  Ragged
# shapes it takes (k and n multiples of 4) and ones it does not (k or n no
# multiple of 4), which must keep the first version.
SGEMM_RAGGED = ((4097, 1088, 544), (1000, 1096, 520), (1, 24, 8),
                (7, 12, 20))
NO_SGEMM = ((1000, 70, 33), (512, 1026, 520), (512, 1024, 514))
SGEMM_SOURCE = "rawaudiovae_kelsey_tpu_torch/csrc/sgemm.cuh"
# phase 3e, the narrow-channel Toeplitz kernel: its source, and ragged
# shapes (B, nb, G, KB, N, t_out, shift) held in both dtypes and swept
# against the other forms: G or N below 8 (3, 4, 6; N = 40 over two column
# chunks, t_out above nb over three blocks of 128 positions), and three it
# does not take (G and N of 8 or more; the last at the rule's edge at full
# batch).
NARROW_SOURCE = "rawaudiovae_kelsey_tpu_torch/csrc/narrow.cuh"
# the tensor-core Toeplitz walk's ragged plans, (B, nb, G, KB, N, t_out,
# shift): t_out below 64 that does not divide it, above 64 and above 128,
# shift 0 and KB - 1, G no multiple of 64 and below it, B = 1, output rows
# past nb; held in bf16 and in four passes (phase 3e)
TC_TOEPLITZ_RAGGED = (
    (37, 48, 24, 3, 40, 48, 0), (5, 100, 72, 3, 136, 100, 2),
    (3, 200, 64, 5, 64, 200, 0), (9, 16, 128, 4, 256, 13, 3),
    (1, 64, 128, 3, 64, 64, 1), (6, 9, 16, 3, 24, 13, 2))
# row 17's 4-pass form: its library sequence and the parts of its device
# time, by the kernels' names
FOUR_PASS_LIBRARY = ("the sequence split_hi_lo of x and w -> four "
                     "torch.mm(bf16, bf16, out_dtype=float32) a tap over its "
                     "valid rows, added (hh + ll) + (hl + lh), the taps in "
                     "order -> the bias and the activation as the plain "
                     "version, device time summed (no one PyTorch call "
                     "computes toeplitz_fwd in four passes)")
FOUR_PASS_PARTS = {"split pass": "split_pass", "walk": "FourPassRows"}
NARROW_RAGGED = ((37, 9, 4, 3, 24, 13, 0), (1, 9, 24, 3, 4, 5, 2),
                 (37, 40, 3, 3, 8, 40, 2), (5, 300, 6, 5, 40, 301, 4),
                 (2, 20, 8, 3, 4, 17, 1), (3, 33, 12, 2, 6, 33, 1),
                 (37, 9, 24, 3, 40, 13, 2), (4, 130, 16, 3, 72, 129, 0),
                 (4096, 256, 8, 3, 8, 256, 1))


# roofline peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
SEG, UNITS, LATENT = 1024, 2048, 256
SAMPLER_SHAPE = (4096, 256)      # configs/perf_bf16.ini: batch x latent
# per element: ten Philox rounds of 2 mulhi + 2 mullo + 4 xor + 2 add, then
# ~30 for the bit packing, Box-Muller and the affine step; counted at the
# fp32 rate (the data sheet gives no integer rate)
SAMPLER_OPS = 130


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, kind: str) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of the operand type, whichever is
    larger."""
    by_bytes = moved / HBM_BYTES_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_both(kernel, plain, iters: int):
    """Mean ms of ``kernel()`` and ``plain()`` and each one's runs, timed
    plain, kernel, kernel, plain: drift in clocks hits both alike."""
    t_plain = [cuda_time_ms(plain, iters)]
    t_kern = [cuda_time_ms(kernel, iters), cuda_time_ms(kernel, iters)]
    t_plain.append(cuda_time_ms(plain, iters))
    return statistics.mean(t_kern), statistics.mean(t_plain), t_kern, t_plain


def time_in_turns(fns: dict, iters: int, rounds: int = 1):
    """Mean ms of each of ``fns`` and each one's runs, timed in the order
    given and then in reverse (``time_both``'s order for more than two),
    ``rounds`` times."""
    runs = {name: [] for name in fns}
    for name in (*fns, *reversed(fns)) * rounds:
        runs[name].append(cuda_time_ms(fns[name], iters))
    return {name: statistics.mean(t) for name, t in runs.items()}, runs


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def phase_kernels(gen_params):
    """Phase 3: each kernel against its plain version on the card."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp, quant

    dev = torch.device("cuda")
    p = gen_params(1234)
    qp = quant.quantize_decoder(p)
    enc_w = [p[n][k] for n in ("fc1", "fc21", "fc22") for k in ("w", "b")]
    dec_w = [p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")]
    g = torch.Generator(device=dev).manual_seed(99)
    cases = {
        "encoder_fwd": (
            lambda b: torch.rand((b, 1024), generator=g, device=dev) * 2 - 1,
            lambda x: mlp.encoder_fwd(*enc_w, x),
            lambda x: mlp.encoder_fwd_ref(*enc_w, x),
            "rawaudiovae_kelsey_tpu_torch/csrc/mlp.cu",
            "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py:246"),
        "decoder_fwd": (
            lambda b: torch.randn((b, 256), generator=g, device=dev),
            lambda z: mlp.decoder_fwd(*dec_w, z),
            lambda z: mlp.decoder_fwd_ref(*dec_w, z),
            "rawaudiovae_kelsey_tpu_torch/csrc/mlp.cu",
            "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py:294"),
        "quantized_decoder_fwd": (
            lambda b: torch.randn((b, 256), generator=g, device=dev),
            lambda z: (quant.quantized_decoder_fwd(qp, z),),
            lambda z: (quant.quantized_decode_ref(qp, z),),
            "rawaudiovae_kelsey_tpu_torch/csrc/quant.cu",
            "rawaudiovae_kelsey_tpu/ops/quant.py:74"),
    }
    # operations and operand bytes at the timed batch
    enc_flops = 2 * BATCH * (SEG * UNITS + 2 * UNITS * LATENT)
    dec_flops = 2 * BATCH * (LATENT * UNITS + UNITS * SEG)
    q_w = [t for layer in qp.values() for t in layer.values()]
    work = {"encoder_fwd": (enc_flops, enc_w),
            "decoder_fwd": (dec_flops, dec_w),
            "quantized_decoder_fwd": (dec_flops, q_w)}
    rows = {}
    for name, (make, kernel, plain, source, replaces) in cases.items():
        err = 0.0
        for b in (BATCH, RAGGED, 1):
            x = make(b)
            got = kernel(x)
            torch.cuda.synchronize()
            want = plain(x)
            torch.cuda.synchronize()
            for t, w in zip(got, want):
                check(t.shape == w.shape and bool(torch.isfinite(t).all()),
                      f"{name} batch {b}: shape {tuple(t.shape)} vs "
                      f"{tuple(w.shape)} or non-finite")
            e = max_err(got, want)
            print(f"  {name:<22} batch {b:>3}: max |kernel - plain| = {e:.3e}")
            check(e <= KERNEL_ATOL,
                  f"{name} batch {b}: error {e:.3e} > {KERNEL_ATOL}")
            err = max(err, e)
        x = make(BATCH)
        ms, plain_ms, t_kern, t_plain = time_both(
            lambda: kernel(x), lambda: plain(x), 50)
        print(f"  {name:<22} batch {BATCH}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (runs {t_kern} / {t_plain})")
        flops, weights = work[name]
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms,
                      **bound(flops, nbytes(x, *weights, *kernel(x)), "fp32"),
                      "library_ms": None}
    return rows


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, across the outputs of one call."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def phase_train_kernels(gen_params):
    """Phase 3b: the training kernels against their plain versions."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    dev = torch.device("cuda")
    p32 = gen_params(4321)
    g = torch.Generator(device=dev).manual_seed(77)
    bwd = "rawaudiovae_kelsey_tpu_torch/csrc/bwd.cu"
    fwd = "rawaudiovae_kelsey_tpu_torch/csrc/mlp.cu"
    tpu = "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py"

    def inputs(b, dt):
        def rnd(n, relu=False):
            t = torch.randn((b, n), generator=g, device=dev)
            return (t.clamp_min(0) if relu else t).to(dt)
        p = {n: {k: t.to(dt) for k, t in q.items()} for n, q in p32.items()}
        return p, dict(x=rnd(1024) * 0.3, h=rnd(2048, True), dmu=rnd(256),
                       dlv=rnd(256), da=rnd(1024) * 1e-3,
                       h3=rnd(2048, True), z=rnd(256))

    cases = {
        "grad_accum": (
            lambda p, t: mlp.grad_accum(t["h3"], t["da"]),
            lambda p, t: mlp.grad_accum_ref(t["h3"], t["da"]),
            bwd, f"{tpu}:453", ("fp32", "bf16"),
            2 * UNITS * SEG, lambda p, t: (t["h3"], t["da"])),
        "enc_bwd_dw1": (
            lambda p, t: mlp.enc_bwd_dw1(t["x"], t["h"], t["dmu"], t["dlv"],
                                         p["fc21"]["w"], p["fc22"]["w"]),
            lambda p, t: mlp.enc_bwd_dw1_ref(t["x"], t["h"], t["dmu"],
                                             t["dlv"], p["fc21"]["w"],
                                             p["fc22"]["w"]),
            bwd, f"{tpu}:542", ("fp32", "bf16"),
            2 * (2 * LATENT * UNITS + SEG * UNITS),
            lambda p, t: (t["x"], t["h"], t["dmu"], t["dlv"],
                          p["fc21"]["w"], p["fc22"]["w"])),
        "grad_accum2": (
            lambda p, t: mlp.grad_accum2(t["h"], t["dmu"], t["dlv"]),
            lambda p, t: mlp.grad_accum2_ref(t["h"], t["dmu"], t["dlv"]),
            bwd, f"{tpu}:624", ("fp32", "bf16"),
            2 * 2 * UNITS * LATENT,
            lambda p, t: (t["h"], t["dmu"], t["dlv"])),
        "dec_bwd_fused": (
            lambda p, t: mlp.dec_bwd_fused(t["da"], t["h3"], t["z"],
                                           p["fc4"]["w"], p["fc3"]["w"]),
            lambda p, t: mlp.dec_bwd_fused_ref(t["da"], t["h3"], t["z"],
                                               p["fc4"]["w"], p["fc3"]["w"]),
            bwd, f"{tpu}:695", ("fp32", "bf16"),
            2 * (SEG * UNITS + 2 * UNITS * LATENT),
            lambda p, t: (t["da"], t["h3"], t["z"], p["fc4"]["w"],
                          p["fc3"]["w"])),
        "encoder_fwd": (
            lambda p, t: mlp.encoder_fwd(
                *[p[n][k] for n in ("fc1", "fc21", "fc22")
                  for k in ("w", "b")], t["x"]),
            lambda p, t: mlp.encoder_fwd_ref(
                *[p[n][k] for n in ("fc1", "fc21", "fc22")
                  for k in ("w", "b")], t["x"]),
            fwd, f"{tpu}:246", ("bf16",),
            2 * (SEG * UNITS + 2 * UNITS * LATENT),
            lambda p, t: (t["x"], *[p[n][k] for n in ("fc1", "fc21", "fc22")
                                    for k in ("w", "b")])),
        "decoder_fwd": (
            lambda p, t: mlp.decoder_fwd(
                *[p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")],
                t["z"]),
            lambda p, t: mlp.decoder_fwd_ref(
                *[p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")],
                t["z"]),
            fwd, f"{tpu}:294", ("bf16",),
            2 * (LATENT * UNITS + UNITS * SEG),
            lambda p, t: (t["z"], *[p[n][k] for n in ("fc3", "fc4")
                                    for k in ("w", "b")])),
    }
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = {}
    for name, (kernel, plain, source, replaces, kinds, row_flops,
               operands) in cases.items():
        for kind in kinds:
            dt = dtypes[kind]
            tol = BF16_REL if dt == torch.bfloat16 else GRAD_REL
            err = 0.0
            for b in (TRAIN_BATCH, TRAIN_RAGGED, 1):
                p, t = inputs(b, dt)
                got = kernel(p, t)
                torch.cuda.synchronize()
                want = plain(p, t)
                torch.cuda.synchronize()
                for a, w in zip(got, want):
                    check(a.shape == w.shape and a.dtype == w.dtype
                          and bool(torch.isfinite(a).all()),
                          f"{name}[{kind}] batch {b}: shape/dtype "
                          f"{tuple(a.shape)} {a.dtype} vs {tuple(w.shape)} "
                          f"{w.dtype}, or non-finite")
                e = rel_err(got, want)
                err = max(err, max_err(got, want))
                print(f"  {name + '[' + kind + ']':<22} batch {b:>4}: max "
                      f"|kernel - plain| / max|plain| = {e:.3e} (tolerance "
                      f"{tol:.3e})")
                check(e <= tol, f"{name}[{kind}] batch {b}: relative error "
                      f"{e:.3e} > {tol:.3e}")
            p, t = inputs(TRAIN_BATCH, dt)
            ms, plain_ms, t_kern, t_plain = time_both(
                lambda: kernel(p, t), lambda: plain(p, t), 20)
            print(f"  {name + '[' + kind + ']':<22} batch {TRAIN_BATCH}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs "
                  f"{t_kern} / {t_plain})")
            rows[f"{name}[{kind}]"] = {
                "name": f"{name}[{kind}]", "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                **bound(TRAIN_BATCH * row_flops,
                        nbytes(*operands(p, t), *kernel(p, t)), kind),
                "library_ms": None}
    encoder_tensor_cores(rows["encoder_fwd[bf16]"], inputs)
    decoder_tensor_cores(rows["decoder_fwd[bf16]"], inputs)
    dec_bwd_tensor_cores(rows["dec_bwd_fused[bf16]"], inputs)
    grad_accum_tensor_cores(rows["grad_accum[bf16]"], inputs)
    enc_bwd_tensor_cores(rows["enc_bwd_dw1[bf16]"], inputs)
    grad_accum2_tensor_cores(rows["grad_accum2[bf16]"], inputs)
    backward_sgemm(rows, inputs)
    return rows


# phase 3b, rows 8-10 in fp32 on csrc/sgemm.cuh: each is the fp32 launches
# of rows 6 / 5, 4 and 7 one after another; no one PyTorch call computes
# any of them, so library_ms is the device time of a sequence of fp32 calls
# (TF32 off) on the same operands, summed
BWD_SGEMM_LIBRARY = {
    "enc_bwd_dw1": "the sequence addmm(dmu @ w21.t(), dlv, w22.t()) -> "
                   "where(h > 0, ., 0) -> x.t() @ dh -> dh.sum(0) in fp32, "
                   "TF32 off, device time summed",
    "grad_accum2": "the sequence h.t() @ dmu -> dmu.sum(0) -> h.t() @ dlv "
                   "-> dlv.sum(0) in fp32, TF32 off, device time summed",
    "dec_bwd_fused": "the sequence da @ w4.t() -> where(h3 > 0, ., 0) -> "
                     "@ w3.t() -> z.t() @ dh3 -> dh3.sum(0) in fp32, TF32 "
                     "off, device time summed",
}
# each form's launches by kernel name: the gated product, the plain and
# weight-gradient products, the slices' sum
BWD_SGEMM_PARTS = {
    "enc_bwd_dw1": {"dh gated joined": "sgemm_gated_kernel",
                    "dW1 db1": "sgemm_kernel", "sum slices": "sum_slices"},
    "grad_accum2": {"dW21 db21 dW22 db22": "sgemm_kernel",
                    "sum slices": "sum_slices"},
    "dec_bwd_fused": {"dh3 gated": "sgemm_gated_kernel",
                      "dz and dW3 db3": "sgemm_kernel",
                      "sum slices": "sum_slices"},
}


def backward_sgemm(rows, inputs):
    """Phase 3b: fp32 ``enc_bwd_dw1``, ``grad_accum2`` and
    ``dec_bwd_fused`` (rows 8-10) on csrc/sgemm.cuh (csrc/bwd.cu
    sgemm_enc_bwd_dw1, sgemm_grad_accum2, sgemm_dec_bwd: the fp32 launches
    of ``matmul_nt2_mask`` / ``matmul_nt_mask``, ``matmul_nt`` and
    ``grad_accum`` one after another) at the microbatch, the ragged 1000
    and batch 1: against the plain version and the first version, equal
    bits twice and equal bits with the same launches called one by one at
    their plans; a latent of 38 on the first version; timed at the
    microbatch in turns with the first version, the plain version and the
    fp32 library sequence, and by device time with each launch apart.  No
    path runs them on fp32 operands: their rows stay out of the kernel
    line (``off_path``)."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    operands = {
        "enc_bwd_dw1": lambda p, t: [t["x"], t["h"], t["dmu"], t["dlv"],
                                     p["fc21"]["w"], p["fc22"]["w"]],
        "grad_accum2": lambda p, t: [t["h"], t["dmu"], t["dlv"]],
        "dec_bwd_fused": lambda p, t: [t["da"], t["h3"], t["z"],
                                       p["fc4"]["w"], p["fc3"]["w"]]}

    def one_by_one(name, ops):
        if name == "enc_bwd_dw1":
            x, h, dmu, dlv, w21, w22 = ops
            dh = mlp.matmul_nt2_mask(dmu, w21, dlv, w22, h, kernel="sgemm")
            return mlp.grad_accum(x, dh, kernel="sgemm")
        if name == "grad_accum2":
            h, dmu, dlv = ops
            return (*mlp.grad_accum(h, dmu, kernel="sgemm"),
                    *mlp.grad_accum(h, dlv, kernel="sgemm"))
        da, h3, z, w4, w3 = ops
        dh3 = mlp.matmul_nt_mask(da, w4, h3, kernel="sgemm")
        return (mlp.matmul_nt(dh3, w3, kernel="sgemm"),
                *mlp.grad_accum(z, dh3, kernel="sgemm"))

    def library(name, ops):
        if name == "enc_bwd_dw1":
            x, h, dmu, dlv, w21, w22 = ops
            dh = torch.where(h > 0, torch.addmm(dmu @ w21.t(), dlv,
                                                w22.t()), 0)
            return x.t() @ dh, dh.sum(0)
        if name == "grad_accum2":
            h, dmu, dlv = ops
            return h.t() @ dmu, dmu.sum(0), h.t() @ dlv, dlv.sum(0)
        da, h3, z, w4, w3 = ops
        dh3 = torch.where(h3 > 0, da @ w4.t(), 0)
        return dh3 @ w3.t(), z.t() @ dh3, dh3.sum(0)

    g = torch.Generator(device="cuda").manual_seed(71)

    def odd(name, batch, latent=38):
        # a latent no multiple of 4: widths the fp32 form refuses
        def rnd(*shape, scale=1.0, relu=False):
            t = torch.randn(shape, generator=g, device="cuda") * scale
            return t.clamp_min(0) if relu else t
        if name == "enc_bwd_dw1":
            return [rnd(batch, SEG, scale=0.3), rnd(batch, UNITS, relu=True),
                    rnd(batch, latent), rnd(batch, latent),
                    rnd(UNITS, latent, scale=UNITS ** -0.5),
                    rnd(UNITS, latent, scale=UNITS ** -0.5)]
        if name == "grad_accum2":
            return [rnd(batch, UNITS, relu=True), rnd(batch, latent),
                    rnd(batch, latent)]
        return [rnd(batch, SEG, scale=1e-3), rnd(batch, UNITS, relu=True),
                rnd(batch, latent), rnd(UNITS, SEG, scale=SEG ** -0.5),
                rnd(latent, UNITS, scale=UNITS ** -0.5)]

    for name in ("enc_bwd_dw1", "grad_accum2", "dec_bwd_fused"):
        op, plain = getattr(mlp, name), getattr(mlp, f"{name}_ref")
        row = rows[f"{name}[fp32]"]
        cases = [(f"batch {b}", operands[name](*inputs(b, torch.float32)))
                 for b in (TRAIN_BATCH, TRAIN_RAGGED, 1)]
        err = hold_tensor_cores(name, op, plain, cases,
                                [("batch 1000, latent 38", odd(name, 1000))],
                                kernel="sgemm")
        for what, ops in cases:
            check(all(torch.equal(a, b) for a, b in
                      zip(op(*ops), one_by_one(name, ops))),
                  f"{name}[fp32] {what}: other bits than its launches one "
                  "by one")
        print(f"  {name + '[fp32]':<24} equal bits with its sgemm.cuh "
              f"launches called one by one at batch {TRAIN_BATCH}, "
              f"{TRAIN_RAGGED} and 1")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        ops = operands[name](*inputs(TRAIN_BATCH, torch.float32))
        fns = {"library": lambda: library(name, ops),
               "plain": lambda: plain(*ops),
               "cuda_cores": lambda: op(*ops, kernel="cuda_cores"),
               "sgemm": lambda: op(*ops, kernel="sgemm")}
        fast = fns["sgemm"]
        dev = time_tensor_cores(
            name, row, fns,
            {label: (lambda m=m: device_ms(fast, match=m))
             for label, m in BWD_SGEMM_PARTS[name].items()},
            BWD_SGEMM_LIBRARY[name], kernel="sgemm")
        print(f"  {name + '[fp32]':<24} batch {TRAIN_BATCH}: device time "
              f"{dev['sgemm']:.4f} ms, {dev['sgemm'] / dev['library']:.3f}x "
              f"the fp32 library sequence's, "
              f"{dev['cuda_cores'] / dev['sgemm']:.2f}x faster than the "
              f"first version, {dev['sgemm'] / row['bound_ms']:.2f}x its "
              f"bound")


# phase 3b, the bf16 dense kernels on the tensor cores: no one PyTorch call
# computes any of them, so a row's library_ms is the device time of a
# sequence of calls on the same operands, summed (its `library` key says
# which); so do phase 3c's gated input gradients (rows 5 and 6) in both
# dtypes
ENCODER_LIBRARY = ("the sequence addmm -> relu -> addmm -> addmm, device "
                   "time summed (no one PyTorch call computes encoder_fwd)")
DECODER_LIBRARY = ("the sequence addmm -> relu -> addmm -> tanh, device "
                   "time summed (no one PyTorch call computes decoder_fwd)")
DEC_BWD_LIBRARY = ("the sequence da @ w4.t() -> where(h3 > 0, ., 0) -> "
                   "@ w3.t() -> z.t() @ dh3 -> dh3.float().sum(0), device "
                   "time summed (no one PyTorch call computes dec_bwd_fused)")
BWD_LIBRARY = {
    "grad_accum": "the sequence a.t() @ b -> b.float().sum(0), device time "
                  "summed (no one PyTorch call computes grad_accum)",
    "enc_bwd_dw1": "the sequence addmm(dmu @ w21.t(), dlv, w22.t()) -> "
                   "where(h > 0, ., 0) -> x.t() @ dh -> dh.float().sum(0), "
                   "device time summed (no one PyTorch call computes "
                   "enc_bwd_dw1)",
    "grad_accum2": "the sequence h.t() @ dmu -> dmu.float().sum(0) -> "
                   "h.t() @ dlv -> dlv.float().sum(0), device time summed "
                   "(no one PyTorch call computes grad_accum2)",
    "matmul_nt_mask": "the sequence (a @ w.t()) * (gate > 0), device time "
                      "summed (no one PyTorch call computes matmul_nt_mask)",
    "matmul_nt2_mask": "the sequence where(gate > 0, addmm(a1 @ w1.t(), a2, "
                       "w2.t()), 0), device time summed (no one PyTorch "
                       "call computes matmul_nt2_mask)",
}
# the shapes held on the tensor cores besides the microbatch, the ragged
# 1000 and batch 1: a ragged width TMA takes, as (latent, units, seg)
TC_RAGGED_DENSE = (72, 520, 264)


def hold_tensor_cores(name, op, plain, cases, odd=(),
                      kernel="tensor_cores"):
    """Phases 3b / 3c: ``op`` (bf16 ``encoder_fwd``, ``decoder_fwd``,
    ``dec_bwd_fused``, ``grad_accum``, ``enc_bwd_dw1``, ``grad_accum2`` on
    the tensor cores; fp32 ``grad_accum`` on ``kernel="sgemm"``) against
    its plain version and its first version (``kernel="cuda_cores"``),
    every output within the kernel's tolerance (FAST: BF16_REL, GRAD_REL),
    equal bits on a second launch, one launch counted on the kernel;
    ``cases`` are ``(what, operands)``.  The ``odd`` cases (a width the
    kernel cannot take) must keep the first version under ``auto`` and
    raise for ``kernel``.  Returns the largest absolute error against the
    plain version."""
    fast = FAST[kernel]
    label, tol, counter = f"{name}[{fast['kind']}]", fast["tol"], \
        fast["counter"]
    err = 0.0
    for what, ops in cases:
        before = (op.launches, getattr(op, counter))
        got = op(*ops)
        torch.cuda.synchronize()
        rose = (op.launches - before[0], getattr(op, counter) - before[1])
        check(rose == (1, 1), f"{label} {what}: launches / {kernel} "
              f"launches rose by {rose}")
        want = plain(*ops)
        first = op(*ops, kernel="cuda_cores")
        for a, w in zip(got, want):
            check(a.shape == w.shape and a.dtype == w.dtype
                  and bool(torch.isfinite(a).all()),
                  f"{label} {what}: shape, dtype or non-finite")
        e, e1 = rel_err(got, want), rel_err(got, first)
        check(max(e, e1) <= tol, f"{label} {what}: relative error "
              f"{e:.3e} (vs the first version {e1:.3e}) > {tol:.3e}")
        check(all(torch.equal(a, b) for a, b in zip(got, op(*ops))),
              f"{label} {what}: a second launch gave other bits")
        err = max(err, max_err([a.float() for a in got],
                               [w.float() for w in want]))
        print(f"  {label:<24} {what}: ran {kernel}; |kernel - plain| / "
              f"max|plain| = {e:.3e}, vs the first version {e1:.3e}, equal "
              f"bits twice (tolerance {tol:.3e})")
    for what, ops in odd:
        before = (op.launches, getattr(op, counter))
        got = op(*ops)
        torch.cuda.synchronize()
        rose = (op.launches - before[0], getattr(op, counter) - before[1])
        check(rose == (1, 0), f"{label} {what}: launches / {kernel} "
              f"launches rose by {rose}, expected the first version")
        e = rel_err(got, plain(*ops))
        check(e <= tol, f"{label} {what}: relative error {e:.3e}")
        try:
            op(*ops, kernel=kernel)
        except ValueError:
            pass
        else:
            check(False, f"{label} {what}: kernel={kernel!r} did not raise")
        print(f"  {label:<24} {what}: ran cuda_cores (the first version); "
              f"|kernel - plain| / max|plain| = {e:.3e}; kernel={kernel!r} "
              f"raised")
    return err


def time_tensor_cores(name, row, fns, parts, library_text,
                      kernel="tensor_cores", batch=TRAIN_BATCH):
    """Phases 3-3c: ``fns`` (library, plain, cuda_cores, and ``kernel``:
    tensor_cores or sgemm) timed in turns at ``batch`` rows (the
    microbatch unless named) and by the profiler's device time, with the
    device time of each of ``parts`` ({label: fn() -> ms}); ``row`` (the
    kernel line's) takes ``kernel`` 's numbers.  Returns the device
    times."""
    fast = FAST[kernel]
    ms, runs = time_in_turns(fns, 20)
    dev = {key: device_ms(fn) for key, fn in fns.items()}
    split = {label: part() for label, part in parts.items()}
    print(f"  {name + '[' + fast['kind'] + ']':<24} batch {batch}: "
          f"{kernel} {ms[kernel]:.4f} ms (device {dev[kernel]:.4f} "
          f"ms: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"), cuda_cores (first version) {ms['cuda_cores']:.4f} ms "
          f"(device {dev['cuda_cores']:.4f}), plain {ms['plain']:.4f} ms "
          f"(device {dev['plain']:.4f}), library sequence "
          f"{ms['library']:.4f} ms (device {dev['library']:.4f}), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); device time / the "
          f"sequence's {dev[kernel] / dev['library']:.3f}, / bound "
          f"{dev[kernel] / row['bound_ms']:.3f}; runs {runs}")
    row.update(source=fast["source"], ms=ms[kernel], plain_ms=ms["plain"],
               library_ms=dev["library"], library=library_text,
               library_event_ms=ms["library"],
               first_version_ms=ms["cuda_cores"],
               device_ms=dev[kernel],
               first_version_device_ms=dev["cuda_cores"],
               **{f"{k.replace(' ', '_')}_device_ms": v
                  for k, v in split.items()})
    # any other callable timed beside them (the int8 decoder's fp32
    # decoder on the dequantized weights)
    for key in fns:
        if key not in ("library", "plain", "cuda_cores", kernel):
            row[f"{key.replace(' ', '_')}_ms"] = ms[key]
            row[f"{key.replace(' ', '_')}_device_ms"] = dev[key]
    return dev


def encoder_tensor_cores(row, inputs):
    """Phase 3b: bf16 ``encoder_fwd`` on the tensor cores (csrc/wgmma.cuh: h,
    then both heads in one launch) at the training microbatch, the ragged
    1000, batch 1, a latent no multiple of a tile width and a narrow model;
    timed with the hidden and the heads' launch apart."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    def operands(p, t):
        return [p[n][k] for n in ("fc1", "fc21", "fc22")
                for k in ("w", "b")] + [t["x"]]

    # a generator of its own: the draws of the later phases stay as they were
    g = torch.Generator(device="cuda").manual_seed(41)

    def narrow(batch, seg, units, latent):
        shapes = (((seg, units), seg ** -0.5), ((units,), 0.1),
                  ((units, latent), units ** -0.5), ((latent,), 0.1),
                  ((units, latent), units ** -0.5), ((latent,), 0.1),
                  ((batch, seg), 0.3))
        return [(torch.randn(sh, generator=g, device="cuda") * sc).bfloat16()
                for sh, sc in shapes]

    cases = [(f"batch {b}", operands(*inputs(b, torch.bfloat16)))
             for b in (TRAIN_BATCH, TRAIN_RAGGED, 1)]
    cases += [("batch 1000, latent 72", narrow(1000, SEG, UNITS, 72)),
              ("4097x256->512->200", narrow(4097, 256, 512, 200))]
    err = hold_tensor_cores("encoder_fwd", mlp.encoder_fwd,
                            mlp.encoder_fwd_ref, cases)
    ops = operands(*inputs(TRAIN_BATCH, torch.bfloat16))
    w1, b1, w21, b21, w22, b22, x = ops

    def library():
        h = torch.relu(torch.addmm(b1, x, w1))
        return torch.addmm(b21, h, w21), torch.addmm(b22, h, w22), h

    fns = {"library": library, "plain": lambda: mlp.encoder_fwd_ref(*ops),
           "cuda_cores": lambda: mlp.encoder_fwd(*ops, kernel="cuda_cores"),
           "tensor_cores": lambda: mlp.encoder_fwd(*ops,
                                                   kernel="tensor_cores")}
    tc = fns["tensor_cores"]
    time_tensor_cores("encoder_fwd", row, fns, {
        "hidden": lambda: device_ms(tc, match="BiasActPair"),
        "heads": lambda: device_ms(tc, match="HeadsBias")}, ENCODER_LIBRARY)
    row["max_abs_err"] = max(row["max_abs_err"], err)


def decoder_tensor_cores(row, inputs):
    """Phase 3b: bf16 ``decoder_fwd`` on the tensor cores (csrc/wgmma.cuh: h3,
    then y, each the linear layer's launch) at the training microbatch, the
    ragged 1000, batch 1 and a ragged width, a latent of 36 on the first
    version; timed with each launch apart (the same launch as
    ``linear_fwd``'s on the same operands)."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear, mlp

    def operands(p, t):
        return [p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")] \
            + [t["z"]]

    g = torch.Generator(device="cuda").manual_seed(43)

    def narrow(batch, latent, units, seg):
        shapes = (((latent, units), latent ** -0.5), ((units,), 0.1),
                  ((units, seg), units ** -0.5), ((seg,), 0.1),
                  ((batch, latent), 1.0))
        return [(torch.randn(sh, generator=g, device="cuda") * sc).bfloat16()
                for sh, sc in shapes]

    cases = [(f"batch {b}", operands(*inputs(b, torch.bfloat16)))
             for b in (TRAIN_BATCH, TRAIN_RAGGED, 1)]
    cases.append(("batch 1000, {}->{}->{}".format(*TC_RAGGED_DENSE),
                  narrow(1000, *TC_RAGGED_DENSE)))
    err = hold_tensor_cores("decoder_fwd", mlp.decoder_fwd,
                            mlp.decoder_fwd_ref, cases,
                            [("batch 1000, latent 36",
                              narrow(1000, 36, UNITS, SEG))])
    ops = operands(*inputs(TRAIN_BATCH, torch.bfloat16))
    w3, b3, w4, b4, z = ops

    def library():
        h3 = torch.relu(torch.addmm(b3, z, w3))
        return torch.tanh(torch.addmm(b4, h3, w4)), h3

    fns = {"library": library, "plain": lambda: mlp.decoder_fwd_ref(*ops),
           "cuda_cores": lambda: mlp.decoder_fwd(*ops, kernel="cuda_cores"),
           "tensor_cores": lambda: mlp.decoder_fwd(*ops,
                                                   kernel="tensor_cores")}
    _, h3 = fns["tensor_cores"]()
    time_tensor_cores("decoder_fwd", row, fns, {
        "h3": lambda: device_ms(lambda: linear.linear_fwd(
            z, w3, b3, "relu", kernel="tensor_cores")),
        "y": lambda: device_ms(lambda: linear.linear_fwd(
            h3, w4, b4, "tanh", kernel="tensor_cores"))}, DECODER_LIBRARY)
    row["max_abs_err"] = max(row["max_abs_err"], err)


# the weight gradient's plans swept at the microbatch (tile width, slices):
# the rule's picks at dW3 (128 x 4) and at dW4 and dW1 (128 x 1) among them
WGRAD_PLANS = ((256, 8), (256, 4), (256, 2), (128, 8), (128, 4), (128, 2),
               (128, 1), (64, 4), (64, 2), (256, 1), (64, 1))
# the fp32 weight gradient's plans (index of SGEMM_TILES, slices), swept at
# dW4 (the rule's 128 x 128 x 1) and dW21 (128 x 128 x 4)
SGEMM_WGRAD_PLANS = ((0, 1), (0, 2), (0, 4), (0, 8), (1, 1), (1, 2), (1, 4),
                     (2, 1), (2, 2))

# phase 3b: the simple form of dh3's gate, built only to be timed beside the
# kept one (which has TMA load h3's boxes into the staging buffer under the
# products, csrc/wgmma.cuh): h3's pair read by a 4-byte global load in the
# epilogue's pair(), spliced into a copy of csrc/bwd.cu
SIMPLE_GATE = r'''struct GateLoad {
  struct Column {};
  static constexpr int kModes = 1;
  const rvk::bf16* gate;
  int N;
  __device__ __forceinline__ Column column(int) const { return Column{}; }
  template <int>
  __device__ __forceinline__ __nv_bfloat162 pair(Column, int m, int n,
                                                 float v0, float v1) const {
    const __nv_bfloat162 g =
        *reinterpret_cast<const __nv_bfloat162*>(gate + size_t(m) * N + n);
    return __floats2bfloat162_rn(__low2float(g) > 0.f ? v0 : 0.f,
                                 __high2float(g) > 0.f ? v1 : 0.f);
  }
};

'''
KEPT_GATE = ("GatePair{}, batch, units, seg,\n      tile_dh3, s, "
             "src<T>(h3));")
SIMPLE_GATE_LAUNCH = "GateLoad{src<T>(h3), units}, batch, units, seg, " \
                     "tile_dh3, s);"


def simple_gate_ms(ops) -> float:
    """Device ms of dh3's launch with the simple gate (SIMPLE_GATE, built
    from a copy of csrc/bwd.cu, csrc/full.cu, whose 3-pass chains bwd.cu's
    entry points call, and their headers into a temporary directory), after
    a check that the whole call gives the kept kernel's bits."""
    import ctypes
    import shutil

    from rawaudiovae_kelsey_tpu_torch.ops import _build, mlp, tensor_cores

    da, h3, z, w4, w3 = ops
    (batch, seg), units, latent = da.shape, h3.shape[1], z.shape[1]
    dev = da.device
    with tempfile.TemporaryDirectory() as tmp:
        csrc = Path(tmp) / "csrc"
        csrc.mkdir()
        for path in [_build.CSRC / "bwd.cu", _build.CSRC / "full.cu",
                     *_build.CSRC.glob("*.cuh")]:
            shutil.copy(path, csrc / path.name)
        text = (csrc / "bwd.cu").read_text()
        check(text.count(KEPT_GATE) == 1
              and text.count("struct GatePair {") == 1,
              "csrc/bwd.cu no longer has the gated launch the simple gate "
              "replaces")
        text = text.replace("struct GatePair {",
                            SIMPLE_GATE + "struct GatePair {")
        (csrc / "bwd.cu").write_text(text.replace(KEPT_GATE,
                                                  SIMPLE_GATE_LAUNCH))
        saved = _build.CSRC, _build.BUILD_DIR
        _build.CSRC, _build.BUILD_DIR = csrc, Path(tmp) / "lib"
        try:
            path = _build.build()
        finally:
            _build.CSRC, _build.BUILD_DIR = saved
        fn = ctypes.CDLL(str(path)).rvk_dec_bwd_fused
    fn.argtypes = _build._SIGNATURES["rvk_dec_bwd_fused"]
    fn.restype = ctypes.c_int
    code = tensor_cores.TENSOR_CORES
    tile_dw, split = tensor_cores.wgrad(code, dev, latent, units, batch)
    out = [torch.empty(s, device=dev, dtype=t) for s, t in (
        ((batch, units), torch.bfloat16), ((batch, latent), torch.bfloat16),
        ((latent, units), torch.float32), ((units,), torch.float32))]
    work = torch.empty((split, latent * units + units), device=dev)
    args = [t.data_ptr() for t in (*ops, *out, work)] + [
        batch, seg, units, latent, 1, tensor_cores.tile(code, dev, batch,
                                                        units),
        tensor_cores.tile(code, dev, batch, latent), tile_dw, split, code]

    def call():
        rc = fn(*args, _build._raw_stream(dev.index or 0))
        check(rc == 0, f"the simple gate's launch failed: CUDA error {rc}")

    call()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in
              zip(out[1:], mlp.dec_bwd_fused(*ops))),
          "the simple gate gave other bits than the kept one")
    return device_ms(call, match="GateLoad")


def dec_bwd_tensor_cores(row, inputs):
    """Phase 3b: bf16 ``dec_bwd_fused`` on the tensor cores (csrc/bwd.cu
    tensor_core_dec_bwd: dh3 with the gate in the epilogue, dz, then dW3 and
    db3 over slices of the batch) as ``decoder_tensor_cores``; timed with
    each launch apart, beside the same dh3 product without the gate
    (``matmul_nt``), and with the weight gradient's plan swept."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    def operands(p, t):
        return [t["da"], t["h3"], t["z"], p["fc4"]["w"], p["fc3"]["w"]]

    g = torch.Generator(device="cuda").manual_seed(47)

    def narrow(batch, latent, units, seg):
        shapes = (((batch, seg), 1e-3, False), ((batch, units), 1.0, True),
                  ((batch, latent), 1.0, False),
                  ((units, seg), seg ** -0.5, False),
                  ((latent, units), units ** -0.5, False))
        out = []
        for sh, sc, relu in shapes:
            t = torch.randn(sh, generator=g, device="cuda") * sc
            out.append((t.clamp_min(0) if relu else t).bfloat16())
        return out

    cases = [(f"batch {b}", operands(*inputs(b, torch.bfloat16)))
             for b in (TRAIN_BATCH, TRAIN_RAGGED, 1)]
    cases.append(("batch 1000, {}->{}->{}".format(*TC_RAGGED_DENSE),
                  narrow(1000, *TC_RAGGED_DENSE)))
    err = hold_tensor_cores("dec_bwd_fused", mlp.dec_bwd_fused,
                            mlp.dec_bwd_fused_ref, cases,
                            [("batch 1000, latent 36",
                              narrow(1000, 36, UNITS, SEG))])
    ops = operands(*inputs(TRAIN_BATCH, torch.bfloat16))
    da, h3, z, w4, w3 = ops

    def library():
        dh3 = torch.where(h3 > 0, da @ w4.t(), 0)
        return dh3 @ w3.t(), z.t() @ dh3, dh3.float().sum(0)

    fns = {"library": library, "plain": lambda: mlp.dec_bwd_fused_ref(*ops),
           "cuda_cores": lambda: mlp.dec_bwd_fused(*ops, kernel="cuda_cores"),
           "tensor_cores": lambda: mlp.dec_bwd_fused(*ops,
                                                     kernel="tensor_cores")}
    tc = fns["tensor_cores"]
    time_tensor_cores("dec_bwd_fused", row, fns, {
        "dh3 gated": lambda: device_ms(tc, match="GatePair"),
        "dh3 ungated": lambda: device_ms(
            lambda: mlp.matmul_nt(da, w4, kernel="tensor_cores")),
        "dz": lambda: device_ms(tc, match="RoundPair"),
        "dW3 db3": lambda: device_ms(tc, match="WgradOut"),
        "sum slices": lambda: device_ms(tc, match="sum_slices")},
        DEC_BWD_LIBRARY)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["dh3_simple_gate_device_ms"] = simple = simple_gate_ms(ops)
    print(f"  {'dec_bwd_fused[bf16]':<24} batch {TRAIN_BATCH}: dh3 with the "
          f"simple gate (a 4-byte global load a pair in the epilogue) "
          f"{simple:.4f} ms of device time against "
          f"{row['dh3_gated_device_ms']:.4f} with the gate's boxes loaded by "
          f"TMA (kept), {row['dh3_ungated_device_ms']:.4f} with no gate; "
          f"equal bits")
    sweep_wgrad(row, "dW3 + db3", tc, lambda: mlp.dec_bwd_fused_ref(*ops),
                LATENT, UNITS)


def sweep_wgrad(row, label, call, plain, m, n, outputs=1, kernel=
                "tensor_cores"):
    """Phases 3b / 3c: the device ms of the weight gradient ``(m, n)`` in
    ``call()`` (the launches of WgradOut, or of sgemm.cuh's kernel, and
    sum_slices where the plan has more than one slice) at the microbatch
    with each plan of WGRAD_PLANS (``outputs`` outputs side by side) or
    SGEMM_WGRAD_PLANS forced, every output within the kernel's tolerance
    of ``plain()``, beside the rule's pick (tensor_cores.wgrad_plan /
    sgemm_wgrad_plan) and how far it is behind the fastest; into
    ``row["wgrad_plan_device_ms"]`` (or ``row[f"{label}_plan_device_ms"]``
    for a second shape)."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    sms = tensor_cores.sm_count(torch.device("cuda", 0))
    if kernel == "sgemm":
        name, plans, match = "sgemm_wgrad_plan", SGEMM_WGRAD_PLANS, \
            "sgemm_kernel"
        picked = tensor_cores.sgemm_wgrad_plan(m, n, TRAIN_BATCH, sms)
    else:
        name, plans, match = "wgrad_plan", WGRAD_PLANS, "WgradOut"
        picked = tensor_cores.wgrad_plan(m, n, TRAIN_BATCH, sms, outputs)
    rule, tol = getattr(tensor_cores, name), FAST[kernel]["tol"]
    swept = {}
    try:
        for plan in plans:
            setattr(tensor_cores, name,
                    lambda *args, plan=plan, **kw: plan)
            e = rel_err(call(), plain())
            check(e <= tol, f"{row['name']} plan {plan}: relative error "
                  f"{e:.3e}")
            swept[plan] = (device_ms(call, match=match)
                           + (device_ms(call, match="sum_slices")
                              if plan[1] > 1 else 0.0))
    finally:
        setattr(tensor_cores, name, rule)
    best = min(swept, key=swept.get)
    behind = swept[picked] / swept[best] - 1 if picked in swept \
        else float("nan")
    print(f"  {row['name']:<24} batch {TRAIN_BATCH}: {label} device ms by "
          f"plan ({'tile index' if kernel == 'sgemm' else 'tile width'}, "
          f"slices), the slices' sum included: "
          + ", ".join(f"{w}x{s}: {v:.4f}" for (w, s), v in swept.items())
          + f"; the rule (tensor_cores.{name}) picks "
            f"{picked[0]}x{picked[1]}, the fastest is {best[0]}x{best[1]}; "
            f"the pick is {100 * behind:.1f} % behind it")
    key = "wgrad_plan_device_ms" if "wgrad_plan_device_ms" not in row \
        else f"{label.split()[0]}_plan_device_ms"
    row[key] = {f"{w}x{s}": v for (w, s), v in swept.items()}


def slices_ms(call, m, n, outputs=1) -> float:
    """Device ms of the slices' sum in ``call()``: 0.0 where the plan of
    the weight gradient ``(m, n)`` (``outputs`` side by side) at the
    microbatch has one slice (no sum runs)."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    _, split = tensor_cores.wgrad_plan(
        m, n, TRAIN_BATCH, tensor_cores.sm_count(torch.device("cuda", 0)),
        outputs)
    return device_ms(call, match="sum_slices") if split > 1 else 0.0


def grad_accum_tensor_cores(row, inputs):
    """Phase 3b: bf16 ``grad_accum`` on the tensor cores (csrc/wgmma.cuh
    launch_wgrad: dW4 = h3ᵀ da and db4 over slices of the batch) as
    ``dec_bwd_tensor_cores``; timed with the weight gradient and the
    slices' sum apart, and with its plan swept."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    g = torch.Generator(device="cuda").manual_seed(53)

    def narrow(batch, units, seg):
        h3 = torch.randn((batch, units), generator=g, device="cuda")
        da = torch.randn((batch, seg), generator=g, device="cuda") * 1e-3
        return [h3.clamp_min(0).bfloat16(), da.bfloat16()]

    cases = [(f"batch {b}", [t[k] for k in ("h3", "da")])
             for b in (TRAIN_BATCH, TRAIN_RAGGED, 1)
             for t in (inputs(b, torch.bfloat16)[1],)]
    cases.append(("batch 1000, units {1}, seg {2}".format(*TC_RAGGED_DENSE),
                  narrow(1000, *TC_RAGGED_DENSE[1:])))
    err = hold_tensor_cores("grad_accum", mlp.grad_accum, mlp.grad_accum_ref,
                            cases, [("batch 1000, m 1020",
                                     narrow(1000, UNITS, 1020))])
    h3, da = (inputs(TRAIN_BATCH, torch.bfloat16)[1][k] for k in ("h3", "da"))
    fns = {"library": lambda: (h3.t() @ da, da.float().sum(0)),
           "plain": lambda: mlp.grad_accum_ref(h3, da),
           "cuda_cores": lambda: mlp.grad_accum(h3, da, kernel="cuda_cores"),
           "tensor_cores": lambda: mlp.grad_accum(h3, da,
                                                  kernel="tensor_cores")}
    tc = fns["tensor_cores"]
    time_tensor_cores("grad_accum", row, fns, {
        "dW4 db4": lambda: device_ms(tc, match="WgradOut"),
        "sum slices": lambda: slices_ms(tc, UNITS, SEG)},
        BWD_LIBRARY["grad_accum"])
    row["max_abs_err"] = max(row["max_abs_err"], err)
    sweep_wgrad(row, "dW4 + db4", tc, fns["plain"], UNITS, SEG)


def enc_bwd_tensor_cores(row, inputs):
    """Phase 3b: bf16 ``enc_bwd_dw1`` on the tensor cores (csrc/bwd.cu
    tensor_core_enc_bwd_dw1: dh as one product joined along k, dmu and w21
    then dlv and w22, with the gate in its epilogue; then dW1 and db1 over
    slices of the batch) as ``dec_bwd_tensor_cores``; timed with each launch
    apart and with the weight gradient's plan swept."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    def operands(p, t):
        return [t["x"], t["h"], t["dmu"], t["dlv"], p["fc21"]["w"],
                p["fc22"]["w"]]

    g = torch.Generator(device="cuda").manual_seed(59)

    def narrow(batch, latent, units, seg):
        shapes = (((batch, seg), 0.3, False), ((batch, units), 1.0, True),
                  ((batch, latent), 1.0, False),
                  ((batch, latent), 1.0, False),
                  ((units, latent), units ** -0.5, False),
                  ((units, latent), units ** -0.5, False))
        out = []
        for sh, sc, relu in shapes:
            t = torch.randn(sh, generator=g, device="cuda") * sc
            out.append((t.clamp_min(0) if relu else t).bfloat16())
        return out

    cases = [(f"batch {b}", operands(*inputs(b, torch.bfloat16)))
             for b in (TRAIN_BATCH, TRAIN_RAGGED, 1)]
    cases.append(("batch 1000, {}->{}->{}".format(*TC_RAGGED_DENSE),
                  narrow(1000, *TC_RAGGED_DENSE)))
    err = hold_tensor_cores("enc_bwd_dw1", mlp.enc_bwd_dw1,
                            mlp.enc_bwd_dw1_ref, cases,
                            [("batch 1000, latent 36",
                              narrow(1000, 36, UNITS, SEG))])
    ops = operands(*inputs(TRAIN_BATCH, torch.bfloat16))
    x, h, dmu, dlv, w21, w22 = ops

    def library():
        dh = torch.where(h > 0, torch.addmm(dmu @ w21.t(), dlv, w22.t()), 0)
        return x.t() @ dh, dh.float().sum(0)

    fns = {"library": library, "plain": lambda: mlp.enc_bwd_dw1_ref(*ops),
           "cuda_cores": lambda: mlp.enc_bwd_dw1(*ops, kernel="cuda_cores"),
           "tensor_cores": lambda: mlp.enc_bwd_dw1(*ops,
                                                   kernel="tensor_cores")}
    tc = fns["tensor_cores"]
    time_tensor_cores("enc_bwd_dw1", row, fns, {
        "dh gated joined": lambda: device_ms(tc, match="JoinedKTiles"),
        "dW1 db1": lambda: device_ms(tc, match="WgradOut"),
        "sum slices": lambda: slices_ms(tc, SEG, UNITS)},
        BWD_LIBRARY["enc_bwd_dw1"])
    row["max_abs_err"] = max(row["max_abs_err"], err)
    sweep_wgrad(row, "dW1 + db1", tc, fns["plain"], SEG, UNITS)


def grad_accum2_tensor_cores(row, inputs):
    """Phase 3b: bf16 ``grad_accum2`` on the tensor cores (csrc/wgmma.cuh
    launch_wgrad2: dW21 = hᵀ dmu and dW22 = hᵀ dlv with their column sums
    in one launch, both outputs side by side, over slices of the batch) as
    ``grad_accum_tensor_cores``: the microbatch, the ragged 1000, batch 1
    and a ragged width, a latent of 36 on the first version; timed with the
    weight gradients and the slices' sum apart, and with its plan swept."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    g = torch.Generator(device="cuda").manual_seed(67)

    def narrow(batch, units, latent):
        h = torch.randn((batch, units), generator=g, device="cuda")
        heads = [torch.randn((batch, latent), generator=g, device="cuda")
                 for _ in range(2)]
        return [t.bfloat16() for t in (h.clamp_min(0), *heads)]

    keys = ("h", "dmu", "dlv")
    cases = [(f"batch {b}", [t[k] for k in keys])
             for b in (TRAIN_BATCH, TRAIN_RAGGED, 1)
             for t in (inputs(b, torch.bfloat16)[1],)]
    latent, units, _ = TC_RAGGED_DENSE
    cases.append((f"batch 1000, units {units}, latent {latent}",
                  narrow(1000, units, latent)))
    err = hold_tensor_cores("grad_accum2", mlp.grad_accum2,
                            mlp.grad_accum2_ref, cases,
                            [("batch 1000, latent 36",
                              narrow(1000, UNITS, 36))])
    h, dmu, dlv = (inputs(TRAIN_BATCH, torch.bfloat16)[1][k] for k in keys)
    fns = {"library": lambda: (h.t() @ dmu, dmu.float().sum(0),
                               h.t() @ dlv, dlv.float().sum(0)),
           "plain": lambda: mlp.grad_accum2_ref(h, dmu, dlv),
           "cuda_cores": lambda: mlp.grad_accum2(h, dmu, dlv,
                                                 kernel="cuda_cores"),
           "tensor_cores": lambda: mlp.grad_accum2(h, dmu, dlv,
                                                   kernel="tensor_cores")}
    tc = fns["tensor_cores"]
    time_tensor_cores("grad_accum2", row, fns, {
        "dW21 db21 dW22 db22": lambda: device_ms(tc, match="WgradOut"),
        "sum slices": lambda: slices_ms(tc, UNITS, LATENT, outputs=2)},
        BWD_LIBRARY["grad_accum2"])
    row["max_abs_err"] = max(row["max_abs_err"], err)
    sweep_wgrad(row, "dW21 + dW22 with their column sums", tc, fns["plain"],
                UNITS, LATENT, outputs=2)


def grad_accum_sgemm(row):
    """Phase 3c: fp32 ``grad_accum`` on csrc/sgemm.cuh (launch_wgrad: aᵀ
    read M-major where it lies, IEEE fp32 FFMAs, the batch cut into slices
    added in order, the column sums from the staged b) at the `highest`
    step's five weight-gradient shapes at the microbatch (dW1 = xᵀ dh,
    dW21 = hᵀ dmu, dW22 = hᵀ dlv, dW3 = zᵀ dh3, dW4 = h3ᵀ da), the ragged
    1000, batch 1, and an m no multiple of 4 (first version); dW4, dW21 and
    dW3 timed in turns with the library sequence, the plain version and the
    first version, and the plan swept at dW4 and dW21.  ``row`` (fp32
    grad_accum's, at dW4) takes the fp32 kernel's numbers."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    g = torch.Generator(device="cuda").manual_seed(71)

    def operands(batch, n, m):
        a = torch.randn((batch, n), generator=g, device="cuda").clamp_min(0)
        return [a, torch.randn((batch, m), generator=g, device="cuda") * 1e-3]

    shapes = {"dW1": (SEG, UNITS), "dW21": (UNITS, LATENT),
              "dW22": (UNITS, LATENT), "dW3": (LATENT, UNITS),
              "dW4": (UNITS, SEG)}
    cases = [(f"{k} {TRAIN_BATCH}x{n}x{m}", operands(TRAIN_BATCH, n, m))
             for k, (n, m) in shapes.items()]
    cases += [(f"dW21 {TRAIN_RAGGED}x{UNITS}x{LATENT}",
               operands(TRAIN_RAGGED, UNITS, LATENT)),
              (f"dW4 1x{UNITS}x{SEG}", operands(1, UNITS, SEG))]
    err = hold_tensor_cores("grad_accum", mlp.grad_accum, mlp.grad_accum_ref,
                            cases, [(f"batch 1000, m {SEG - 2}",
                                     operands(1000, UNITS, SEG - 2))],
                            kernel="sgemm")
    row["max_abs_err"] = max(row["max_abs_err"], err)
    for key in ("dW4", "dW21", "dW3"):
        n, m = shapes[key]
        a, b = operands(TRAIN_BATCH, n, m)
        fns = {"library": lambda: (a.t() @ b, b.sum(0)),
               "plain": lambda: mlp.grad_accum_ref(a, b),
               "cuda_cores": lambda: mlp.grad_accum(a, b,
                                                    kernel="cuda_cores"),
               "sgemm": lambda: mlp.grad_accum(a, b, kernel="sgemm")}
        fast = fns["sgemm"]
        shape_row = row if key == "dW4" else dict(
            name=row["name"], **bound(2 * TRAIN_BATCH * n * m,
                                      4 * (TRAIN_BATCH * (n + m) + n * m + m),
                                      "fp32"))
        dev = time_tensor_cores(f"grad_accum {key}", shape_row, fns, {
            "weight gradient": lambda: device_ms(fast, match="sgemm_kernel"),
            "sum slices": lambda: device_ms(fast, match="sum_slices")},
            BWD_LIBRARY["grad_accum"], kernel="sgemm")
        if key != "dW4":
            row[f"{key}_{n}x{m}"] = {
                k: v for k, v in shape_row.items()
                if k not in ("name", "library")}
        print(f"  grad_accum[fp32] {key} {n}x{m}: device time "
              f"{dev['sgemm']:.4f} ms, {dev['sgemm'] / dev['library']:.3f}x "
              f"the library "
              f"sequence's, {dev['cuda_cores'] / dev['sgemm']:.2f}x faster "
              f"than the first version")
        if key in ("dW4", "dW21"):
            sweep_wgrad(row, f"{key} + db", fast,
                        fns["plain"], n, m, kernel="sgemm")


# phase 3, fp32 encoder_fwd and decoder_fwd on csrc/sgemm.cuh: each
# product's plans (index of SGEMM_TILES, slices of the contraction) swept
# at the server's batch and at the microbatch (those that leave a slice
# empty are skipped); the rule's pick, tensor_cores.sgemm_fwd_plan, among
# them
FWD_PLANS = tuple((t, s) for t in range(3) for s in (1, 2, 4, 8, 16))
FWD_LIBRARY = {"encoder_fwd": ENCODER_LIBRARY, "decoder_fwd": DECODER_LIBRARY}
# the dense model's fp32 forward products: (label, k, n, outputs)
FWD_PRODUCTS = {
    "encoder_fwd": (("h", SEG, UNITS, 1), ("heads", UNITS, LATENT, 2)),
    "decoder_fwd": (("h3", LATENT, UNITS, 1), ("y", UNITS, SEG, 1)),
}


def fwd_plans_valid(k: int):
    """The plans of FWD_PLANS that leave no slice of a contraction of
    ``k`` empty (csrc/sgemm.cuh launch_fwd refuses the others)."""
    steps = -(-k // 64)
    return [(t, s) for t, s in FWD_PLANS
            if s <= steps and -(-steps // -(-steps // s)) == s]


def sweep_fwd(row, name, call, plain, batch, label, k, n, outputs):
    """Phase 3: the device ms of one ``call()`` of fp32 ``name`` at
    ``batch`` rows with the plan of its product ``label`` (contraction
    ``k``, width ``n``, ``outputs`` side by side) forced to each plan of
    FWD_PLANS in turn, the other product on the rule's plan, every output
    within GRAD_REL of ``plain()``; beside the rule's pick
    (tensor_cores.sgemm_fwd_plan), how far it is behind the fastest, and
    the fastest unsplit plan.  Into ``row[f"{label}_plans_{batch}"]``."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    sms = tensor_cores.sm_count(torch.device("cuda", 0))
    rule = tensor_cores.sgemm_fwd_plan
    picked = rule(batch, k, n, sms, outputs)
    swept = {}
    try:
        for plan in fwd_plans_valid(k):
            def forced(rows, kk, nn, sm, o=1, plan=plan):
                return plan if (kk, nn, o) == (k, n, outputs) \
                    else rule(rows, kk, nn, sm, o)
            tensor_cores.sgemm_fwd_plan = forced
            e = rel_err(call(), plain())
            check(e <= GRAD_REL, f"{name}[fp32] batch {batch}, {label} "
                  f"plan {plan}: relative error {e:.3e}")
            swept[plan] = device_ms(call)
    finally:
        tensor_cores.sgemm_fwd_plan = rule
    # a plan whose traces all came back empty reads NaN: it is left out
    swept = {plan: v for plan, v in swept.items() if v == v}
    best = min(swept, key=swept.get)
    whole = min((p for p in swept if p[1] == 1), key=swept.get)
    at = swept.get(picked, float("nan"))
    behind, gain = at / swept[best] - 1, 1 - at / swept[whole]
    print(f"  {name + '[fp32]':<24} batch {batch}: device ms of a call by "
          f"the plan of {label} ({k}->{n} x{outputs}; tile index x slices): "
          + ", ".join(f"{t}x{s}: {v:.4f}" for (t, s), v in swept.items())
          + f"; the rule (tensor_cores.sgemm_fwd_plan) picks "
            f"{picked[0]}x{picked[1]}, {100 * behind:.1f} % behind the "
            f"fastest {best[0]}x{best[1]}; the fastest unsplit plan "
            f"{whole[0]}x1 {swept[whole]:.4f}, the pick {100 * gain:.1f} % "
            f"faster than it")
    row[f"{label}_plans_{batch}"] = {f"{t}x{s}": v
                                     for (t, s), v in swept.items()}


def forward_sgemm(rows, gen_params):
    """Phase 3: fp32 ``encoder_fwd`` and ``decoder_fwd`` on csrc/sgemm.cuh
    (launch_fwd: h, then both heads in one grid; h3, then y; each product's
    tile and slices of its contraction from tensor_cores.sgemm_fwd_plan, a
    split product's slices added in order with the bias and the activation
    after them) against the plain version and the first version at the
    server's batch, the ragged 100, batch 1 and the training microbatch, a
    latent of 38 on the first version; timed in turns with the first
    version, the plain version and the library sequence at 256 and 8192,
    each launch's device time apart, and each product's plan swept at both.
    ``rows`` (phase 3's fp32 rows) take the numbers at 256 and those at
    8192 under ``at_8192``."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp, tensor_cores

    p = gen_params(1234)
    # a generator of its own: the draws of the later phases stay as they were
    g = torch.Generator(device="cuda").manual_seed(83)
    weights = {
        "encoder_fwd": [p[n][k] for n in ("fc1", "fc21", "fc22")
                        for k in ("w", "b")],
        "decoder_fwd": [p[n][k] for n in ("fc3", "fc4") for k in ("w", "b")]}
    make = {"encoder_fwd": lambda b: torch.rand(
                (b, SEG), generator=g, device="cuda") * 2 - 1,
            "decoder_fwd": lambda b: torch.randn(
                (b, LATENT), generator=g, device="cuda")}
    ops_of = {"encoder_fwd": (mlp.encoder_fwd, mlp.encoder_fwd_ref),
              "decoder_fwd": (mlp.decoder_fwd, mlp.decoder_fwd_ref)}

    def odd(name, batch, latent):
        # a latent no multiple of 4: widths the fp32 kernel refuses
        if name == "encoder_fwd":
            shapes = (((SEG, UNITS), SEG ** -0.5), ((UNITS,), 0.1),
                      ((UNITS, latent), UNITS ** -0.5), ((latent,), 0.1),
                      ((UNITS, latent), UNITS ** -0.5), ((latent,), 0.1),
                      ((batch, SEG), 0.5))
        else:
            shapes = (((latent, UNITS), latent ** -0.5), ((UNITS,), 0.1),
                      ((UNITS, SEG), UNITS ** -0.5), ((SEG,), 0.1),
                      ((batch, latent), 1.0))
        return [torch.randn(sh, generator=g, device="cuda") * sc
                for sh, sc in shapes]

    def library(name, ops):
        if name == "encoder_fwd":
            w1, b1, w21, b21, w22, b22, x = ops
            h = torch.relu(torch.addmm(b1, x, w1))
            return torch.addmm(b21, h, w21), torch.addmm(b22, h, w22), h
        w3, b3, w4, b4, z = ops
        h3 = torch.relu(torch.addmm(b3, z, w3))
        return torch.tanh(torch.addmm(b4, h3, w4)), h3

    sms = tensor_cores.sm_count(torch.device("cuda", 0))
    for name, (op, plain) in ops_of.items():
        row = rows[name]
        cases = [(f"batch {b}", [*weights[name], make[name](b)])
                 for b in (BATCH, RAGGED, 1, TRAIN_BATCH)]
        err = hold_tensor_cores(name, op, plain, cases,
                                [("batch 100, latent 38", odd(name, 100, 38))],
                                kernel="sgemm")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for batch in (BATCH, TRAIN_BATCH):
            ops = [*weights[name], make[name](batch)]
            fns = {"library": lambda: library(name, ops),
                   "plain": lambda: plain(*ops),
                   "cuda_cores": lambda: op(*ops, kernel="cuda_cores"),
                   "sgemm": lambda: op(*ops, kernel="sgemm")}
            fast = fns["sgemm"]
            plans = [tensor_cores.sgemm_fwd_plan(batch, k, n, sms, o)
                     for _, k, n, o in FWD_PRODUCTS[name]]
            parts = ({"h": "sgemm_kernel", "heads": "sgemm_heads_kernel"}
                     if name == "encoder_fwd" else
                     {"h3 and y": "sgemm_kernel"})
            if any(s > 1 for _, s in plans):
                parts["slices epilogue"] = "slices_epilogue"
            if batch == BATCH:
                shape_row = row
            else:
                (_, k0, n0, _), (_, k1, n1, o1) = FWD_PRODUCTS[name]
                shape_row = dict(name=row["name"], **bound(
                    2 * batch * (k0 * n0 + o1 * k1 * n1),
                    nbytes(*ops, *fast()), "fp32"))
            dev = time_tensor_cores(
                name, shape_row, fns,
                {label: (lambda m=m: device_ms(fast, match=m))
                 for label, m in parts.items()},
                FWD_LIBRARY[name], kernel="sgemm", batch=batch)
            print(f"  {name}[fp32] batch {batch}: plans (tile index x "
                  f"slices) " + ", ".join(
                      f"{label} {t}x{s}" for (label, *_), (t, s)
                      in zip(FWD_PRODUCTS[name], plans))
                  + f"; device time {dev['sgemm']:.4f} ms, "
                    f"{dev['sgemm'] / dev['library']:.3f}x the library "
                    f"sequence's, {dev['cuda_cores'] / dev['sgemm']:.2f}x "
                    f"faster than the first version, "
                    f"{dev['plain'] / dev['sgemm']:.2f}x than the plain "
                    f"version, {dev['sgemm'] / shape_row['bound_ms']:.2f}x "
                    f"its bound")
            if batch != BATCH:
                row[f"at_{batch}"] = {k: v for k, v in shape_row.items()
                                      if k not in ("name", "library")}
            for label, k, n, o in FWD_PRODUCTS[name]:
                sweep_fwd(row, name, fast, fns["plain"], batch, label, k, n,
                          o)

def quantized_sgemm(rows, gen_params):
    """Phase 3: row 3, the int8 decoder on csrc/sgemm.cuh (csrc/quant.cu:
    h3, then y, each launch_fwd with the int8 B copied into shared memory
    as it lies and dequantized as its slabs are read back, on the fp32
    decoder's plans) at the server's batch, 33, 1, the ragged 100 and the
    microbatch: against the plain version and the first version
    (``kernel="cuda_cores"``), each within KERNEL_ATOL, bit for bit
    against the fp32 ``decoder_fwd`` on ``sgemm.cuh`` with the dequantized
    weights, equal bits twice; a latent of 38 on the first version; timed
    at 256 in turns with the first version, the plain version, that fp32
    decoder and the library sequence (dequantize -> addmm -> relu -> addmm
    -> tanh), and by device time with the products and the slices'
    epilogue apart; each product's plan swept.  ``rows`` (phase 3's) take
    the numbers."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp, quant

    name = "quantized_decoder_fwd"
    op = quant.quantized_decoder_fwd
    qp = quant.quantize_decoder(gen_params(1234))
    w3, w4 = (quant.dequantize_weight(qp[n]["q"], qp[n]["scale"])
              for n in ("fc3", "fc4"))
    b3, b4 = qp["fc3"]["b"], qp["fc4"]["b"]
    # a generator of its own: the draws of the later phases stay as they were
    g = torch.Generator(device="cuda").manual_seed(89)
    row = rows[name]
    err = 0.0
    for b in (BATCH, 33, 1, RAGGED, TRAIN_BATCH):
        z = torch.randn((b, LATENT), generator=g, device="cuda")
        before = (op.launches, op.sgemm_launches)
        got = op(qp, z)
        torch.cuda.synchronize()
        rose = (op.launches - before[0], op.sgemm_launches - before[1])
        check(rose == (1, 1), f"{name} batch {b}: launches / sgemm "
              f"launches rose by {rose}")
        check(got.shape == (b, SEG) and bool(torch.isfinite(got).all()),
              f"{name} batch {b}: shape {tuple(got.shape)} or non-finite")
        fp32, _ = mlp.decoder_fwd(w3, b3, w4, b4, z, kernel="sgemm")
        check(torch.equal(got, fp32), f"{name} batch {b}: other bits than "
              "decoder_fwd(kernel='sgemm') on the dequantized weights")
        check(torch.equal(got, op(qp, z)), f"{name} batch {b}: a second "
              "launch gave other bits")
        want = quant.quantized_decode_ref(qp, z)
        first = op(qp, z, kernel="cuda_cores")
        e, e1 = max_err([got], [want]), max_err([first], [want])
        check(max(e, e1) <= KERNEL_ATOL, f"{name} batch {b}: error {e:.3e} "
              f"(first version {e1:.3e}) > {KERNEL_ATOL}")
        err = max(err, e)
        print(f"  {name:<24} batch {b:>4}: ran sgemm; bit for bit the fp32 "
              f"decoder_fwd(kernel='sgemm') on the dequantized weights, "
              f"equal bits twice; max |kernel - plain| = {e:.3e}, the "
              f"first version's {e1:.3e} (tolerance {KERNEL_ATOL:.0e})")
    odd = quant.quantize_decoder(
        {"fc3": {"w": torch.randn((38, UNITS), generator=g, device="cuda")
                 * 38 ** -0.5, "b": b3},
         "fc4": {"w": torch.randn((UNITS, SEG), generator=g, device="cuda")
                 * UNITS ** -0.5, "b": b4}})
    z = torch.randn((RAGGED, 38), generator=g, device="cuda")
    before = (op.launches, op.sgemm_launches)
    got = op(odd, z)
    torch.cuda.synchronize()
    rose = (op.launches - before[0], op.sgemm_launches - before[1])
    e = max_err([got], [quant.quantized_decode_ref(odd, z)])
    check(rose == (1, 0) and e <= KERNEL_ATOL, f"{name} latent 38: rose "
          f"by {rose}, error {e:.3e}")
    try:
        op(odd, z, kernel="sgemm")
    except ValueError:
        pass
    else:
        check(False, f"{name} latent 38: kernel='sgemm' did not raise")
    print(f"  {name:<24} batch {RAGGED}, latent 38: ran cuda_cores (the "
          f"first version); max |kernel - plain| = {e:.3e}; kernel='sgemm' "
          "raised")
    row["max_abs_err"] = max(row["max_abs_err"], err)

    z = torch.randn((BATCH, LATENT), generator=g, device="cuda")

    def library():
        v3, v4 = (qp[n]["q"].float() * qp[n]["scale"] for n in ("fc3", "fc4"))
        h3 = torch.relu(torch.addmm(b3, z, v3))
        return (torch.tanh(torch.addmm(b4, h3, v4)),)

    fns = {"library": library,
           "plain": lambda: (quant.quantized_decode_ref(qp, z),),
           "cuda_cores": lambda: (op(qp, z, kernel="cuda_cores"),),
           "sgemm": lambda: (op(qp, z, kernel="sgemm"),),
           "fp32 decoder": lambda: mlp.decoder_fwd(w3, b3, w4, b4, z,
                                                   kernel="sgemm")}
    fast = fns["sgemm"]
    check(max_err(library(), fns["plain"]()) <= KERNEL_ATOL,
          f"{name}: the library sequence is another function")
    dev = time_tensor_cores(
        name, row, fns,
        {"h3 and y": lambda: device_ms(fast, match="sgemm_kernel"),
         "slices epilogue": lambda: device_ms(fast, match="slices_epilogue")},
        ROW_LIBRARY[name] + ", TF32 off", kernel="sgemm", batch=BATCH)
    print(f"  {name:<24} batch {BATCH}: device time {dev['sgemm']:.4f} ms, "
          f"{dev['cuda_cores'] / dev['sgemm']:.2f}x faster than the first "
          f"version ({dev['cuda_cores']:.4f}), "
          f"{dev['sgemm'] / dev['library']:.3f}x the library sequence's "
          f"({dev['library']:.4f}), {dev['sgemm'] / dev['fp32 decoder']:.3f}"
          f"x the fp32 decoder's on the dequantized weights "
          f"({dev['fp32 decoder']:.4f}), "
          f"{dev['sgemm'] / row['bound_ms']:.2f}x its bound")
    for label, k, n in (("h3", LATENT, UNITS), ("y", UNITS, SEG)):
        sweep_fwd(row, name, fast, fns["plain"], BATCH, label, k, n, 1)


# phase 3f: the library sequences of the rows with no one PyTorch call of
# their function: the sampler and the loss sums (the int8 decoder's is
# timed with it in phase 3, quantized_sgemm)
ROW_LIBRARY = {
    "quantized_decoder_fwd": "the sequence q.float() * scale (both layers) "
                             "-> addmm -> relu -> addmm -> tanh, device time "
                             "summed",
    "reparameterize_prng": "mu + torch.randn_like(mu) * exp(0.5 * logvar), "
                           "device time summed (PyTorch's own Philox stream, "
                           "not the kernel's words)",
    "loss_sums": "the two sums ((recon - x)^2).sum() and (1 + logvar - mu^2 "
                 "- exp(logvar)).sum() in fp32, device time summed",
}


def row_libraries(rows, gen_params):
    """Phase 3f: the sampler and the loss sums timed beside their library
    sequences (ROW_LIBRARY), both by device time, on operands of the row's
    timed shape: the sampler at SAMPLER_SHAPE, the loss sums at
    LOSS_BATCH; into the rows' library_ms and device_ms."""
    from rawaudiovae_kelsey_tpu_torch.ops import loss, rng

    # a generator of its own: the draws of the other phases stay as they were
    g = torch.Generator(device="cuda").manual_seed(67)
    mu = torch.randn(SAMPLER_SHAPE, generator=g, device="cuda")
    logvar = torch.randn(SAMPLER_SHAPE, generator=g, device="cuda") * 0.5
    cases = {
        "reparameterize_prng[fp32]": (
            lambda: mu + torch.randn_like(mu) * torch.exp(0.5 * logvar),
            lambda: rng.reparameterize_prng((7, 8), mu, logvar)),
    }
    for kind, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        recon = torch.tanh(torch.randn((LOSS_BATCH, SEG), generator=g,
                                       device="cuda")).to(dt)
        x = (torch.rand((LOSS_BATCH, SEG), generator=g, device="cuda") * 2
             - 1).to(dt)
        m = torch.randn((LOSS_BATCH, LATENT), generator=g,
                        device="cuda").to(dt)
        lv = (torch.randn((LOSS_BATCH, LATENT), generator=g, device="cuda")
              * 0.5).to(dt)
        cases[f"loss_sums[{kind}]"] = (
            lambda recon=recon, x=x, m=m, lv=lv: (
                torch.square(recon.float() - x.float()).sum(),
                (1.0 + lv.float() - torch.square(m.float())
                 - torch.exp(lv.float())).sum()),
            lambda recon=recon, x=x, m=m, lv=lv: loss.loss_sums(recon, x, m,
                                                                lv))
    for key, (library, kernel) in cases.items():
        row = rows[key]
        lib, dev = device_ms(library), device_ms(kernel)
        print(f"  {key:<24} library sequence {lib:.4f} ms of device time, "
              f"the kernel {dev:.4f} ({dev / lib:.2f}x), bound "
              f"{row['bound_ms']:.4f} ms")
        row.update(library_ms=lib, library=ROW_LIBRARY[key.split("[")[0]],
                   device_ms=dev)


def phase_new_kernels(gen_params):
    """Phase 3c: the input-gradient kernels and the in-kernel sampler
    against their plain versions."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp, rng

    dev = torch.device("cuda")
    p32 = gen_params(2468)
    g = torch.Generator(device=dev).manual_seed(55)
    bwd = "rawaudiovae_kelsey_tpu_torch/csrc/bwd.cu"
    tpu = "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py"

    def inputs(b, dt):
        def rnd(n, relu=False):
            t = torch.randn((b, n), generator=g, device=dev)
            return (t.clamp_min(0) if relu else t).to(dt)
        w = {n: q["w"].to(dt) for n, q in p32.items()}
        return w, dict(h=rnd(UNITS, True), dmu=rnd(LATENT), dlv=rnd(LATENT),
                       da=rnd(SEG) * 1e-3, h3=rnd(UNITS, True),
                       dh3=rnd(UNITS) * 1e-3)

    # (kernel, plain, TPU line, FLOPs per row, operands, library call)
    cases = {
        # the step's use: dz = dh3 @ w3ᵀ
        "matmul_nt": (
            lambda w, t: mlp.matmul_nt(t["dh3"], w["fc3"]),
            lambda w, t: mlp.matmul_nt_ref(t["dh3"], w["fc3"]),
            f"{tpu}:333", 2 * UNITS * LATENT,
            lambda w, t: (t["dh3"], w["fc3"]),
            lambda w, t: t["dh3"] @ w["fc3"].t()),
        "matmul_nt_mask": (
            lambda w, t: mlp.matmul_nt_mask(t["da"], w["fc4"], t["h3"]),
            lambda w, t: mlp.matmul_nt_mask_ref(t["da"], w["fc4"], t["h3"]),
            f"{tpu}:364", 2 * SEG * UNITS,
            lambda w, t: (t["da"], w["fc4"], t["h3"]), None),
        "matmul_nt2_mask": (
            lambda w, t: mlp.matmul_nt2_mask(t["dmu"], w["fc21"], t["dlv"],
                                             w["fc22"], t["h"]),
            lambda w, t: mlp.matmul_nt2_mask_ref(t["dmu"], w["fc21"],
                                                 t["dlv"], w["fc22"], t["h"]),
            f"{tpu}:398", 2 * 2 * LATENT * UNITS,
            lambda w, t: (t["dmu"], w["fc21"], t["dlv"], w["fc22"], t["h"]),
            None),
    }
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = {}
    for name, (kernel, plain, replaces, row_flops, operands,
               library) in cases.items():
        for kind, dt in dtypes.items():
            tol = BF16_REL if dt == torch.bfloat16 else GRAD_REL
            err = 0.0
            for b in (TRAIN_BATCH, TRAIN_RAGGED, 1):
                w, t = inputs(b, dt)
                got = kernel(w, t)
                torch.cuda.synchronize()
                want = plain(w, t)
                check(got.shape == want.shape and got.dtype == want.dtype
                      and bool(torch.isfinite(got).all()),
                      f"{name}[{kind}] batch {b}: shape, dtype or non-finite")
                e = rel_err((got,), (want,))
                err = max(err, max_err((got.float(),), (want.float(),)))
                print(f"  {name + '[' + kind + ']':<22} batch {b:>4}: max "
                      f"|kernel - plain| / max|plain| = {e:.3e} (tolerance "
                      f"{tol:.3e})")
                check(e <= tol, f"{name}[{kind}] batch {b}: relative error "
                      f"{e:.3e} > {tol:.3e}")
            w, t = inputs(TRAIN_BATCH, dt)
            ms, plain_ms, t_kern, t_plain = time_both(
                lambda: kernel(w, t), lambda: plain(w, t), 20)
            library_ms = None
            if library is not None:
                library_ms = cuda_time_ms(lambda: library(w, t), 20)
            print(f"  {name + '[' + kind + ']':<22} batch {TRAIN_BATCH}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (runs "
                  f"{t_kern} / {t_plain})"
                  + (f", a @ w.t() {library_ms:.4f} ms"
                     if library_ms is not None else ""))
            rows[f"{name}[{kind}]"] = {
                "name": f"{name}[{kind}]", "route": "cuda", "source": bwd,
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                **bound(TRAIN_BATCH * row_flops,
                        nbytes(*operands(w, t), kernel(w, t)), kind),
                "library_ms": library_ms}
    # (a draw of the first version's check at the dx shape, which the fp32
    # kernel's section below replaces: the draws below stay as they were)
    inputs(TRAIN_BATCH, torch.float32)

    # bf16 matmul_nt on the tensor cores: dz = dh3 @ w3ᵀ and dx = dh @ w1ᵀ at
    # the microbatch, ragged shapes, shapes TMA cannot take
    # (a generator of its own: the draws of the checks below stay as they
    # were)
    g_tc = torch.Generator(device=dev).manual_seed(56)

    def nt_operands(rows, k, m, what):
        a = torch.randn((rows, k), generator=g_tc, device=dev)
        if what == "a = 0":
            a.zero_()
        a = a.to(torch.bfloat16)
        wt = (torch.randn((m, k), generator=g_tc, device=dev) / k ** 0.5
              ).to(torch.bfloat16)
        return (lambda kernel: mlp.matmul_nt(a, wt, kernel=kernel),
                lambda: mlp.matmul_nt_ref(a, wt), lambda: a @ wt.t(),
                (a, wt))

    dz = (TRAIN_BATCH, UNITS, LATENT)
    dx_shape = (TRAIN_BATCH, UNITS, SEG)
    err, times = hold_kernel(
        "matmul_nt", mlp.matmul_nt, nt_operands,
        [(*dz, ""), (*dx_shape, ""), (256, 512, 256, "a = 0"),
         *((*sh, "") for sh in TC_RAGGED + NO_TMA)],
        [(*dz, ""), (*dx_shape, "")])
    fast_row(rows["matmul_nt[bf16]"], err, times[dz])
    sweep_tiles("matmul_nt", f"{TRAIN_BATCH}x{UNITS}->{LATENT} (dz)",
                nt_operands(*dz, "")[0], (TRAIN_BATCH // 128, LATENT))
    t = times[dx_shape]
    print(f"  matmul_nt[bf16] at the dx shape, batch {TRAIN_BATCH}: kernel "
          f"{t['tensor_cores']:.4f} ms, first version {t['cuda_cores']:.4f} "
          f"ms, a @ w.t() {t['library']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']})")

    # fp32 matmul_nt on the register-tiled kernel (csrc/sgemm.cuh): dz and dx
    # at the microbatch, ragged shapes, batch 1, shapes it cannot take
    # (a generator of its own, as above)
    g_sg = torch.Generator(device=dev).manual_seed(57)

    def nt32_operands(rows, k, m, what):
        a = torch.randn((rows, k), generator=g_sg, device=dev) * 1e-3
        wt = torch.randn((m, k), generator=g_sg, device=dev) / k ** 0.5
        return (lambda kernel: mlp.matmul_nt(a, wt, kernel=kernel),
                lambda: mlp.matmul_nt_ref(a, wt), lambda: a @ wt.t(),
                (a, wt))

    err, times = hold_kernel(
        "matmul_nt", mlp.matmul_nt, nt32_operands,
        [(*dz, ""), (*dx_shape, ""),
         *((*sh, "") for sh in SGEMM_RAGGED + NO_SGEMM)],
        [(*dz, ""), (*dx_shape, "")], kernel="sgemm")
    fast_row(rows["matmul_nt[fp32]"], err, times[dz], "sgemm")
    for shape, label in ((dz, "dz"), (dx_shape, "dx")):
        sweep_tiles("matmul_nt", f"{shape[0]}x{shape[1]}->{shape[2]} "
                    f"({label})", nt32_operands(*shape, "")[0],
                    (shape[0], shape[2]), "sgemm")
    t = times[dx_shape]
    print(f"  matmul_nt[fp32] at the dx shape, batch {TRAIN_BATCH}: kernel "
          f"{t['sgemm']:.4f} ms (device {t['device_ms']:.4f} ms), first "
          f"version {t['cuda_cores']:.4f} ms, a @ w.t() {t['library']:.4f} "
          f"ms (device {t['library_device_ms']:.4f} ms), bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}): "
          f"{2 * TRAIN_BATCH * UNITS * SEG / t['device_ms'] / 1e9:.1f} "
          f"TFLOP/s by device time")

    # rows 5 and 6, the gated input gradients, on their new forms: bf16 on
    # the tensor cores (dec_bwd_fused's dh3 launch; enc_bwd_dw1's dh launch,
    # joined along k), fp32 on csrc/sgemm.cuh's gated product (the pairs
    # joined as the slabs are copied); each beside the library sequence of
    # its function (a generator of its own, as above)
    g_gt = torch.Generator(device=dev).manual_seed(58)
    for op, n, pairs in (("matmul_nt_mask", SEG, 1),
                         ("matmul_nt2_mask", LATENT, 2)):
        fn, plain = getattr(mlp, op), getattr(mlp, f"{op}_ref")
        for kind, dt in dtypes.items():
            kernel = "sgemm" if dt == torch.float32 else "tensor_cores"

            def gated_operands(rows, k, m, what, pairs=pairs, fn=fn,
                               plain=plain, dt=dt):
                ts = []
                for _ in range(pairs):
                    ts += [torch.randn((rows, k), generator=g_gt,
                                       device=dev),
                           torch.randn((m, k), generator=g_gt, device=dev)
                           / k ** 0.5]
                ts = [t.to(dt) for t in ts] + [torch.randn(
                    (rows, m), generator=g_gt, device=dev).clamp_min(0)
                    .to(dt)]
                if pairs == 1:
                    a, w, gate = ts
                    library = lambda: (a @ w.t()) * (gate > 0)  # noqa: E731
                else:
                    a1, w1, a2, w2, gate = ts
                    library = lambda: torch.where(  # noqa: E731
                        gate > 0, torch.addmm(a1 @ w1.t(), a2, w2.t()), 0)
                return (lambda kernel: fn(*ts, kernel=kernel),
                        lambda: plain(*ts), library, tuple(ts))

            full = (TRAIN_BATCH, n, UNITS)
            odd = 36 if dt == torch.bfloat16 else 38
            err, times = hold_kernel(
                op, fn, gated_operands,
                [(*full, ""), (TRAIN_RAGGED, n, UNITS, ""), (1, n, UNITS, ""),
                 (TRAIN_RAGGED, 264, 520, ""), (TRAIN_RAGGED, odd, 520, "")],
                [(*full, "")], kernel, pairs=pairs, named_raises=True)
            t = times[full]
            row = rows[f"{op}[{kind}]"]
            fast_row(row, err, t, kernel)
            row.update(library_ms=t["library_device_ms"],
                       library_event_ms=t["library"],
                       library=BWD_LIBRARY[op], device_ms=t["device_ms"],
                       first_version_device_ms=t["first_version_device_ms"])
            print(f"  {op + '[' + kind + ']':<24} batch {TRAIN_BATCH}, by "
                  f"device time: {kernel} {t['device_ms']:.4f} ms, "
                  f"{t['first_version_device_ms'] / t['device_ms']:.2f}x "
                  f"faster than the first version "
                  f"({t['first_version_device_ms']:.4f} ms), "
                  f"{t['device_ms'] / t['library_device_ms']:.3f}x the "
                  f"library sequence ({t['library_device_ms']:.4f} ms), "
                  f"{t['device_ms'] / t['bound_ms']:.2f}x its bound "
                  f"({t['bound_ms']:.4f} ms, {t['bound_by']})")

    # the sampler
    name = "reparameterize_prng[fp32]"
    err = 0.0
    for i, (b, lat) in enumerate((SAMPLER_SHAPE, (TRAIN_RAGGED, 256),
                                  (1, 256))):
        seed = (0x9E3779B9 + i, 0x7F4A7C15)
        same = torch.equal(rng.philox_words(seed, b, lat, dev),
                           rng.philox_words_ref(seed, b, lat, dev))
        check(same, f"sampler ({b}, {lat}): the kernel's Philox words "
              "differ from the plain version's")
        mu = torch.randn((b, lat), generator=g, device=dev)
        logvar = torch.randn((b, lat), generator=g, device=dev) * 0.5
        z = rng.reparameterize_prng(seed, mu, logvar)
        torch.cuda.synchronize()
        want = rng.reparameterize_prng_ref(seed, mu, logvar)
        check(bool(torch.isfinite(z).all()), f"sampler ({b}, {lat}): "
              "non-finite z")
        excess = float(((z - want).abs() / (1 + want.abs())).max())
        check(excess <= 1e-5, f"sampler ({b}, {lat}): |z - plain| / (1 + "
              f"|z|) = {excess:.3e} > 1e-5")
        check(torch.equal(z, rng.reparameterize_prng(seed, mu, logvar)),
              f"sampler ({b}, {lat}): two launches with one seed differ")
        check(not torch.equal(z, rng.reparameterize_prng(
            (seed[0], seed[1] ^ 1), mu, logvar)),
            f"sampler ({b}, {lat}): the high seed word is ignored")
        e = float((z - want).abs().max())
        err = max(err, e)
        print(f"  {name:<22} ({b}, {lat}): words equal bit for bit; max |z "
              f"- plain| = {e:.3e}, / (1 + |z|) = {excess:.3e}; "
              f"deterministic; both seed words used")
    zeros = torch.zeros(SAMPLER_SHAPE, device=dev)
    eps = rng.reparameterize_prng((2024, 1), zeros, zeros)
    mean, var = float(eps.mean()), float(eps.var())
    check(eps.numel() >= 1_000_000 and bool(torch.isfinite(eps).all()),
          "sampler: non-finite eps")
    check(abs(mean) < 5e-3 and abs(var - 1) < 1e-2,
          f"sampler moments: mean {mean:.3e}, var {var:.6f}")
    print(f"  {name:<22} {eps.numel()} samples: mean {mean:.3e}, variance "
          f"{var:.6f}, max |eps| {float(eps.abs().max()):.3f}")
    mu = torch.randn(SAMPLER_SHAPE, generator=g, device=dev)
    logvar = torch.randn(SAMPLER_SHAPE, generator=g, device=dev) * 0.5
    cot = torch.randn(SAMPLER_SHAPE, generator=g, device=dev)
    with torch.enable_grad():
        a, b = mu.clone().requires_grad_(), logvar.clone().requires_grad_()
        ga = torch.autograd.grad(
            (rng.reparameterize((7, 8), a, b) * cot).sum(), (a, b))
        gp = torch.autograd.grad(
            (rng.reparameterize_prng_ref((7, 8), a, b) * cot).sum(), (a, b))
    e = rel_err(ga, gp)
    check(e <= 1e-5, f"sampler backward vs autograd of the plain version: "
          f"{e:.3e}")
    print(f"  {name:<22} backward vs autograd through the plain version: "
          f"relative error {e:.3e}")
    ms, plain_ms, t_kern, t_plain = time_both(
        lambda: rng.reparameterize_prng((7, 8), mu, logvar),
        lambda: rng.reparameterize_prng_ref((7, 8), mu, logvar), 20)
    print(f"  {name:<22} {SAMPLER_SHAPE}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (runs {t_kern} / {t_plain})")
    n = mu.numel()
    rows[name] = {
        "name": name, "route": "cuda",
        "source": "rawaudiovae_kelsey_tpu_torch/csrc/rng.cu",
        "replaces": "rawaudiovae_kelsey_tpu/ops/rng.py:69",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(SAMPLER_OPS * n, 3 * 4 * n, "fp32"), "library_ms": None}

    # dx: the encoder's input gradient through the autograd Function
    enc = {n: {k: t.clone() for k, t in q.items()} for n, q in p32.items()}
    x = (torch.rand((TRAIN_RAGGED, SEG), generator=g, device=dev) * 2 - 1)
    cmu = torch.randn((TRAIN_RAGGED, LATENT), generator=g, device=dev)
    clv = torch.randn((TRAIN_RAGGED, LATENT), generator=g, device=dev)
    before = (mlp.matmul_nt2_mask.launches, mlp.matmul_nt.launches)
    with torch.enable_grad():
        xx = x.clone().requires_grad_()
        mu, lv = mlp.encode(enc, xx)
        (dx,) = torch.autograd.grad((mu * cmu).sum() + (lv * clv).sum(), xx)
    rose = (mlp.matmul_nt2_mask.launches - before[0],
            mlp.matmul_nt.launches - before[1])
    check(rose == (1, 1), f"dx: matmul_nt2_mask / matmul_nt rose by {rose}")
    _, _, h = mlp.encoder_fwd_ref(
        *[enc[n][k] for n in ("fc1", "fc21", "fc22") for k in ("w", "b")], x)
    want = mlp.matmul_nt_ref(mlp.matmul_nt2_mask_ref(
        cmu, enc["fc21"]["w"], clv, enc["fc22"]["w"], h), enc["fc1"]["w"])
    e = rel_err((dx,), (want,))
    check(e <= GRAD_REL, f"dx vs the plain composition: {e:.3e}")
    print(f"  dx through mlp.encode, batch {TRAIN_RAGGED}: relative error "
          f"{e:.3e}; rows 6 and 4 launched once each")
    return rows


def split_probe_values(g, shape, dev):
    """fp32 values made from their bits, to tell one hi/lo split from
    another: random sign, exponent in [-3, 3], random mantissa, and of every
    eight values two whose low 16 bits are exactly 0x8000 (the tie, where
    rounding half up and rounding to nearest even part), one just below it
    (0x7FFF) and one just above (0x8001)."""
    def draw(lo, hi):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)
    mant, kind = draw(0, 1 << 23), draw(0, 8)
    low = mant & 0xFFFF
    for k, bits in ((0, 0x8000), (1, 0x8000), (2, 0x7FFF), (3, 0x8001)):
        low = torch.where(kind == k, bits, low)
    v = ((draw(124, 131) << 23) | (mant & ~0xFFFF) | low).view(torch.float32)
    return torch.where(draw(0, 2) == 1, -v, v)


def exact_split_case(dev, seed=0, seg=SEG, units=UNITS, latent=LATENT):
    """Operands of ``enc_bwd_full`` and ``dec_bwd_full`` at batch = latent on
    which the 3-pass product leaves no room for summation order: every
    contraction of the two chains has at most one non-zero term, so each
    product is ``(hi·hi + hi·lo) + lo·hi`` of one pair of values (each
    partial product exact in fp32), and a kernel that splits and adds as the
    plain version does gives its bits.  The values are
    :func:`split_probe_values`.  Only ``db1`` and ``db3`` add a dense
    cotangent over the batch.  Returns ``(enc_args, dec_args)``; needs
    ``seg >= latent`` and ``units >= latent``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b = latent

    def val(*shape):
        return split_probe_values(g, shape, dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    r, cols = torch.arange(b, device=dev), torch.arange(seg, device=dev)
    # encoder.  x: column i is non-zero in row i % b alone (dW1 = xᵀ dh);
    # dmu on the even rows' diagonal and dlogvar on the odd rows' (dh, the
    # head gradients and their bias gradients); h, w21, w22 dense
    x = zeros(b, seg)
    x[cols % b, cols] = val(seg)
    d = val(b)
    dmu = torch.diag(torch.where(r % 2 == 0, d, 0.0))
    dlv = torch.diag(torch.where(r % 2 == 1, d, 0.0))
    enc = (x, val(b, units).clamp_min(0), dmu, dlv, val(units, latent),
           val(units, latent))
    # decoder.  da: row r is non-zero in one column of its own (dh3, dW4,
    # db4); z diagonal (dW3); w3: row l is non-zero in one column of its own
    # (dz); h3, w4 dense
    da = zeros(b, seg)
    da[r, (seg // b) * r] = val(b)
    w3 = zeros(latent, units)
    w3[r, (units // latent) * r] = val(latent)
    dec = (da, val(b, units).clamp_min(0), torch.diag(val(b)),
           val(units, seg), w3)
    return enc, dec


def exact_toeplitz_case(dev, B, nb, G, kb, N, seed=0):
    """Operands ``(x (B, nb, G), w (KB, G, N), b (N,))`` of ``toeplitz_fwd``
    on which the 4-pass product leaves no room for summation order: column
    n of w is non-zero in one row (tap j, channel g) of w viewed as (KB·G,
    N) alone, so each output is one product ``(hh + ll) + (hl + lh)`` of
    one pair of values (each partial product exact in fp32), or none where
    its tap reads outside x, and a kernel that splits and adds as the plain
    version does gives its bits.  The values are :func:`split_probe_values`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = split_probe_values(g, (B, nb, G), dev)
    rows = torch.randint(0, kb * G, (N,), generator=g, device=dev)
    w = torch.zeros((kb * G, N), device=dev)
    w[rows, torch.arange(N, device=dev)] = split_probe_values(g, (N,), dev)
    return x, w.reshape(kb, G, N), split_probe_values(g, (N,), dev)


# outputs of the two chains that sum a dense cotangent over the batch (db1
# of enc_bwd_full, db3 of dec_bwd_full): the others are exact on
# exact_split_case
DENSE_SUMS = {"enc_bwd_full": (1,), "dec_bwd_full": (2,)}


def exact_forward_case(dev, seed=0, seg=SEG, units=UNITS, latent=LATENT):
    """Operands of the `high` tier's 3-pass forms of rows 1, 2, 6 and 4 at
    batch = latent on which, as on :func:`exact_split_case`, every
    contraction has at most one non-zero term: each product is ``(hi·hi +
    hi·lo) + lo·hi`` of one pair of :func:`split_probe_values`, the bias is
    added after it and the activation applied, so a kernel that splits and
    adds as the plain version does gives its bits (y up to its tanh).
    Returns a dict: "encoder" ``(w1, b1, w21, b21, w22, b22, x)``, x with
    one non-zero a row and the heads' weights one a column; "decoder"
    ``(w3, b3, w4, b4, z)``, z one a row and w4 one a column (scaled by
    2^-6 so that tanh does not saturate); "dh" ``(dmu, w21, dlv, w22, h)``,
    :func:`exact_split_case` 's encoder operands; "dx" ``(w1,)`` with one
    non-zero a row, so that ``dh @ w1ᵀ`` has one term a sum.  Needs ``seg
    >= latent`` and ``units >= latent``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b = latent

    def val(*shape):
        return split_probe_values(g, shape, dev)

    def one_a_row(rows, cols, scale=1.0):
        t = torch.zeros((rows, cols), device=dev)
        r = torch.arange(rows, device=dev)
        t[r, (r * 7 + 3) % cols] = val(rows) * scale
        return t

    # a column of w21 / w22 / w4 non-zero in one row: the transpose of one
    # non-zero a row
    encoder = (val(seg, units), val(units), one_a_row(latent, units).t(),
               val(latent), one_a_row(latent, units).t().flip(0),
               val(latent), one_a_row(b, seg))
    decoder = (val(latent, units), val(units),
               one_a_row(seg, units, 2.0 ** -6).t(), val(seg),
               one_a_row(b, latent))
    enc, _ = exact_split_case(dev, seed, seg, units, latent)
    x, h, dmu, dlv, w21, w22 = enc
    return {"encoder": tuple(t.contiguous() for t in encoder),
            "decoder": tuple(t.contiguous() for t in decoder),
            "dh": (dmu, w21, dlv, w22, h),
            "dx": (one_a_row(seg, units),)}


# phase 3d: rows 11 and 12's library sequence, the 3-pass chain of library
# calls where the card's PyTorch has a bf16 product with an fp32 output;
# beside it the IEEE fp32 sequence, which computes another function
FULL_LIBRARY = ("the sequence split_hi_lo of each operand -> three "
                "torch.mm(bf16, bf16, out_dtype=float32) a product, added "
                "(hh + hl) + lh -> where / sum(0) as the plain version, "
                "device time summed (no one PyTorch call computes {})")
FP32_SEQUENCE = ("the plain version in one IEEE fp32 pass (fp32 matmuls, "
                 "TF32 off): another function, the `highest` tier's")


FULL_LIBRARY_BF16 = ("the sequence addmm(dmu @ w21.t(), dlv, w22.t()) / "
                     "da @ w4.t() -> where -> torch.mm(bf16, bf16, "
                     "out_dtype=float32) a weight gradient (dz: dh3 @ "
                     "w3.t()) -> sum(0) in fp32, device time summed (no one "
                     "PyTorch call computes {})")


def full_chain_library_bf16(name, args):
    """``name`` 's one-pass chain on the bf16 ``args`` as library calls: the
    hidden cotangent a bf16 product gated, each weight gradient one
    ``torch.mm`` of bf16 operands with an fp32 output, the bias gradients
    fp32 sums (the function of the split backward's kernels)."""
    def mm(u, v):
        return torch.mm(u, v, out_dtype=torch.float32)

    if name == "enc_bwd_full":
        x, h, dmu, dlv, w21, w22 = args

        def run():
            dh = torch.where(h > 0, torch.addmm(dmu @ w21.t(), dlv,
                                                w22.t()), 0.0).to(h.dtype)
            return (mm(x.t(), dh), dh.float().sum(0), mm(h.t(), dmu),
                    dmu.float().sum(0), mm(h.t(), dlv), dlv.float().sum(0))
        return run
    da, h3, z, w4, w3 = args

    def run():
        dh3 = torch.where(h3 > 0, da @ w4.t(), 0.0).to(da.dtype)
        return (dh3 @ w3.t(), mm(z.t(), dh3), dh3.float().sum(0),
                mm(h3.t(), da), da.float().sum(0))
    return run


def full_chain_library(name, args):
    """``name`` 's 3-pass chain (enc_bwd_full or dec_bwd_full) on the fp32
    ``args`` as library calls: each operand split as the kernels split it
    (``mlp.split_hi_lo``, both halves exact in bf16), each product three
    ``torch.mm`` of bf16 operands with an fp32 output added ``(hh + hl) +
    lh``, the gate and the bias gradients as in the plain version; on bf16
    ``args`` full_chain_library_bf16.  None where the card's PyTorch has no
    bf16 product with an fp32 output."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    def split(v):
        hi, lo = mlp.split_hi_lo(v)
        return hi.to(torch.bfloat16), lo.to(torch.bfloat16)

    def tr(pair):
        return pair[0].t(), pair[1].t()

    def mm3(a, b):
        def mm(u, v):
            return torch.mm(u, v, out_dtype=torch.float32)
        return (mm(a[0], b[0]) + mm(a[0], b[1])) + mm(a[1], b[0])

    try:
        probe = split(args[0][:16, :16].float())
        mm3(tr(probe), probe)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        print(f"  {name}: no bf16 product with an fp32 output in this "
              f"PyTorch ({type(e).__name__}: {str(e)[:80]})")
        return None
    if args[0].dtype == torch.bfloat16:
        return full_chain_library_bf16(name, args)
    if name == "enc_bwd_full":
        x, h, dmu, dlv, w21, w22 = args

        def run():
            sh, smu, slv = split(h), split(dmu), split(dlv)
            dh = torch.where(h > 0, mm3(smu, tr(split(w21)))
                             + mm3(slv, tr(split(w22))), 0.0)
            return (mm3(tr(split(x)), split(dh)), dh.sum(0),
                    mm3(tr(sh), smu), dmu.sum(0), mm3(tr(sh), slv),
                    dlv.sum(0))
        return run
    da, h3, z, w4, w3 = args

    def run():
        sda = split(da)
        dh3 = torch.where(h3 > 0, mm3(sda, tr(split(w4))), 0.0)
        sdh3 = split(dh3)
        return (mm3(sdh3, tr(split(w3))), mm3(tr(split(z)), sdh3),
                dh3.sum(0), mm3(tr(split(h3)), sda), da.sum(0))
    return run


def split_pass_alone(name, ops):
    """The split pass as ``name`` 's 3-pass chain runs it on ``ops`` (fp32):
    every operand, and a matrix of the hidden cotangent's shape, the
    summed ones with their column sums."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    summed = {"enc_bwd_full": (2, 3), "dec_bwd_full": (0,)}[name]
    hidden = torch.zeros_like(ops[1])

    def run():
        for i, v in enumerate((*ops, hidden)):
            mlp.split_pass(v, sums=i in summed or v is hidden)
    return run


# the parts of a 3-pass chain's device time, by the kernels' names
FULL_PARTS = {"split pass": "split_", "gated / plain rows": "SplitRows",
              "weight gradients": "SplitWgradOut",
              "slices' sum": "sum_slices"}


def full_libraries(row, name, kernel, plain, ops, kind, passes):
    """Phase 3d: by device time, the chain ``kernel`` (row 11 or 12) on
    ``ops`` on its new form and its first version, its library sequence
    (full_chain_library, held against the plain version first), the IEEE
    fp32 sequence (fp32) and the split pass alone (fp32), into the row."""
    dev = device_ms(lambda: kernel(*ops))
    first = device_ms(lambda: kernel(*ops, kernel="cuda_cores"))
    row.update(device_ms=dev, first_version_device_ms=first)
    text = (f"  {name}[{kind}]           batch {ops[0].shape[0]}, by device "
            f"time: the new form {dev:.4f} ms, the first version "
            f"{first:.4f} ms ({first / dev:.2f}x)")
    library = full_chain_library(name, ops)
    if library is not None:
        tol = FULL_REL if kind == "fp32" else BF16_REL
        e = rel_err(library(), plain(*ops, passes))
        check(e <= tol, f"{name}[{kind}]: the library sequence is {e:.3e} "
              "from the plain version")
        lib = device_ms(library)
        row.update(library_ms=lib, library=(
            FULL_LIBRARY if kind == "fp32" else FULL_LIBRARY_BF16
        ).format(name))
        text += (f", the {passes}-pass library sequence {lib:.4f} ms "
                 f"({dev / lib:.3f}x; {e:.3e} from the plain version)")
    if kind == "fp32":
        fp32 = device_ms(lambda: plain(*ops, 1))
        split = device_ms(split_pass_alone(name, ops))
        parts = {label: device_ms(lambda: kernel(*ops), match=key)
                 for label, key in FULL_PARTS.items()}
        row.update(fp32_sequence_ms=fp32, fp32_sequence=FP32_SEQUENCE,
                   split_pass_ms=split, parts_ms=parts)
        text += (f", the IEEE fp32 sequence (another function) {fp32:.4f} "
                 f"ms ({dev / fp32:.3f}x), the split pass alone {split:.4f} "
                 "ms; the new form's parts: " + ", ".join(
                     f"{k} {v:.4f} ms" for k, v in parts.items()))
    print(text)


def sweep_split_widths(name, call):
    """Phase 3d: the 3-pass chain's device time with each tile width of the
    3-pass mode forced on all its products (``tensor_cores.SPLIT_WIDTHS``),
    beside the rule's pick."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    rule = tensor_cores.SPLIT_WIDTHS
    times = {}
    try:
        for widths in ((128,), (64,), rule):
            tensor_cores.SPLIT_WIDTHS = widths
            times["rule " + str(rule) if widths == rule else widths[0]] = \
                device_ms(call)
    finally:
        tensor_cores.SPLIT_WIDTHS = rule
    print(f"  {name}[fp32] tile widths, device ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()))
    return times


def phase_full_kernels(gen_params):
    """Phase 3d: the full backward chains and the fused loss reduction
    against their plain versions."""
    from rawaudiovae_kelsey_tpu_torch.ops import loss, mlp

    dev = torch.device("cuda")
    p32 = gen_params(1357)
    g = torch.Generator(device=dev).manual_seed(99)
    tpu = "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py"

    def inputs(b, dt):
        def rnd(n, relu=False):
            t = torch.randn((b, n), generator=g, device=dev)
            return (t.clamp_min(0) if relu else t).to(dt)
        w = {n: q["w"].to(dt) for n, q in p32.items()}
        return w, dict(x=rnd(SEG) * 0.3, h=rnd(UNITS, True), dmu=rnd(LATENT),
                       dlv=rnd(LATENT), da=rnd(SEG) * 1e-3,
                       h3=rnd(UNITS, True), z=rnd(LATENT))

    def enc_args(w, t):
        return (t["x"], t["h"], t["dmu"], t["dlv"], w["fc21"], w["fc22"])

    def dec_args(w, t):
        return (t["da"], t["h3"], t["z"], w["fc4"], w["fc3"])

    # (kernel, plain, operands, TPU line, FLOPs per row of one pass)
    cases = {
        "enc_bwd_full": (mlp.enc_bwd_full, mlp.enc_bwd_full_ref, enc_args,
                         f"{tpu}:789",
                         2 * (2 * LATENT * UNITS + SEG * UNITS
                              + 2 * UNITS * LATENT)),
        "dec_bwd_full": (mlp.dec_bwd_full, mlp.dec_bwd_full_ref, dec_args,
                         f"{tpu}:886",
                         2 * (SEG * UNITS + 2 * UNITS * LATENT
                              + UNITS * SEG)),
    }
    # fp32 operands take the 3-pass product of the `high` tier, bf16 one pass
    kinds = {"fp32": (torch.float32, 3, FULL_REL),
             "bf16": (torch.bfloat16, 1, BF16_REL)}
    rows, at_train_batch = {}, {}
    # each form: the new one on the tensor cores (every shape here takes
    # it) and the first version, named
    forms = {"tensor cores": "auto", "first version": "cuda_cores"}
    for name, (kernel, plain, args, replaces, row_flops) in cases.items():
        for kind, (dt, passes, tol) in kinds.items():
            err = 0.0
            for b in (STREAM_BATCH, TRAIN_BATCH, FULL_RAGGED):
                w, t = inputs(b, dt)
                want = plain(*args(w, t), passes)
                for form, named in forms.items():
                    before = kernel.tensor_core_launches
                    got = kernel(*args(w, t), kernel=named)
                    torch.cuda.synchronize()
                    check((kernel.tensor_core_launches - before)
                          == (named == "auto"), f"{name}[{kind}] batch {b}: "
                          f"the {form} form did not run")
                    for a, r in zip(got, want):
                        check(a.shape == r.shape and a.dtype == r.dtype
                              and bool(torch.isfinite(a).all()),
                              f"{name}[{kind}] batch {b} ({form}): shape, "
                              "dtype or non-finite")
                    e = rel_err(got, want)
                    if named == "auto":
                        err = max(err, max_err([a.float() for a in got],
                                               [r.float() for r in want]))
                    print(f"  {name + '[' + kind + ']':<22} batch {b:>4}, "
                          f"{passes} pass(es), {form}: max |kernel - plain| "
                          f"/ max|plain| = {e:.3e} (tolerance {tol:.3e})")
                    check(e <= tol, f"{name}[{kind}] batch {b} ({form}): "
                          f"relative error {e:.3e} > {tol:.3e}")
            # the stream's batch is the shape the `high` path gives the
            # chains (the row of the kernel line); the training microbatch
            # beside it, the `high` step's
            for b in (STREAM_BATCH, TRAIN_BATCH):
                w, t = inputs(b, dt)
                ms, runs = time_in_turns({
                    "kernel": lambda: kernel(*args(w, t)),
                    "first": lambda: kernel(*args(w, t),
                                            kernel="cuda_cores"),
                    "plain": lambda: plain(*args(w, t), passes)}, 5)
                print(f"  {name + '[' + kind + ']':<22} batch {b}: new form "
                      f"{ms['kernel']:.4f} ms, first version "
                      f"{ms['first']:.4f} ms ({ms['first'] / ms['kernel']:.2f}"
                      f"x), plain {ms['plain']:.4f} ms (runs {runs})")
                if b == TRAIN_BATCH:
                    at_train_batch[f"{name}[{kind}]"] = ms["kernel"]
                    if kind == "fp32":
                        sweep_split_widths(name, lambda: kernel(*args(w, t)))
                    continue
                # three bf16 passes a product under `high`: the tensor
                # cores' bf16 rate bounds both forms
                rows[f"{name}[{kind}]"] = {
                    "name": f"{name}[{kind}]", "route": "cuda",
                    "source": ("rawaudiovae_kelsey_tpu_torch/csrc/full.cu"
                               if kind == "fp32" else
                               "rawaudiovae_kelsey_tpu_torch/csrc/bwd.cu"),
                    "replaces": replaces, "max_abs_err": err,
                    "ms": ms["kernel"], "plain_ms": ms["plain"],
                    "first_version_ms": ms["first"],
                    **bound(passes * b * row_flops,
                            nbytes(*args(w, t), *kernel(*args(w, t))),
                            "bf16"),
                    "library_ms": None}
                full_libraries(rows[f"{name}[{kind}]"], name, kernel, plain,
                               args(w, t), kind, passes)
                if kind == "fp32":
                    sweep_split_widths(name, lambda: kernel(*args(w, t)))

    # three passes, and the split itself, bit for bit: built operands on
    # which every sum has one non-zero term; the new form and the first
    # version alike
    for name, case in zip(cases, exact_split_case(dev)):
        kernel, plain = cases[name][:2]
        want = plain(*case, 3)
        once = plain(*case, 1)
        exact = [i for i in range(len(want)) if i not in DENSE_SUMS[name]]
        moved = sum(int((want[i] != once[i]).sum()) for i in exact)
        total = sum(want[i].numel() for i in exact)
        check(moved > total // 10, f"{name}: the built operands do not tell "
              "three passes from one")
        for form, named in forms.items():
            got = kernel(*case, kernel=named)
            torch.cuda.synchronize()
            off = sum(int((got[i] != want[i]).sum()) for i in exact)
            print(f"  {name}[fp32] on built operands, batch "
                  f"{case[0].shape[0]}, {form}: {off} of {total} values "
                  f"differ from the 3-pass plain version (one fp32 pass "
                  f"would move {moved})")
            check(off == 0 and all(bool(torch.isfinite(a).all())
                                   for a in got),
                  f"{name}[fp32] ({form}): {off} values differ from the "
                  "3-pass plain version bit for bit on the built operands")
            e = rel_err([got[i] for i in DENSE_SUMS[name]],
                        [want[i] for i in DENSE_SUMS[name]])
            check(e <= EXACT_DB_REL, f"{name}[fp32] ({form}): dense bias "
                  f"gradient on the built operands off by {e:.3e}")

    # the loss reduction: the stream's batch and a ragged, larger one
    name = "loss_sums"
    for kind, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        err = 0.0
        for b in (LOSS_BATCH, LOSS_RAGGED):
            recon = torch.tanh(torch.randn((b, SEG), generator=g,
                                           device=dev)).to(dt)
            x = (torch.rand((b, SEG), generator=g, device=dev) * 2 - 1).to(dt)
            mu = torch.randn((b, LATENT), generator=g, device=dev).to(dt)
            lv = (torch.randn((b, LATENT), generator=g, device=dev)
                  * 0.5).to(dt)
            got = loss.loss_sums(recon, x, mu, lv)
            again = loss.loss_sums(recon, x, mu, lv)
            torch.cuda.synchronize()
            want = loss.loss_sums_ref(recon, x, mu, lv)
            check(all(bool(torch.isfinite(a)) and a.dtype == torch.float32
                      and a.dim() == 0 for a in got),
                  f"{name}[{kind}] batch {b}: non-finite or not fp32 scalars")
            e = max(abs(float(a) / float(r) - 1) for a, r in zip(got, want))
            err = max(err, max_err(got, want))
            same = all(torch.equal(a, r) for a, r in zip(got, again))
            print(f"  {name + '[' + kind + ']':<22} batch {b:>5}: max "
                  f"|kernel / plain - 1| = {e:.3e} (tolerance {SUMS_REL:g}); "
                  f"second launch {'equal bit for bit' if same else 'DIFFERS'}")
            check(e <= SUMS_REL, f"{name}[{kind}] batch {b}: {e:.3e}")
            check(same, f"{name}[{kind}] batch {b}: two launches differ")
            if b == LOSS_BATCH:
                ms, plain_ms, t_kern, t_plain = time_both(
                    lambda: loss.loss_sums(recon, x, mu, lv),
                    lambda: loss.loss_sums_ref(recon, x, mu, lv), 50)
                print(f"  {name + '[' + kind + ']':<22} batch {b}: kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms (runs {t_kern} "
                      f"/ {t_plain})")
                # 3 operations an element of recon, ~8 an element of mu
                # (the exponential counted as 4)
                row = {"name": f"{name}[{kind}]", "route": "cuda",
                       "source": "rawaudiovae_kelsey_tpu_torch/csrc/loss.cu",
                       "replaces":
                           "rawaudiovae_kelsey_tpu/ops/pallas_loss.py:53",
                       "ms": ms, "plain_ms": plain_ms,
                       **bound(3 * recon.numel() + 8 * mu.numel(),
                               nbytes(recon, x, mu, lv) + 8, "fp32"),
                       "library_ms": None}
        row["max_abs_err"] = err
        rows[f"{name}[{kind}]"] = row

    # the closed-form backward of the fused loss against autograd of the
    # plain loss, on the card
    from rawaudiovae_kelsey_tpu_torch.models import vae

    recon, x, mu, lv = (t.float() for t in (recon, x, mu, lv))
    with torch.enable_grad():
        a = [t.clone().requires_grad_() for t in (recon, mu, lv)]
        b_ = [t.clone().requires_grad_() for t in (recon, mu, lv)]
        fused = loss.fused_loss(a[0], x, a[1], a[2], 1e-4)
        plain = vae.loss_fn(b_[0], x, b_[1], b_[2], 1e-4, SEG)
        ga = torch.autograd.grad(fused, a)
        gp = torch.autograd.grad(plain, b_)
    e = abs(float(fused) / float(plain) - 1)
    eg = rel_err(ga, gp)
    print(f"  fused_loss vs the plain loss, batch {LOSS_RAGGED}: value "
          f"{e:.3e}, input gradients {eg:.3e}")
    check(e <= 1e-5 and eg <= 1e-5, "fused_loss disagrees with the plain "
          "loss")
    rows.update(loss_step_rows(dev))
    return rows, at_train_batch


def bf16_ulps(a, b) -> int:
    """The largest elementwise distance of two bf16 tensors, in ulps."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


def loss_step_rows(dev):
    """Phase 3d: row 14 as the train steps run it, at LOSS_STEP_ROWS x SEG
    (+ x LATENT): ``loss_sums`` and ``loss_grads`` on bf16 recon / x
    beside fp32 mu / logvar (the bf16 step), ``loss_grads`` on fp32 (the
    fp32 tiers; the fp32 sums row is LOSS_BATCH's, above).  Each against
    its plain version: the sums within SUMS_REL and bit for bit those of
    the fp32 copies of recon and x (the order of the additions is a
    function of the shapes alone); the gradient's d recon within one bf16
    ulp (fp32: LOSS_GRAD_REL), d mu and d logvar within LOSS_GRAD_REL; two
    launches a pair of calls and equal bits on the second; timed in turns
    beside the plain version, and by device time against the bytes bound
    (operands read once, the gradients written once)."""
    from rawaudiovae_kelsey_tpu_torch.ops import loss

    # a generator of its own: the draws of the other phases stay as they were
    g = torch.Generator(device=dev).manual_seed(1414)
    b = LOSS_STEP_ROWS
    n_x, n_l = b * SEG, b * LATENT
    g_m = torch.tensor(1.0, device=dev)
    g_k = torch.tensor(1e-4, device=dev)
    rows = {}
    for kind, pair in (("bf16-fp32", torch.bfloat16),
                       ("fp32", torch.float32)):
        recon = torch.tanh(torch.randn((b, SEG), generator=g,
                                       device=dev)).to(pair)
        x = (torch.rand((b, SEG), generator=g, device=dev) * 2 - 1).to(pair)
        mu = torch.randn((b, LATENT), generator=g, device=dev)
        lv = torch.randn((b, LATENT), generator=g, device=dev) * 0.5
        four = (recon, x, mu, lv)
        calls = {"loss_grads": (
            lambda: loss.loss_grads(*four, g_m, g_k, n_x, n_l),
            lambda: loss.loss_grads_ref(*four, g_m, g_k, n_x, n_l),
            "rawaudiovae_kelsey_tpu/ops/pallas_loss.py:145",
            3 * n_x + 9 * n_l)}
        if kind == "bf16-fp32":
            calls["loss_sums"] = (
                lambda: loss.loss_sums(*four),
                lambda: loss.loss_sums_ref(*four),
                "rawaudiovae_kelsey_tpu/ops/pallas_loss.py:53",
                3 * n_x + 8 * n_l)
        for name, (kernel, plain, replaces, flops) in calls.items():
            key = f"{name}[{kind}]"
            wrapper = getattr(loss, name)
            n0 = wrapper.launches
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            check(wrapper.launches - n0 == 2, f"{key}: {wrapper.launches - n0}"
                  " launches for two calls")
            want = plain()
            same = all(torch.equal(a, r) for a, r in zip(got, again))
            check(same, f"{key}: two launches differ")
            check(all(a.dtype == r.dtype and a.shape == r.shape
                      and bool(torch.isfinite(a).all())
                      for a, r in zip(got, want)),
                  f"{key}: dtype, shape or non-finite")
            if name == "loss_sums":
                e = max(abs(float(a) / float(r) - 1)
                        for a, r in zip(got, want))
                copy = loss.loss_sums(recon.float(), x.float(), mu, lv)
                exact = all(torch.equal(a, c) for a, c in zip(got, copy))
                print(f"  {key:<22} batch {b}: max |kernel / plain - 1| = "
                      f"{e:.3e} (tolerance {SUMS_REL:g}); the fp32 copies' "
                      f"sums {'equal bit for bit' if exact else 'DIFFER'}")
                check(e <= SUMS_REL and exact, f"{key}: {e:.3e}, fp32 "
                      f"copies equal: {exact}")
                moved = nbytes(*four) + 8
            else:
                if kind == "bf16-fp32":
                    ulps = bf16_ulps(got[0], want[0])
                    first, ok = f"{ulps} bf16 ulp (tolerance 1)", ulps <= 1
                else:
                    e0 = rel_err(got[:1], want[:1])
                    first = f"rel {e0:.3e} (tolerance {LOSS_GRAD_REL:g})"
                    ok = e0 <= LOSS_GRAD_REL
                e = rel_err(got[1:], want[1:])
                print(f"  {key:<22} batch {b}: d recon {first}; d mu, d "
                      f"logvar rel {e:.3e} (tolerance {LOSS_GRAD_REL:g}); "
                      "second launch equal bit for bit")
                check(ok and e <= LOSS_GRAD_REL, f"{key}: d recon {first}, "
                      f"d mu / d logvar {e:.3e}")
                moved = nbytes(*four, *got)
            err = max_err(got, want)
            del got, again, want
            ms, plain_ms, t_kern, t_plain = time_both(kernel, plain, 20)
            dev_ms = device_ms(kernel)
            row = {"name": key, "route": "cuda",
                   "source": "rawaudiovae_kelsey_tpu_torch/csrc/loss.cu",
                   "replaces": replaces, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "device_ms": dev_ms,
                   **bound(flops, moved, "fp32"), "library_ms": None}
            print(f"  {key:<22} batch {b}: kernel {ms:.4f} ms (runs "
                  f"{t_kern}), device {dev_ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms (runs {t_plain}); bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}, {moved / 1e9:.3f} GB): the kernel "
                  f"at {row['bound_ms'] / dev_ms:.1%} of its bound")
            rows[key] = row
        del recon, x, mu, lv, four
    return rows


# phase 3g: the `high` tier's 3-pass forms of rows 1, 2, 6 -> 4 and of the
# row-parallel rows 1 and 2 (passes = 3: csrc/full.cu's chains on the
# tensor cores; the first version's 3-pass mode, named), at full width,
# against their 3-pass plain versions: FULL_REL * max|plain| (the same
# split and bf16 products, summed in another order), equal bits on a second
# launch, and bit for bit on exact_forward_case (every sum one term; y
# within TANH_ULPS, the kernel's tanhf beside torch.tanh).  The bound is
# the contract's (the products' three passes at the bf16 rate, or the
# function's bytes); split_bound_ms adds the split pass's bytes to the
# products' time (every split matrix read in fp32, written as two bf16
# halves: 8 bytes an element).
HIGH_BATCHES = (TRAIN_BATCH, STREAM_BATCH, FULL_RAGGED)
TANH_ULPS = 8
HIGH_LIBRARY = ("the sequence split_hi_lo of each operand -> three "
                "torch.mm(bf16, bf16, out_dtype=float32) a product, added "
                "(hh + hl) + lh -> the bias and the activation (the gate) as "
                "the plain version, device time summed (no one PyTorch call "
                "computes {})")
# the parts of a 3-pass form's device time, by the kernels' names
HIGH_PARTS = {"split pass": "split_", "products": "Split"}


def high_library(name, weights, args):
    """``name`` 's 3-pass form (phase 3g's, or phase 3h's backward forms)
    on ``args`` as library calls: each operand
    split as the kernels split it, each product three ``torch.mm`` of bf16
    halves with an fp32 output added ``(hh + hl) + lh``, then the bias and
    the activation (the gate) as the plain version; None where the card's
    PyTorch has no bf16 product with an fp32 output."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    def split(v):
        hi, lo = mlp.split_hi_lo(v)
        return hi.to(torch.bfloat16), lo.to(torch.bfloat16)

    def mm3(a, b):
        (ah, al), (bh, bl) = split(a), split(b)

        def mm(u, v):
            return torch.mm(u, v, out_dtype=torch.float32)
        return (mm(ah, bh) + mm(ah, bl)) + mm(al, bh)

    try:
        mm3(args[0][:16, :16].contiguous(), args[0][:16, :16].contiguous())
    except (RuntimeError, TypeError, NotImplementedError) as e:
        print(f"  {name}: no bf16 product with an fp32 output in this "
              f"PyTorch ({type(e).__name__}: {str(e)[:80]})")
        return None
    if name.startswith("encoder_fwd"):
        w1, b1, w21, b21, w22, b22 = weights
        (x,) = args

        def run():
            h = torch.relu(mm3(x, w1) + b1)
            mu, lv = mm3(h, w21), mm3(h, w22)
            if b21 is None:
                return mu, lv, h
            return mu + b21, lv + b22, h
        return run
    if name.startswith("decoder_fwd"):
        w3, b3, w4, b4 = weights
        (z,) = args

        def run():
            h3 = torch.relu(mm3(z, w3) + b3)
            y = mm3(h3, w4)
            return (y if b4 is None else torch.tanh(y + b4)), h3
        return run
    if name.startswith("matmul_nt2_mask"):
        w21, w22 = weights
        dmu, dlv, h = args

        def run():
            return torch.where(h > 0, mm3(dmu, w21.t()) + mm3(dlv, w22.t()),
                               0.0)
        return run
    # the backward's forms (phase 3h): their weights among ``args``
    if name == "matmul_nt_mask":
        a, w, gate = args
        return lambda: (torch.where(gate > 0, mm3(a, w.t()), 0.0),)
    if name in ("grad_accum", "grad_accum2"):
        a, *bs = args
        return lambda: tuple(v for b in bs for v in (mm3(a.t(), b),
                                                     b.sum(0)))
    if name == "enc_bwd_dw1":
        x, h, dmu, dlv, w21, w22 = args

        def run():
            dh = torch.where(h > 0, mm3(dmu, w21.t()) + mm3(dlv, w22.t()),
                             0.0)
            return mm3(x.t(), dh), dh.sum(0)
        return run
    if name == "dec_bwd_fused":
        da, h3, z, w4, w3 = args

        def run():
            dh3 = torch.where(h3 > 0, mm3(da, w4.t()), 0.0)
            return mm3(dh3, w3.t()), mm3(z.t(), dh3), dh3.sum(0)
        return run
    (w1,) = weights
    (dh,) = args

    def run():
        return mm3(dh, w1.t())
    return run


def phase_high_forward(gen_params):
    """Phase 3g: the `high` tier's 3-pass forms against their plain
    versions (header above).  Returns the rows of the kernel line
    (launches filled in later, from the paths that run them)."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    dev = torch.device("cuda")
    p32 = gen_params(2468)
    g = torch.Generator(device=dev).manual_seed(2469)
    tpu = "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py"
    src = "rawaudiovae_kelsey_tpu_torch/csrc/full.cu"
    enc = [p32[n][k] for n in ("fc1", "fc21", "fc22") for k in ("w", "b")]
    dec = [p32[n][k] for n in ("fc3", "fc4") for k in ("w", "b")]
    w1, w21, w22 = enc[0], enc[2], enc[4]
    half = UNITS // TP_MODEL
    # a rank's shards of the model-2 step (phase 14): fc1 / fc3 by columns,
    # the heads / fc4 by rows, units 1024 of 2048
    enc_p = (enc[0][:, :half].contiguous(), enc[1][:half].contiguous(),
             enc[2][:half].contiguous(), None, enc[4][:half].contiguous(),
             None)
    dec_p = (dec[0][:, :half].contiguous(), dec[1][:half].contiguous(),
             dec[2][:half].contiguous(), None)

    def rnd(*shape, scale=1.0, relu=False):
        t = torch.randn(shape, generator=g, device=dev) * scale
        return t.clamp_min(0) if relu else t

    # each form's kernel (operands, kernel name) and plain version
    # (operands), the operands a tuple
    def enc_call(weights, partial):
        if partial:
            w_1, b_1, w_21, _, w_22, _ = weights
            return (lambda a, k="auto": mlp.encoder_fwd_partial(
                        w_1, b_1, w_21, w_22, a[0], kernel=k, passes=3),
                    lambda a: mlp.encoder_fwd_partial_ref(
                        w_1, b_1, w_21, w_22, a[0], 3))
        return (lambda a, k="auto": mlp.encoder_fwd(*weights, a[0], kernel=k,
                                                    passes=3),
                lambda a: mlp.encoder_fwd_ref(*weights, a[0], 3))

    def dec_call(weights, partial):
        if partial:
            w_3, b_3, w_4, _ = weights
            return (lambda a, k="auto": mlp.decoder_fwd_partial(
                        w_3, b_3, w_4, a[0], kernel=k, passes=3),
                    lambda a: mlp.decoder_fwd_partial_ref(
                        w_3, b_3, w_4, a[0], 3))
        return (lambda a, k="auto": mlp.decoder_fwd(*weights, a[0], kernel=k,
                                                    passes=3),
                lambda a: mlp.decoder_fwd_ref(*weights, a[0], 3))

    # name: (kernel, plain, operands of a batch, weights for the library,
    # FLOPs a row of one pass, split elements of a batch, TPU line, wrapper)
    forms = {
        "encoder_fwd": (*enc_call(enc, False),
                        lambda b: (rnd(b, SEG, scale=0.3),), enc,
                        2 * (SEG * UNITS + 2 * UNITS * LATENT),
                        lambda b: b * SEG + SEG * UNITS + 2 * UNITS * LATENT
                        + b * UNITS, f"{tpu}:246", mlp.encoder_fwd),
        "decoder_fwd": (*dec_call(dec, False), lambda b: (rnd(b, LATENT),),
                        dec, 2 * (LATENT * UNITS + UNITS * SEG),
                        lambda b: b * LATENT + LATENT * UNITS + UNITS * SEG
                        + b * UNITS, f"{tpu}:294", mlp.decoder_fwd),
        "matmul_nt2_mask": (
            lambda a, k="auto": mlp.matmul_nt2_mask(a[0], w21, a[1], w22,
                                                    a[2], kernel=k, passes=3),
            lambda a: mlp.matmul_nt2_mask_ref(a[0], w21, a[1], w22, a[2], 3),
            lambda b: (rnd(b, LATENT), rnd(b, LATENT),
                       rnd(b, UNITS, relu=True)), (w21, w22),
            2 * 2 * LATENT * UNITS,
            lambda b: 2 * (b * LATENT + UNITS * LATENT), f"{tpu}:398",
            mlp.matmul_nt2_mask),
        "matmul_nt": (
            lambda a, k="auto": mlp.matmul_nt(a[0], w1, kernel=k, passes=3),
            lambda a: mlp.matmul_nt_ref(a[0], w1, 3),
            lambda b: (rnd(b, UNITS, scale=1e-2, relu=True),), (w1,),
            2 * UNITS * SEG, lambda b: b * UNITS + SEG * UNITS,
            f"{tpu}:333", mlp.matmul_nt),
        "encoder_fwd_partial": (
            *enc_call(enc_p, True), lambda b: (rnd(b, SEG, scale=0.3),),
            enc_p, 2 * (SEG * half + 2 * half * LATENT),
            lambda b: b * SEG + SEG * half + 2 * half * LATENT + b * half,
            f"{tpu}:246", mlp.encoder_fwd),
        "decoder_fwd_partial": (
            *dec_call(dec_p, True), lambda b: (rnd(b, LATENT),), dec_p,
            2 * (LATENT * half + half * SEG),
            lambda b: b * LATENT + LATENT * half + half * SEG + b * half,
            f"{tpu}:294", mlp.decoder_fwd),
    }

    def outputs(out):
        return out if isinstance(out, tuple) else (out,)

    rows = {}
    for name, (kernel, plain, make, weights, row_flops, split_elems,
               replaces, wrapper) in forms.items():
        key = f"{name}[3-pass]"
        err = 0.0
        for b in HIGH_BATCHES:
            a = make(b)
            want = outputs(plain(a))
            for form, named in (("tensor cores", "auto"),
                                ("first version", "cuda_cores")):
                before = (wrapper.split_launches, wrapper.sgemm_launches)
                got = outputs(kernel(a, named))
                again = outputs(kernel(a, named))
                torch.cuda.synchronize()
                rose = (wrapper.split_launches - before[0],
                        wrapper.sgemm_launches - before[1])
                check(rose == (2 * (named == "auto"), 0), f"{key} batch {b} "
                      f"({form}): split / sgemm launches rose by {rose}")
                for t, w in zip(got, want):
                    check(t.shape == w.shape and t.dtype == w.dtype
                          and bool(torch.isfinite(t).all()),
                          f"{key} batch {b} ({form}): shape, dtype or "
                          "non-finite")
                e = rel_err(got, want)
                same = all(torch.equal(t, u) for t, u in zip(got, again))
                if named == "auto":
                    err = max(err, max_err(got, want))
                print(f"  {key:<28} batch {b:>4}, {form}: max |kernel - "
                      f"plain| / max|plain| = {e:.3e} (tolerance "
                      f"{FULL_REL:g}); second launch "
                      f"{'equal bit for bit' if same else 'DIFFERS'}")
                check(e <= FULL_REL and same, f"{key} batch {b} ({form}): "
                      f"error {e:.3e}, second launch equal: {same}")
        a = make(TRAIN_BATCH)
        t, runs = time_in_turns({
            "kernel": lambda: kernel(a), "plain": lambda: plain(a),
            "first": lambda: kernel(a, "cuda_cores")}, 10)
        dev_ms = device_ms(lambda: kernel(a))
        parts = {label: device_ms(lambda: kernel(a), match=m)
                 for label, m in HIGH_PARTS.items()}
        flops = 3 * TRAIN_BATCH * row_flops
        outs = outputs(kernel(a))
        row = {"name": key, "route": "cuda", "source": src,
               "replaces": replaces, "max_abs_err": err, "ms": t["kernel"],
               "plain_ms": t["plain"],
               **bound(flops, nbytes(*a, *(w for w in weights
                                           if w is not None), *outs),
                       "bf16"),
               "library_ms": None, "first_version_ms": t["first"],
               "device_ms": dev_ms, "parts_ms": parts,
               "split_bound_ms": (flops / PEAK_FLOPS["bf16"]
                                  + 8 * split_elems(TRAIN_BATCH)
                                  / HBM_BYTES_S) * 1e3}
        library = high_library(name, weights, a)
        text = ""
        if library is not None:
            e = rel_err(outputs(library()), outputs(plain(a)))
            check(e <= FULL_REL, f"{key}: the library sequence is {e:.3e} "
                  "from the plain version")
            lib = device_ms(library)
            row.update(library_ms=lib, library=HIGH_LIBRARY.format(name))
            text = f", library sequence {lib:.4f} ms ({dev_ms / lib:.3f}x)"
        print(f"  {key:<28} batch {TRAIN_BATCH}: kernel {t['kernel']:.4f} ms "
              f"(device {dev_ms:.4f}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in parts.items())
              + f"), plain {t['plain']:.4f}, first version {t['first']:.4f}"
              f"{text}; bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"with the split pass's bytes {row['split_bound_ms']:.4f} ms "
              f"(runs {runs})")
        rows[key] = row

    # one term a sum: the kernels give the plain version's bits (y up to
    # its tanh); both forms
    case = exact_forward_case(dev)
    e_args, d_args = case["encoder"], case["decoder"]
    checks = {
        "encoder_fwd": (lambda k: mlp.encoder_fwd(*e_args, kernel=k,
                                                  passes=3),
                        mlp.encoder_fwd_ref(*e_args, passes=3),
                        mlp.encoder_fwd_ref(*e_args)),
        "encoder_fwd_partial": (
            lambda k: mlp.encoder_fwd_partial(*e_args[:3], e_args[4],
                                              e_args[6], kernel=k, passes=3),
            mlp.encoder_fwd_partial_ref(*e_args[:3], e_args[4], e_args[6],
                                        passes=3),
            mlp.encoder_fwd_partial_ref(*e_args[:3], e_args[4], e_args[6])),
        "decoder_fwd": (lambda k: mlp.decoder_fwd(*d_args, kernel=k,
                                                  passes=3)[1:],
                        mlp.decoder_fwd_ref(*d_args, passes=3)[1:],
                        mlp.decoder_fwd_ref(*d_args)[1:]),
        "decoder_fwd_partial": (
            lambda k: mlp.decoder_fwd_partial(*d_args[:3], d_args[4],
                                              kernel=k, passes=3),
            mlp.decoder_fwd_partial_ref(*d_args[:3], d_args[4], passes=3),
            mlp.decoder_fwd_partial_ref(*d_args[:3], d_args[4])),
        "matmul_nt2_mask": (
            lambda k: (mlp.matmul_nt2_mask(*case["dh"], kernel=k,
                                           passes=3),),
            (mlp.matmul_nt2_mask_ref(*case["dh"], passes=3),),
            (mlp.matmul_nt2_mask_ref(*case["dh"]),)),
    }
    dh = checks["matmul_nt2_mask"][1][0]
    checks["matmul_nt"] = (
        lambda k: (mlp.matmul_nt(dh, *case["dx"], kernel=k, passes=3),),
        (mlp.matmul_nt_ref(dh, *case["dx"], passes=3),),
        (mlp.matmul_nt_ref(dh, *case["dx"]),))
    for name, (kernel, want, once) in checks.items():
        moved = sum(int((w != o).sum()) for w, o in zip(want, once))
        total = sum(w.numel() for w in want)
        check(moved > total // 20, f"{name}[3-pass]: the built operands do "
              "not tell three passes from one")
        for form, named in (("tensor cores", "auto"),
                            ("first version", "cuda_cores")):
            got = kernel(named)
            torch.cuda.synchronize()
            off = sum(int((a != w).sum()) for a, w in zip(got, want))
            print(f"  {name}[3-pass] on built operands, batch "
                  f"{e_args[6].shape[0]}, {form}: {off} of {total} values "
                  f"differ from the 3-pass plain version (one fp32 pass "
                  f"would move {moved})")
            check(off == 0, f"{name}[3-pass] ({form}): {off} values differ "
                  "from the 3-pass plain version on the built operands")
    want_y = mlp.decoder_fwd_ref(*d_args, passes=3)[0]
    for form, named in (("tensor cores", "auto"),
                        ("first version", "cuda_cores")):
        y = mlp.decoder_fwd(*d_args, kernel=named, passes=3)[0]
        ulps = int((y.view(torch.int32).long()
                    - want_y.view(torch.int32).long()).abs().max())
        print(f"  decoder_fwd[3-pass] y on built operands, {form}: at most "
              f"{ulps} ulps from the plain version's (tolerance "
              f"{TANH_ULPS}: tanhf beside torch.tanh)")
        check(ulps <= TANH_ULPS, f"decoder_fwd[3-pass] y ({form}): {ulps} "
              "ulps")
    return rows


# phase 3h: the backward-fusion switch (ops/mlp.py BWD_FUSION, the JAX
# package's pallas_mlp.py:993) and the forms of the dense backward it
# reaches: rows 5 and 7-10 in three bf16 passes (passes = 3: csrc/full.cu's
# parts of the chains on the tensor cores; the first version's 3-pass mode,
# named) and rows 11-12 in one fp32 pass (sgemm.cuh's launches of rows 6,
# 7 / 5, 4, 7, 7 in turn; the first version at one pass, named), at the
# training microbatch and a ragged batch, against their plain versions:
# FULL_REL * max|plain| (the same products summed in another order), equal
# bits on a second launch, the 3-pass forms bit for bit on exact_split_case
# (every sum one term but the dense bias gradients, EXACT_DB_REL) and the
# one-pass chains bit for bit against the kernels they launch, one by one.
# Then one step of configs/default.ini's model (two microbatches of 8192)
# for every forced mode and tier, through the kernels against the plain step
# of the same mode and pass count (the wrappers' plain versions on the
# card), PERF.md section 2's update bound on the update outside Adam's eps
# zone and on the gradient (Adam's first moment); every launch of the mode's
# kernels on the tier's form and none on a first version.  Then
# probes/fusion_ab.py at bfloat16 and high.
FUSION_BATCHES = (TRAIN_BATCH, FULL_RAGGED)
FUSION_STEP_BATCH = 2 * TRAIN_BATCH
# |g| below which a first Adam step's update is the rounding of g
# (tests/test_torch_mesh.py)
ADAM_EPS_ZONE = 1e-7
FUSION_TIERS = ("bfloat16", "high", "highest")
FUSION_MODES = ("primitive", "split", "full")
IEEE_LIBRARY = ("the one-pass plain version: fp32 matmuls (TF32 off) -> "
                "where -> sum(0), device time summed (no one PyTorch call "
                "computes {})")
# the wrappers a plain step replaces by their plain versions
PLAIN_WRAPPERS = ("encoder_fwd", "decoder_fwd", "matmul_nt", "matmul_nt_mask",
                  "matmul_nt2_mask", "grad_accum", "grad_accum2",
                  "enc_bwd_dw1", "dec_bwd_fused", "enc_bwd_full",
                  "dec_bwd_full")
# the kernels of each backward mode, and the launch counter of the form
# each tier takes (fusion_step's tags)
FUSION_KERNELS = {"primitive": ("matmul_nt2_mask", "matmul_nt_mask",
                                "matmul_nt", "grad_accum"),
                  "split": ("enc_bwd_dw1", "grad_accum2", "dec_bwd_fused",
                            "grad_accum"),
                  "full": ("enc_bwd_full", "dec_bwd_full")}
FUSION_FORM = {"bfloat16": "tc", "high": "split", "highest": "sgemm"}


@contextlib.contextmanager
def plain_wrappers():
    """``ops/mlp.py`` 's kernel wrappers replaced by their plain versions,
    which then run on CUDA tensors too: a step in it is the plain step of
    its backward mode and pass count."""
    from rawaudiovae_kelsey_tpu_torch.ops import mlp

    saved = {name: getattr(mlp, name) for name in PLAIN_WRAPPERS}

    def plain(name):
        ref = getattr(mlp, name + "_ref")

        def run(*args, kernel="auto", passes=None):
            if passes is None:
                passes = (mlp.full_passes(args[0].dtype)
                          if name.endswith("_full") else 1)
            return ref(*args, passes=passes)
        return run

    try:
        for name in PLAIN_WRAPPERS:
            setattr(mlp, name, plain(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(mlp, name, fn)


def fusion_step(cfg, mode, x):
    """One step of ``cfg`` 's model with the switch forced to ``mode``,
    through the kernels and as the plain step of the same mode (same
    state and noise; its loss on plain ops, not on row 14's kernels): the
    update held at PERF.md section 2's bound.
    Returns the kernels' launches by wrapper, "<name>@<form>" for each
    counter of a faster form."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.models.registry import plain_loss
    from rawaudiovae_kelsey_tpu_torch.ops import mlp
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves

    dev = x.device

    def noise(step, i, shape):
        return torch.randn(shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1000 * step + (i or 0)))

    saved = mlp.BWD_FUSION
    mlp.BWD_FUSION = mode
    try:
        model = build_model(cfg, dev)
    finally:
        mlp.BWD_FUSION = saved
    check(model.encode.keywords == {"mode": mode},
          f"{cfg.tpu.precision} {mode}: the model bound "
          f"{model.encode.keywords}")
    start = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              0)
    counters = ("tensor_core_launches", "sgemm_launches", "split_launches")
    out, counts = {}, None
    for kind in ("kernels", "plain"):
        state = start.clone()
        before = [(w.launches, *(getattr(w, c, 0) for c in counters))
                  for w in ops.KERNEL_WRAPPERS]
        # the plain step: ops/mlp.py's plain versions, and the loss on
        # plain ops where the model binds row 14's kernels
        step_model = (model if kind == "kernels"
                      else dataclasses.replace(model,
                                               loss_components=plain_loss))
        with (plain_wrappers() if kind == "plain"
              else contextlib.nullcontext()):
            state, m = build_train_step(step_model, cfg, noise=noise)(state,
                                                                      x)
        torch.cuda.synchronize()
        if kind == "kernels":
            counts = {}
            for w, b in zip(ops.KERNEL_WRAPPERS, before):
                counts[w.__name__] = w.launches - b[0]
                for c, tag, n in zip(counters, ("tc", "sgemm", "split"),
                                     b[1:]):
                    counts[f"{w.__name__}@{tag}"] = getattr(w, c, 0) - n
        else:
            check(all(w.launches == b[0] for w, b in
                      zip(ops.KERNEL_WRAPPERS, before)),
                  "the plain step launched a kernel")
        out[kind] = (float(m["loss"]), torch.cat(
            [(a - b).ravel() for a, b in zip(leaves(state.params),
                                             leaves(start.params))]),
                     torch.cat([a.ravel() for a in leaves(state.mu)]))
    (lk, dk, mk), (lp, dp, mp) = out["kernels"], out["plain"]
    # Adam's first step moves a param by lr·g/(|g| + 1e-8): where |g| is
    # within a few eps the absolute rounding of g moves it by a share of lr
    # (3.4 % of the params at this width, in bf16), so the update is held
    # outside that zone and the gradient itself, through the first moment
    # mu = 0.1·g, everywhere
    zone = mp.abs() / 0.1 < ADAM_EPS_ZONE
    upd = float((dk - dp)[~zone].norm() / dp[~zone].norm())
    grad = float((mk - mp).norm() / mp.norm())
    whole = float((dk - dp).norm() / dp.norm())
    tol = 5e-2 if cfg.tpu.precision == "bfloat16" else 1e-3
    print(f"  {cfg.tpu.precision:<8} {mode:<9} one step of "
          f"{x.shape[0]}, kernels vs plain: loss {lk:.7f} vs {lp:.7f}; "
          f"|update difference| / |update| = {upd:.3e} outside Adam's eps "
          f"zone ({int(zone.sum())} params; {whole:.3e} with it), "
          f"|gradient difference| / |gradient| = {grad:.3e} (tolerance "
          f"{tol:g})")
    check(abs(lk / lp - 1) <= tol and upd <= tol and grad <= tol,
          f"{cfg.tpu.precision} {mode} step: kernels and plain disagree")
    return counts


def phase_fusion(gen_params, card):
    """Phase 3h (header above).  Returns the rows of the kernel line, the
    launch counts of each (tier, mode) step and the probe's results."""
    from rawaudiovae_kelsey_tpu_torch.config import load_config
    from rawaudiovae_kelsey_tpu_torch.ops import mlp
    from rawaudiovae_kelsey_tpu_torch.probes import fusion_ab

    dev = torch.device("cuda")
    p32 = gen_params(8642)
    g = torch.Generator(device=dev).manual_seed(8643)
    tpu = "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py"
    w21, w22, w3, w4 = (p32[n]["w"] for n in ("fc21", "fc22", "fc3", "fc4"))

    def rnd(*shape, relu=False):
        t = torch.randn(shape, generator=g, device=dev)
        return t.clamp_min(0) if relu else t

    def inputs(b):
        return dict(x=rnd(b, SEG), h=rnd(b, UNITS, relu=True),
                    dmu=rnd(b, LATENT), dlv=rnd(b, LATENT), da=rnd(b, SEG),
                    h3=rnd(b, UNITS, relu=True), z=rnd(b, LATENT))

    # name: (operands of a batch's inputs, FLOPs a row of one pass, split
    # elements of a batch, TPU line, passes)
    forms = {
        "matmul_nt_mask": (lambda t: (t["da"], w4, t["h3"]),
                           2 * SEG * UNITS,
                           lambda b: b * SEG + UNITS * SEG, f"{tpu}:364", 3),
        "grad_accum": (lambda t: (t["h3"], t["da"]), 2 * UNITS * SEG,
                       lambda b: b * UNITS + b * SEG, f"{tpu}:453", 3),
        "enc_bwd_dw1": (lambda t: (t["x"], t["h"], t["dmu"], t["dlv"], w21,
                                   w22),
                        2 * (2 * LATENT * UNITS + SEG * UNITS),
                        lambda b: 2 * b * LATENT + 2 * UNITS * LATENT
                        + b * UNITS + b * SEG, f"{tpu}:542", 3),
        "grad_accum2": (lambda t: (t["h"], t["dmu"], t["dlv"]),
                        2 * 2 * UNITS * LATENT,
                        lambda b: b * UNITS + 2 * b * LATENT, f"{tpu}:624",
                        3),
        "dec_bwd_fused": (lambda t: (t["da"], t["h3"], t["z"], w4, w3),
                          2 * (SEG * UNITS + 2 * UNITS * LATENT),
                          lambda b: b * SEG + UNITS * SEG + b * UNITS
                          + LATENT * UNITS + b * LATENT, f"{tpu}:695", 3),
        "enc_bwd_full": (lambda t: (t["x"], t["h"], t["dmu"], t["dlv"], w21,
                                    w22),
                         2 * (2 * LATENT * UNITS + SEG * UNITS
                              + 2 * UNITS * LATENT), None, f"{tpu}:789", 1),
        "dec_bwd_full": (lambda t: (t["da"], t["h3"], t["z"], w4, w3),
                         2 * (2 * SEG * UNITS + 2 * UNITS * LATENT), None,
                         f"{tpu}:886", 1),
    }
    rows = {}
    for name, (make, row_flops, split_elems, replaces, passes) in \
            forms.items():
        key = f"{name}[{'3-pass' if passes == 3 else 'fp32-1pass'}]"
        wrapper, plain = getattr(mlp, name), getattr(mlp, name + "_ref")
        fast = "split_launches" if passes == 3 else "sgemm_launches"
        err = 0.0
        for b in FUSION_BATCHES:
            a = make(inputs(b))
            want = plain(*a, passes=passes)
            want = want if isinstance(want, tuple) else (want,)
            for form, named in (("new form", "auto"),
                                ("first version", "cuda_cores")):
                n0 = (wrapper.launches, getattr(wrapper, fast))
                got = wrapper(*a, kernel=named, passes=passes)
                again = wrapper(*a, kernel=named, passes=passes)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                again = again if isinstance(again, tuple) else (again,)
                rose = (wrapper.launches - n0[0],
                        getattr(wrapper, fast) - n0[1])
                check(rose == (2, 2 * (named == "auto")), f"{key} batch {b} "
                      f"({form}): launches / {fast} rose by {rose}")
                for t, w in zip(got, want):
                    check(t.shape == w.shape and t.dtype == w.dtype
                          and bool(torch.isfinite(t).all()),
                          f"{key} batch {b} ({form}): shape, dtype or "
                          "non-finite")
                e = rel_err(got, want)
                same = all(torch.equal(t, u) for t, u in zip(got, again))
                if named == "auto":
                    err = max(err, max_err(got, want))
                print(f"  {key:<26} batch {b:>4}, {form}: max |kernel - "
                      f"plain| / max|plain| = {e:.3e} (tolerance "
                      f"{FULL_REL:g}); second launch "
                      f"{'equal bit for bit' if same else 'DIFFERS'}")
                check(e <= FULL_REL and same, f"{key} batch {b} ({form}): "
                      f"error {e:.3e}, second launch equal: {same}")
        a = make(inputs(TRAIN_BATCH))
        t, runs = time_in_turns({
            "kernel": lambda: wrapper(*a, passes=passes),
            "plain": lambda: plain(*a, passes=passes),
            "first": lambda: wrapper(*a, kernel="cuda_cores",
                                     passes=passes)}, 10)
        dev_ms = device_ms(lambda: wrapper(*a, passes=passes))
        flops = passes * TRAIN_BATCH * row_flops
        outs = wrapper(*a, passes=passes)
        outs = outs if isinstance(outs, tuple) else (outs,)
        row = {"name": key, "route": "cuda",
               "source": "rawaudiovae_kelsey_tpu_torch/csrc/"
                         + ("full.cu" if passes == 3 else "sgemm.cuh"),
               "replaces": replaces, "max_abs_err": err, "ms": t["kernel"],
               "plain_ms": t["plain"],
               **bound(flops, nbytes(*a, *outs),
                       "bf16" if passes == 3 else "fp32"),
               "library_ms": None, "first_version_ms": t["first"],
               "device_ms": dev_ms}
        if passes == 3:
            row["split_bound_ms"] = (flops / PEAK_FLOPS["bf16"]
                                     + 8 * split_elems(TRAIN_BATCH)
                                     / HBM_BYTES_S) * 1e3
            row["parts_ms"] = {
                label: device_ms(lambda: wrapper(*a, passes=3), match=m)
                for label, m in FULL_PARTS.items()}
            library = high_library(name, (), a)
            text = FULL_LIBRARY
        else:
            library = (lambda: plain(*a, passes=1))
            text = IEEE_LIBRARY
        if library is not None:
            want = plain(*a, passes=passes)
            e = rel_err(library(), want if isinstance(want, tuple)
                        else (want,))
            check(e <= FULL_REL, f"{key}: the library sequence is {e:.3e} "
                  "from the plain version")
            row.update(library_ms=device_ms(library),
                       library=text.format(name))
        lib = row["library_ms"]
        print(f"  {key:<26} batch {TRAIN_BATCH}: kernel {t['kernel']:.4f} "
              f"ms (device {dev_ms:.4f}"
              + "".join(f", {k} {v:.4f}" for k, v in
                        row.get("parts_ms", {}).items())
              + f"), plain {t['plain']:.4f}, first version {t['first']:.4f}"
              + (f", library {lib:.4f} ({dev_ms / lib:.3f}x)" if lib
                 else "")
              + f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
              + (f", with the split pass's bytes {row['split_bound_ms']:.4f}"
                 if passes == 3 else "") + f" (runs {runs})")
        rows[key] = row

    # one term a sum: the 3-pass forms give the 3-pass plain version's bits
    enc, dec = exact_split_case(dev)
    x, h, dmu, dlv = enc[:4]
    da, h3 = dec[:2]
    exact = {"enc_bwd_dw1": (enc, (1,)), "dec_bwd_fused": (dec, (2,)),
             "grad_accum2": ((h, dmu, dlv), ()), "grad_accum": ((h3, da), ()),
             "matmul_nt_mask": ((da, dec[3], h3), ())}
    for name, (args, dense) in exact.items():
        want = getattr(mlp, name + "_ref")(*args, passes=3)
        once = getattr(mlp, name + "_ref")(*args)
        want = want if isinstance(want, tuple) else (want,)
        once = once if isinstance(once, tuple) else (once,)
        for form, named in (("new form", "auto"),
                            ("first version", "cuda_cores")):
            got = getattr(mlp, name)(*args, kernel=named, passes=3)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            off = moved = total = 0
            for i, (a, w, o) in enumerate(zip(got, want, once)):
                if i in dense:
                    e = rel_err((a,), (w,))
                    check(e <= EXACT_DB_REL, f"{name}[3-pass] ({form}): "
                          f"dense bias gradient {e:.3e}")
                    continue
                off += int((a != w).sum())
                moved += int((w != o).sum())
                total += w.numel()
            print(f"  {name}[3-pass] on built operands, {form}: {off} of "
                  f"{total} values differ from the 3-pass plain version "
                  f"(one pass would move {moved})")
            check(off == 0 and moved > total // 10, f"{name}[3-pass] "
                  f"({form}): {off} values off the plain version's bits, "
                  f"{moved} moved by one pass")
    # rows 11-12 in three passes at the microbatch beside their library
    # sequence (phase 3d holds and times them at 4096)
    t = inputs(TRAIN_BATCH)
    for name in ("enc_bwd_full", "dec_bwd_full"):
        ops_ = forms[name][0](t)
        three = device_ms(lambda: getattr(mlp, name)(*ops_, passes=3))
        library = full_chain_library(name, ops_)
        text = ""
        if library is not None:
            lib = device_ms(library)
            text = (f", the 3-pass library sequence {lib:.4f} ms "
                    f"({three / lib:.3f}x)")
        print(f"  {name}[fp32] in three passes, batch {TRAIN_BATCH}: device "
              f"{three:.4f} ms{text}")
    # the one-pass chains are the split kernels' fp32 launches in turn
    e_args = forms["enc_bwd_full"][0](t)
    d_args = forms["dec_bwd_full"][0](t)
    for name, got, parts in (
            ("enc_bwd_full", mlp.enc_bwd_full(*e_args, passes=1),
             (*mlp.enc_bwd_dw1(*e_args), *mlp.grad_accum2(*e_args[1:4]))),
            ("dec_bwd_full", mlp.dec_bwd_full(*d_args, passes=1),
             (*mlp.dec_bwd_fused(*d_args),
              *mlp.grad_accum(d_args[1], d_args[0])))):
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, parts))
        print(f"  {name}[fp32-1pass] against the kernels it launches, one "
              f"by one: {'equal bit for bit' if same else 'DIFFERS'}")
        check(same, f"{name}[fp32-1pass] differs from its parts")

    # one step for every forced mode and tier
    cfg = load_config(ROOT / "configs" / "default.ini")
    cfg.tpu.backend = "pallas"
    check(cfg.tpu.microbatch_size == TRAIN_BATCH, "configs/default.ini's "
          "microbatch is not the training batch of the forms")
    cfg.training.batch_size = FUSION_STEP_BATCH
    micro = FUSION_STEP_BATCH // TRAIN_BATCH
    x = torch.rand((FUSION_STEP_BATCH, SEG), generator=g, device=dev) * 2 - 1
    steps = {}
    for tier in FUSION_TIERS:
        cfg.tpu.precision = tier
        fwd_tag = FUSION_FORM[tier]
        for mode in FUSION_MODES:
            counts = fusion_step(cfg, mode, x)
            # the 3-pass full chains count on the tensor cores
            bwd_tag = "tc" if (tier, mode) == ("high", "full") else fwd_tag
            seen = {n: (counts[n], counts[f"{n}@{bwd_tag}"])
                    for n in FUSION_KERNELS[mode]}
            seen.update((n, (counts[n], counts[f"{n}@{fwd_tag}"]))
                        for n in ("encoder_fwd", "decoder_fwd"))
            others = {n: counts[n] for m, ns in FUSION_KERNELS.items()
                      for n in ns if n not in FUSION_KERNELS[mode]}
            print(f"  {tier:<8} {mode:<9} launches (all, on the tier's form):"
                  f" {seen}; the other modes' kernels {others}")
            for n, (all_, on) in seen.items():
                check(all_ >= micro and on == all_, f"{tier} {mode}: {n} "
                      f"{all_} launches, {on} on its form")
            check(not any(others.values()), f"{tier} {mode}: another "
                  f"mode's kernel launched: {others}")
            steps[(tier, mode)] = counts

    # the probe, both modes from one state, at least 10 alternating pairs
    probe = {}
    for precision in ("bfloat16", "high"):
        probe[precision] = out = fusion_ab.main(
            ["--precision", precision, "--pairs", "10", "--steps", "5"])
        check(out["launches_per_step"]["full"] == {"enc_bwd_full": 1,
                                                   "dec_bwd_full": 1},
              f"fusion_ab {precision}: {out['launches_per_step']}")
        split = out["launches_per_step"]["split"]
        check(all(split.get(n) == 1 for n in FUSION_KERNELS["split"][:3])
              and split.get("grad_accum") == 1, f"fusion_ab {precision}: "
              f"{split}")
    return rows, steps, probe


def read_scalars(log_dir: Path, tag: str) -> dict:
    """{step: value} of one scalar tag from TensorBoard event files
    (TFRecord framing, the Event / Summary / Value protos decoded by hand:
    the card's machine has no tensorboard)."""
    def varint(buf, i):
        n = shift = 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return n, i

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = varint(buf, i)
            num, wire = key >> 3, key & 7
            if wire == 0:
                v, i = varint(buf, i)
            elif wire == 1:
                v, i = buf[i:i + 8], i + 8
            elif wire == 5:
                v, i = buf[i:i + 4], i + 4
            else:
                n, i = varint(buf, i)
                v, i = buf[i:i + n], i + n
            yield num, v

    out = {}
    for f in sorted(Path(log_dir).glob("events.out.tfevents.*")):
        data, i = f.read_bytes(), 0
        while i < len(data):
            (n,) = struct.unpack_from("<Q", data, i)
            event = data[i + 12:i + 12 + n]
            i += 12 + n + 4
            ev = dict(fields(event))
            for num, summary in fields(ev.get(5, b"")):
                val = dict(fields(summary))
                if num == 1 and val.get(1) == tag.encode():
                    out[ev.get(2, 0)] = struct.unpack("<f", val[2])[0]
    return out


def busy_share(fn) -> str:
    """The device's busy share of the wall time of ``fn()``: the union of
    CUDA kernel and copy intervals in a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: recording every host op would slow the host
    # and understate the share
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return "not measured (the profiler saw no device activity)"
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    return (f"{100 * busy / wall_us:.1f} % ({busy / 1e3:.1f} ms of "
            f"{wall_us / 1e3:.1f} ms wall)")


def device_time_by_kernel(fn, top: int = 6, focus=None) -> str:
    """Device time of ``fn()`` by kernel name, the ``top`` largest and the
    rest, from a torch.profiler trace; and the sum of the kernels whose
    names hold each string of ``focus`` ({label: substring})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us:
            times[e.key] = times.get(e.key, 0.0) + us
    if not times:
        return "not measured (the profiler saw no device activity)"
    ranked = sorted(times.items(), key=lambda kv: -kv[1])
    total = sum(times.values())
    parts = [f"{name[:60]} {us / 1e3:.2f} ms ({100 * us / total:.1f} %)"
             for name, us in ranked[:top]]
    rest = sum(us for _, us in ranked[top:])
    picked = [(label, sum(us for name, us in ranked if key in name))
              for label, key in (focus or {}).items()]
    return (f"{total / 1e3:.2f} ms of device time: " + "; ".join(parts)
            + f"; the other {max(len(ranked) - top, 0)} kernels "
              f"{rest / 1e3:.2f} ms"
            + "".join(f"; {label} {us / 1e3:.2f} ms" for label, us in picked))


def device_ms(fn, calls: int = 10, match: str = "") -> float:
    """Device time of one ``fn()``: the kernels' own time in a
    torch.profiler trace of ``calls`` calls (only the kernels whose names
    hold ``match``), each kernel's mean over the launches the trace
    recorded times its launches a call, counted in a trace of one call: a
    trace that missed some launches (on an H100 one read dW4's weight
    gradient at half its time, and a library sequence whose two launches a
    call of one kernel lost half of them at a third under its bound) does
    not read short.  A trace that recorded no kernel at all (one did on an
    H100) is taken again, up to three times, before the reading is NaN.
    For a kernel of a few tens of microseconds the event-timed loop
    measures the host's launch rate."""
    from torch.profiler import ProfilerActivity, profile

    def traced(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if match in e.key and e.count]

    fn()
    per_call = {e.key: e.count for e in traced(1)}
    for _ in range(3):
        total = 0.0
        for e in traced(calls):
            us = getattr(e, "device_time_total", None)
            us = getattr(e, "cuda_time_total", 0.0) if us is None else us
            total += us / e.count * max(per_call.get(e.key, 0),
                                        round(e.count / calls), 1)
        if total:
            return total / 1e3
    return float("nan")


def host_us(fn, calls: int = 500) -> float:
    """Host time of one ``fn()``, µs: the host clock around ``calls`` calls
    queued behind one another, the device drained before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


# the two redesigned kernels' families: their operand type, tolerance
# against plain, launch counter, source, and tile rule with its choices
FAST = {
    "tensor_cores": dict(kind="bf16", tol=BF16_REL,
                         counter="tensor_core_launches", source=TC_SOURCE,
                         rule="tile_n", tiles="TILE_WIDTHS"),
    "sgemm": dict(kind="fp32", tol=GRAD_REL, counter="sgemm_launches",
                  source=SGEMM_SOURCE, rule="sgemm_tile",
                  tiles="SGEMM_TILES"),
}


def sweep_tiles(name, label, call, rule_args, kernel="tensor_cores",
                calls: int = 5, rule: str = "") -> dict:
    """Device ms of ``call(kernel)`` with the tile forced to each of the
    kernel's tiles in turn (the tensor-core kernel's widths
    ``tensor_cores.TILE_WIDTHS``, the fp32 kernel's ``SGEMM_TILES``), one
    profiler trace a tile, beside the tile its rule
    (``tensor_cores.tile_n`` / ``sgemm_tile``, or the function of
    ``tensor_cores`` named ``rule``) picks for ``rule_args`` (``(tiles_m,
    n)`` / ``(rows, n)``)."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    fast = dict(FAST[kernel], **({"rule": rule} if rule else {}))
    rule = getattr(tensor_cores, fast["rule"])

    def text(tile):
        return "x".join(map(str, tile)) if isinstance(tile, tuple) \
            else str(tile)

    ms = {}
    try:
        for tile in getattr(tensor_cores, fast["tiles"]):
            setattr(tensor_cores, fast["rule"], lambda *args, t=tile: t)
            ms[text(tile)] = device_ms(lambda: call(kernel), calls)
    finally:
        setattr(tensor_cores, fast["rule"], rule)
    picked = rule(*rule_args, tensor_cores.sm_count(torch.device("cuda", 0)))
    print(f"  {name + '[' + fast['kind'] + ']':<24} {label}: device ms by "
          "tile " + ", ".join(f"{t}: {v:.4f}" for t, v in ms.items())
          + f"; the rule picks {text(picked)}")
    return ms


def conv_form(kind: str, i: int) -> str:
    """The form both Toeplitz launches (forward and dx) of
    ``configs/conv1d.ini`` layer ``i`` take: the first and the last layers
    (G or N of 4) the narrow kernel, the six between the tensor cores in
    bf16 and the fp32 kernel in fp32."""
    if i in (0, len(CONV_LAYERS) - 1):
        return "narrow"
    return "tensor_cores" if kind == "bf16" else "sgemm"


def narrow_sweep(kind, label, args, calls: int = 5, plans=False) -> dict:
    """The narrow rule's sweep: device ms of the Toeplitz product ``args``
    (x, w, b, act, t_out, shift) on each form that can run it, named, the
    narrow kernel also where its rule would not take the widths (its rule's
    width limit lifted, its shared-memory limit kept), beside the form
    ``"auto"`` picks; with ``plans``, the narrow kernel's too: each column
    chunk and one or two positions a thread forced in turn, beside the
    rules' picks (``toeplitz.narrow_chunk``, ``narrow_rows``)."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores, toeplitz

    x, w, b, act, t_out, shift = args
    B, nb, G = x.shape
    kb, _, N = w.shape
    aligned = tensor_cores.pointers_aligned(x, w, b)
    runs = {"narrow": toeplitz.narrow_smem(G, kb, N, 1, x.element_size())
            <= toeplitz.NARROW_SMEM_BYTES,
            "sgemm": toeplitz.takes_sgemm(x.dtype, B, nb, t_out, G, N,
                                          (0, kb * G), 1, aligned),
            "tensor_cores": toeplitz.takes_tensor_cores(
                x.dtype, B, nb, t_out, G, N, 1, aligned),
            "cuda_cores": True}
    below = toeplitz.NARROW_BELOW
    ms = {}
    try:
        toeplitz.NARROW_BELOW = 1 << 30
        for kernel in (k for k, ok in runs.items() if ok):
            ms[kernel] = device_ms(lambda: toeplitz.toeplitz_fwd(
                x, w, b, act, t_out, shift, kernel=kernel), calls)
    finally:
        toeplitz.NARROW_BELOW = below
    counters = {"narrow": "narrow_launches", "sgemm": "sgemm_launches",
                "tensor_cores": "tensor_core_launches"}
    before = {k: getattr(toeplitz.toeplitz_fwd, c)
              for k, c in counters.items()}
    toeplitz.toeplitz_fwd(x, w, b, act, t_out, shift)
    picked = next((k for k, c in counters.items()
                   if getattr(toeplitz.toeplitz_fwd, c) > before[k]),
                  "cuda_cores")
    print(f"  {'toeplitz_fwd[' + kind + ']':<24} {label} x {tuple(x.shape)} "
          f"w {tuple(w.shape)}: device ms by form "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; the rule picks {picked}")
    if plans:
        rules = {"narrow_chunk": toeplitz.narrow_chunk,
                 "narrow_rows": toeplitz.narrow_rows}
        plan_ms = {}
        try:
            for name, values in (("narrow_chunk", toeplitz.NARROW_CHUNKS),
                                 ("narrow_rows", (1, 2))):
                for v in values:
                    setattr(toeplitz, name, lambda _, v=v: v)
                    if toeplitz.takes_narrow(x.dtype, B, nb, t_out, G, N,
                                             kb, 1, aligned):
                        plan_ms[name, v] = device_ms(
                            lambda: toeplitz.toeplitz_fwd(
                                x, w, b, act, t_out, shift,
                                kernel="narrow"), calls)
                    setattr(toeplitz, name, rules[name])
        finally:
            for name, rule in rules.items():
                setattr(toeplitz, name, rule)
        print(f"  {'toeplitz_fwd[' + kind + ']':<24} {label}: narrow device "
              "ms by column chunk "
              + ", ".join(f"{v}: {t:.4f}" for (n, v), t in plan_ms.items()
                          if n == "narrow_chunk")
              + f" (the rule picks {toeplitz.narrow_chunk(N)}), by "
              "positions a thread "
              + ", ".join(f"{v}: {t:.4f}" for (n, v), t in plan_ms.items()
                          if n == "narrow_rows")
              + f" (the rule picks {toeplitz.narrow_rows(x.dtype)})")
    return ms


def hold_kernel(name, op, make, shapes, timed, kernel="tensor_cores",
                pairs=1, named_raises=False):
    """Phases 3c / 3e: the redesigned form ``kernel`` (``"tensor_cores"``,
    bf16; ``"sgemm"``, fp32) of wrapper ``op`` against its plain version
    and its first version.

    ``make(rows, k, n, what)`` → ``(call, plain, library, tensors)``:
    ``call(kernel)`` runs the wrapper with that ``kernel=``, ``plain()`` its
    plain version and ``library()`` the one PyTorch call, all on the same
    operands ``tensors`` of the kernel's type.  ``shapes`` are held (those
    the kernel cannot take must run the first version), ``timed`` are timed
    in turns with the first version, the plain version and the library
    call, and by the profiler's device time.  ``pairs``: operand pairs
    joined along k (the bound counts ``2 · pairs · rows · k · n``
    operations).  ``named_raises``: a shape that keeps the first version
    must also raise when ``kernel`` is named.  Returns the largest
    absolute error and, by shape, the times."""
    from rawaudiovae_kelsey_tpu_torch.ops import tensor_cores

    fast = FAST[kernel]
    kind, tol, code_fast = fast["kind"], fast["tol"], \
        tensor_cores.KERNEL_CODES[kernel]
    label_of = f"{name}[{kind}]"

    def held(got, want, what):
        check(got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all()),
              f"{label_of} {what}: shape, dtype or non-finite")
        e = rel_err([got], [want])
        check(e <= tol, f"{label_of} {what}: relative error {e:.3e} > "
              f"{tol:.3e}")
        return e

    err = 0.0
    for rows, k, n, what in shapes:
        call, plain, _, tensors = make(rows, k, n, what)
        code = tensor_cores.resolve_kernel(name, "auto", tensors[0].dtype,
                                           rows, k, n)
        before = (op.launches, getattr(op, fast["counter"]))
        got = call("auto")
        torch.cuda.synchronize()
        rose = (op.launches - before[0],
                getattr(op, fast["counter"]) - before[1])
        label = f"{rows}x{k}->{n} {what}".strip()
        check(rose == (1, int(code == code_fast)), f"{label_of} {label}: "
              f"launches / {kernel} launches rose by {rose}")
        want = plain()
        line = (f"  {label_of:<24} {label}: ran "
                f"{kernel if code == code_fast else 'cuda_cores'}; |kernel "
                f"- plain| / max|plain| = {held(got, want, label):.3e}")
        err = max(err, max_err([got.float()], [want.float()]))
        if code == code_fast:
            e1 = held(got, call("cuda_cores"), label + " vs the first version")
            check(torch.equal(got, call("auto")), f"{label_of} {label}: a "
                  "second launch gave other bits")
            line += f", vs the first version {e1:.3e}, equal bits twice"
        elif named_raises:
            try:
                call(kernel)
            except ValueError:
                line += f"; kernel={kernel!r} raised"
            else:
                check(False, f"{label_of} {label}: kernel={kernel!r} did "
                      "not raise")
        print(line + f" (tolerance {tol:.3e})")
    times = {}
    for rows, k, n, what in timed:
        call, plain, library, tensors = make(rows, k, n, what)
        iters = 5 if rows * k * n > 1 << 34 else 20
        ms, runs = time_in_turns(
            {"library": library, "plain": plain,
             "cuda_cores": lambda: call("cuda_cores"),
             kernel: lambda: call(kernel)}, iters)
        ms["device_ms"] = device_ms(lambda: call(kernel))
        ms["first_version_device_ms"] = device_ms(lambda: call("cuda_cores"))
        ms["library_device_ms"] = device_ms(library)
        bd = bound(2 * pairs * rows * k * n, nbytes(*tensors, call("auto")),
                   kind)
        print(f"  {label_of:<24} {rows}x{k}->{n}: {kernel} "
              f"{ms[kernel]:.4f} ms (device time by the profiler "
              f"{ms['device_ms']:.4f} ms), cuda_cores (first version) "
              f"{ms['cuda_cores']:.4f} ms (device "
              f"{ms['first_version_device_ms']:.4f} ms), plain "
              f"{ms['plain']:.4f} ms, library call {ms['library']:.4f} ms "
              f"(device time {ms['library_device_ms']:.4f} ms), bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); device time / "
              f"library's {ms['device_ms'] / ms['library_device_ms']:.3f}, "
              f"/ bound {ms['device_ms'] / bd['bound_ms']:.3f}; runs {runs}")
        times[rows, k, n] = {**ms, **bd}
    # what a call costs the host, at a shape whose kernels are a few µs: an
    # event-timed loop of a kernel shorter than this reads this instead
    call, _, library, _ = make(128, 64, 128, timed[0][3])
    print(f"  {label_of:<24} host time a call, 128x64->128: {kernel} "
          f"{host_us(lambda: call(kernel)):.1f} us, cuda_cores "
          f"{host_us(lambda: call('cuda_cores')):.1f} us, library call "
          f"{host_us(library):.1f} us")
    return err, times


def fast_row(row: dict, err: float, t: dict, kernel="tensor_cores") -> None:
    """Rewrite a kernel-line row from the in-turns times ``t`` of its shape:
    the redesigned kernel's numbers, the first version's beside them."""
    row.update(source=FAST[kernel]["source"],
               max_abs_err=max(row["max_abs_err"], err), ms=t[kernel],
               plain_ms=t["plain"], library_ms=t["library"],
               first_version_ms=t["cuda_cores"], bound_ms=t["bound_ms"],
               bound_by=t["bound_by"])


def write_corpus(root: Path, frames: int, hop: int, seg: int) -> None:
    """``frames`` overlapping training frames of synthetic audio in
    ``root/audio`` (four files) and 3 s in ``root/test_audio``."""
    from rawaudiovae_kelsey_tpu_torch.io import write_wav

    rng = np.random.default_rng(5)
    n = (frames - 1) * hop + seg
    t = np.arange(n) / SR
    wave = (0.3 * np.sin(2 * np.pi * 110 * t * (1 + 0.5 * np.sin(t)))
            + 0.1 * np.sin(2 * np.pi * 1650 * t)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)
    (root / "audio").mkdir(parents=True)
    (root / "test_audio").mkdir()
    cuts = np.linspace(0, n, 5).astype(int) // hop * hop
    cuts[-1] = n
    for k in range(4):
        write_wav(root / "audio" / f"train{k}.wav",
                  wave[cuts[k]:cuts[k + 1]], SR)
    write_wav(root / "test_audio" / "test.wav", wave[:int(3 * SR)], SR)


def phase_train(data: Path, card: str):
    """Phase 5: the training path of configs/default.ini."""
    from rawaudiovae_kelsey_tpu_torch import ops

    # the bf16 dense kernels on the tensor cores; the fp32 ones on
    # csrc/sgemm.cuh
    dense_tc = (ops.encoder_fwd, ops.decoder_fwd, ops.dec_bwd_fused,
                ops.grad_accum, ops.enc_bwd_dw1, ops.grad_accum2)
    fp32_sgemm = (ops.encoder_fwd, ops.decoder_fwd, ops.grad_accum,
                  ops.matmul_nt_mask, ops.matmul_nt2_mask)
    # the `high` step's full chains, on the tensor cores (3-pass), and its
    # forward's 3-pass forms
    full_tc = (ops.enc_bwd_full, ops.dec_bwd_full)
    forward3 = (ops.encoder_fwd, ops.decoder_fwd)
    from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
    from rawaudiovae_kelsey_tpu_torch.config.workspace import iter_runs
    from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
    from rawaudiovae_kelsey_tpu_torch.data.datasets import AudioFrameDataset
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import (
        TrainState,
        latest_checkpoint,
        restore_checkpoint,
    )
    from rawaudiovae_kelsey_tpu_torch.train.cli import main as train_cli

    cfg = load_config(ROOT / "configs" / "default.ini")
    check(cfg.tpu.precision == "bfloat16" and cfg.tpu.backend == "pallas"
          and cfg.tpu.microbatch_size == 8192
          and cfg.training.batch_size == 131072,
          "configs/default.ini is not the bf16 pallas microbatch-8192 "
          "batch-131072 trainer")
    batch, seg, hop = (cfg.training.batch_size, cfg.audio.segment_length,
                       cfg.audio.hop_length)
    frames = batch + 3 * cfg.tpu.microbatch_size + 1234   # full + ragged
    t0 = time.perf_counter()
    write_corpus(data, frames, hop, seg)
    print(f"  corpus: {frames} frames ({frames * hop / SR:.0f} s of audio) "
          f"written in {time.perf_counter() - t0:.1f} s")
    epochs = 2
    cfg.dataset.datapath = str(data)
    cfg.training.epochs = epochs
    cfg.training.checkpoint_interval = 1
    cfg.training.save_best_model_after = 0
    ini = data / "train.ini"
    save_config(cfg, ini)

    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    for w in dense_tc:
        w.tensor_core_launches = 0
    t0 = time.perf_counter()
    train_cli(["--config", str(ini)])
    train_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
    # the bf16 dense kernels' launches on the tensor cores (the run's fp32
    # test-set reconstructions take csrc/sgemm.cuh)
    launches.update((f"{w.__name__}@tc", w.tensor_core_launches)
                    for w in dense_tc)
    print(f"  train command: {epochs} epochs in {train_s:.1f} s (ingest, "
          f"checkpoints and reconstructions included)")
    print(f"  kernel launches in the training run: {launches}")
    for w in ops.TRAINING_KERNELS:
        check(launches[w.__name__] > 0,
              f"{w.__name__} was never launched by the training run")

    runs = iter_runs(data / cfg.extra.description)
    check(len(runs) == 1, f"expected one run dir, found {runs}")
    ws = runs[0]
    n_batches = -(-(frames) // batch)
    losses = read_scalars(ws / "logs", "Loss/Batch")
    totals = read_scalars(ws / "logs", "Loss/train_total")
    check(sorted(losses) == list(range(epochs * n_batches)),
          f"Loss/Batch steps {sorted(losses)}")
    check(all(np.isfinite(v) for v in losses.values()), "non-finite loss")
    tot = [totals[e] for e in range(epochs)]
    print(f"  epoch losses {tot}; per batch "
          f"{[round(losses[k], 6) for k in sorted(losses)]}")
    check(tot[-1] < tot[0], f"the epoch loss did not fall: {tot}")
    want = ["config.ini", "model/best_model.npz", "model/last_model.npz",
            f"model/checkpoints/ckpt_{epochs:05d}.npz",
            f"model/checkpoints/ckpt_{epochs:05d}.json",
            f"audio_logs/test_reconst_{epochs:05d}.wav"]
    for rel in want:
        check((ws / rel).is_file(), f"workspace lacks {rel}")
    check(list((ws / "logs").glob("events.out.tfevents.*")),
          "workspace lacks a TB event file")
    print(f"  workspace {ws.name}: " + ", ".join(want) + ", a TB event file")

    # resume: the last checkpoint, one more epoch
    cfg.training.epochs = epochs + 1
    save_config(cfg, ini)
    train_cli(["--config", str(ini), "--resume"])
    runs = iter_runs(data / cfg.extra.description)
    check(len(runs) == 2, f"the resume made no new run dir: {runs}")
    resumed = read_scalars(runs[1] / "logs", "Loss/Batch")
    check(sorted(resumed) == list(range(epochs * n_batches,
                                        (epochs + 1) * n_batches)),
          f"the resumed run logged steps {sorted(resumed)}")
    meta = json.loads((runs[1] / "model" / "checkpoints"
                       / f"ckpt_{epochs + 1:05d}.json").read_text())
    check(meta["step"] == (epochs + 1) * n_batches, f"resumed meta {meta}")
    print(f"  resume: one more epoch, steps {sorted(resumed)}, losses "
          f"{[round(resumed[k], 6) for k in sorted(resumed)]}")

    # one step from the trained state: kernels vs plain, same noise
    dev = torch.device("cuda")
    dataset = AudioFrameDataset(build_corpus(data / "audio", SR)[0], seg,
                                hop, SR)
    x = torch.from_numpy(next(dataset.batches(batch, seed=99))).to(dev)
    ckpt = latest_checkpoint(runs[1] / "model" / "checkpoints")

    def noise(step, i, shape):
        g = torch.Generator().manual_seed(1000 * step + (i or 0))
        return torch.randn(shape, generator=g)

    # `high` runs the fp32 "full" chains, `highest` the fp32 "primitive"
    # kernels; no precision runs the "split" kernels on fp32 operands
    step_counts = {}
    highest_by_kernel = high_by_kernel = ""
    for precision, rel_tol in (("bfloat16", 5e-2), ("high", 1e-3),
                               ("highest", 1e-3)):
        cfg.tpu.precision = precision
        out = {}
        for backend in ("pallas", "xla"):
            cfg.tpu.backend = backend
            model = build_model(cfg, dev)
            state, _ = restore_checkpoint(ckpt, TrainState.create(
                model.init(torch.Generator().manual_seed(0)), 0))
            before = {n: {k: t.clone() for k, t in q.items()}
                      for n, q in state.params.items()}
            if backend == "pallas":
                for w in ops.KERNEL_WRAPPERS:
                    w.launches = 0
                for w in dense_tc + full_tc:
                    w.tensor_core_launches = 0
                for w in fp32_sgemm:
                    w.sgemm_launches = 0
                for w in forward3:
                    w.split_launches = 0
            step = build_train_step(model, cfg, noise=noise)
            start = state
            state, m = step(start, x)
            if backend == "pallas":
                step_counts[precision] = {w.__name__: w.launches
                                          for w in ops.KERNEL_WRAPPERS}
                step_counts[precision].update(
                    (f"{w.__name__}@tc", w.tensor_core_launches)
                    for w in dense_tc + full_tc)
                step_counts[precision].update(
                    (f"{w.__name__}@sgemm", w.sgemm_launches)
                    for w in fp32_sgemm)
                step_counts[precision].update(
                    (f"{w.__name__}@split", w.split_launches)
                    for w in forward3)
            delta = torch.cat([(state.params[n][k] - before[n][k]).ravel()
                               for n in sorted(before)
                               for k in sorted(before[n])])
            out[backend] = (float(m["loss"]), delta)
            # the `high` and `highest` steps' device time by kernel, once
            # the update has been read
            if backend == "pallas" and precision == "high":
                high_by_kernel = device_time_by_kernel(
                    lambda: step(start, x), top=8, focus={
                        "forward h and h3 (3-pass, SplitBiasRows, ReLU)":
                        "SplitBiasRows<1>",
                        "forward y (3-pass, tanh)": "SplitBiasRows<2>",
                        "encoder heads (3-pass, one two-output walk)":
                        "SplitBiasRows<0>",
                        "anything on sgemm.cuh (none expected)": "sgemm_",
                        "split pass, forward and backward (split.cuh)":
                        "split_",
                        "full chains' dh, dh3, dz (3-pass, SplitRows)":
                        "SplitRows",
                        "full chains' weight gradients (3-pass)":
                        "SplitWgradOut",
                        "weight gradients' slices' sum": "sum_slices",
                        "first-version GEMMs (gemm.cuh)": "::gemm_kernel",
                        "host-to-device copies": "Memcpy HtoD"})
            if backend == "pallas" and precision == "highest":
                highest_by_kernel = device_time_by_kernel(
                    lambda: step(start, x), top=8, focus={
                        "encoder h, decoder h3 and y (sgemm.cuh)":
                        "true, false, ",
                        "encoder heads (sgemm.cuh, one launch)":
                        "sgemm_heads_kernel",
                        "fp32 weight gradients (sgemm.cuh, M-major A)":
                        "false, false, 0>",
                        "matmul_nt dz (sgemm.cuh)": "true, true, 0>",
                        "gated dh3 and joined dh (sgemm.cuh)":
                        "sgemm_gated_kernel",
                        "weight gradients' slices' sum": "sum_slices",
                        "first-version GEMMs (gemm.cuh)": "::gemm_kernel",
                        "host-to-device copies": "Memcpy HtoD"})
        (lk, dk), (lx, dx) = out["pallas"], out["xla"]
        upd = float((dk - dx).norm() / dx.norm())
        print(f"  one {precision} step, kernels vs plain: loss {lk:.7f} vs "
              f"{lx:.7f}; |update difference| / |update| = {upd:.3e} "
              f"(tolerance {rel_tol:g}); max |param difference| = "
              f"{float((dk - dx).abs().max()):.3e}")
        check(abs(lk / lx - 1) <= rel_tol and upd <= rel_tol,
              f"{precision} step: kernels and plain disagree")
    print(f"  kernel launches in the fp32 `high` step: {step_counts['high']}")
    print(f"  kernel launches in the fp32 `highest` step: "
          f"{step_counts['highest']}")
    for w in ops.FULL_KERNELS:
        check(step_counts["high"][w.__name__] > 0,
              f"{w.__name__} was never launched by the fp32 `high` step")
    # the full chains: one launch each a microbatch, every one on the
    # tensor cores (the 3-pass chain of csrc/full.cu)
    micro = -(-batch // cfg.tpu.microbatch_size)
    for w in full_tc:
        name = w.__name__
        seen = (step_counts["high"][name], step_counts["high"][f"{name}@tc"])
        print(f"  {name} launches in the `high` step (all, on the tensor "
              f"cores): {seen}")
        check(seen == (micro, micro), f"`high` step: {seen} {name} launches "
              f"(all, tensor cores), expected {micro} of {micro} on the "
              "tensor cores")
    print(f"  one `high` kernel step by kernel (70.33 ms of device time "
          f"with the forward on csrc/sgemm.cuh, PERF.md section 5): "
          f"{high_by_kernel}")
    for name in ("enc_bwd_dw1", "grad_accum2", "dec_bwd_fused"):
        for precision in ("high", "highest"):
            check(step_counts[precision][name] == 0,
                  f"{name} was launched by the fp32 `{precision}` step")
    for w in ops.PRIMITIVE_KERNELS:
        check(step_counts["highest"][w.__name__] > 0,
              f"{w.__name__} was never launched by the `highest` step")
    # the primitive backward's five weight gradients a microbatch, every
    # one on the fp32 kernel of csrc/sgemm.cuh
    seen = (step_counts["highest"]["grad_accum"],
            step_counts["highest"]["grad_accum@sgemm"])
    print(f"  grad_accum launches in the `highest` step (all, on "
          f"csrc/sgemm.cuh): {seen}")
    check(seen == (5 * micro, 5 * micro), f"`highest` step: {seen} "
          f"grad_accum launches (all, sgemm.cuh), expected {5 * micro} of "
          f"{5 * micro} on csrc/sgemm.cuh")
    # its dh3 and dh (rows 5 and 6): one launch each a microbatch, every
    # one on csrc/sgemm.cuh's gated product
    for name in ("matmul_nt_mask", "matmul_nt2_mask"):
        seen = (step_counts["highest"][name],
                step_counts["highest"][f"{name}@sgemm"])
        print(f"  {name} launches in the `highest` step (all, on "
              f"csrc/sgemm.cuh): {seen}")
        check(seen == (micro, micro), f"`highest` step: {seen} {name} "
              f"launches (all, sgemm.cuh), expected {micro} of {micro} on "
              f"csrc/sgemm.cuh")
    # the fp32 encoder and decoder: one launch each a microbatch of both
    # fp32 steps, every one on csrc/sgemm.cuh under `highest` and on the
    # 3-pass tensor-core chains under `high` (rows 1-2 at passes = 3)
    for name in ("encoder_fwd", "decoder_fwd"):
        seen = {p: (step_counts[p][name], step_counts[p][f"{name}@sgemm"],
                    step_counts[p][f"{name}@split"])
                for p in ("high", "highest")}
        print(f"  {name} launches in the fp32 steps (all, on "
              f"csrc/sgemm.cuh, on the 3-pass tensor cores): {seen}")
        check(seen["highest"] == (micro, micro, 0), f"`highest` step: "
              f"{seen['highest']} {name} launches (all, sgemm.cuh, 3-pass), "
              f"expected {micro} of {micro} on csrc/sgemm.cuh")
        check(seen["high"] == (micro, 0, micro), f"`high` step: "
              f"{seen['high']} {name} launches (all, sgemm.cuh, 3-pass), "
              f"expected {micro} of {micro} on the 3-pass tensor cores")
        check(step_counts["bfloat16"][f"{name}@sgemm"] == 0
              and step_counts["bfloat16"][f"{name}@split"] == 0,
              f"the bf16 step ran {name} on csrc/sgemm.cuh or in 3 passes")
    print(f"  one `highest` kernel step by kernel (132.05 ms of device time "
          f"with the first-version rows 5 and 6, PERF.md section 5): "
          f"{highest_by_kernel}")
    # the bf16 step's encoder, decoder, decoder backward, dW4, encoder
    # backward and the heads' weight gradients: one launch each a
    # microbatch, every one on the tensor cores; the fp32 tiers run them on
    # the fp32 kernel or the first version (and other backward kernels)
    for w in dense_tc:
        name = w.__name__
        seen = {p: (c[name], c[f"{name}@tc"]) for p, c in step_counts.items()}
        print(f"  {name} launches a step (all, on the tensor cores): {seen}")
        check(seen["bfloat16"] == (micro, micro), f"bf16 step: "
              f"{seen['bfloat16']} {name} launches (all, tensor cores), "
              f"expected {micro} of {micro} on the tensor cores")
        check(seen["high"][1] == seen["highest"][1] == 0,
              f"an fp32 step ran {name} on the tensor cores")

    # remat: the bf16 kernel step recomputing its forward in the backward
    cfg.tpu.precision, cfg.tpu.backend = "bfloat16", "pallas"
    remat_pair(cfg, ckpt, x, (ops.encoder_fwd, ops.decoder_fwd),
               (ops.grad_accum, ops.enc_bwd_dw1, ops.grad_accum2,
                ops.dec_bwd_fused), "default.ini bf16", card)

    # training rate of both backends on one device-resident batch, and the
    # device's busy share over kernel steps
    cfg.tpu.precision = "bfloat16"
    rates = {}
    steps = {}
    for backend in ("pallas", "xla"):
        cfg.tpu.backend = backend
        model = build_model(cfg, dev)
        state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                                  0)
        steps[backend] = (build_train_step(model, cfg), state)
        steps[backend][0](state, x)                       # warmup
    order = ("xla", "pallas", "pallas", "xla")
    times = {"xla": [], "pallas": []}
    for backend in order:
        step, state = steps[backend]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, x)
        torch.cuda.synchronize()
        times[backend].append((time.perf_counter() - t0) / 2)
    for backend, ts in times.items():
        rates[backend] = batch / statistics.mean(ts)
        print(f"  training rate, {backend}: {rates[backend]:,.0f} frames/s "
              f"(step {statistics.mean(ts) * 1e3:.1f} ms; runs "
              f"{[round(t * 1e3, 1) for t in ts]} ms)")
    step, state = steps["pallas"]
    print(f"  device busy share over 2 kernel steps: "
          f"{busy_share(lambda: [step(state, x) for _ in range(2)])}")
    focus = {"encoder_fwd hidden + decoder_fwd h3 and y (tensor cores)":
             "BiasActPair",
             "encoder_fwd heads (tensor cores)": "HeadsBias",
             "dec_bwd_fused dh3 + enc_bwd_dw1 dh (tensor cores, gated)":
             "GatePair",
             "enc_bwd_dw1 dh (tensor cores, joined along k)": "JoinedKTiles",
             "dec_bwd_fused dz (tensor cores)": "RoundPair",
             "dW3 db3 + dW4 db4 + dW1 db1 (tensor cores)":
             "WgradTiles<1>",
             "dW21 db21 + dW22 db22 (tensor cores, one launch)":
             "WgradTiles<2>",
             "weight gradients' slices' sum": "sum_slices",
             "first-version GEMMs (gemm.cuh)": "::gemm_kernel"}
    by_kernel = device_time_by_kernel(lambda: step(state, x), top=8,
                                      focus=focus)
    print(f"  one kernel step by kernel (with the first-version grad_accum2 "
          f"the step took 35.63 ms of device time, PERF.md section 5; no "
          f"gain claimed): {by_kernel}")
    return launches, step_counts["highest"], step_counts["high"]


def tee_stdout(fn):
    """Run ``fn()``, echo what it printed, and return it as text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            fn()
        finally:
            sys.__stdout__.write(buf.getvalue())
            sys.__stdout__.flush()
    return buf.getvalue()


def phase_resident(data: Path, card: str):
    """Phase 6: the device-resident path of configs/perf_bf16.ini."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
    from rawaudiovae_kelsey_tpu_torch.config.workspace import iter_runs
    from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
    from rawaudiovae_kelsey_tpu_torch.data.datasets import AudioFrameDataset
    from rawaudiovae_kelsey_tpu_torch.data.loader import (
        feed_dtype,
        prefetch_to_device,
    )
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import mlp
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.parallel import resident as R
    from rawaudiovae_kelsey_tpu_torch.train import TrainState, epoch
    from rawaudiovae_kelsey_tpu_torch.train.cli import main as train_cli

    dev = torch.device("cuda")
    base = load_config(ROOT / "configs" / "perf_bf16.ini")
    t = base.tpu
    check((t.precision, t.backend, t.device_resident, t.resident_shuffle,
           t.rng, base.training.batch_size, base.audio.segment_length,
           base.vae.n_units, base.vae.latent_dim)
          == ("bfloat16", "best", "always", "block", "tpu_prng", 4096, SEG,
              UNITS, LATENT),
          "configs/perf_bf16.ini is not the resident bf16 block-shuffle "
          "tpu_prng batch-4096 trainer")
    batch, seg, hop = base.training.batch_size, SEG, base.audio.hop_length
    corpus, n_samples = build_corpus(data / "audio", SR)
    dataset = AudioFrameDataset(corpus, seg, hop, SR)
    n_frames = len(dataset)
    n_batches = n_frames // batch
    layout = R.choose_layout(n_samples, seg, hop, 2,
                             int(t.resident_budget_gb * (1 << 30)))
    print(f"  corpus: {n_frames} frames ({n_frames * seg * 2 / 1e6:.0f} MB "
          f"in bf16), layout {layout}, {n_batches} batches an epoch")
    check(layout == "frames" and n_batches == 38, "unexpected corpus size")

    def config(**changes):
        cfg = load_config(ROOT / "configs" / "perf_bf16.ini")
        cfg.dataset.datapath = str(data)
        cfg.training.save_best_model_after = 0
        # the kernels by name: the file's `best` is the measured winner, the
        # plain ops (models/registry.py resolve_backend)
        cfg.tpu.backend = "pallas"
        for key, value in changes.items():
            section, name = key.split("__")
            setattr(getattr(cfg, section), name, value)
        return cfg

    # the host loader must never be built on this path
    built = []
    real_prefetch = epoch.prefetch_to_device
    epoch.prefetch_to_device = lambda *a, **k: (
        built.append(1), real_prefetch(*a, **k))[1]

    # --- the trainer: 4 epochs, a boundary after epoch 2, then a resume
    epochs = 4
    cfg = config(training__epochs=epochs, training__checkpoint_interval=2)
    ini = data / "resident.ini"
    save_config(cfg, ini)
    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    out = tee_stdout(lambda: train_cli(["--config", str(ini)]))
    train_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
    print(f"  train command: {epochs} resident epochs in {train_s:.1f} s "
          f"(ingest, upload, checkpoints and reconstructions included)")
    print(f"  kernel launches in the resident run: {launches}")
    steps = epochs * n_batches
    check(launches["reparameterize_prng"] == steps,
          f"the sampler launched {launches['reparameterize_prng']} times "
          f"in {steps} steps")
    for w in ops.TRAINING_KERNELS:
        check(launches[w.__name__] >= steps,
              f"{w.__name__}: {launches[w.__name__]} launches in {steps} "
              "steps")
    check(not built, "the resident run built the host loader")
    for line in ("Device-resident corpus (frames layout)", "[drain] 3 epochs",
                 "[drain] 1 epochs", "====> Resident epochs e2e: 4 epochs",
                 "Checkpoint - Epoch 2"):
        check(line in out, f"the resident run did not print {line!r}")
    runs = iter_runs(data / cfg.extra.description)
    check(len(runs) == 1, f"expected one run dir, found {runs}")
    ws = runs[0]
    losses = read_scalars(ws / "logs", "Loss/Batch")
    totals = read_scalars(ws / "logs", "Loss/train_total")
    check(sorted(losses) == list(range(steps)),
          f"Loss/Batch has {len(losses)} points, expected {steps}")
    check(all(np.isfinite(v) for v in losses.values()), "non-finite loss")
    tot = [totals[e] for e in range(epochs)]
    print(f"  epoch losses {tot}")
    check(tot[-1] < tot[0], f"the epoch loss did not fall: {tot}")
    want = ["config.ini", "model/best_model.npz", "model/last_model.npz",
            "model/checkpoints/ckpt_00002.npz",
            f"model/checkpoints/ckpt_{epochs:05d}.npz",
            "audio_logs/test_reconst_00002.wav",
            f"audio_logs/test_reconst_{epochs:05d}.wav"]
    for rel in want:
        check((ws / rel).is_file(), f"workspace lacks {rel}")
    meta = json.loads((ws / "model" / "checkpoints"
                       / "ckpt_00002.json").read_text())
    check(meta["step"] == 3 * n_batches and meta["epoch"] == 2,
          f"the boundary checkpoint is not the boundary state: {meta}")
    print(f"  workspace {ws.name}: " + ", ".join(want))

    cfg.training.epochs = epochs + 1
    save_config(cfg, ini)
    out = tee_stdout(lambda: train_cli(["--config", str(ini), "--resume"]))
    check(f"Resuming at epoch {epochs}" in out, "the resume did not resume")
    runs = iter_runs(data / cfg.extra.description)
    resumed = read_scalars(runs[1] / "logs", "Loss/Batch")
    check(sorted(resumed) == list(range(steps, steps + n_batches)),
          f"the resumed run logged steps {sorted(resumed)}")
    print(f"  resume: one more epoch, steps {steps}..{steps + n_batches - 1},"
          f" epoch loss {sum(resumed.values()):.6f}")
    check(not built, "the resumed resident run built the host loader")

    # --- one epoch, resident against a host-fed loop fed the same bf16
    # batches: same state, same permutation, same (seeded) noise
    cfg = config(tpu__rng="threefry")
    model = build_model(cfg, dev)
    check(model.backend == "pallas", f"backend {model.backend}")
    data_dev = R.put_resident(corpus, cfg, "frames", dev)
    blk = R.pick_block_rows(n_frames, n_batches, batch)
    check(blk == 32, f"block rows {blk}")

    def perm(epoch_, n):
        return torch.randperm(n, generator=torch.Generator().manual_seed(
            1234 + epoch_))

    def fresh():
        return TrainState.create(
            model.init(torch.Generator().manual_seed(0)), 11)

    run, nb = R.build_resident_epoch(model, cfg, None, n_samples,
                                     layout="frames", perm=perm)
    _, res_losses = run(fresh(), data_dev, 0)
    n_shuffle = n_frames // blk
    sel = perm(0, n_shuffle)[: nb * batch // blk]
    host_frames = data_dev.cpu()
    host_batches = host_frames[: n_shuffle * blk].view(
        n_shuffle, blk, seg)[sel].view(nb, batch, seg)
    step = build_train_step(model, cfg)
    state = fresh()
    fed = []
    for xb in host_batches.unbind(0):
        state, m = step(state, xb.to(dev))
        fed.append(m["loss"].float())
    fed = torch.stack(fed)
    same = torch.equal(res_losses[0], fed)
    print(f"  one epoch, resident vs host-fed on the same bf16 batches: "
          f"losses {'equal bit for bit' if same else 'DIFFER'} "
          f"({float(fed[0]):.7f} .. {float(fed[-1]):.7f})")
    check(same, "the resident epoch's losses differ from the host-fed "
          f"loop's: max |d| {float((res_losses[0] - fed).abs().max()):.3e}")
    del host_frames, host_batches

    # --- one resident epoch at `highest`: the primitive kernels against
    # the plain backend (the sampler gives both the same noise)
    deltas, prim = {}, {}
    fp32_sgemm = (mlp.encoder_fwd, mlp.decoder_fwd, mlp.matmul_nt,
                  mlp.grad_accum, mlp.matmul_nt_mask, mlp.matmul_nt2_mask)
    for backend in ("pallas", "xla"):
        cfg = config(tpu__precision="highest", tpu__backend=backend)
        model = build_model(cfg, dev)
        state = fresh()
        before = torch.cat([t.ravel().clone() for _, t in sorted(
            (f"{n}.{k}", t) for n, q in state.params.items()
            for k, t in q.items())])
        run, _ = R.build_resident_epoch(model, cfg, None, n_samples)
        d32 = R.put_resident(corpus, cfg, "frames", dev)
        if backend == "pallas":
            for w in ops.KERNEL_WRAPPERS:
                w.launches = 0
            on_sgemm = {w: w.sgemm_launches for w in fp32_sgemm}
        state, ls = run(state, d32, 0)
        torch.cuda.synchronize()
        if backend == "pallas":
            prim = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
            prim.update((f"{w.__name__}@sgemm", w.sgemm_launches - n)
                        for w, n in on_sgemm.items())
        after = torch.cat([t.ravel() for _, t in sorted(
            (f"{n}.{k}", t) for n, q in state.params.items()
            for k, t in q.items())])
        deltas[backend] = (after - before, ls[0])
        del d32
    per_step = {k: v / n_batches for k, v in prim.items() if v}
    print(f"  `highest` resident epoch, launches per step: {per_step}")
    check(per_step == {"encoder_fwd": 1, "encoder_fwd@sgemm": 1,
                       "decoder_fwd": 1, "decoder_fwd@sgemm": 1,
                       "matmul_nt2_mask": 1, "matmul_nt2_mask@sgemm": 1,
                       "matmul_nt_mask": 1, "matmul_nt_mask@sgemm": 1,
                       "matmul_nt": 1, "matmul_nt@sgemm": 1, "grad_accum": 5,
                       "grad_accum@sgemm": 5, "reparameterize_prng": 1,
                       "loss_sums": 1, "loss_grads": 1},
          f"unexpected launches per `highest` step (the encoder, the "
          f"decoder, matmul_nt, matmul_nt_mask, matmul_nt2_mask and the "
          f"five grad_accum on the fp32 kernel of csrc/sgemm.cuh, the "
          f"sampler, row 14's sums and gradient): {per_step}")
    (dk, lk), (dx, lx) = deltas["pallas"], deltas["xla"]
    upd = float((dk - dx).norm() / dx.norm())
    print(f"  `highest` resident epoch, kernels vs plain: first loss "
          f"{float(lk[0]):.7f} vs {float(lx[0]):.7f}, last {float(lk[-1]):.7f}"
          f" vs {float(lx[-1]):.7f}; |update difference| / |update| = "
          f"{upd:.3e} (tolerance 1e-3)")
    check(bool(torch.isfinite(lk).all()) and float(lk[-1]) < float(lk[0]),
          "the `highest` resident epoch did not train")
    check(upd <= 1e-3, "`highest` resident epoch: kernels and plain disagree")

    # --- dx through the model's encoder, fp32 and bf16
    cfg = config()
    model = build_model(cfg, dev)
    params = model.init(torch.Generator().manual_seed(3))
    g = torch.Generator(device=dev).manual_seed(3)
    dx_counts = {}
    for kind, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        p = {n: {k: v.to(dt) for k, v in q.items()}
             for n, q in params.items()}
        x = (torch.rand((batch, seg), generator=g, device=dev) * 2 - 1).to(dt)
        cmu = torch.randn((batch, LATENT), generator=g, device=dev).to(dt)
        clv = torch.randn((batch, LATENT), generator=g, device=dev).to(dt)
        for w in ops.KERNEL_WRAPPERS:
            w.launches = 0
        dh_fn = mlp.matmul_nt2_mask
        on_tc = mlp.matmul_nt.tensor_core_launches
        dh_on = (dh_fn.tensor_core_launches, dh_fn.sgemm_launches)
        xx = x.clone().requires_grad_()
        mu, lv = model.encode(p, xx)
        (dx,) = torch.autograd.grad(
            (mu.float() * cmu.float()).sum() + (lv.float() * clv.float())
            .sum(), xx)
        dx_counts[kind] = {w.__name__: w.launches
                           for w in ops.KERNEL_WRAPPERS}
        dx_counts[kind]["matmul_nt2_mask@tc"] = \
            dh_fn.tensor_core_launches - dh_on[0]
        dx_counts[kind]["matmul_nt2_mask@sgemm"] = \
            dh_fn.sgemm_launches - dh_on[1]
        _, _, h = mlp.encoder_fwd_ref(
            *[p[n][k] for n in ("fc1", "fc21", "fc22") for k in ("w", "b")],
            x)
        want = mlp.matmul_nt_ref(mlp.matmul_nt2_mask_ref(
            cmu, p["fc21"]["w"], clv, p["fc22"]["w"], h), p["fc1"]["w"])
        e = rel_err((dx,), (want,))
        tol = GRAD_REL if kind == "fp32" else BF16_REL
        print(f"  dx through model.encode [{kind}], batch {batch}: relative "
              f"error {e:.3e} (tolerance {tol:.3e}); launches "
              f"matmul_nt2_mask {dx_counts[kind]['matmul_nt2_mask']}, "
              f"matmul_nt {dx_counts[kind]['matmul_nt']}")
        check(e <= tol and dx_counts[kind]["matmul_nt2_mask"] == 1
              and dx_counts[kind]["matmul_nt"] == 1, f"dx [{kind}]")
        on_tc = mlp.matmul_nt.tensor_core_launches - on_tc
        check(on_tc == (kind == "bf16"), f"dx [{kind}]: {on_tc} matmul_nt "
              "launches on the tensor cores (bf16 takes them, fp32 does not)")
        # its dh: the tensor cores in bf16, csrc/sgemm.cuh in fp32
        dh_on = (dx_counts[kind]["matmul_nt2_mask@tc"],
                 dx_counts[kind]["matmul_nt2_mask@sgemm"])
        print(f"  dx [{kind}]: matmul_nt2_mask launches on the tensor cores, "
              f"on csrc/sgemm.cuh: {dh_on}")
        check(dh_on == ((1, 0) if kind == "bf16" else (0, 1)),
              f"dx [{kind}]: matmul_nt2_mask launches on the tensor cores, "
              f"on csrc/sgemm.cuh: {dh_on}")

    # --- dx through the `high` step's encoder (the model under the tier, as
    # a step binds it): the forward, dh and dx each in three passes on the
    # tensor cores (phase 3g's forms), the parameter backward the full chain
    from rawaudiovae_kelsey_tpu_torch.models.registry import under_tier

    cfg = config(tpu__precision="high")
    model = under_tier(build_model(cfg, dev), cfg)
    x = torch.rand((batch, seg), generator=g, device=dev) * 2 - 1
    cmu = torch.randn((batch, LATENT), generator=g, device=dev)
    clv = torch.randn((batch, LATENT), generator=g, device=dev)
    three = (mlp.encoder_fwd, mlp.matmul_nt2_mask, mlp.matmul_nt)
    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    for w in three:
        w.split_launches = w.sgemm_launches = 0
    xx = x.clone().requires_grad_()
    mu, lv = model.encode(params, xx)
    (dx,) = torch.autograd.grad((mu * cmu).sum() + (lv * clv).sum(), xx)
    torch.cuda.synchronize()
    dx_counts["high"] = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
    dx_counts["high"].update((f"{w.__name__}@split", w.split_launches)
                             for w in three)
    seen = {w.__name__: (dx_counts["high"][w.__name__],
                         dx_counts["high"][f"{w.__name__}@split"],
                         w.sgemm_launches) for w in three}
    # the plain version of dh and dx on the kernel's own h (phase 3g holds
    # the forward): the same ReLU gate on both sides, where a plain h a
    # few ulps off could flip one h ≈ 0 and move dx by ~1e-2
    enc = [params[n][k] for n in ("fc1", "fc21", "fc22") for k in ("w", "b")]
    _, _, h = mlp.encoder_fwd(*enc, x, passes=3)
    want = mlp.matmul_nt_ref(mlp.matmul_nt2_mask_ref(
        cmu, params["fc21"]["w"], clv, params["fc22"]["w"], h, passes=3),
        params["fc1"]["w"], passes=3)
    e = rel_err((dx,), (want,))
    print(f"  dx through the `high` step's encoder, batch {batch}: relative "
          f"error {e:.3e} against the 3-pass plain version on the kernel's h "
          f"(tolerance "
          f"{GRAD_REL:g}); launches (all, 3-pass tensor cores, sgemm.cuh): "
          f"{seen}; enc_bwd_full {dx_counts['high']['enc_bwd_full']}")
    check(e <= GRAD_REL and all(v == (1, 1, 0) for v in seen.values())
          and dx_counts["high"]["enc_bwd_full"] == 1, "dx [high]")

    # --- the corpus layout under a small budget; the error under none
    cfg = config(training__epochs=1, training__checkpoint_interval=0,
                 tpu__resident_budget_gb=0.1, extra__description="perf_corpus")
    save_config(cfg, ini)
    out = tee_stdout(lambda: train_cli(["--config", str(ini)]))
    check("Device-resident corpus (corpus layout)" in out
          and "[drain] 1 epochs" in out,
          "a 0.1 GB budget did not take the corpus layout")
    cfg.tpu.resident_budget_gb = 0.001
    cfg.extra.description = "perf_nofit"
    save_config(cfg, ini)
    try:
        train_cli(["--config", str(ini)])
    except ValueError as e:
        check("device_resident=always" in str(e), f"unexpected error: {e}")
        print(f"  resident_budget_gb = 0.001: ValueError, as it must "
              f"({str(e)[:60]}...)")
    else:
        check(False, "device_resident = always ran on a corpus that does "
              "not fit")
    check(not built, "a resident run built the host loader")
    epoch.prefetch_to_device = real_prefetch

    # --- epoch rates: resident and host-fed, kernels and plain
    engines = {}
    for backend in ("pallas", "xla"):
        cfg = config(tpu__backend=backend)
        model = build_model(cfg, dev)
        run, _ = R.build_resident_epoch(model, cfg, None, n_samples)
        engines[backend] = (cfg, run, build_train_step(model, cfg),
                            TrainState.create(model.init(
                                torch.Generator().manual_seed(0)), 5))

    def resident_epoch(backend, e):
        cfg, run, _, state = engines[backend]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state, data_dev, e)
        torch.cuda.synchronize()
        return n_batches * batch / (time.perf_counter() - t0)

    def hostfed_epoch(backend, e):
        cfg, _, step, state = engines[backend]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feed = prefetch_to_device(
            dataset.batches(batch, shuffle=True, seed=cfg.tpu.seed + e),
            dev, depth=cfg.tpu.prefetch, cast_dtype=feed_dtype(cfg))
        try:
            for xb in feed:
                step(state, xb)
        finally:
            feed.close()
        torch.cuda.synchronize()
        return n_frames / (time.perf_counter() - t0)

    rates = {(b, k): [] for b in engines for k in ("resident", "host-fed")}
    for backend in engines:                                   # warm-up
        resident_epoch(backend, 0)
        hostfed_epoch(backend, 0)
    for e, backend in enumerate(("xla", "pallas", "pallas", "xla"), 1):
        rates[backend, "resident"].append(resident_epoch(backend, e))
        rates[backend, "host-fed"].append(hostfed_epoch(backend, e))
    for (backend, kind), rs in rates.items():
        label = "kernels" if backend == "pallas" else "plain"
        print(f"  epoch rate, {kind}, {label}: {statistics.mean(rs):,.0f} "
              f"frames/s (runs {[round(r) for r in rs]}) [{card}]")
    _, run, _, state = engines["pallas"]
    print(f"  device busy share over one resident epoch, kernels: "
          f"{busy_share(lambda: run(state, data_dev, 9))} [{card}]")
    return launches, prim, dx_counts


def write_stream_corpus(root: Path, frames: int, hop: int, seg: int) -> None:
    """About ``frames`` streaming frames of synthetic audio in ``root/audio``
    as five files of unequal length (one of them at half the sample rate,
    so the loader resamples it) and 3 s in ``root/test_audio``."""
    from rawaudiovae_kelsey_tpu_torch.io import write_wav

    rng = np.random.default_rng(11)
    n = frames * hop
    t = np.arange(n) / SR
    wave = (0.3 * np.sin(2 * np.pi * 147 * t * (1 + 0.3 * np.sin(0.7 * t)))
            + 0.1 * np.sin(2 * np.pi * 1230 * t)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)
    (root / "audio").mkdir(parents=True)
    (root / "test_audio").mkdir()
    cuts = (np.array([0, 0.07, 0.30, 0.45, 0.81, 1.0]) * n).astype(int)
    for k in range(5):
        part = wave[cuts[k]:cuts[k + 1]]
        if k == 1:
            write_wav(root / "audio" / f"part{k}.wav", part[::2], SR // 2)
        else:
            write_wav(root / "audio" / f"part{k}.wav", part, SR)
    write_wav(root / "test_audio" / "test.wav", wave[:int(3 * SR)], SR)


def phase_stream(tmp: Path):
    """Phase 7: the streaming path of configs/default_iterable.ini, as
    written (bf16) and at ``precision = high``."""
    import itertools
    import shutil

    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
    from rawaudiovae_kelsey_tpu_torch.config.workspace import iter_runs
    from rawaudiovae_kelsey_tpu_torch.data.datasets import (
        StreamingFrameDataset,
    )
    from rawaudiovae_kelsey_tpu_torch.data.loader import (
        feed_dtype,
        prefetch_to_device,
    )
    from rawaudiovae_kelsey_tpu_torch.eval.cli import main as eval_cli
    from rawaudiovae_kelsey_tpu_torch.models import build_model, vae
    from rawaudiovae_kelsey_tpu_torch.models.registry import (
        kernel_loss,
        plain_loss,
        under_tier,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import (
        TrainState,
        latest_checkpoint,
        restore_checkpoint,
    )
    from rawaudiovae_kelsey_tpu_torch.train.cli import main_stream

    base = load_config(ROOT / "configs" / "default_iterable.ini")
    check(base.tpu.precision == "bfloat16" and base.tpu.backend == "pallas"
          and base.training.batch_size == 4096
          and base.training.total_num_frames == 154314100
          and (base.audio.segment_length, base.vae.n_units,
               base.vae.latent_dim) == (SEG, UNITS, LATENT),
          "configs/default_iterable.ini is not the bf16 pallas batch-4096 "
          "1024/2048/256 stream trainer")
    batch, seg, hop = (base.training.batch_size, base.audio.segment_length,
                       base.audio.hop_length)
    n_batches, more, interval = 40, 48, 16
    src = tmp / "corpus"
    t0 = time.perf_counter()
    # about 15 batches a pass: the stream wraps the folder and reshuffles it
    write_stream_corpus(src, 15 * batch, hop, seg)
    print(f"  corpus: five files, ~{15 * batch} frames a pass, written in "
          f"{time.perf_counter() - t0:.1f} s")

    def run(name, precision, batches, resume=False):
        """The ``stream`` command on its own copy of the corpus: only the
        datapath, the frame budget, the two intervals (and the precision,
        for `high`) differ from the file, and a resident budget of 0, so
        that the gate prints its plan and trains host-fed: this phase
        holds the host-fed stream, phase 12 the resident one."""
        data = tmp / name
        if not data.exists():
            shutil.copytree(src, data)
        cfg = load_config(ROOT / "configs" / "default_iterable.ini")
        cfg.dataset.datapath = str(data)
        cfg.training.total_num_frames = batches * batch
        cfg.training.checkpoint_interval = interval
        cfg.tpu.histogram_interval = interval
        cfg.tpu.precision = precision
        cfg.tpu.resident_budget_gb = 0.0
        ini = data / "stream.ini"
        save_config(cfg, ini)
        for w in ops.KERNEL_WRAPPERS:
            w.launches = 0
        for w in (ops.enc_bwd_full, ops.dec_bwd_full):
            w.tensor_core_launches = 0
        t0 = time.perf_counter()
        out = tee_stdout(lambda: main_stream(
            ["--config", str(ini)] + (["--resume"] if resume else [])))
        wall = time.perf_counter() - t0
        ws = iter_runs(data / cfg.extra.description)[-1]
        return cfg, ws, out, wall

    def window_rates(out):
        return [float(ln.split("(")[1].split(" frames/s")[0].replace(",", ""))
                for ln in out.splitlines() if ln.startswith("Checkpoint - ")]

    results = {}
    for name, precision in (("bf16", "bfloat16"), ("high", "high")):
        cfg, ws, out, wall = run(name, precision, n_batches)
        counts = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
        counts.update((f"{w.__name__}@tc", w.tensor_core_launches)
                      for w in (ops.enc_bwd_full, ops.dec_bwd_full))
        check("device_resident=auto" in out and "training host-fed" in out,
              f"{name}: the gate did not say which engine runs")
        losses = read_scalars(ws / "logs", "Loss/Batch")
        check(sorted(losses) == list(range(n_batches)),
              f"{name}: Loss/Batch steps {sorted(losses)}")
        vals = [losses[k] for k in range(n_batches)]
        check(all(np.isfinite(v) for v in vals), f"{name}: non-finite loss")
        head, tail = statistics.mean(vals[:5]), statistics.mean(vals[-5:])
        check(tail < head, f"{name}: the loss did not fall: {head} → {tail}")
        want = ["config.ini", "console_log", "model/best_model.npz",
                "model/last_model.npz"] + [
            f"model/checkpoints/ckpt_{b:05d}.{ext}"
            for b in (interval, 2 * interval, n_batches)
            for ext in ("npz", "json")] + [
            f"audio_logs/test_reconst_{n_batches:05d}.wav"]
        for rel in want:
            check((ws / rel).is_file(), f"{name}: workspace lacks {rel}")
        meta = json.loads((ws / "model" / "checkpoints"
                           / f"ckpt_{interval:05d}.json").read_text())
        check(meta["batch_id"] == interval and meta["step"] == interval + 1,
              f"{name}: checkpoint meta {meta}")
        rates = window_rates(out)
        print(f"  stream[{name}]: {n_batches} batches of {batch} in "
              f"{wall:.1f} s (set-up, checkpoints and reconstructions "
              f"included); loss {head:.6f} → {tail:.6f}; window rates "
              f"{rates} frames/s")
        print(f"  stream[{name}]: kernel launches {counts}")
        results[name] = (cfg, ws, counts, rates)

    # which backward ran: the bf16 run takes the split kernels, the `high`
    # run the full chains, once a step each, and none of the split ones
    _, _, c_bf16, _ = results["bf16"]
    cfg_high, ws_high, c_high, _ = results["high"]
    for w in ops.TRAINING_KERNELS:
        check(c_bf16[w.__name__] >= n_batches,
              f"bf16 stream: {w.__name__} launched {c_bf16[w.__name__]} "
              f"times in {n_batches} steps")
    check(c_bf16["enc_bwd_full"] == 0 and c_bf16["dec_bwd_full"] == 0,
          "bf16 stream: a full chain was launched")
    check(c_high["enc_bwd_full"] == n_batches
          and c_high["dec_bwd_full"] == n_batches,
          f"high stream: full chains launched {c_high['enc_bwd_full']} / "
          f"{c_high['dec_bwd_full']} times in {n_batches} steps")
    # every one on the tensor cores (the 3-pass chain of csrc/full.cu)
    on_tc = (c_high["enc_bwd_full@tc"], c_high["dec_bwd_full@tc"])
    print(f"  stream[high]: full chains on the tensor cores {on_tc} of "
          f"{n_batches} each")
    check(on_tc == (n_batches, n_batches), f"high stream: {on_tc} full "
          f"chain launches on the tensor cores, expected {n_batches} each")
    for split in ("enc_bwd_dw1", "grad_accum2", "dec_bwd_fused",
                  "grad_accum"):
        check(c_high[split] == 0, f"high stream: {split} was launched")

    # one `high` step from the trained state, kernels vs plain, same noise;
    # the fused loss on that step's tensors
    dev = torch.device("cuda")
    ckpt = latest_checkpoint(ws_high / "model" / "checkpoints")
    dataset = StreamingFrameDataset(
        tmp / "high" / "audio", SR, hop, seg, seed=cfg_high.tpu.seed,
        mono=cfg_high.dataset.mono)
    x = torch.from_numpy(next(dataset.batches(batch))).to(dev)

    def noise(step, i, shape):
        g = torch.Generator().manual_seed(7000 + step)
        return torch.randn(shape, generator=g)

    out = {}
    for backend in ("pallas", "xla"):
        cfg_high.tpu.backend = backend
        model = build_model(cfg_high, dev)
        check(model.loss_components is (kernel_loss if backend == "pallas"
                                        else plain_loss),
              f"high {backend}: the model bound {model.loss_components}")
        state, _ = restore_checkpoint(ckpt, TrainState.create(
            model.init(torch.Generator().manual_seed(0)), 0))
        before = {n: {k: t.clone() for k, t in q.items()}
                  for n, q in state.params.items()}
        step_no = state.step
        state, m = build_train_step(model, cfg_high, noise=noise)(state, x)
        delta = torch.cat([(state.params[n][k] - before[n][k]).ravel()
                           for n in sorted(before) for k in sorted(before[n])])
        out[backend] = (float(m["loss"]), delta)
        if backend == "pallas":
            # the step's forward on the same state and noise (its pass
            # count bound as the step binds it), the loss on plain ops
            tiered = under_tier(model, cfg_high)
            with torch.no_grad():
                mu, logvar = tiered.encode(before, x)
                eps = noise(step_no, None, mu.shape).to(dev)
                recon = tiered.decode(
                    before, vae.reparameterize(mu, logvar, eps=eps))
                plain = float(plain_loss(
                    recon, x, mu, logvar, cfg_high.vae.kl_beta, seg,
                    cfg_high.training.loss_reduction.split()[0])[0])
    cfg_high.tpu.backend = "pallas"
    (lk, dk), (lx, dx) = out["pallas"], out["xla"]
    upd = float((dk - dx).norm() / dx.norm())
    print(f"  one high step, full chains vs plain: loss {lk:.7f} vs {lx:.7f}; "
          f"|update difference| / |update| = {upd:.3e} (tolerance 1e-3)")
    check(abs(lk / lx - 1) <= 1e-3 and upd <= 1e-3,
          "high step: kernels and plain disagree")
    print(f"  the plain loss (models/vae.py) on that step's recon, x, mu, "
          f"logvar: {plain:.9f} vs the step's loss on row 14's kernels "
          f"{lk:.9f} (rel {abs(plain / lk - 1):.3e})")
    check(abs(plain / lk - 1) <= 1e-6, "the step's loss differs from the "
          "plain loss")
    # row 14 in each stream run (counters reset before it): the sums and
    # the gradient once a step, bf16 recon / x beside fp32 mu / logvar in
    # the bf16 run, fp32 in the `high` run
    for name, counts in (("bf16", c_bf16), ("high", c_high)):
        seen = (counts["loss_sums"], counts["loss_grads"])
        print(f"  stream[{name}]: loss_sums / loss_grads launched {seen} "
              f"times in {n_batches} steps")
        check(seen == (n_batches, n_batches), f"stream[{name}]: loss_sums "
              f"/ loss_grads launched {seen} times in {n_batches} steps")
    high_counts = c_high

    # resume the bf16 run with a larger budget; a straight run of that
    # budget must log the same losses for the batches the resume trained:
    # the state came back whole and the stream order stayed aligned
    _, ws_more, out_more, _ = run("bf16", "bfloat16", more, resume=True)
    check(f"Resuming at batch {n_batches}" in out_more,
          "the resumed run did not continue at the saved batch_id")
    resumed = read_scalars(ws_more / "logs", "Loss/Batch")
    check(sorted(resumed) == list(range(n_batches, more)),
          f"the resumed run logged steps {sorted(resumed)}")
    _, ws_straight, _, _ = run("straight", "bfloat16", more)
    straight = read_scalars(ws_straight / "logs", "Loss/Batch")
    worst = max(abs(resumed[k] / straight[k] - 1) for k in resumed)
    print(f"  resume: batches {n_batches}-{more - 1} after --resume; against "
          f"a straight {more}-batch run, max loss difference {worst:.3e} "
          f"(relative)")
    check(worst <= 1e-6, "the resumed run's losses differ from a straight "
          "run's: the stream order or the state is off")

    # eval on the resumed run, at z = mu, on the card
    text = tee_stdout(lambda: eval_cli(["--run", str(ws_more),
                                        "--deterministic"]))
    report = json.loads([ln for ln in text.splitlines()
                         if ln.startswith("{")][-1])
    check(report["frames"] == -(-int(3 * SR) // seg)
          and 0 < report["recon_mse"] < 1
          and report["sampling"] == "deterministic", f"eval: {report}")
    print(f"  eval: recon_mse {report['recon_mse']:.6f} over "
          f"{report['frames']} test frames")

    # the hot loop's rate and the device's busy share: the stream's own
    # feed (decode-ahead, pinned prefetch) into the step, 24 batches
    for name, precision in (("bf16", "bfloat16"), ("high", "high")):
        cfg = results[name][0]
        check(cfg.tpu.precision == precision and cfg.tpu.backend == "pallas",
              f"stream[{name}]: config drifted")
        model = build_model(cfg, dev)
        state = TrainState.create(
            model.init(torch.Generator().manual_seed(0)), 0)
        step = build_train_step(model, cfg)
        dataset = StreamingFrameDataset(
            tmp / name / "audio", SR, hop, seg, seed=cfg.tpu.seed,
            mono=cfg.dataset.mono)

        def loop(n, state=state, step=step, dataset=dataset, cfg=cfg):
            feed = prefetch_to_device(
                itertools.islice(dataset.batches(batch), n), dev,
                depth=cfg.tpu.prefetch, cast_dtype=feed_dtype(cfg))
            for b in feed:
                step(state, b)
            feed.close()

        loop(4)                                           # warm the cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(24)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"  stream[{name}] hot loop: {24 * batch / dt:,.0f} frames/s "
              f"({dt / 24 * 1e3:.2f} ms a batch of {batch}); device busy "
              f"share: {busy_share(lambda: loop(24))}")
    return c_bf16, high_counts


RESIDENT_STREAM_BATCHES = 300    # phase 12: the stream wraps the folder
RESIDENT_STREAM_INTERVAL = 100   # checkpoint and histogram boundaries
RESIDENT_STREAM_RATE_BATCHES = 48


def write_resident_stream_corpus(root: Path) -> int:
    """Phase 12's folder, from a numpy seed: 24 wavs of 10-40 s of mixed
    sines and noise at 44.1 kHz (one at 22.05 kHz) and one shorter than a
    segment, about ten minutes in all, and 3 s of test audio.  Returns the
    samples written."""
    from rawaudiovae_kelsey_tpu_torch.io import write_wav

    rng = np.random.default_rng(12)
    (root / "audio").mkdir(parents=True)
    (root / "test_audio").mkdir()
    total = 0
    for k in range(24):
        sr = SR // 2 if k == 5 else SR
        n = int(rng.uniform(10, 40) * sr)
        t = np.arange(n) / sr
        f1, f2 = rng.uniform(80, 400), rng.uniform(600, 3000)
        wave = (0.3 * np.sin(2 * np.pi * f1 * t * (1 + 0.2 * np.sin(t)))
                + 0.1 * np.sin(2 * np.pi * f2 * t)
                + 0.02 * rng.standard_normal(n)).astype(np.float32)
        write_wav(root / "audio" / f"clip{k:02d}.wav", wave, sr)
        total += n
    write_wav(root / "audio" / "short.wav",
              rng.uniform(-0.3, 0.3, SEG // 2).astype(np.float32), SR)
    write_wav(root / "test_audio" / "test.wav",
              (0.3 * np.sin(np.arange(int(3 * SR)) * 0.05)).astype(
                  np.float32), SR)
    return total


def phase_resident_stream(tmp: Path, card: str) -> None:
    """Phase 12: the device-resident stream of configs/default_iterable.ini
    at full width (dense 1024/2048/256, batch 4096, bf16, pallas)."""
    import itertools
    import shutil

    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
    from rawaudiovae_kelsey_tpu_torch.config.workspace import iter_runs
    from rawaudiovae_kelsey_tpu_torch.data import datasets
    from rawaudiovae_kelsey_tpu_torch.data.loader import (
        feed_dtype,
        prefetch_to_device,
    )
    from rawaudiovae_kelsey_tpu_torch.io.native import native_available
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState, stream
    from rawaudiovae_kelsey_tpu_torch.train.cli import main_stream

    base = load_config(ROOT / "configs" / "default_iterable.ini")
    check(base.tpu.precision == "bfloat16" and base.tpu.backend == "pallas"
          and base.training.batch_size == 4096
          and (base.audio.segment_length, base.vae.n_units,
               base.vae.latent_dim) == (SEG, UNITS, LATENT),
          "configs/default_iterable.ini is not the bf16 pallas batch-4096 "
          "1024/2048/256 stream trainer")
    batch, seg, hop = (base.training.batch_size, base.audio.segment_length,
                       base.audio.hop_length)
    n_all, every = RESIDENT_STREAM_BATCHES, RESIDENT_STREAM_INTERVAL
    print(f"  native codec: {'C++ (io/native.py)' if native_available() else 'numpy (the library did not build)'}")
    src = tmp / "corpus"
    t0 = time.perf_counter()
    n_samples = write_resident_stream_corpus(src)
    ds = datasets.StreamingFrameDataset(src / "audio", SR, hop, seg)
    n_frames = stream._estimate_stream_frames(ds, base)[0]
    print(f"  corpus: 25 wavs, {n_samples:,} samples "
          f"({n_samples / SR / 60:.1f} min), {n_frames:,} frames a pass, "
          f"written in {time.perf_counter() - t0:.1f} s")
    check(n_all * batch > 3 * n_frames, "the stream does not wrap the "
          "folder several times")

    dense_tc = (ops.encoder_fwd, ops.decoder_fwd, ops.grad_accum,
                ops.enc_bwd_dw1, ops.grad_accum2, ops.dec_bwd_fused)
    full_tc = (ops.enc_bwd_full, ops.dec_bwd_full)
    # the host-fed feed: counted wherever a run builds it
    fed = [0]
    real_batches = datasets.StreamingFrameDataset.batches

    def counted_batches(self, *a, **kw):
        fed[0] += 1
        return real_batches(self, *a, **kw)

    datasets.StreamingFrameDataset.batches = counted_batches

    def run(name, batches, resume=False, **tpu):
        """The ``stream`` command on its own copy of the folder: only the
        datapath, the frame budget, the two intervals and the [tpu] keys
        named differ from the file."""
        data = tmp / name
        if not data.exists():
            shutil.copytree(src, data)
        cfg = load_config(ROOT / "configs" / "default_iterable.ini")
        cfg.dataset.datapath = str(data)
        cfg.training.total_num_frames = batches * batch
        cfg.training.checkpoint_interval = every
        cfg.tpu.histogram_interval = every
        for key, value in tpu.items():
            setattr(cfg.tpu, key, value)
        ini = data / "stream.ini"
        save_config(cfg, ini)
        for w in ops.KERNEL_WRAPPERS:
            w.launches = 0
        for w in dense_tc + full_tc:
            w.tensor_core_launches = 0
        for w in dense_tc[:2]:
            w.sgemm_launches = 0
        fed[0] = 0
        t0 = time.perf_counter()
        out = tee_stdout(lambda: main_stream(
            ["--config", str(ini)] + (["--resume"] if resume else [])))
        wall = time.perf_counter() - t0
        ws = iter_runs(data / cfg.extra.description)[-1]
        counts = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
        counts.update((f"{w.__name__}@tc", w.tensor_core_launches)
                      for w in dense_tc + full_tc)
        counts.update((f"{w.__name__}@sgemm", w.sgemm_launches)
                      for w in dense_tc[:2])
        return ws, out, wall, counts, fed[0]

    def resident_checks(name, out, counts, steps, layout, n_fed, full=False):
        check(f"MB on device, {layout} layout)" in out,
              f"{name}: no Device-resident stream line naming the "
              f"{layout} layout")
        check(n_fed == 0, f"{name}: the host-fed feed was built")
        if full:
            for w in full_tc:
                n = (counts[w.__name__], counts[f"{w.__name__}@tc"])
                check(n == (steps, steps), f"{name}: {w.__name__} launched "
                      f"{n} (all, tensor cores) in {steps} steps")
            return
        for w in dense_tc:
            n, tc = counts[w.__name__], counts[f"{w.__name__}@tc"]
            # rows 1-2 also run the fp32 test-set reconstructions on
            # csrc/sgemm.cuh; no launch takes a first version
            other = counts.get(f"{w.__name__}@sgemm", 0)
            check(tc == steps and n == tc + other,
                  f"{name}: {w.__name__} {n} launches, {tc} on the tensor "
                  f"cores, {other} on sgemm.cuh, in {steps} steps")
        check(counts["enc_bwd_full"] == counts["dec_bwd_full"] == 0,
              f"{name}: a full chain was launched")

    def losses_of(ws, steps):
        got = read_scalars(ws / "logs", "Loss/Batch")
        check(sorted(got) == list(steps), f"Loss/Batch steps {sorted(got)}")
        return got

    # the resident stream, samples layout: the working set beside the corpus
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ws_s, out_s, wall_s, c_s, fed_s = run(
        "samples", n_all, device_resident="always",
        resident_layout="samples")
    peak = torch.cuda.max_memory_allocated() - resident_before
    resident_checks("samples", out_s, c_s, n_all, "samples", fed_s)
    corpus_mb = float(re.search(r"Device-resident stream: [\d,]+ frames "
                                r"\(([\d,]+) MB on device",
                                out_s).group(1).replace(",", ""))
    losses = losses_of(ws_s, range(n_all))
    vals = [losses[k] for k in range(n_all)]
    check(all(np.isfinite(v) for v in vals), "samples: non-finite loss")
    head, tail = statistics.mean(vals[:10]), statistics.mean(vals[-10:])
    check(tail < head, f"samples: the loss did not fall: {head} → {tail}")
    e2e = re.search(r"Resident stream e2e: .*", out_s).group(0)
    print(f"  resident[samples]: {n_all} batches of {batch} in {wall_s:.1f} s "
          f"(the command, set-up included); loss {head:.6f} → {tail:.6f}; "
          f"{e2e}")
    print(f"  resident[samples]: peak device memory {peak / 1e6:,.0f} MB "
          f"(torch.cuda.max_memory_allocated), of it the corpus "
          f"{corpus_mb:,.0f} MB: working set {peak / 1e6 - corpus_mb:,.0f} MB "
          f"(the gate keeps {stream.RESIDENT_STEP_BYTES / 1e6:,.0f} MB) "
          f"[{card}]")
    check(peak - corpus_mb * 1e6 <= stream.RESIDENT_STEP_BYTES,
          "the resident step's working set exceeds what the gate keeps")
    print(f"  resident[samples]: kernel launches {c_s}")

    # the frames layout: the same bits
    ws_f, out_f, _, c_f, fed_f = run(
        "frames", n_all, device_resident="always", resident_layout="frames")
    resident_checks("frames", out_f, c_f, n_all, "frames", fed_f)
    check(losses_of(ws_f, range(n_all)) == losses,
          "the frames layout's losses differ from the samples layout's")
    last = f"model/checkpoints/ckpt_{n_all:05d}.npz"
    check((ws_f / last).read_bytes() == (ws_s / last).read_bytes(),
          "the frames layout's final state differs from the samples "
          "layout's")
    print(f"  resident[frames]: {n_all} losses and the final checkpoint "
          "equal the samples layout's, bit for bit")

    # the host-fed stream, bf16 feed: the first `every` batches' bits
    ws_h, out_h, _, _, fed_h = run("fed", every, device_resident="never",
                                   feed_dtype="bfloat16")
    check(fed_h > 0 and "Device-resident" not in out_h,
          "the host-fed run did not build its feed")
    fed_losses = losses_of(ws_h, range(every))
    check(all(fed_losses[k] == losses[k] for k in range(every)),
          "the host-fed stream's losses differ from the resident one's")
    ck = f"model/checkpoints/ckpt_{every:05d}.npz"
    check((ws_h / ck).read_bytes() == (ws_s / ck).read_bytes(),
          f"the host-fed state after {every} batches differs from the "
          "resident one's")
    print(f"  host-fed (feed_dtype = bfloat16): {every} losses and the state "
          f"after {every} batches equal the resident run's, bit for bit")

    # --resume from the first checkpoint: the straight run's bits
    run("resume", every, device_resident="always")
    ws_r, out_r, _, c_r, fed_r = run("resume", n_all, resume=True,
                                     device_resident="always")
    check(f"Resuming at batch {every}" in out_r, "the resumed run did not "
          "continue at the saved batch_id")
    resident_checks("resume", out_r, c_r, n_all - every, "samples", fed_r)
    resumed = losses_of(ws_r, range(every, n_all))
    check(all(resumed[k] == losses[k] for k in resumed),
          "the resumed run's losses differ from the straight run's")
    check((ws_r / last).read_bytes() == (ws_s / last).read_bytes(),
          "the resumed run's final state differs from the straight run's")
    print(f"  resume from batch {every}: losses {every}-{n_all - 1} and the "
          "final checkpoint equal the straight run's, bit for bit")

    # precision = high: the 3-pass chains once a step, on the tensor cores
    n_high = every
    ws_hi, out_hi, _, c_hi, fed_hi = run(
        "high", n_high, device_resident="always", precision="high")
    resident_checks("high", out_hi, c_hi, n_high, "samples", fed_hi,
                    full=True)
    vals = [v for _, v in sorted(losses_of(ws_hi, range(n_high)).items())]
    check(all(np.isfinite(v) for v in vals)
          and statistics.mean(vals[-10:]) < statistics.mean(vals[:10]),
          "high: the loss is not finite and falling")
    print(f"  resident[high]: {n_high} steps, enc_bwd_full / dec_bwd_full "
          f"{c_hi['enc_bwd_full@tc']} / {c_hi['dec_bwd_full@tc']} on the "
          f"tensor cores; loss {vals[0]:.6f} → {vals[-1]:.6f}")

    # the gate
    need = {"samples": None, "frames": None}
    plan_cfg = load_config(ROOT / "configs" / "default_iterable.ini")
    for layout in need:
        plan_cfg.tpu.resident_layout = layout
        need[layout] = stream.resident_plan(ds, plan_cfg,
                                            torch.device("cuda")).need_bytes
    budget_gb = (need["samples"] + need["frames"]) / 2 / (1 << 30)
    _, out_g, _, _, fed_g = run("gate", 4, resident_budget_gb=budget_gb)
    check("samples layout)" in out_g and fed_g == 0,
          "auto with a budget between the layouts did not train resident "
          "in the samples layout")
    _, out_g, _, _, fed_g = run("gate", 4, resident_budget_gb=budget_gb,
                                resident_layout="frames")
    check("device_resident=auto" in out_g and "frames layout" in out_g
          and "does not fit" in out_g and "training host-fed" in out_g
          and fed_g > 0, "auto in the frames layout over budget did not "
          "train host-fed and print the plan")
    try:
        run("gate", 4, device_resident="always", resident_budget_gb=0.0)
        raised = None
    except ValueError as err:
        raised = err
    check(raised is not None and "does not fit" in str(raised),
          "always with a budget of 0 did not raise ValueError")
    print(f"  gate: samples {need['samples'] / 1e6:,.0f} MB, frames "
          f"{need['frames'] / 1e6:,.0f} MB; a {budget_gb * (1 << 30) / 1e6:,.0f}"
          f" MB budget trains resident (samples) and host-fed (frames); "
          f"always at 0 raised: {raised}")
    datasets.StreamingFrameDataset.batches = real_batches

    # frames/s of the two engines' hot loops on the same config, in turns
    cfg = load_config(ROOT / "configs" / "default_iterable.ini")
    cfg.tpu.feed_dtype = "bfloat16"
    dev = torch.device("cuda")
    model = build_model(cfg, dev)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)), 0)
    step = build_train_step(model, cfg)
    res_ds = datasets.StreamingFrameDataset(src / "audio", SR, hop, seg,
                                            seed=cfg.tpu.seed)
    data, starts, _ = stream.upload_corpus(res_ds, cfg, "samples", dev)
    plan = res_ds.index_batches(batch)
    fed_ds = datasets.StreamingFrameDataset(src / "audio", SR, hop, seg,
                                            seed=cfg.tpu.seed)
    fed_iter = fed_ds.batches(batch)
    n = RESIDENT_STREAM_RATE_BATCHES

    def resident(n=n):
        chunks = (np.stack(list(itertools.islice(plan, 16)))
                  for _ in range(n // 16))
        staged = prefetch_to_device(chunks, dev, depth=3)
        for idx in staged:
            for xb in stream.chunk_rows(data, starts, idx, seg, True):
                step(state, xb)
        staged.close()

    def host_fed(n=n):
        feed = prefetch_to_device(itertools.islice(fed_iter, n), dev,
                                  depth=cfg.tpu.prefetch,
                                  cast_dtype=feed_dtype(cfg))
        for b in feed:
            step(state, b)
        feed.close()

    loops = {"resident": resident, "host-fed": host_fed}
    for fn in loops.values():
        fn(16)                                                # warm up
    rates = {name: [] for name in loops}
    for name in ("resident", "host-fed", "host-fed", "resident"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops[name]()
        torch.cuda.synchronize()
        rates[name].append(n * batch / (time.perf_counter() - t0))
    for name, fn in loops.items():
        print(f"  stream hot loop, {name}: "
              f"{statistics.mean(rates[name]):,.0f} frames/s (runs "
              f"{[round(r) for r in rates[name]]}); device busy share: "
              f"{busy_share(fn)} [{card}]")


def http_request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200,
              f"{method} {path}: HTTP {resp.status} {data[:300]!r}")
        return data
    finally:
        conn.close()


def npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def phase_serve(run_dir, audio, quantize):
    """One server's worth of real requests; returns the responses and the
    median /reconstruct latency."""
    from rawaudiovae_kelsey_tpu_torch.config import load_config
    from rawaudiovae_kelsey_tpu_torch.infer.http import HttpInferenceServer
    from rawaudiovae_kelsey_tpu_torch.io.wavio import (
        decode_wav_bytes,
        encode_wav_bytes,
    )
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.train import load_params

    # what `python -m rawaudiovae_kelsey_tpu_torch serve --run <run_dir>
    # [--quantize]` does, with port 0 and deterministic sampling
    cfg = load_config(run_dir / "config.ini")
    model = build_model(cfg, "cuda")
    check(model.backend == "pallas", f"backend {model.backend}")
    params = load_params(run_dir / "model" / "best_model.npz",
                         model.init(torch.Generator().manual_seed(0)))
    server = HttpInferenceServer(
        model, params, sampling_rate=cfg.audio.sampling_rate, port=0,
        batch_size=BATCH, deterministic=True, quantize=quantize, warmup=True)
    t0 = time.perf_counter()
    server.start()
    print(f"  server up (warmup included) in "
          f"{time.perf_counter() - t0:.2f} s, port {server.port}")
    seg, lat = cfg.audio.segment_length, cfg.vae.latent_dim
    body = encode_wav_bytes(audio, SR)
    out = {}
    try:
        info = json.loads(http_request(server.port, "GET", "/healthz"))
        check(info["status"] == "ok" and info["segment_length"] == seg
              and info["latent_dim"] == lat, f"healthz {info}")
        lat_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            data = http_request(server.port, "POST", "/reconstruct", body)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
        out["flat"], sr = decode_wav_bytes(data)
        check(sr == SR, f"reconstruct sr {sr}")
        data = http_request(server.port, "POST",
                            "/reconstruct?hop=128&ola=1", body)
        out["ola"], _ = decode_wav_bytes(data)
        with np.load(io.BytesIO(http_request(server.port, "POST",
                                             "/encode", body))) as npz:
            out["mu"], out["logvar"] = npz["mu"], npz["logvar"]
        z = out["mu"][:7]
        out["decode"], _ = decode_wav_bytes(http_request(
            server.port, "POST", "/decode", npz_bytes(z=z)))
        out["interp"], _ = decode_wav_bytes(http_request(
            server.port, "POST", "/interpolate?alphas=0,0.5,1",
            npz_bytes(a=audio, b=audio[::-1].copy())))
    finally:
        server.stop()
    n_frames = -(-len(audio) // seg)
    n_hop = (len(audio) + (-len(audio) % 128)) // 128 - seg // 128 + 1
    shapes = {
        "flat": (n_frames * seg, 1), "ola": ((n_hop - 1) * 128 + seg, 1),
        "mu": (n_frames, lat), "logvar": (n_frames, lat),
        "decode": (7 * seg, 1), "interp": (3 * n_frames * seg, 1),
    }
    for k, shape in shapes.items():
        check(out[k].shape == shape, f"{k}: shape {out[k].shape} != {shape}")
        check(bool(np.isfinite(out[k]).all()), f"{k}: non-finite values")
    label = "int8" if quantize else "fp32"
    print(f"  {label}: healthz ok; reconstruct {out['flat'].shape[0]} "
          f"samples, hop+OLA {out['ola'].shape[0]}, encode {out['mu'].shape}"
          f", decode {out['decode'].shape[0]}, interpolate "
          f"{out['interp'].shape[0]}; all finite")
    print(f"  {label}: POST /reconstruct of {CLIP_S:g} s of audio: "
          f"median {statistics.median(lat_ms):.2f} ms (runs "
          f"{[round(t, 2) for t in lat_ms]})")
    return out, statistics.median(lat_ms)


def four_pass_library(x, w, b, act, t_out, shift):
    """``toeplitz_fwd(x, w, b, act, t_out, shift, passes=4)`` as library
    calls (:data:`FOUR_PASS_LIBRARY`), or None where the card's PyTorch has
    no bf16 product with an fp32 output."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear, mlp, toeplitz

    B, nb, G = x.shape
    kb, _, N = w.shape

    def mm(u, v):
        return torch.mm(u, v, out_dtype=torch.float32)

    def run():
        xh, xl = (t.to(torch.bfloat16) for t in mlp.split_hi_lo(x))
        wh, wl = (t.to(torch.bfloat16) for t in mlp.split_hi_lo(w))
        acc = torch.zeros((B, t_out, N), device=x.device)
        for j, o, a, e in toeplitz.tap_ranges(kb, shift, t_out, nb):
            uh, ul = (v[:, a + o:e + o].reshape(-1, G) for v in (xh, xl))
            p = ((mm(uh, wh[j]) + mm(ul, wl[j]))
                 + (mm(uh, wl[j]) + mm(ul, wh[j])))
            acc[:, a:e] += p.view(B, e - a, N)
        return linear.apply_act(act, acc + b)

    try:
        probe = torch.zeros((16, 16), device=x.device, dtype=torch.bfloat16)
        mm(probe, probe)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        print(f"  toeplitz_fwd[4-pass]: no bf16 product with an fp32 output "
              f"in this PyTorch ({type(e).__name__}: {str(e)[:80]})")
        return None
    return run


def phase_variant_kernels():
    """Phase 3e: linear_ksplit_fwd, linear_fwd and toeplitz_fwd against
    their plain versions."""
    import torch.nn.functional as F

    from rawaudiovae_kelsey_tpu_torch.models import variants
    from rawaudiovae_kelsey_tpu_torch.ops import conv, linear, toeplitz

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    lin_src = "rawaudiovae_kelsey_tpu_torch/csrc/linear.cu"
    tpu_lin = "rawaudiovae_kelsey_tpu/ops/pallas_linear.py"
    rows = {}

    def lin_operands(batch, k, n, dt):
        x = torch.randn((batch, k), generator=g, device=dev)
        w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
        b = torch.randn((n,), generator=g, device=dev) * 0.1
        return x.to(dt), w.to(dt), b.to(dt)

    def held(name, kind, got, want, tol, what):
        check(got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all()),
              f"{name}[{kind}] {what}: shape/dtype {tuple(got.shape)} "
              f"{got.dtype} vs {tuple(want.shape)} {want.dtype}, or "
              "non-finite")
        e = rel_err([got], [want])
        print(f"  {name + '[' + kind + ']':<24} {what}: max |kernel - plain|"
              f" / max|plain| = {e:.3e} (tolerance {tol:.3e})")
        check(e <= tol, f"{name}[{kind}] {what}: relative error {e:.3e} > "
              f"{tol:.3e}")
        return max_err([got.float()], [want.float()])

    linear_cases = {
        "linear_ksplit_fwd": (
            linear.linear_ksplit_fwd, linear.linear_ksplit_fwd_ref,
            f"{tpu_lin}:77",
            [(DEEP_BATCH, 4096, 4096, "relu"), (DEEP_BATCH, 1024, 512, "none"),
             (4097, 1088, 544, "tanh")]),
        "linear_fwd": (
            linear.linear_fwd, linear.linear_fwd_ref, f"{tpu_lin}:119",
            [(DEEP_BATCH, 512, 256, "none"),
             (SERVE_BATCH, 4096, 4096, "tanh"), (96, 384, 640, "relu")]),
    }
    for name, (kernel, plain, replaces, shapes) in linear_cases.items():
        for kind, dt in dtypes.items():
            err = 0.0
            for batch, k, n, act in shapes:
                x, w, b = lin_operands(batch, k, n, dt)
                before = kernel.launches
                got = kernel(x, w, b, act)
                torch.cuda.synchronize()
                check(kernel.launches == before + 1,
                      f"{name}: the launch was not counted")
                err = max(err, held(name, kind, got, plain(x, w, b, act),
                                    VARIANT_REL[kind],
                                    f"{batch}x{k}->{n} {act}"))
                if name == "linear_ksplit_fwd":
                    check(linear.ksplit_slices(k) > 1,
                          f"{name}: k = {k} is one slice")
                    again = kernel(x, w, b, act)
                    torch.cuda.synchronize()
                    check(torch.equal(got, again), f"{name}[{kind}] "
                          f"{batch}x{k}->{n}: a second launch gave other bits")
            # timed at the first shape: the main path's (the deep model's
            # 4096->4096 layer; its 512->256 latent head)
            batch, k, n, act = shapes[0]
            x, w, b = lin_operands(batch, k, n, dt)
            iters = 5 if k * n > 1 << 22 else 30
            ms, plain_ms, t_kern, t_plain = time_both(
                lambda: kernel(x, w, b, act), lambda: plain(x, w, b, act),
                iters)
            lib_ms = cuda_time_ms(lambda: torch.addmm(b, x, w), iters)
            print(f"  {name + '[' + kind + ']':<24} {batch}x{k}->{n}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.addmm "
                  f"{lib_ms:.4f} ms (runs {t_kern} / {t_plain})")
            rows[f"{name}[{kind}]"] = {
                "name": f"{name}[{kind}]", "route": "cuda", "source": lin_src,
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                **bound(2 * batch * k * n,
                        nbytes(x, w, b, kernel(x, w, b, act)), kind),
                "library_ms": lib_ms}
            if name == "linear_ksplit_fwd":
                # the same layer through the whole-k kernel, and the server's
                # largest layer through it
                whole = cuda_time_ms(lambda: linear.linear_fwd(x, w, b, act),
                                     iters)
                row = rows[f"{name}[{kind}]"]
                print(f"  {'linear_fwd[' + kind + ']':<24} {batch}x{k}->{n} "
                      f"(the k-split kernel's shape): {whole:.4f} ms, "
                      f"k-split / whole-k = {ms / whole:.3f}, torch.addmm "
                      f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']})")
            else:
                # (the operands of the server's 256x4096->4096, timed below
                # in both dtypes: the draws after it stay as they were)
                lin_operands(SERVE_BATCH, 4096, 4096, dt)

    # bf16 linear_ksplit_fwd on the tensor cores: the deep model's seven
    # k-split layers at its batch (six distinct shapes), ragged shapes with
    # every activation, shapes TMA cannot take
    # (a generator of its own: the Toeplitz draws below stay as they were)
    g_tc = torch.Generator(device=dev).manual_seed(32)

    def tc_operands(batch, k, n, what):
        act = what.split()[0]
        x = torch.randn((batch, k), generator=g_tc, device=dev)
        if what.endswith("x = 0"):
            x.zero_()
        x = x.to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g_tc, device=dev) / k ** 0.5
             ).to(torch.bfloat16)
        b = (torch.randn((n,), generator=g_tc, device=dev) * 0.1
             ).to(torch.bfloat16)
        return (lambda kernel: linear.linear_ksplit_fwd(x, w, b, act,
                                                        kernel=kernel),
                lambda: linear.linear_ksplit_fwd_ref(x, w, b, act),
                lambda: torch.addmm(b, x, w), (x, w, b))

    deep = [(4096, 4096), (4096, 2048), (2048, 1024), (1024, 512),
            (1024, 2048), (2048, 4096)]
    for k, n in deep:
        check(linear.takes_ksplit(DEEP_BATCH, k, n), f"{k}->{n} is no "
              "k-split layer")
    big, small = (DEEP_BATCH, 4096, 4096), (DEEP_BATCH, 1024, 512)
    err, times = hold_kernel(
        "linear_ksplit_fwd", linear.linear_ksplit_fwd, tc_operands,
        [(DEEP_BATCH, k, n, "relu") for k, n in deep]
        + [(*big, "tanh"), (1024, 1024, 512, "relu x = 0")]
        + [(*sh, act) for sh in TC_RAGGED for act in ("none", "relu", "tanh")]
        + [(*sh, "relu") for sh in NO_TMA],
        [(*big, "relu"), (*small, "relu")])
    fast_row(rows["linear_ksplit_fwd[bf16]"], err, times[big])
    for k, n in ((1024, 512), (2048, 1024)):
        sweep_tiles("linear_ksplit_fwd", f"{DEEP_BATCH}x{k}->{n}",
                    tc_operands(DEEP_BATCH, k, n, "relu")[0],
                    (DEEP_BATCH // 128, n))

    # bf16 linear_fwd on the tensor cores: the deep model's four whole-k
    # layers at its batch (the 512 -> 256 heads twice a forward), the
    # server's largest layer, ragged shapes, shapes TMA cannot take
    def fwd_operands(batch, k, n, what):
        call, _, library, tensors = tc_operands(batch, k, n, what)
        x, w, b = tensors
        act = what.split()[0]
        return (lambda kernel: linear.linear_fwd(x, w, b, act, kernel=kernel),
                lambda: linear.linear_fwd_ref(x, w, b, act), library, tensors)

    whole_k = [(DEEP_BATCH, 512, 256, "none"), (DEEP_BATCH, 256, 512, "relu"),
               (DEEP_BATCH, 512, 1024, "relu"),
               (SERVE_BATCH, 4096, 4096, "tanh")]
    err, times = hold_kernel(
        "linear_fwd", linear.linear_fwd, fwd_operands,
        whole_k + [(*sh, act) for sh in TC_RAGGED
                   for act in ("none", "relu", "tanh")]
        + [(*sh, "relu") for sh in NO_TMA], whole_k)
    fast_row(rows["linear_fwd[bf16]"], err, times[whole_k[0][:3]])

    def forward(key):
        return sum(times[sh[:3]][key] * c
                   for sh, c in zip(whole_k, (2, 1, 1)))

    print(f"  {'linear_fwd[bf16]':<24} the four whole-k launches of a deep "
          f"forward (512->256 twice, 256->512, 512->1024): device time "
          f"{forward('device_ms'):.4f} ms, torch.addmm "
          f"{forward('library_device_ms'):.4f} ms (no activation), bound "
          f"{forward('bound_ms'):.4f} ms")
    for batch, k, n, act in whole_k:
        sweep_tiles("linear_fwd", f"{batch}x{k}->{n}",
                    fwd_operands(batch, k, n, act)[0], (-(-batch // 128), n))

    # fp32 linear_fwd on the register-tiled kernel (csrc/sgemm.cuh): the
    # deep server's eleven launches at its batch (nine distinct shapes), the
    # deep heads at the training batch, 4096^3, ragged shapes with every
    # activation, shapes it cannot take (a generator of its own, as above)
    g_sg = torch.Generator(device=dev).manual_seed(33)

    def fwd32_operands(batch, k, n, what):
        act = what.split()[0]
        x = torch.randn((batch, k), generator=g_sg, device=dev)
        w = torch.randn((k, n), generator=g_sg, device=dev) / k ** 0.5
        b = torch.randn((n,), generator=g_sg, device=dev) * 0.1
        return (lambda kernel: linear.linear_fwd(x, w, b, act, kernel=kernel),
                lambda: linear.linear_fwd_ref(x, w, b, act),
                lambda: torch.addmm(b, x, w), (x, w, b))

    server = [(SERVE_BATCH, k, n, act) for (k, n), act in
              {(k, n): act for k, n, act in SERVER_LAYERS}.items()]
    timed = server + [(DEEP_BATCH, 512, 256, "none"),
                      (DEEP_BATCH, 4096, 4096, "relu")]
    err, times = hold_kernel(
        "linear_fwd", linear.linear_fwd, fwd32_operands,
        timed + [(*sh, act) for sh in SGEMM_RAGGED
                 for act in ("none", "relu", "tanh")]
        + [(*sh, "relu") for sh in NO_SGEMM], timed, kernel="sgemm")
    widest = (SERVE_BATCH, 4096, 4096)
    fast_row(rows["linear_fwd[fp32]"], err, times[widest], "sgemm")

    def served(key):
        return sum(times[SERVE_BATCH, k, n][key] for k, n, _ in SERVER_LAYERS)

    print(f"  {'linear_fwd[fp32]':<24} the deep server's eleven launches at "
          f"batch {SERVE_BATCH}: device time {served('device_ms'):.4f} ms, "
          f"first version {served('first_version_device_ms'):.4f} ms, "
          f"torch.addmm {served('library_device_ms'):.4f} ms (no "
          f"activation), bound {served('bound_ms'):.4f} ms")
    for batch, k, n, act in timed:
        sweep_tiles("linear_fwd", f"{batch}x{k}->{n}",
                    fwd32_operands(batch, k, n, act)[0], (batch, n), "sgemm")

    # fp32 linear_ksplit_fwd on the fp32 kernel (csrc/sgemm.cuh, the launch
    # of fp32 linear_fwd): the deep model's k-split layers at its batch,
    # ragged shapes with every activation, shapes it cannot take, and equal
    # bits with linear_fwd(kernel="sgemm") (a generator of its own)
    g_ks = torch.Generator(device=dev).manual_seed(34)

    def ksplit32_operands(batch, k, n, what):
        act = what.split()[0]
        x = torch.randn((batch, k), generator=g_ks, device=dev)
        w = torch.randn((k, n), generator=g_ks, device=dev) / k ** 0.5
        b = torch.randn((n,), generator=g_ks, device=dev) * 0.1
        return (lambda kernel: linear.linear_ksplit_fwd(x, w, b, act,
                                                        kernel=kernel),
                lambda: linear.linear_ksplit_fwd_ref(x, w, b, act),
                lambda: torch.addmm(b, x, w), (x, w, b))

    big32, small32 = (DEEP_BATCH, 4096, 4096), (DEEP_BATCH, 1024, 512)
    deep32 = [(DEEP_BATCH, k, n, "relu") for k, n in deep]
    err, times = hold_kernel(
        "linear_ksplit_fwd", linear.linear_ksplit_fwd, ksplit32_operands,
        deep32 + [(*sh, act) for sh in SGEMM_RAGGED
                  for act in ("none", "relu", "tanh")]
        + [(*sh, "relu") for sh in NO_SGEMM],
        [(*big32, "relu"), (*small32, "relu")], kernel="sgemm")
    fast_row(rows["linear_ksplit_fwd[fp32]"], err, times[big32], "sgemm")
    same = deep32 + [(*sh, "tanh") for sh in SGEMM_RAGGED]
    for batch, k, n, act in same:
        call, _, _, (x, w, b) = ksplit32_operands(batch, k, n, act)
        check(torch.equal(call("auto"), linear.linear_fwd(
            x, w, b, act, kernel="sgemm")), f"linear_ksplit_fwd[fp32] "
              f"{batch}x{k}->{n}: other bits than linear_fwd(kernel='sgemm')")
    print(f"  {'linear_ksplit_fwd[fp32]':<24} equal bits with linear_fwd("
          f"kernel='sgemm') at all {len(same)} shapes (the same launch)")

    # the block-Toeplitz kernel through the two convolutions, at every layer
    # of configs/conv1d.ini, batch 4096: forward and the dx launch
    toe_src = "rawaudiovae_kelsey_tpu_torch/csrc/toeplitz.cu"
    tpu_toe = "rawaudiovae_kelsey_tpu/ops/pallas_toeplitz.py:166"

    def conv_operands(batch, length, cin, cout, dt):
        x = torch.randn((batch, length, cin), generator=g, device=dev)
        w = torch.randn((CONV_K, cin, cout), generator=g, device=dev) \
            / (CONV_K * cin) ** 0.5
        b = torch.randn((cout,), generator=g, device=dev) * 0.1
        return x.to(dt), w.to(dt), b.to(dt)

    def both(direction):
        if direction == "conv":
            return conv.conv1d_pallas, variants.conv_same, conv.pack_conv1d
        return (conv.conv1d_transpose_pallas, variants.conv_transpose_same,
                conv.pack_conv1d_transpose)

    def library_call(direction, x, w, b):
        """The one PyTorch call of the same convolution (bias, no
        activation) on operands laid out for it beforehand: NCW input
        (SAME-padded for the forward direction: the call pads only
        symmetrically), (out, in, K) or flipped (in, out, K) weight."""
        xt = x.transpose(1, 2).contiguous()
        if direction == "conv":
            xp = F.pad(xt, variants.same_pad(x.shape[1], CONV_K, CONV_S))
            wt = w.permute(2, 1, 0).contiguous()
            return lambda: F.conv1d(xp, wt, b, stride=CONV_S)
        pb = (CONV_K - CONV_S) // 2
        wt = w.flip(0).permute(1, 2, 0).contiguous()
        return lambda: F.conv_transpose1d(
            xt, wt, b, stride=CONV_S, padding=pb,
            output_padding=max(0, CONV_S - CONV_K + 2 * pb))

    layer_ms = {}
    counter = {"tensor_cores": "tensor_core_launches",
               "sgemm": "sgemm_launches", "narrow": "narrow_launches"}
    fp32_windows = {}
    # the dx launches' cotangents (a generator of their own: the draws
    # below stay as they were)
    g_da = torch.Generator(device=dev).manual_seed(34)
    for kind, dt in dtypes.items():
        err = 0.0
        for i, (direction, length, cin, cout) in enumerate(CONV_LAYERS):
            op, plain, pack = both(direction)
            act = "tanh" if i == len(CONV_LAYERS) - 1 else "relu"
            form = conv_form(kind, i)
            for batch in ((DEEP_BATCH, 4097) if i == 2 else (DEEP_BATCH,)):
                x, w, b = conv_operands(batch, length, cin, cout, dt)
                x.requires_grad_()
                before = {c: getattr(toeplitz.toeplitz_fwd, c)
                          for c in ("launches", *counter.values())}
                with torch.enable_grad():
                    got = op(x, w, b, CONV_S, act)
                    (dx,) = torch.autograd.grad(got.float().square().sum(), x)
                torch.cuda.synchronize()
                rose = {c: getattr(toeplitz.toeplitz_fwd, c) - n
                        for c, n in before.items()}
                check(rose["launches"] == 2, f"{direction} layer {i}: "
                      f"{rose['launches']} Toeplitz launches, expected the "
                      "forward and dx")
                check(rose[counter[form]] == 2
                      and sum(rose[c] for c in counter.values()) == 2,
                      f"{kind} {direction} layer {i}: launches by form "
                      f"{rose}, expected both on {form}")
                # plain: the fp32 convolution of the same operands, bias
                # and activation in fp32, one rounding (the kernel's
                # epilogue); its dx from the same rounded output
                x32 = x.detach().float().requires_grad_()
                with torch.enable_grad():
                    want32 = linear.apply_act(act, plain(
                        {"w": w.float(), "b": b.float()}, x32, CONV_S))
                    want = want32.detach().to(dt)
                    (dx_want,) = torch.autograd.grad(want32, x32,
                                                     2 * want.float())
                what = (f"layer {i} {direction} {batch}x{length}x{cin}->{cout}"
                        f" (both launches on {form})")
                err = max(err, held("toeplitz_fwd", kind, got.detach(), want,
                                    VARIANT_REL[kind], what))
                held("toeplitz_fwd", kind, dx, dx_want.to(dt),
                     VARIANT_REL[kind], what + ", dx")
            x, w, b = conv_operands(DEEP_BATCH, length, cin, cout, dt)
            packed = pack(x, w, CONV_S) if direction == "conv" \
                else pack(x, w, b, CONV_S)
            if direction == "conv":
                xf, wp, t_out, shift = packed
                bp = b
                window = conv.conv1d_window(length, CONV_K, cin, CONV_S)
            else:
                xf, wp, bp, t_out, shift = packed
                window = None
            wp = wp.contiguous()

            def call(kernel="auto", window=window):
                return toeplitz.toeplitz_fwd(xf, wp, bp, act, t_out, shift,
                                             kernel=kernel, window=window)

            # the dx launch of the same layer: the reversed taps over a
            # cotangent, zero bias, no activation
            da = torch.randn((DEEP_BATCH, t_out, wp.shape[2]),
                             generator=g_da, device=dev).to(dt)
            wrev = wp.flip(0).transpose(1, 2).contiguous()
            zero = torch.zeros((wp.shape[1],), device=dev, dtype=dt)

            def call_dx(kernel="auto"):
                return toeplitz.toeplitz_fwd(
                    da, wrev, zero, "none", xf.shape[1],
                    wp.shape[0] - 1 - shift, kernel=kernel)

            y = call()
            check(torch.equal(y, call()), f"toeplitz_fwd[{kind}] layer {i}: "
                  "a second launch gave other bits")
            if form == "tensor_cores":
                held("toeplitz_fwd", kind, y, call("cuda_cores"),
                     VARIANT_REL[kind], f"layer {i}, tensor cores against "
                     "the first version (equal bits twice)")
            else:
                # the first version's FMA chains: equal bits, forward (over
                # the window where the layer has one) and dx
                for name, fn in (("forward", call), ("dx", call_dx)):
                    check(torch.equal(fn(), fn("cuda_cores")),
                          f"toeplitz_fwd[{kind}] layer {i} {name}: {form} "
                          "and the first version gave other bits")
                print(f"  {'toeplitz_fwd[' + kind + ']':<24} layer {i}: "
                      f"{form} gives the first version's bits, forward and "
                      "dx, and equal bits on a second launch")
            fns = {"library": library_call(direction, x, w, b),
                   "plain": lambda: toeplitz.toeplitz_fwd_ref(
                       xf, wp, bp, act, t_out, shift),
                   "cuda_cores": lambda: call("cuda_cores"),
                   form: lambda: call(form)}
            t, runs = time_in_turns(fns, 10)
            t["kernel"] = t[form]
            t["device"] = device_ms(call)
            t["first_device"] = device_ms(lambda: call("cuda_cores"))
            t["library_device"] = device_ms(fns["library"])
            t["dx_device"] = device_ms(call_dx)
            t["dx_first_device"] = device_ms(lambda: call_dx("cuda_cores"))
            # the convolution's own multiply-adds (the packed tap stack's
            # zero rows are not work the function needs)
            flops = 2 * DEEP_BATCH * length * CONV_K * cin * cout // (
                CONV_S if direction == "conv" else 1)
            bd = bound(flops, nbytes(x, w, b, y), kind)
            layer_ms[kind, i] = {**t, **bd, "form": form}
            lib = "F.conv1d" if direction == "conv" else "F.conv_transpose1d"
            print(f"  {'toeplitz_fwd[' + kind + ']':<24} layer {i} "
                  f"{direction} {length}x{cin}->{cout}: x {tuple(xf.shape)} w "
                  f"{tuple(wp.shape)} shift {shift} window {window}: ran "
                  f"{form}, kernel {t['kernel']:.4f} ms (device "
                  f"{t['device']:.4f} ms), first version "
                  f"{t['cuda_cores']:.4f} ms (device "
                  f"{t['first_device']:.4f} ms), plain {t['plain']:.4f} ms, "
                  f"{lib} {t['library']:.4f} ms (device "
                  f"{t['library_device']:.4f} ms), bound "
                  f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); dx device "
                  f"{t['dx_device']:.4f} ms, first version "
                  f"{t['dx_first_device']:.4f} ms (runs {runs})")
            if form == "tensor_cores":
                sweep_tiles("toeplitz_fwd", f"layer {i}", call,
                            (-(-toeplitz.tile_halves(
                                DEEP_BATCH, t_out,
                                *toeplitz.tile_plan(t_out)) // 2),
                             wp.shape[2]))
            elif form == "sgemm":
                sweep_tiles("toeplitz_fwd", f"layer {i}", call,
                            (DEEP_BATCH * t_out, wp.shape[2]), kernel="sgemm",
                            rule="sgemm_whole_tile")
                if window is not None:
                    fp32_windows[i] = (t["device"], device_ms(
                        lambda: call("sgemm", None)), window,
                        wp.shape[0] * wp.shape[1])
            else:
                narrow_sweep(kind, f"layer {i}", (xf, wp, bp, act, t_out,
                                                  shift), plans=True)
                narrow_sweep(kind, f"layer {i} dx",
                             (da, wrev, zero, "none", xf.shape[1],
                              wp.shape[0] - 1 - shift), plans=True)

        def total(key):
            return sum(layer_ms[kind, i][key] for i in range(len(CONV_LAYERS)))

        print(f"  {'toeplitz_fwd[' + kind + ']':<24} a forward of the eight "
              f"layers: kernel {total('kernel'):.4f} ms (device "
              f"{total('device'):.4f} ms), first version "
              f"{total('cuda_cores'):.4f} ms (device "
              f"{total('first_device'):.4f} ms), plain {total('plain'):.4f} "
              f"ms, cuDNN {total('library'):.4f} ms (device "
              f"{total('library_device'):.4f} ms), bound "
              f"{total('bound_ms'):.4f} ms")
        # the kernel line's rows: the second encoder layer (the first of
        # the six 12.9 GFLOP layers) for the tensor-core and fp32 forms, the
        # last decoder layer for the narrow form
        for name, i in (("toeplitz_fwd", 1), ("toeplitz_fwd_narrow", 7)):
            t = layer_ms[kind, i]
            rows[f"{name}[{kind}]"] = {
                "name": f"{name}[{kind}]", "route": "cuda",
                "source": {"tensor_cores": TC_SOURCE, "sgemm": toe_src,
                           "narrow": NARROW_SOURCE}[t["form"]],
                "replaces": tpu_toe, "max_abs_err": err, "ms": t["kernel"],
                "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library"],
                "device_ms": t["device"],
                "library_device_ms": t["library_device"],
                "first_version_ms": t["cuda_cores"],
                "first_version_device_ms": t["first_device"],
                "at": f"configs/conv1d.ini layer {i}, batch {DEEP_BATCH}"}
    for i, (window_ms, full_ms, window, rows_k) in fp32_windows.items():
        print(f"  {'toeplitz_fwd[fp32]':<24} layer {i}: the window "
              f"{window} ({window[1] - window[0]} of {rows_k} rows) "
              f"{window_ms:.4f} ms of device time, the whole packed stack "
              f"{full_ms:.4f} ms ({full_ms / window_ms:.3f}x)")

    # bf16 on the tensor cores at ragged plans
    for B, nb, G, kb, N, t_out, shift in TC_TOEPLITZ_RAGGED:
        xs = torch.randn((B, nb, G), generator=g_tc, device=dev).bfloat16()
        ws = (torch.randn((kb, G, N), generator=g_tc, device=dev)
              / (kb * G) ** 0.5).bfloat16()
        bs = (torch.randn((N,), generator=g_tc, device=dev) * 0.1).bfloat16()
        before = toeplitz.toeplitz_fwd.tensor_core_launches
        got = toeplitz.toeplitz_fwd(xs, ws, bs, "tanh", t_out, shift)
        torch.cuda.synchronize()
        what = (f"x {(B, nb, G)} w {(kb, G, N)} t_out {t_out} shift {shift} "
                f"plan {toeplitz.tile_plan(t_out)}")
        check(toeplitz.toeplitz_fwd.tensor_core_launches == before + 1,
              f"toeplitz_fwd[bf16] {what}: not on the tensor cores")
        check(torch.equal(got, toeplitz.toeplitz_fwd(xs, ws, bs, "tanh",
                                                     t_out, shift)),
              f"toeplitz_fwd[bf16] {what}: a second launch gave other bits")
        held("toeplitz_fwd", "bf16", got, toeplitz.toeplitz_fwd_ref(
            xs, ws, bs, "tanh", t_out, shift), VARIANT_REL["bf16"],
            what + ", tensor cores")
        held("toeplitz_fwd", "bf16", got, toeplitz.toeplitz_fwd(
            xs, ws, bs, "tanh", t_out, shift, kernel="cuda_cores"),
            VARIANT_REL["bf16"], what + ", against the first version")
    # what a call costs the host, at a shape whose kernels are a few µs
    xh, wh = (torch.zeros(sh, device=dev, dtype=torch.bfloat16)
              for sh in ((2, 64, 64), (3, 64, 64)))
    bh = torch.zeros((64,), device=dev, dtype=torch.bfloat16)
    xt, wt = xh.transpose(1, 2).contiguous(), wh.permute(2, 1, 0).contiguous()
    costs = {kernel: host_us(lambda: toeplitz.toeplitz_fwd(
        xh, wh, bh, "relu", 64, 1, kernel=kernel))
        for kernel in ("tensor_cores", "cuda_cores")}
    print(f"  {'toeplitz_fwd[bf16]':<24} host time a call, x (2, 64, 64), w "
          f"(3, 64, 64): tensor_cores {costs['tensor_cores']:.1f} us, "
          f"cuda_cores {costs['cuda_cores']:.1f} us, library call "
          f"{host_us(lambda: F.conv1d(xt, wt, bh, padding=1)):.1f} us")

    # passes = 4 against its plain version and against IEEE fp32, and odd
    # shifts and lengths straight through the kernel
    x, w, b = conv_operands(512, 64, 64, 128, torch.float32)
    xf, wpad, _, _ = conv.pack_conv1d(x, w, CONV_S)
    four = toeplitz.toeplitz_fwd(xf, wpad, b, "relu", 16, 1, 4)
    one = toeplitz.toeplitz_fwd(xf, wpad, b, "relu", 16, 1, 1)
    torch.cuda.synchronize()
    held("toeplitz_fwd", "fp32", four,
         toeplitz.toeplitz_fwd_ref(xf, wpad, b, "relu", 16, 1, 4),
         FOUR_PASS_REL, "passes = 4 against its 4-pass plain version")
    held("toeplitz_fwd", "fp32", four, one, FOUR_PASS_REL,
         "passes = 4 against IEEE fp32")
    t4 = cuda_time_ms(lambda: toeplitz.toeplitz_fwd(xf, wpad, b, "relu", 16,
                                                    1, 4), 10)
    t1 = cuda_time_ms(lambda: toeplitz.toeplitz_fwd(xf, wpad, b, "relu", 16,
                                                    1, 1), 10)
    print(f"  toeplitz_fwd[fp32]       512x16x256 (3 taps) ->128: passes = 4 "
          f"{t4:.4f} ms, passes = 1 {t1:.4f} ms ({t4 / t1:.2f}x)")
    for kind, dt in dtypes.items():
        for shift, t_out in ((0, 13), (2, 5), (1, 9), (0, None)):
            xs = torch.randn((37, 9, 24), generator=g, device=dev).to(dt)
            ws = (torch.randn((3, 24, 40), generator=g, device=dev) * 0.2
                  ).to(dt)
            bs = torch.randn((40,), generator=g, device=dev).to(dt)
            held("toeplitz_fwd", kind,
                 toeplitz.toeplitz_fwd(xs, ws, bs, "tanh", t_out, shift),
                 toeplitz.toeplitz_fwd_ref(xs, ws, bs, "tanh", t_out, shift),
                 VARIANT_REL[kind], f"37x9x24 shift {shift} t_out {t_out}")
    # the narrow and fp32 forms at ragged shapes (a generator of its own):
    # against plain, the first version's bits (passes = 4 too), the forms
    # swept against one another
    g_nw = torch.Generator(device=dev).manual_seed(33)
    for kind, dt in dtypes.items():
        for B, nb, G, kb, N, t_out, shift in NARROW_RAGGED:
            xs = torch.randn((B, nb, G), generator=g_nw, device=dev).to(dt)
            ws = (torch.randn((kb, G, N), generator=g_nw, device=dev)
                  / (kb * G) ** 0.5).to(dt)
            bs = (torch.randn((N,), generator=g_nw, device=dev) * 0.1).to(dt)
            what = (f"x {(B, nb, G)} w {(kb, G, N)} t_out {t_out} shift "
                    f"{shift}")
            for passes in ((1, 4) if kind == "fp32" else (1,)):
                before = (toeplitz.toeplitz_fwd.narrow_launches,
                          toeplitz.toeplitz_fwd.sgemm_launches)
                got = toeplitz.toeplitz_fwd(xs, ws, bs, "tanh", t_out, shift,
                                            passes)
                torch.cuda.synchronize()
                new = (toeplitz.toeplitz_fwd.narrow_launches - before[0],
                       toeplitz.toeplitz_fwd.sgemm_launches - before[1])
                narrow = min(G, N) < toeplitz.NARROW_BELOW
                check(new[0] == narrow, f"toeplitz_fwd[{kind}] {what}: "
                      f"{new[0]} narrow launches, expected {int(narrow)}")
                form = "narrow" if new[0] else "sgemm" if new[1] else "auto"
                held("toeplitz_fwd", kind, got, toeplitz.toeplitz_fwd_ref(
                    xs, ws, bs, "tanh", t_out, shift, passes),
                    FOUR_PASS_REL if passes == 4 else VARIANT_REL[kind],
                    f"{what} passes {passes} ({form})")
                if any(new):
                    check(torch.equal(got, toeplitz.toeplitz_fwd(
                        xs, ws, bs, "tanh", t_out, shift, passes,
                        kernel="cuda_cores")), f"toeplitz_fwd[{kind}] "
                          f"{what} passes {passes}: other bits than the "
                          "first version")
            narrow_sweep(kind, "ragged", (xs, ws, bs, "tanh", t_out, shift))
    rows["toeplitz_fwd[4-pass]"] = four_pass_kernels(dev, held, both,
                                                     tpu_toe)
    return rows


def four_pass_kernels(dev, held, both, tpu_toe) -> dict:
    """Phase 3e's 4-pass part (row 17 at ``passes = 4``, the fp32 layers of
    a ``high`` op-level step): every wide layer of configs/conv1d.ini
    (1-6) at batch 4096, forward and dx, on the tensor cores' 4-pass form,
    held within FOUR_PASS_REL of its 4-pass plain version and of the first
    version, equal bits on a second launch and with the plain version on
    single-term operands (:func:`exact_toeplitz_case`, 64 batch rows);
    timed in turns with the first version, the plain version and the
    library sequence, its device time in parts, its bound with and without
    the split pass's bytes; then the ragged plans.  Returns the kernel
    line's row (layer 1's forward)."""
    from rawaudiovae_kelsey_tpu_torch.ops import conv, toeplitz

    g = torch.Generator(device=dev).manual_seed(35)
    counters = ("launches", "split_launches")

    def on_form(fn, what):
        before = [getattr(toeplitz.toeplitz_fwd, c) for c in counters]
        out = fn()
        torch.cuda.synchronize()
        rose = [getattr(toeplitz.toeplitz_fwd, c) - n
                for c, n in zip(counters, before)]
        check(rose == [1, 1], f"toeplitz_fwd[4-pass] {what}: launches "
              f"{rose}, expected one on the 4-pass tensor-core form")
        return out

    def exact(args, what, seed):
        B, nb, G = args[0].shape
        kb, _, N = args[1].shape
        ea = (*exact_toeplitz_case(dev, min(B, 64), nb, G, kb, N, seed),
              "relu", *args[4:])
        check(torch.equal(toeplitz.toeplitz_fwd(*ea, 4),
                          toeplitz.toeplitz_fwd_ref(*ea, 4)),
              f"toeplitz_fwd[4-pass] {what}: single-term operands gave "
              "other bits than the plain version")

    err, out = 0.0, {}
    for i, (direction, length, cin, cout) in enumerate(CONV_LAYERS):
        if i in (0, len(CONV_LAYERS) - 1):
            continue                      # G or N below 8: narrow.cuh
        x = torch.randn((DEEP_BATCH, length, cin), generator=g, device=dev)
        w = torch.randn((CONV_K, cin, cout), generator=g, device=dev) \
            / (CONV_K * cin) ** 0.5
        b = torch.randn((cout,), generator=g, device=dev) * 0.1
        pack = both(direction)[2]
        if direction == "conv":
            xf, wp, t_out, shift = pack(x, w, CONV_S)
            bp = b
        else:
            xf, wp, bp, t_out, shift = pack(x, w, b, CONV_S)
        wp = wp.contiguous()
        da = torch.randn((DEEP_BATCH, t_out, wp.shape[2]), generator=g,
                         device=dev)
        wrev = wp.flip(0).transpose(1, 2).contiguous()
        zero = torch.zeros((wp.shape[1],), device=dev)
        # the convolution's own multiply-adds in four bf16 passes (the
        # packed tap stack's zero rows are not work the function needs)
        flops = 4 * 2 * DEEP_BATCH * length * CONV_K * cin * cout // (
            CONV_S if direction == "conv" else 1)
        for part, args in (
                ("forward", (xf, wp, bp, "relu", t_out, shift)),
                ("dx", (da, wrev, zero, "none", xf.shape[1],
                        wp.shape[0] - 1 - shift))):
            def call(kernel="auto", args=args):
                return toeplitz.toeplitz_fwd(*args, 4, kernel=kernel)

            what = (f"layer {i} {part} x {tuple(args[0].shape)} w "
                    f"{tuple(args[1].shape)}")
            got = on_form(call, what)
            want = toeplitz.toeplitz_fwd_ref(*args, 4)
            err = max(err, held("toeplitz_fwd", "4-pass", got, want,
                                FOUR_PASS_REL, what + ", tensor cores"))
            check(torch.equal(got, call()), f"toeplitz_fwd[4-pass] {what}: "
                  "a second launch gave other bits")
            held("toeplitz_fwd", "4-pass", got, call("cuda_cores"),
                 FOUR_PASS_REL, what + ", against the first version")
            exact(args, what, i)
            fns = {"plain": lambda args=args: toeplitz.toeplitz_fwd_ref(
                       *args, 4),
                   "cuda_cores": lambda: call("cuda_cores"),
                   "kernel": call}
            lib = four_pass_library(*args)
            if lib is not None:
                e = rel_err([lib()], [want])
                check(e <= FOUR_PASS_REL, f"toeplitz_fwd[4-pass] {what}: "
                      f"the library sequence is {e:.3e} from the plain "
                      "version")
                fns["library"] = lib
            t, runs = time_in_turns(fns, 5)
            moved = nbytes(*args[:3], got)
            # the split pass writes x's and w's halves and the walk reads
            # them: 4 + 4 bytes an element
            halves = 8 * (args[0].numel() + args[1].numel())
            row = {"ms": t["kernel"], "plain_ms": t["plain"],
                   "first_version_ms": t["cuda_cores"],
                   "library_ms": t.get("library"),
                   "device_ms": device_ms(call),
                   "parts_ms": {label: device_ms(call, match=m)
                                for label, m in FOUR_PASS_PARTS.items()},
                   "first_version_device_ms": device_ms(
                       lambda: call("cuda_cores"), calls=3),
                   "library_device_ms": (device_ms(lib) if lib is not None
                                         else None),
                   **bound(flops, moved, "bf16"),
                   "split_bound_ms": bound(flops, moved + halves,
                                           "bf16")["bound_ms"]}
            out[i, part] = row
            lib_text = ("" if lib is None else
                        f", library {row['library_ms']:.4f} (device "
                        f"{row['library_device_ms']:.4f}, kernel / library "
                        f"{row['device_ms'] / row['library_device_ms']:.3f}"
                        "x by device time)")
            print(f"  {'toeplitz_fwd[4-pass]':<24} {what}: kernel "
                  f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}: "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in row["parts_ms"].items())
                  + f"), first version {row['first_version_ms']:.4f} (device "
                  f"{row['first_version_device_ms']:.4f}), plain "
                  f"{row['plain_ms']:.4f}{lib_text}; bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"{row['split_bound_ms']:.4f} with the split pass's bytes "
                  f"(runs {runs})")
    for key in ("ms", "device_ms", "first_version_ms", "plain_ms",
                "library_device_ms", "bound_ms", "split_bound_ms"):
        if all(r[key] is not None for r in out.values()):
            print(f"  {'toeplitz_fwd[4-pass]':<24} layers 1-6, forward + dx "
                  f"(12 launches): {key} "
                  f"{sum(r[key] for r in out.values()):.4f}")
    # the ragged plans in four passes (fp32 operands of the same draws'
    # shapes as bf16's)
    for B, nb, G, kb, N, t_out, shift in TC_TOEPLITZ_RAGGED:
        xs = torch.randn((B, nb, G), generator=g, device=dev)
        ws = torch.randn((kb, G, N), generator=g, device=dev) / (kb * G) ** 0.5
        bs = torch.randn((N,), generator=g, device=dev) * 0.1
        args = (xs, ws, bs, "tanh", t_out, shift)
        what = (f"x {(B, nb, G)} w {(kb, G, N)} t_out {t_out} shift {shift} "
                f"plan {toeplitz.tile_plan(t_out)}")
        got = on_form(lambda: toeplitz.toeplitz_fwd(*args, 4), what)
        check(torch.equal(got, toeplitz.toeplitz_fwd(*args, 4)),
              f"toeplitz_fwd[4-pass] {what}: a second launch gave other bits")
        held("toeplitz_fwd", "4-pass", got, toeplitz.toeplitz_fwd_ref(
            *args, 4), FOUR_PASS_REL, what + ", tensor cores")
        held("toeplitz_fwd", "4-pass", got, toeplitz.toeplitz_fwd(
            *args, 4, kernel="cuda_cores"), FOUR_PASS_REL,
            what + ", against the first version")
        exact(args, what, B)
    print(f"  {'toeplitz_fwd[4-pass]':<24} equal bits on a second launch and "
          "with the plain version on single-term operands at every wide "
          "layer, forward and dx, and at the ragged plans")
    t = out[1, "forward"]
    return {"name": "toeplitz_fwd[4-pass]", "route": "cuda",
            "source": TC_SOURCE, "replaces": tpu_toe, "max_abs_err": err,
            **t, "library": FOUR_PASS_LIBRARY,
            "at": f"configs/conv1d.ini layer 1 forward, batch {DEEP_BATCH}, "
                  "passes = 4 (fp32)"}


# phase 3f: the new form of each dtype of dw_fused / dx_fused, the library
# sequence each is timed against, and the plans swept at the deep layers:
# (tensor_cores rule, plans, kernel names in a trace) for dx and for dW
FORMED = {"bf16": "tensor_cores", "fp32": "sgemm"}
FORMED_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
FUSED_LIBRARY = {
    "dw_fused": "the sequence cotangent -> x.t() @ da -> da.sum(0), device "
                "time summed (no one PyTorch call computes dw_fused)",
    "dx_fused": "the sequence cotangent -> da @ w.t(), device time summed "
                "(no one PyTorch call computes dx_fused)",
}
FORMED_PLANS = {
    "bf16": (("cotangent_tile_n", (256, 128, 64), "CotangentRows"),
             ("cotangent_wgrad_plan", ((256, 1), (256, 2), (128, 1),
                                       (128, 2), (64, 1), (64, 2)),
              "CotangentWgrad")),
    "fp32": (("sgemm_tile", ((128, 128), (128, 64), (64, 64)),
              "sgemm_fused_kernel"),
             ("sgemm_wgrad_plan", SGEMM_WGRAD_PLANS, "sgemm_fused_kernel")),
}


def sweep_formed(kind, operands, rows):
    """Phase 3f: the device ms of the new forms of dx_fused and dw_fused
    (relu) with each plan of FORMED_PLANS forced, beside the rule's pick
    and the library product's device time, at the four deep layers in bf16
    and at the largest and the narrowest in fp32; a plan of more than one
    slice counts the slices' sum.  Into the rows' ``plan_device_ms``."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd, tensor_cores

    layers = DEEP_LAYERS if kind == "bf16" else (DEEP_LAYERS[0],
                                                 DEEP_LAYERS[-1])
    tol = VARIANT_REL[kind]
    for (rule, plans, match), name in zip(FORMED_PLANS[kind],
                                          ("dx_fused", "dw_fused")):
        real = getattr(tensor_cores, rule)
        table = {}
        for k, n in layers:
            x, y, dy, w = operands(DEEP_BATCH, k, n, FORMED_DTYPES[kind])
            da = linear_bwd.cotangent("relu", y, dy)
            if name == "dx_fused":
                call = lambda: linear_bwd.dx_fused(y, dy, w, "relu")
                plain = lambda: [linear_bwd.dx_fused_ref(y, dy, w, "relu")]
                bare = device_ms(lambda: da @ w.t(), 5)
            else:
                call = lambda: linear_bwd.dw_fused(x, y, dy, "relu")
                plain = lambda: linear_bwd.dw_fused_ref(x, y, dy, "relu")
                bare = device_ms(lambda: x.t() @ da, 5)
            sms = tensor_cores.sm_count(x.device)
            pick = real(*{
                "cotangent_tile_n": (-(-DEEP_BATCH // 128), k, sms),
                "cotangent_wgrad_plan": (n, k, DEEP_BATCH, sms),
                "sgemm_tile": (DEEP_BATCH, k, sms),
                "sgemm_wgrad_plan": (k, n, DEEP_BATCH, sms)}[rule])
            swept = {}
            try:
                for plan in plans:
                    setattr(tensor_cores, rule,
                            lambda *a, plan=plan, **kw: plan)
                    got = call()
                    got = list(got) if isinstance(got, tuple) else [got]
                    e = rel_err(got, plain())
                    check(e <= tol, f"{name}[{kind}] {k}->{n} plan {plan}: "
                          f"relative error {e:.3e}")
                    split = plan[1] if name == "dw_fused" else 1
                    swept[plan] = device_ms(call, 5, match) + (
                        device_ms(call, 5, "sum_slices") if split > 1
                        else 0.0)
            finally:
                setattr(tensor_cores, rule, real)
            best = min(swept, key=swept.get)
            behind = swept[pick] / swept[best] - 1 if pick in swept \
                else float("nan")
            print(f"  {name + '[' + kind + ']':<24} {DEEP_BATCH}x{k}->{n}: "
                  f"device ms by plan: "
                  + ", ".join(f"{p}: {v:.4f}" for p, v in swept.items())
                  + f"; the rule picks {pick}, the fastest is {best} (the "
                    f"pick {100 * behind:.1f} % behind it); the library "
                    f"product {bare:.4f} ms (the pick at "
                    f"{swept.get(pick, float('nan')) / bare:.3f}x)")
            table[f"{k}->{n}"] = {"plans": {str(p): v for p, v in
                                            swept.items()},
                                  "pick": str(pick), "product_ms": bare}
        rows[f"{name}[{kind}]"]["plan_device_ms"] = table


def phase_probe_kernels():
    """Phase 3f: dw_fused and dx_fused against their plain versions,
    leaf_update, adam_tree and fused_adam_apply against theirs bit for
    bit."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear_bwd, tensor_cores
    from rawaudiovae_kelsey_tpu_torch.probes import deep_bwd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(41)
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    src = "rawaudiovae_kelsey_tpu_torch/csrc/linear_bwd.cu"
    tpu = "benchmarks/deep_bwd_probe.py"
    rows = {}

    def operands(batch, k, n, dt):
        return deep_bwd.operands(batch, k, n, dt, dev, g)

    def held(name, kind, got, want, what):
        check(got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all()),
              f"{name}[{kind}] {what}: shape/dtype {tuple(got.shape)} "
              f"{got.dtype} vs {tuple(want.shape)} {want.dtype}, or "
              "non-finite")
        e = rel_err([got], [want])
        check(e <= VARIANT_REL[kind], f"{name}[{kind}] {what}: relative "
              f"error {e:.3e} > {VARIANT_REL[kind]:.3e}")
        return e, max_err([got.float()], [want.float()])

    shapes = [(DEEP_BATCH, k, n) for k, n in DEEP_LAYERS] + list(
        RAGGED_LAYERS)
    for kind, dt in dtypes.items():
        # the new form of each dtype: the tensor cores in bf16, csrc/
        # sgemm.cuh in fp32; a shape it cannot take keeps the first version
        form = FORMED[kind]
        counter = FAST[form]["counter"]
        takes = tensor_cores.takes_tensor_cores if kind == "bf16" \
            else tensor_cores.takes_sgemm
        worst = {"dw_fused": (0.0, 0.0), "dx_fused": (0.0, 0.0)}
        for batch, k, n in shapes:
            fits = takes(dt, batch, k, n)
            for act in ("relu", "tanh", "none"):
                x, y, dy, w = operands(batch, k, n, dt)
                what = f"{batch}x{k}->{n} {act}"
                ops = (linear_bwd.dw_fused, linear_bwd.dx_fused)
                before = [(op.launches, getattr(op, counter)) for op in ops]
                dw, db = linear_bwd.dw_fused(x, y, dy, act)
                dx = linear_bwd.dx_fused(y, dy, w, act)
                dw2, db2 = linear_bwd.dw_fused(x, y, dy, act)
                dx2 = linear_bwd.dx_fused(y, dy, w, act)
                torch.cuda.synchronize()
                rose = [(op.launches - b[0], getattr(op, counter) - b[1])
                        for op, b in zip(ops, before)]
                check(rose == [(2, 2 * fits)] * 2,
                      f"{kind} {what}: launches / {form} launches rose by "
                      f"{rose}, expected {2 * fits} on {form}")
                check(torch.equal(dw, dw2) and torch.equal(db, db2)
                      and torch.equal(dx, dx2),
                      f"{kind} {what}: a second launch gave other bits")
                want_dw, want_db = linear_bwd.dw_fused_ref(x, y, dy, act)
                e_dw = held("dw_fused", kind, dw, want_dw, what + ", dW")
                e_db = held("dw_fused", kind, db, want_db, what + ", db")
                e_dx = held("dx_fused", kind, dx,
                            linear_bwd.dx_fused_ref(y, dy, w, act), what)
                if fits:
                    # and against the first version on the same inputs
                    first = linear_bwd.fused_bwd(x, y, dy, w, act,
                                                 kernel="cuda_cores")
                    for got, old, label in zip((dx, dw, db), first,
                                               ("dx", "dW", "db")):
                        held(f"{label} of the fused pair", kind, got, old,
                             what + ", against the first version")
                worst["dw_fused"] = tuple(
                    max(v) for v in zip(worst["dw_fused"], e_dw, e_db))
                worst["dx_fused"] = tuple(
                    max(v) for v in zip(worst["dx_fused"], e_dx))
            if not fits:
                for call in (lambda: linear_bwd.dw_fused(x, y, dy, act,
                                                         kernel=form),
                             lambda: linear_bwd.dx_fused(y, dy, w, act,
                                                         kernel=form)):
                    try:
                        call()
                    except ValueError:
                        continue
                    check(False, f"{kind} {batch}x{k}->{n}: kernel={form!r} "
                          "did not raise on a shape it cannot take")
            print(f"  {'fused pair[' + kind + ']':<24} {batch}x{k}->{n}: "
                  + (f"every launch on {form}" if fits else
                     f"the first version (kernel={form!r} raised)"))
        for name, (rel, _) in worst.items():
            print(f"  {name + '[' + kind + ']':<24} {len(shapes)} shapes x 3 "
                  f"activations: max |kernel - plain| / max|plain| = "
                  f"{rel:.3e} (tolerance {VARIANT_REL[kind]:.3e}); equal "
                  "bits on a second launch")
        # timed at the deep model's largest layer, relu: the new form, the
        # first version, the plain version and the library sequence in
        # turns, and each one's device time
        k, n = DEEP_LAYERS[0]
        x, y, dy, w = operands(DEEP_BATCH, k, n, dt)
        flops = 2 * DEEP_BATCH * k * n
        da = linear_bwd.cotangent("relu", y, dy)
        wt, xt = w.t(), x.t()
        cases = {
            "dw_fused": (
                {form: lambda: linear_bwd.dw_fused(x, y, dy, "relu"),
                 "cuda_cores": lambda: linear_bwd.dw_fused(
                     x, y, dy, "relu", kernel="cuda_cores"),
                 "plain": lambda: linear_bwd.dw_fused_ref(x, y, dy, "relu"),
                 "library": lambda: (lambda d: (xt @ d, d.sum(0)))(
                     linear_bwd.cotangent("relu", y, dy))},
                "x.t() @ da", lambda: xt @ da, f"{tpu}:83",
                nbytes(x, y, dy) + 4 * (k * n + n)),
            "dx_fused": (
                {form: lambda: linear_bwd.dx_fused(y, dy, w, "relu"),
                 "cuda_cores": lambda: linear_bwd.dx_fused(
                     y, dy, w, "relu", kernel="cuda_cores"),
                 "plain": lambda: linear_bwd.dx_fused_ref(y, dy, w, "relu"),
                 "library": lambda: linear_bwd.cotangent("relu", y, dy)
                 @ wt},
                "da @ w.t()", lambda: da @ wt, f"{tpu}:134",
                nbytes(y, dy, w, x)),
        }
        for name, (fns, label, product, replaces, moved) in cases.items():
            ms, runs = time_in_turns(fns, 20 if kind == "bf16" else 5)
            dms = {key: device_ms(fn, 5) for key, fn in fns.items()}
            bare = device_ms(product, 5)
            bd = bound(flops, moved, kind)
            print(f"  {name + '[' + kind + ']':<24} {DEEP_BATCH}x{k}->{n} "
                  f"relu: {form} {ms[form]:.4f} ms (device {dms[form]:.4f} "
                  f"ms, {flops / dms[form] / 1e9:.1f} TFLOP/s), cuda_cores "
                  f"(first version) {ms['cuda_cores']:.4f} ms (device "
                  f"{dms['cuda_cores']:.4f}: "
                  f"{dms['cuda_cores'] / dms[form]:.1f}x), plain {ms['plain']:.4f} ms (device "
                  f"{dms['plain']:.4f}), library sequence "
                  f"{ms['library']:.4f} ms (device {dms['library']:.4f}), "
                  f"{label} alone device {bare:.4f} ms, bound "
                  f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); device time /"
                  f" the sequence's {dms[form] / dms['library']:.3f}, / the "
                  f"product's {dms[form] / bare:.3f}, / bound "
                  f"{dms[form] / bd['bound_ms']:.3f}; runs {runs}")
            rows[f"{name}[{kind}]"] = {
                "name": f"{name}[{kind}]", "route": "cuda",
                "source": FAST[form]["source"], "replaces": replaces,
                "max_abs_err": worst[name][1], "ms": ms[form],
                "plain_ms": ms["plain"], **bd,
                "library_ms": dms["library"],
                "library": FUSED_LIBRARY[name],
                "library_event_ms": ms["library"],
                "product_device_ms": bare, "device_ms": dms[form],
                "first_version_ms": ms["cuda_cores"],
                "first_version_device_ms": dms["cuda_cores"]}
        sweep_formed(kind, operands, rows)
        # context: the backward the deep model takes today, and its parts
        parts = {"plain_bwd": lambda: linear_bwd.plain_bwd(x, y, dy, w,
                                                           "relu"),
                 "fused_bwd": lambda: linear_bwd.fused_bwd(x, y, dy, w,
                                                           "relu"),
                 "da @ w.t()": lambda: da @ wt, "x.t() @ da": lambda: xt @ da,
                 "da.sum(0)": lambda: da.sum(0)}
        print(f"  {'plain backward[' + kind + ']':<24} {DEEP_BATCH}x{k}->{n}: "
              + ", ".join(f"{label} device {device_ms(fn, 5):.4f} ms"
                          for label, fn in parts.items()))

    rows.update(adam_kernels())
    return rows


def adam_kernels() -> dict:
    """Phase 3f's one-pass Adam: leaf_update, adam_tree and
    fused_adam_apply against their plain versions, equal bits and not a
    tolerance; their times.  Returns the row of the tree kernel."""
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import adam
    from rawaudiovae_kelsey_tpu_torch.probes import adam_fusion, common
    from rawaudiovae_kelsey_tpu_torch.train import Adam, TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves, unflatten

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(43)
    rows = {}
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-4)

    def adam_operands(shape):
        p = torch.randn(shape, generator=g, device=dev)
        grad = torch.randn(shape, generator=g, device=dev) * 0.1
        m = torch.randn(shape, generator=g, device=dev) * 0.01
        v = torch.rand(shape, generator=g, device=dev) * 1e-3
        return p, grad, m, v

    def bits_differ(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    bc_host = adam.bias_corrections(0.9, 0.999, 3)
    bc = [torch.full((), c, device=dev) for c in bc_host]

    def leaf_cases():
        cases = [(str(shape), adam_operands(shape))
                 for shape in ADAM_LEAVES]
        # four views that start 4 bytes past a 16-byte boundary
        unaligned = torch.empty(4 * 1001, device=dev)
        cases.append(("(1000,) unaligned", tuple(
            unaligned[i * 1001 + 1:(i + 1) * 1001].copy_(t)
            for i, t in enumerate(adam_operands((1000,))))))
        return cases

    # leaf_update: the tree kernel with a table of one leaf, and the first
    # version by name
    for kernel in ("auto", "first"):
        cases = leaf_cases()
        for label, (p, grad, m, v) in cases:
            want = [t.clone() for t in (p, grad, m, v)]
            ptrs = [t.data_ptr() for t in (p, m, v)]
            before = adam.leaf_update.launches, adam.adam_tree.launches
            adam.leaf_update(p, grad, m, v, *bc, kernel=kernel, **hyper)
            torch.cuda.synchronize()
            check((adam.leaf_update.launches, adam.adam_tree.launches)
                  == (before[0] + 1, before[1]),
                  f"leaf_update[{kernel}]: the launch was not counted")
            adam.leaf_update_ref(*want, *bc, **hyper)
            check(ptrs == [t.data_ptr() for t in (p, m, v)]
                  and torch.equal(grad, want[1]),
                  f"leaf_update[{kernel}] {label}: not in place, or the "
                  "gradient changed")
            diff = [bits_differ(a, b) for a, b in zip((p, m, v),
                                                      (want[0], *want[2:]))]
            check(diff == [0, 0, 0] and bool(torch.isfinite(p).all()),
                  f"leaf_update[{kernel}] {label}: {diff} elements of p, m, "
                  "v differ from the plain version's bits")
        print(f"  {'leaf_update[' + kernel + ']':<24} {len(cases)} leaves "
              f"({', '.join(label for label, _ in cases)}): p, m and v "
              "equal the plain version's bit for bit, in place")

    # the tree kernel: a tree of aligned, unaligned (all four, or the
    # gradient alone), empty leaves and a strided gradient in one launch,
    # and one of
    # K_MAX_LEAVES + 3 leaves in two
    def tree_case(shapes, unaligned):
        leaves_ = []
        for i, shape in enumerate(shapes):
            n = int(np.prod(shape))
            four = []
            for k, t in enumerate(adam_operands(shape)):
                off = int(i in unaligned or (k == 1 and -i - 1 in unaligned))
                four.append(torch.empty(n + 4, device=dev)[off:off + n]
                            .view(shape).copy_(t))
            leaves_.append(four)
        return [list(x) for x in zip(*leaves_)]

    k_max = adam.K_MAX_LEAVES
    tree_cases = {
        "mixed": ([(4096, 1024), (0,), (1,), (255,), (1027,), (7, 33, 5),
                   (0, 3), (4097,), (300, 41), (2048,)], (2, 4, -8), 1),
        f"{k_max + 3} leaves": ([(1000 + 97 * i,) for i in range(k_max + 3)],
                                (k_max + 1,), 2)}
    for label, (shapes, unaligned, n_launch) in tree_cases.items():
        ps, gs, ms, vs = tree_case(shapes, unaligned)
        if label == "mixed":
            # a strided gradient (a convolution's), copied contiguous
            gs[8] = gs[8].t().contiguous().t()
        want = [[t.clone() for t in x] for x in (ps, ms, vs)]
        before = adam.adam_tree.launches
        adam.adam_tree(ps, gs, ms, vs, *bc_host, **hyper)
        torch.cuda.synchronize()
        check(adam.adam_tree.launches == before + n_launch,
              f"adam_tree {label}: {adam.adam_tree.launches - before} "
              f"launches, expected {n_launch}")
        for p, grad, m, v in zip(want[0], gs, want[1], want[2]):
            adam.leaf_update_ref(p, grad, m, v, *bc, **hyper)
        diff = sum(bits_differ(a, b) for got, ref in zip((ps, ms, vs), want)
                   for a, b in zip(got, ref))
        check(diff == 0, f"adam_tree {label}: {diff} elements differ from "
              "the plain version's bits")
        print(f"  {'adam_tree[fp32]':<24} {label} ({len(shapes)} leaves, "
              f"{n_launch} launch{'es' if n_launch > 1 else ''}): equal the "
              "plain version's bits")

    # five coupled steps of each model's tree at full width: one launch a
    # step, the states equal Adam.update's bit for bit
    opt = Adam(learning_rate=1e-4)
    trees = {}
    for arch, (n_leaves, n_params) in ADAM_TREES.items():
        model = build_model(common.build_cfg(arch, DEEP_BATCH, "bfloat16",
                                             "xla"), dev)
        plain_state = TrainState.create(
            model.init(torch.Generator().manual_seed(5)), 0)
        fused_state = plain_state.clone()
        got = leaves(plain_state.params)
        check((len(got), sum(t.numel() for t in got)) == (n_leaves,
                                                          n_params),
              f"the {arch} tree has {len(got)} leaves, "
              f"{sum(t.numel() for t in got)} parameters")
        before = adam.adam_tree.launches, adam.leaf_update.launches
        for step in range(5):
            grads = unflatten(plain_state.params, [
                torch.randn(t.shape, generator=g, device=dev)
                * 10.0 ** (step % 3 - 2) for t in got])
            opt.update(plain_state, grads)
            adam.fused_adam_apply(opt, fused_state, grads)
        torch.cuda.synchronize()
        check((adam.adam_tree.launches, adam.leaf_update.launches)
              == (before[0] + 5, before[1]),
              f"fused_adam_apply on the {arch} tree: not one launch a step")
        bad = adam_fusion.differing_leaves(plain_state, fused_state)
        check(not bad and plain_state.count == fused_state.count == 5,
              f"fused_adam_apply differs from Adam.update on the {arch} "
              f"tree in {bad}")
        print(f"  {'fused_adam_apply':<24} 5 coupled steps on the {arch} "
              f"tree ({n_leaves} leaves, {n_params:,} parameters, 1 launch "
              "a step): params, mu and nu equal Adam.update's bit for bit")
        trees[arch] = (plain_state, fused_state, n_params)

    # timed in turns, by CUDA events over the host loop and by device time,
    # beside the bytes bound: the tree kernel through fused_adam_apply and
    # alone, the first version (a launch a leaf), the plain
    # Adam.update and PyTorch's own fused Adam (a yardstick, used nowhere
    # in the port), on the deep and the dense trees and on a 4096x4096 leaf
    def torch_fused(params, grads):
        params = [torch.nn.Parameter(t.clone()) for t in params]
        for t, grad in zip(params, grads):
            t.grad = grad
        lib = torch.optim.Adam(params, lr=1e-4, fused=True)
        return lib.step

    lib = "torch.optim.Adam(fused=True)"

    def timed(label, fns, n_params, iters):
        # five rounds of turns: the host's rate drifts between runs, and
        # the kernel and the library call come within that drift on the
        # dense tree
        ms, runs = time_in_turns(fns, iters, rounds=5)
        dev_ms = {name: device_ms(fn, 5) for name, fn in fns.items()}
        bd = bound(ADAM_OPS * n_params, ADAM_BYTES * n_params, "fp32")
        first = next(iter(fns))
        # the turns in which the first of fns beat the library call
        won = sum(a < b for a, b in zip(runs[first], runs[lib]))
        print(f"  {'adam_tree[fp32]':<24} {label}: bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); event / device "
              "ms: " + ", ".join(f"{name} {ms[name]:.4f} / "
                                 f"{dev_ms[name]:.4f}" for name in fns))
        print(f"  {'':<24} event ms min-max: " + ", ".join(
            f"{name} {min(runs[name]):.4f}-{max(runs[name]):.4f}"
            for name in fns) + f"; {first} faster than {lib} in {won} of "
            f"{len(runs[lib])} turns")
        print(f"  {'':<24} runs {runs}")
        return ms, dev_ms, bd, won

    out = {}
    for arch in ("deep", "dense"):
        plain_state, fused_state, n_params = trees[arch]
        grads = unflatten(plain_state.params, [
            torch.randn(t.shape, generator=g, device=dev) * 0.1
            for t in leaves(plain_state.params)])
        ps, gs, mus, nus = (leaves(x) for x in (fused_state.params, grads,
                                                fused_state.mu,
                                                fused_state.nu))
        fns = {
            "fused_adam_apply": lambda: adam.fused_adam_apply(
                opt, fused_state, grads),
            "adam_tree": lambda: adam.adam_tree(ps, gs, mus, nus, *bc_host,
                                                **hyper),
            "first version": lambda: adam.fused_adam_apply(
                opt, fused_state, grads, kernel="first"),
            "Adam.update": lambda: opt.update(plain_state, grads),
            lib: torch_fused(leaves(plain_state.params), leaves(grads))}
        out[arch] = timed(f"the {arch} tree, one update", fns, n_params, 20)
    p, grad, m, v = adam_operands((4096, 4096))
    leaf = timed("a 4096x4096 leaf", {
        "leaf_update": lambda: adam.leaf_update(p, grad, m, v, *bc, **hyper),
        "first version": lambda: adam.leaf_update(p, grad, m, v, *bc,
                                                  kernel="first", **hyper),
        "leaf_update_ref": lambda: adam.leaf_update_ref(p, grad, m, v, *bc,
                                                        **hyper),
        lib: torch_fused([p], [grad])},
        p.numel(), 20)

    # the row: the deep tree, the main path's update, through
    # fused_adam_apply; the dense tree and the leaf beside it
    ms, dev_ms, bd, won = out["deep"]
    rows["adam_tree[fp32]"] = {
        "name": "adam_tree[fp32]", "route": "cuda",
        "source": "rawaudiovae_kelsey_tpu_torch/csrc/adam.cu",
        "replaces": "benchmarks/adam_fusion_ab.py:93", "max_abs_err": 0.0,
        "shape": f"the deep tree, {DEEP_LEAVES} leaves, "
                 f"{trees['deep'][2]:,} parameters, one launch",
        "ms": ms["fused_adam_apply"], "plain_ms": ms["Adam.update"], **bd,
        "library_ms": ms[lib], "device_ms": dev_ms["fused_adam_apply"],
        "library_device_ms": dev_ms[lib], "turns_won": won,
        "alone_ms": ms["adam_tree"], "alone_device_ms": dev_ms["adam_tree"],
        "first_version_ms": ms["first version"],
        "first_version_device_ms": dev_ms["first version"],
        "dense_tree": {key: out["dense"][0][name] for key, name in (
            ("ms", "fused_adam_apply"), ("first_version_ms",
                                         "first version"),
            ("plain_ms", "Adam.update"), ("library_ms", lib))}
        | {"device_ms": out["dense"][1]["fused_adam_apply"],
           "library_device_ms": out["dense"][1][lib],
           "bound_ms": out["dense"][2]["bound_ms"],
           "turns_won": out["dense"][3]},
        "leaf_4096x4096": {"ms": leaf[0]["leaf_update"],
                           "device_ms": leaf[1]["leaf_update"],
                           "first_version_ms": leaf[0]["first version"],
                           "plain_ms": leaf[0]["leaf_update_ref"],
                           "library_ms": leaf[0][lib],
                           "bound_ms": leaf[2]["bound_ms"]}}
    return rows


def phase_probes(card: str):
    """Phase 10: the three probes through their main() at full width."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.probes import (
        adam_fusion,
        deep_bwd,
        deep_step,
    )

    fused = (ops.dw_fused, ops.dx_fused)

    def counted(run):
        for w in ops.KERNEL_WRAPPERS:
            w.launches = 0
        for w in fused:
            w.tensor_core_launches = w.sgemm_launches = 0
        out = run()
        check(out["device"] == card, f"the probe ran on {out['device']!r}, "
              f"not on {card!r}")
        counts = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
        for w in fused:
            counts[f"{w.__name__}@tc"] = w.tensor_core_launches
            counts[f"{w.__name__}@sgemm"] = w.sgemm_launches
        return out, counts

    launches = {}
    for kind, argv in (("bf16", ["--all"]),
                       ("fp32", ["--dtype", "float32", "--launches", "2"])):
        out, counts = counted(lambda: deep_bwd.main(argv))
        want = DEEP_LAYERS if kind == "bf16" else DEEP_LAYERS[:1]
        check([(s["k"], s["n"]) for s in out["shapes"]] == list(map(tuple,
                                                                    want))
              and all(s["batch"] == DEEP_BATCH for s in out["shapes"]),
              f"deep_bwd {argv} ran other shapes")
        for s in out["shapes"]:
            check(s["launches_per_fused_bwd"] == {"dw_fused": 1,
                                                  "dx_fused": 1},
                  f"a fused backward launched {s['launches_per_fused_bwd']}")
        # a shape: parity, the count above, then two warm-up and pairs x
        # launches timed calls of the pair and of each kernel alone
        n = len(want) * (2 + 2 * (2 + out["pairs"] * out["launches"]))
        check(counts["dw_fused"] == counts["dx_fused"] == n,
              f"deep_bwd {argv}: {counts['dw_fused']} + {counts['dx_fused']}"
              f" launches, expected {n} each")
        # every launch on the new form: the tensor cores in bf16, csrc/
        # sgemm.cuh in fp32 (the deep layers take both)
        tag = "tc" if kind == "bf16" else "sgemm"
        on_form = {name: counts[f"{name}@{tag}"]
                   for name in ("dw_fused", "dx_fused")}
        print(f"  deep_bwd {' '.join(argv)}: launches on {tag}: "
              + ", ".join(f"{name} {v}/{counts[name]}"
                          for name, v in on_form.items()))
        check(all(v == n for v in on_form.values()),
              f"deep_bwd {argv}: {on_form} of {n} launches on {tag}")
        launches[kind] = counts

    out, _ = counted(lambda: deep_step.main([]))
    check(out["arch"] == "deep" and out["params"] == 55_987_712
          and out["batch"] == DEEP_BATCH, "deep_step ran another model")
    t = {k: v["median"] for k, v in out["ms"].items()}
    check(all(np.isfinite(v) and v > 0 for v in t.values())
          and t["adam"] >= out["adam_bound_ms"],
          f"deep_step times {t} against the bound {out['adam_bound_ms']}")

    # the whole tree in ONE launch of the tree kernel a step (22 leaves
    # deep, 10 dense), no launch a leaf
    tree_launches = 0
    for arch, backend, n_leaves in (("deep", "xla", DEEP_LEAVES),
                                    ("deep", "pallas", DEEP_LEAVES),
                                    ("dense", "pallas", DENSE_LEAVES)):
        out, counts = counted(lambda: adam_fusion.main(
            ["--arch", arch, "--backend", backend]))
        check(out["states_equal"] and out["leaves"] == n_leaves
              and out["batch"] == DEEP_BATCH and out["backend"] == backend,
              f"adam_fusion {arch}/{backend}: {out}")
        check(out["adam_tree_launches_per_step"] == {"plain": 0,
                                                     "fused": 1},
              f"adam_fusion {arch}/{backend}: adam_tree launches a step "
              f"{out['adam_tree_launches_per_step']}")
        check(counts["adam_tree"] == out["steps_each"]
              and counts["leaf_update"] == 0,
              f"adam_fusion {arch}/{backend}: {counts['adam_tree']} tree "
              f"and {counts['leaf_update']} leaf launches over "
              f"{out['steps_each']} steps")
        if backend == "pallas":
            used = ops.DEEP_KERNELS if arch == "deep" else \
                ops.TRAINING_KERNELS
            for w in used:
                check(counts[w.__name__] > 0, f"adam_fusion {arch}/pallas "
                      f"never launched {w.__name__}")
        rate = out["frames_per_s"]
        print(f"  adam_fusion {arch}/{backend}: fused {rate['fused']:.1f} "
              f"against plain {rate['plain']:.1f} frames/s "
              f"({out['gain_percent']:+.2f} %), step ms "
              f"{out['ms']['fused']['median']:.4f} / "
              f"{out['ms']['plain']['median']:.4f}, 1 adam_tree launch a "
              f"step ({counts['adam_tree']} in {out['steps_each']} steps)")
        tree_launches += counts["adam_tree"]
    launches["fp32"] = dict(launches["fp32"], adam_tree=tree_launches)
    return launches


def step_pair(cfg, ckpt, x, models, tol, label):
    """One step from checkpoint ``ckpt`` on batch ``x`` with each of the two
    models of ``models`` ({name: build(cfg)}), same noise; the first is the
    kernels', the second the plain one.  Returns the kernel launches of the
    first, and under "<wrapper>@tc" / "<wrapper>@sgemm" / "<wrapper>@narrow"
    / "<wrapper>@split" those of a wrapper with a tensor-core / fp32 /
    narrow-channel / 3- or 4-pass tensor-core form that took it."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import (
        TrainState,
        restore_checkpoint,
    )
    from rawaudiovae_kelsey_tpu_torch.tree import leaves, tree_map

    def noise(step, i, shape):
        g = torch.Generator().manual_seed(1000 * step + (i or 0))
        return torch.randn(shape, generator=g)

    out, counts = [], None
    for k, (name, build) in enumerate(models.items()):
        model = build(cfg)
        state, _ = restore_checkpoint(ckpt, TrainState.create(
            model.init(torch.Generator().manual_seed(0)), 0))
        before = tree_map(torch.clone, state.params)
        for w in ops.KERNEL_WRAPPERS:
            w.launches = 0
        fast = [(w, attr, tag) for w in ops.KERNEL_WRAPPERS
                for attr, tag in (("tensor_core_launches", "tc"),
                                  ("sgemm_launches", "sgemm"),
                                  ("narrow_launches", "narrow"),
                                  ("split_launches", "split"))
                if hasattr(w, attr)]
        on_fast = [getattr(w, attr) for w, attr, _ in fast]
        state, m = build_train_step(model, cfg, noise=noise)(state, x)
        torch.cuda.synchronize()
        if k == 0:
            counts = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
            counts.update((f"{w.__name__}@{tag}", getattr(w, attr) - n)
                          for (w, attr, tag), n in zip(fast, on_fast))
        delta = torch.cat([(a - b).ravel() for a, b in
                           zip(leaves(state.params), leaves(before))])
        out.append((float(m["loss"]), delta))
    (lk, dk), (lx, dx) = out
    upd = float((dk - dx).norm() / dx.norm())
    print(f"  one {label} step, {' vs '.join(models)}: loss {lk:.7f} vs "
          f"{lx:.7f}; |update difference| / |update| = {upd:.3e} (tolerance "
          f"{tol:g}); max |param difference| = "
          f"{float((dk - dx).abs().max()):.3e}")
    check(abs(lk / lx - 1) <= tol and upd <= tol,
          f"{label} step: {' and '.join(models)} disagree")
    return counts


def remat_pair(cfg, ckpt, x, fwd, bwd, label, card) -> None:
    """One step of ``cfg`` from checkpoint ``ckpt`` on batch ``x`` with
    ``[tpu] remat = true`` against the same step without it, from the same
    state and noise: the loss, params and Adam moments must be equal bit
    for bit; the forward wrappers ``fwd`` must launch twice as often, the
    backward ones ``bwd`` as often.  Prints both steps' times and peak
    device memory."""
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import (
        TrainState,
        restore_checkpoint,
    )
    from rawaudiovae_kelsey_tpu_torch.tree import leaves

    def noise(step, i, shape):
        g = torch.Generator().manual_seed(1000 * step + (i or 0))
        return torch.randn(shape, generator=g)

    dev = x.device
    model = build_model(cfg, dev)
    start, _ = restore_checkpoint(ckpt, TrainState.create(
        model.init(torch.Generator().manual_seed(0)), 0))
    out, steps = {}, {}
    for remat in (False, True):
        cfg.tpu.remat = remat
        steps[remat] = step = build_train_step(build_model(cfg, dev), cfg,
                                               noise=noise)
        step(start.clone(), x)                                   # warm up
        state = start.clone()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = [w.launches for w in fwd + bwd]
        state, m = step(state, x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        counts = [w.launches - n for w, n in zip(fwd + bwd, before)]
        out[remat] = (m["loss"], leaves((state.params, state.mu, state.nu)),
                      counts, peak)
    cfg.tpu.remat = False
    # the two steps' times, in turns: plain, remat, remat, plain
    times = {False: [], True: []}
    for remat in (False, True, True, False):
        state = start.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps[remat](state, x)
        torch.cuda.synchronize()
        times[remat].append((time.perf_counter() - t0) * 1e3)
    (l0, s0, c0, p0), (l1, s1, c1, p1) = out[False], out[True]
    t0_, t1 = statistics.mean(times[False]), statistics.mean(times[True])
    names = [w.__name__ for w in fwd + bwd]
    print(f"  {label} step with remat against without: loss "
          f"{float(l1):.9f} vs {float(l0):.9f}; launches "
          f"{dict(zip(names, c1))} vs {dict(zip(names, c0))}; "
          f"{t1:.2f} ms vs {t0_:.2f} ms (runs {times[True]} vs "
          f"{times[False]}); peak device memory above the state "
          f"{p1 / 1e6:,.0f} MB vs {p0 / 1e6:,.0f} MB [{card}]")
    check(torch.equal(l0, l1) and all(torch.equal(a, b)
                                      for a, b in zip(s0, s1)),
          f"{label}: the remat step's loss or state differs from the plain "
          "step's")
    nf = len(fwd)
    check(all(c0) and c1[:nf] == [2 * n for n in c0[:nf]]
          and c1[nf:] == c0[nf:],
          f"{label}: remat launches {c1}, plain {c0}: the forward kernels "
          "must launch twice as often, the backward ones as often")


def step_rates(cfg, x, models, card, n=3, focus=None):
    """Steps/s of each model of ``models`` on the device-resident batch
    ``x``, timed first, second, second, first; the busy share of the first;
    each one's device time by kernel (``focus``: device_time_by_kernel's)."""
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    steps = {}
    for name, build in models.items():
        model = build(cfg)
        state = TrainState.create(
            model.init(torch.Generator().manual_seed(0)), 0)
        steps[name] = (build_train_step(model, cfg), state)
        steps[name][0](state, x)                              # warmup
    a, b = models
    times = {a: [], b: []}
    for name in (b, a, a, b):
        step, state = steps[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, x)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / n)
    for name, ts in times.items():
        print(f"  training rate, {name}: "
              f"{x.shape[0] / statistics.mean(ts):,.0f} frames/s (step "
              f"{statistics.mean(ts) * 1e3:.2f} ms; runs "
              f"{[round(t * 1e3, 2) for t in ts]} ms) [{card}]")
    step, state = steps[a]
    print(f"  device busy share over {n} {a} steps: "
          f"{busy_share(lambda: [step(state, x) for _ in range(n)])}")
    for name in (a, b):
        step, state = steps[name]
        print(f"  one {name} step by kernel: "
              f"{device_time_by_kernel(lambda: step(state, x), focus=focus)}")


def train_and_resume(name, cfg, data, epochs, n_batches):
    """The ``train`` command on ``cfg`` for ``epochs`` epochs, then
    ``--resume`` for one more; returns the two run directories."""
    from rawaudiovae_kelsey_tpu_torch.config import save_config
    from rawaudiovae_kelsey_tpu_torch.config.workspace import iter_runs
    from rawaudiovae_kelsey_tpu_torch.train.cli import main as train_cli

    cfg.dataset.datapath = str(data)
    cfg.training.epochs = epochs
    cfg.training.checkpoint_interval = 1
    cfg.training.save_best_model_after = 0
    ini = data / f"{name}.ini"
    save_config(cfg, ini)
    t0 = time.perf_counter()
    train_cli(["--config", str(ini)])
    print(f"  train command: {epochs} epochs in "
          f"{time.perf_counter() - t0:.1f} s (ingest, checkpoints and "
          "reconstructions included)")
    runs = iter_runs(data / cfg.extra.description)
    check(len(runs) == 1, f"expected one run dir, found {runs}")
    ws = runs[0]
    losses = read_scalars(ws / "logs", "Loss/Batch")
    totals = read_scalars(ws / "logs", "Loss/train_total")
    check(sorted(losses) == list(range(epochs * n_batches)),
          f"Loss/Batch steps {sorted(losses)}")
    check(all(np.isfinite(v) for v in losses.values()), "non-finite loss")
    tot = [totals[e] for e in range(epochs)]
    print(f"  epoch losses {tot}; per batch "
          f"{[round(losses[k], 6) for k in sorted(losses)]}")
    check(tot[-1] < tot[0], f"the epoch loss did not fall: {tot}")
    want = ["config.ini", "model/best_model.npz", "model/last_model.npz",
            f"model/checkpoints/ckpt_{epochs:05d}.npz",
            f"audio_logs/test_reconst_{epochs:05d}.wav"]
    for rel in want:
        check((ws / rel).is_file(), f"workspace lacks {rel}")
    cfg.training.epochs = epochs + 1
    save_config(cfg, ini)
    train_cli(["--config", str(ini), "--resume"])
    runs = iter_runs(data / cfg.extra.description)
    check(len(runs) == 2, f"the resume made no new run dir: {runs}")
    resumed = read_scalars(runs[1] / "logs", "Loss/Batch")
    check(sorted(resumed) == list(range(epochs * n_batches,
                                        (epochs + 1) * n_batches)),
          f"the resumed run logged steps {sorted(resumed)}")
    check(all(np.isfinite(v) for v in resumed.values()),
          "non-finite loss after the resume")
    print(f"  resume: one more epoch, steps {sorted(resumed)}, losses "
          f"{[round(resumed[k], 6) for k in sorted(resumed)]}")
    return runs


def phase_deep(tmp: Path, audio, card: str):
    """Phase 8: configs/deep_wide.ini trained and served through the fused
    linear kernels."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.config import load_config
    from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
    from rawaudiovae_kelsey_tpu_torch.data.datasets import AudioFrameDataset
    from rawaudiovae_kelsey_tpu_torch.infer.api import frame_audio
    from rawaudiovae_kelsey_tpu_torch.models import build_model, variants
    from rawaudiovae_kelsey_tpu_torch.ops import linear
    from rawaudiovae_kelsey_tpu_torch.train import (
        latest_checkpoint,
        load_params,
    )
    from rawaudiovae_kelsey_tpu_torch.tree import tree_map

    cfg = load_config(ROOT / "configs" / "deep_wide.ini")
    check(cfg.vae.arch == "deep" and cfg.tpu.precision == "bfloat16"
          and cfg.vae.hidden_dims.replace(" ", "") == "4096,2048,1024,512"
          and (cfg.audio.segment_length, cfg.vae.latent_dim,
               cfg.training.batch_size) == (4096, 256, DEEP_BATCH),
          "configs/deep_wide.ini is not the bf16 4096/4096,2048,1024,512/256 "
          "model at batch 4096")
    cfg.tpu.backend = "pallas"
    batch = DEEP_BATCH
    seg, hop = cfg.audio.segment_length, cfg.audio.hop_length
    n_batches, epochs = 3, 2
    frames = n_batches * batch
    data = tmp / "deep"
    write_corpus(data, frames, hop, seg)
    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    on_tc = [w.tensor_core_launches for w in ops.DEEP_KERNELS]
    runs = train_and_resume("deep", cfg, data, epochs, n_batches)
    launches = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
    launches.update((f"{w.__name__}@tc", w.tensor_core_launches - n)
                    for w, n in zip(ops.DEEP_KERNELS, on_tc))
    print(f"  kernel launches in the two deep training runs: {launches}")
    for w in ops.DEEP_KERNELS:
        check(launches[w.__name__] > 0,
              f"{w.__name__} was never launched by the deep training run")

    dev = torch.device("cuda")
    dataset = AudioFrameDataset(build_corpus(data / "audio", SR)[0], seg, hop,
                                SR)
    x = torch.from_numpy(next(dataset.batches(batch, seed=99))).to(dev)
    ckpt = latest_checkpoint(runs[1] / "model" / "checkpoints")

    def build(backend):
        def make(c):
            c.tpu.backend = backend
            return build_model(c, dev)
        return make

    models = {"kernels": build("pallas"), "plain": build("xla")}
    step_counts = {}
    for precision, tol in (("bfloat16", 5e-2), ("highest", 1e-3)):
        cfg.tpu.precision = precision
        counts = step_counts[precision] = step_pair(cfg, ckpt, x, models, tol,
                                                    f"deep {precision}")
        n_k, n_w, tc_k, tc_w, sg_k, sg_w = (counts[k] for k in (
            "linear_ksplit_fwd", "linear_fwd", "linear_ksplit_fwd@tc",
            "linear_fwd@tc", "linear_ksplit_fwd@sgemm", "linear_fwd@sgemm"))
        print(f"  kernel launches in that step: linear_ksplit_fwd {n_k} "
              f"({tc_k} on the tensor cores, {sg_k} on the fp32 kernel), "
              f"linear_fwd {n_w} ({tc_w} on the tensor cores, {sg_w} on the "
              f"fp32 kernel): {tc_k + tc_w} of {n_k + n_w} linear launches on "
              f"the tensor cores, {sg_k + sg_w} on the fp32 kernel")
        check((n_k, n_w) == (7, 4), f"deep {precision} step: {n_k} k-split + "
              f"{n_w} whole-k launches, expected 7 + 4")
        bf16 = precision == "bfloat16"
        check((tc_k, tc_w, sg_k, sg_w) == ((7, 4, 0, 0) if bf16
                                           else (0, 0, 7, 4)),
              f"deep {precision} step: {tc_k} + {tc_w} linear launches on the "
              f"tensor cores, {sg_k} + {sg_w} on the fp32 kernel (bf16 layers "
              "take the tensor cores, fp32 ones csrc/sgemm.cuh)")
    # remat: the deep bf16 kernel step recomputing its forward
    cfg.tpu.precision, cfg.tpu.backend = "bfloat16", "pallas"
    remat_pair(cfg, ckpt, x, (linear.linear_ksplit_fwd, linear.linear_fwd),
               (), "deep bf16", card)
    # per forward at the server's batch: every layer takes the whole-k
    # kernel; on the fp32 master params the fp32 kernel (csrc/sgemm.cuh), on
    # bf16 ones the tensor cores
    cfg.tpu.precision = "bfloat16"
    model = models["kernels"](cfg)
    params = model.init(torch.Generator().manual_seed(0))
    for dt in (torch.float32, torch.bfloat16):
        for w in ops.DEEP_KERNELS:
            w.launches = 0
        on_tc = linear.linear_fwd.tensor_core_launches
        on_sg = linear.linear_fwd.sgemm_launches
        with torch.inference_mode():
            mu, _ = model.encode(tree_map(lambda t: t.to(dt), params),
                                 x[:SERVE_BATCH].to(dt))
            model.decode(tree_map(lambda t: t.to(dt), params), mu)
        torch.cuda.synchronize()
        n_k, n_w = (w.launches for w in ops.DEEP_KERNELS)
        on_tc = linear.linear_fwd.tensor_core_launches - on_tc
        on_sg = linear.linear_fwd.sgemm_launches - on_sg
        want = (11, 0) if dt == torch.bfloat16 else (0, 11)
        print(f"  a {dt} forward at batch {SERVE_BATCH}: linear_ksplit_fwd "
              f"{n_k}, linear_fwd {n_w} ({on_tc} on the tensor cores, "
              f"{on_sg} on the fp32 kernel)")
        check((n_k, n_w, on_tc, on_sg) == (0, 11, *want),
              f"{dt} batch {SERVE_BATCH}: {n_k} k-split + {n_w} whole-k "
              f"launches, {on_tc} on the tensor cores and {on_sg} on the fp32 "
              f"kernel, expected 0 + 11, {want[0]} and {want[1]}")

    # serve the trained run: fp32 master weights through the whole-k
    # layer's fp32 kernel (csrc/sgemm.cuh)
    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    on_tc = linear.linear_fwd.tensor_core_launches
    on_sg = linear.linear_fwd.sgemm_launches
    out, lat_ms = phase_serve(runs[0], audio, False)
    serve_launches = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
    serve_launches["linear_fwd@sgemm"] = \
        linear.linear_fwd.sgemm_launches - on_sg
    print(f"  kernel launches in the deep serving path: "
          f"{ {k: v for k, v in serve_launches.items() if v} }")
    check(serve_launches["linear_fwd"] > 0
          and serve_launches["linear_fwd@sgemm"]
          == serve_launches["linear_fwd"]
          and serve_launches["linear_ksplit_fwd"] == 0
          and linear.linear_fwd.tensor_core_launches == on_tc,
          "the deep server did not run every launch on the fp32 kernel of "
          "linear_fwd (it serves fp32)")
    served = load_params(runs[0] / "model" / "best_model.npz", params)
    with torch.inference_mode():
        fr = torch.from_numpy(np.ascontiguousarray(
            frame_audio(audio, seg))).to(dev)
        mu, _ = variants.encode_deep(served, fr)
        want = variants.decode_deep(served, mu).cpu().numpy().reshape(-1)
    e = float(np.abs(out["flat"][:, 0] - want).max())
    print(f"  /reconstruct vs the plain backend: max err {e:.3e}; median "
          f"latency {lat_ms:.2f} ms")
    check(e <= HTTP_ATOL, "deep /reconstruct differs from the plain backend")

    # the library path on the served weights: encode_trajectory /
    # decode_trajectory through the kernels (fp32: the whole-k layer's fp32
    # kernel) against the plain backend on the same card
    from rawaudiovae_kelsey_tpu_torch.infer.api import (
        decode_trajectory,
        encode_trajectory,
    )

    for w in ops.DEEP_KERNELS:
        w.launches = 0
    on_sg = linear.linear_fwd.sgemm_launches
    mu, logvar = encode_trajectory(model, served, audio)
    y = decode_trajectory(model, served, mu)
    lib = {w.__name__: w.launches for w in ops.DEEP_KERNELS}
    lib["linear_fwd@sgemm"] = linear.linear_fwd.sgemm_launches - on_sg
    plain = models["plain"](cfg)
    want_mu, want_lv = encode_trajectory(plain, served, audio)
    e = max(float(np.abs(a - b).max()) for a, b in (
        (mu, want_mu), (logvar, want_lv),
        (y, decode_trajectory(plain, served, mu))))
    print(f"  encode_trajectory / decode_trajectory of {len(mu)} frames "
          f"through the kernels: launches {lib}; vs the plain backend: max "
          f"err {e:.3e}")
    check(lib == {"linear_ksplit_fwd": 0, "linear_fwd": 11,
                  "linear_fwd@sgemm": 11},
          f"deep library path: launches {lib}, expected 0 k-split and 11 "
          "whole-k, all on the fp32 kernel")
    check(e <= HTTP_ATOL, "deep encode_trajectory / decode_trajectory "
          "differ from the plain backend")

    step_rates(cfg, x, models, card)
    return launches, step_counts["highest"], serve_launches


def phase_conv(tmp: Path, card: str):
    """Phase 9: configs/conv1d.ini trained through the registry, and one
    step through the block-Toeplitz op-level path."""
    import dataclasses
    from functools import partial

    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.config import load_config
    from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
    from rawaudiovae_kelsey_tpu_torch.data.datasets import AudioFrameDataset
    from rawaudiovae_kelsey_tpu_torch.models import build_model, variants
    from rawaudiovae_kelsey_tpu_torch.train import latest_checkpoint

    cfg = load_config(ROOT / "configs" / "conv1d.ini")
    check(cfg.vae.arch == "conv1d" and cfg.tpu.precision == "bfloat16"
          and cfg.vae.conv_channels.replace(" ", "") == "32,64,128,256"
          and (cfg.vae.conv_kernel, cfg.vae.conv_stride) == (CONV_K, CONV_S)
          and (cfg.audio.segment_length, cfg.vae.latent_dim,
               cfg.training.batch_size) == (1024, 256, DEEP_BATCH),
          "configs/conv1d.ini is not the bf16 32,64,128,256 / 9 / 4 model at "
          "batch 4096")
    batch = DEEP_BATCH
    seg, hop = cfg.audio.segment_length, cfg.audio.hop_length
    n_batches, epochs = 3, 2
    data = tmp / "conv"
    write_corpus(data, n_batches * batch, hop, seg)
    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    runs = train_and_resume("conv1d", cfg, data, epochs, n_batches)
    check(not any(w.launches for w in ops.KERNEL_WRAPPERS),
          "the registry's conv1d model launched a kernel: it runs the plain "
          "convolutions under every backend")

    dev = torch.device("cuda")
    dataset = AudioFrameDataset(build_corpus(data / "audio", SR)[0], seg, hop,
                                SR)
    x = torch.from_numpy(next(dataset.batches(batch, seed=99))).to(dev)
    ckpt = latest_checkpoint(runs[1] / "model" / "checkpoints")
    width = variants.conv_latent_width(seg, 4, CONV_S)

    def op_level(c):
        # the registry's model with its encode / decode replaced by the
        # Toeplitz path: the explicit op-level API
        return dataclasses.replace(
            build_model(c, dev),
            encode=partial(ops.conv_encode_pallas, stride=CONV_S),
            decode=partial(ops.conv_decode_pallas, stride=CONV_S,
                           width=width, channels=256))

    models = {"toeplitz": op_level, "registry": lambda c: build_model(c, dev)}
    # the Toeplitz kernels in a trace, by name or template argument: the
    # tensor-core tile walk (the 4-pass form's too), the 4-pass form and
    # its split pass, the fp32 kernel, the narrow-channel kernel, the first
    # version's implicit A
    focus = {"Toeplitz on the tensor cores": "ToeplitzTiles",
             "of which 4-pass": "FourPassRows",
             "split pass": "split_pass",
             "Toeplitz on sgemm.cuh": "sgemm_toeplitz_kernel",
             "Toeplitz narrow": "narrow_kernel",
             "Toeplitz first version": "ToeplitzRows"}
    step_counts = {}
    # the `high` step: every wide Toeplitz product in four bf16 passes on
    # the tensor cores (JAX's toeplitz_fwd under `high`), the heads and
    # dec_in in one fp32 pass, as in JAX; held against the registry's IEEE
    # fp32 step with `highest`'s tolerance
    for precision, tol in (("bfloat16", 5e-2), ("highest", 1e-3),
                           ("high", 1e-3)):
        cfg.tpu.precision = precision
        counts = step_counts[precision] = step_pair(
            cfg, ckpt, x, models, tol, f"conv1d {precision}")
        forms = {tag: counts[f"toeplitz_fwd@{tag}"]
                 for tag in ("tc", "split", "sgemm", "narrow")}
        print(f"  kernel launches in that step: toeplitz_fwd "
              f"{counts['toeplitz_fwd']} ({forms['tc']} on the tensor "
              f"cores, {forms['split']} on the tensor cores in four passes, "
              f"{forms['sgemm']} on sgemm.cuh, {forms['narrow']} narrow, "
              f"{counts['toeplitz_fwd'] - sum(forms.values())} on the first "
              f"version), linear_fwd {counts['linear_fwd']} "
              f"({counts['linear_fwd@tc']} on the tensor cores, "
              f"{counts['linear_fwd@sgemm']} on sgemm.cuh), "
              f"linear_ksplit_fwd {counts['linear_ksplit_fwd']}")
        # 8 forward, 7 for dx: the first layer's input is the batch, which
        # needs no gradient; the two heads and dec_in take the whole-k kernel
        check(counts["toeplitz_fwd"] == 15 and counts["linear_fwd"] == 3
              and counts["linear_ksplit_fwd"] == 0,
              f"conv1d {precision} step: {counts['toeplitz_fwd']} Toeplitz + "
              f"{counts['linear_fwd']} whole-k launches, expected 8 + 7 and 3")
        # the first encoder layer (G = 4) and the last decoder layer and its
        # dx (N = 4, G = 4) take the narrow kernel; the other twelve the
        # tensor cores in bf16, the fp32 kernel at `highest` and the 4-pass
        # tensor-core form under `high`: none the first version
        bf16 = precision == "bfloat16"
        wide = {"bfloat16": "tc", "highest": "sgemm", "high": "split"}
        want = {tag: 12 * (tag == wide[precision])
                for tag in ("tc", "split", "sgemm")}
        want["narrow"] = 3
        check(forms == want and counts["linear_fwd@tc"] == 3 * bf16
              and counts["linear_fwd@sgemm"] == 3 * (not bf16),
              f"conv1d {precision} step: Toeplitz launches by form {forms}, "
              f"expected {want}; {counts['linear_fwd@tc']} / "
              f"{counts['linear_fwd@sgemm']} whole-k launches on the tensor "
              f"cores / sgemm.cuh, expected {3 * bf16} / {3 * (not bf16)}")
    cfg.tpu.precision = "bfloat16"
    step_rates(cfg, x, models, card, focus=focus)
    # the `highest` op-level step's device time by kernel, beside the bf16
    # one step_rates printed
    from rawaudiovae_kelsey_tpu_torch.parallel import build_train_step
    from rawaudiovae_kelsey_tpu_torch.train import TrainState

    # and the `high` one's
    for precision in ("highest", "high"):
        cfg.tpu.precision = precision
        model = op_level(cfg)
        state = TrainState.create(
            model.init(torch.Generator().manual_seed(0)), 0)
        step = build_train_step(model, cfg)
        step(state, x)                                        # warmup
        by_kernel = device_time_by_kernel(lambda: step(state, x), top=8,
                                          focus=focus)
        print(f"  one toeplitz {precision} step by kernel: {by_kernel}")
    cfg.tpu.precision = "bfloat16"
    return step_counts


LIBRARY_CLIPS = 12            # phase 11's wav folder: clips of 1-3 s
LIBRARY_RATE_S = 60.0         # the clip encode_trajectory's rate is timed on
LIBRARY_WAVS = ("source_a.wav", "source_b.wav", "morph_stepwise.wav",
                "morph_timevarying.wav", "morph_gentle.wav", "recon_ola.wav",
                "stretch_effect.wav")


def phase_library(tmp: Path, card: str, gen_params) -> None:
    """Phase 11: the tutorial's latent-space API, the SOM and export on the
    dense model of configs/default.ini, through the commands a user runs
    and through the library calls beneath them."""
    import copy

    from rawaudiovae_kelsey_tpu_torch import __main__ as cli
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.compat import params_to_state_dict
    from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
    from rawaudiovae_kelsey_tpu_torch.infer import (
        OnnxModel,
        SomClusters,
        api,
        concat_random_audio,
        export,
        som_train,
    )
    from rawaudiovae_kelsey_tpu_torch.io import read_wav, write_wav
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.train import save_params

    cfg = load_config(ROOT / "configs" / "default.ini")
    rng = np.random.default_rng(21)
    audio_dir = tmp / "wavs"
    audio_dir.mkdir(parents=True)
    for i in range(LIBRARY_CLIPS):
        t = np.arange(int(rng.uniform(1.0, 3.0) * SR)) / SR
        f1, f2 = rng.uniform(80.0, 2000.0, 2)
        wave = (0.3 * np.sin(2 * np.pi * f1 * t)
                + 0.2 * np.sin(2 * np.pi * f2 * t)
                + 0.05 * rng.standard_normal(t.size))
        write_wav(audio_dir / f"clip{i:02d}.wav", wave.astype(np.float32), SR)
    run = tmp / "run-001"
    save_config(cfg, run / "config.ini")
    params = gen_params(11)
    save_params(run / "model" / "best_model.npz", params)

    dense = (ops.encoder_fwd, ops.decoder_fwd)
    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    for w in dense:
        w.sgemm_launches = 0
    # the commands, as `python -m rawaudiovae_kelsey_tpu_torch <command>`
    # runs them (on the card: --device defaults to cuda)
    tut, som_dir, exp = tmp / "tutorial", tmp / "som", tmp / "export"
    t0 = time.perf_counter()
    cli.example("tutorial", ["--run", str(run), "--audio", str(audio_dir),
                             "--out", str(tut)])
    t1 = time.perf_counter()
    cli.som(["--run", str(run), "--audio", str(audio_dir), "--out",
             str(som_dir), "--grid", "8,8", "--iters", "200"])
    t2 = time.perf_counter()
    cli.example("export", ["--run", str(run), "--out", str(exp)])
    t3 = time.perf_counter()
    print(f"  commands: tutorial {t1 - t0:.2f} s, som {t2 - t1:.2f} s, "
          f"export {t3 - t2:.2f} s")
    for name in LIBRARY_WAVS:
        wave, sr = read_wav(tut / name)
        check(sr == SR and wave.size > 0 and bool(np.isfinite(wave).all())
              and float(np.abs(wave).max()) > 1e-3,
              f"tutorial {name}: empty, non-finite or silent")
    png = tut / "comparison.png"
    print(f"  tutorial: {len(LIBRARY_WAVS)} wavs finite and not silent; "
          + ("comparison.png written" if png.exists() else
             "no comparison.png (matplotlib is not installed here)"))
    clusters = SomClusters(som_dir / "clusters.json",
                           som_dir / "data-concatenated.json")
    ids = clusters.cluster_ids()
    members = sum(len(clusters.clusters[str(c)]) for c in ids)
    check(members == LIBRARY_CLIPS, f"som: {members} clips in clusters.json, "
          f"expected {LIBRARY_CLIPS}")
    biggest = max(ids, key=lambda c: len(clusters.clusters[str(c)]))
    joined = clusters.concat_audio(audio_dir, biggest, sr=SR)
    check(joined.size > 0 and bool(np.isfinite(joined).all())
          and float(np.abs(joined).max()) > 1e-3,
          f"som: cluster {biggest}'s audio is empty or silent")
    print(f"  som: {len(ids)} populated units of 64; cluster {biggest} "
          f"({len(clusters.clusters[str(biggest)])} clips) concatenated to "
          f"{joined.size / SR:.2f} s")
    exported = sorted(p.name for p in exp.iterdir())
    check(exported == ["rawaudiovae.onnx", "rawaudiovae.pt2",
                       "rawaudiovae_det.onnx", "rawaudiovae_det.pt2",
                       "rawaudiovae_weights.npz"], f"export: {exported}")

    # the library calls, through the kernels and through the plain ops
    model = build_model(cfg, "cuda")
    check(model.backend == "pallas", f"backend {model.backend}")
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.tpu.backend = "xla"
    plain = build_model(plain_cfg, "cuda")
    clip = concat_random_audio(audio_dir, 4.0, SR, seed=5)
    other = concat_random_audio(audio_dir, 4.0, SR, seed=6)
    out = {}
    for label, m in (("kernels", model), ("plain", plain)):
        mu_a, lv_a = api.encode_trajectory(m, params, clip)
        mu_b, lv_b = api.encode_trajectory(m, params, other)
        out[label] = {
            "mu": mu_a, "logvar": lv_a,
            "stepwise": api.interpolate_stepwise(
                m, params, mu_a, lv_a, mu_b, lv_b, deterministic=True),
            "timevarying": api.interpolate_timevarying(
                m, params, mu_a, lv_a, mu_b, lv_b, api.sine_alfa(20000, 500),
                deterministic=True)}
    errs = {k: float(np.abs(v - out["plain"][k]).max())
            for k, v in out["kernels"].items()}
    print(f"  4 s clip, {len(out['kernels']['mu'])} frames: kernels vs the "
          "plain backend, max err "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    for k, e in errs.items():
        check(e <= HTTP_ATOL, f"{k} through the kernels differs from the "
              "plain backend")
    mu_a, lv_a = out["kernels"]["mu"], out["kernels"]["logvar"]
    mu_b, lv_b = api.encode_trajectory(model, params, other)
    twice = [api.interpolate_stepwise(model, params, mu_a, lv_a, mu_b, lv_b,
                                      seed=3) for _ in range(2)]
    check(np.array_equal(*twice) and bool(np.isfinite(twice[0]).all()),
          "two stochastic interpolate_stepwise calls of one seed differ")
    check(not np.array_equal(twice[0], out["kernels"]["stepwise"]),
          "the stochastic interpolation equals z = mu's")
    launches = {w.__name__: w.launches for w in dense}
    on_sgemm = {w.__name__: w.sgemm_launches for w in dense}
    print("  the phase's launches: " + ", ".join(
        f"{name} {n} ({on_sgemm[name]} on csrc/sgemm.cuh)"
        for name, n in launches.items()))
    for name, n in launches.items():
        check(n > 0 and on_sgemm[name] == n, f"{name}: {on_sgemm[name]} of "
              f"{n} library-path launches on csrc/sgemm.cuh")

    # the exports, run on the card
    x = api.frame_audio(clip, cfg.audio.segment_length)
    onnx_out = OnnxModel.load(exp / "rawaudiovae_det.onnx").run({"input": x})
    with torch.inference_mode():
        fwd = export.make_forward_fn(model, True)(
            params, torch.from_numpy(x).cuda())
    for name, want in zip(("recon", "mu", "logvar"), fwd):
        want = want.cpu().numpy()
        e = float(np.abs(onnx_out[name] - want).max())
        scale = float(np.abs(want).max())
        print(f"  rawaudiovae_det.onnx ({x.shape[0]} frames) vs the "
              f"forward on the card: {name} max err {e:.3e} (limit "
              f"{1e-4 * scale:.3e})")
        check(e <= 1e-4 * scale, f"the .onnx's {name} differs")
    x1 = torch.from_numpy(x[:1]).cuda()
    with torch.inference_mode():
        want = export.make_forward_fn(plain, True)(params, x1)
        got = export.load_program(exp / "rawaudiovae_det.pt2")(x1)
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        torch.manual_seed(0)
        sto = export.load_program(exp / "rawaudiovae.pt2")(x1)
    print(f"  rawaudiovae_det.pt2 on the card vs the plain forward: max err "
          f"{e:.3e}; rawaudiovae.pt2 (noise in the graph) finite: "
          f"{bool(torch.isfinite(sto[0]).all())}")
    check(e <= 1e-5, "the exported program differs from the plain forward")
    check(bool(torch.isfinite(sto[0]).all())
          and torch.equal(sto[1], got[1]), "the stochastic program's output")
    with np.load(exp / "rawaudiovae_weights.npz") as npz:
        want = params_to_state_dict(params)
        check(sorted(npz.files) == sorted(want) and all(
            np.array_equal(npz[k], v) for k, v in want.items()),
            "rawaudiovae_weights.npz does not read back equal")

    # encode_trajectory's rate at batch 256, kernels and plain in turns
    long = concat_random_audio(audio_dir, LIBRARY_RATE_S, SR, seed=7)
    frames = len(api.frame_audio(long, cfg.audio.segment_length))
    rates = {"kernels": [], "plain": []}
    for label in ("kernels", "plain", "plain", "kernels", "kernels", "plain"):
        m = model if label == "kernels" else plain
        t0 = time.perf_counter()
        api.encode_trajectory(m, params, long, batch_size=BATCH)
        rates[label].append(frames / (time.perf_counter() - t0))
    print(f"  encode_trajectory of {frames} frames at batch {BATCH}: "
          + ", ".join(f"{k} {statistics.median(v):,.0f} frames/s "
                      f"(runs {[round(r) for r in v]})"
                      for k, v in rates.items()))
    feats, _ = som_train.extract_file_features(model, params, audio_dir, SR)
    fit_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        codebook = som_train.train_som(feats, grid=(8, 8), iters=200,
                                       device="cuda")
        fit_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"  SOM fit (8x8 units, 200 iterations, {len(feats)} features of "
          f"{feats.shape[1]}) on the card: median "
          f"{statistics.median(fit_ms):.2f} ms (runs "
          f"{[round(t, 2) for t in fit_ms]})")
    # the card's fit against the CPU's fp32 and float64 fits from the same
    # initial codebook: units drawn from one sample sit within the fp32
    # search's rounding of it, so the fits may part value by value; the
    # quantization error and every feature's BMU distance hold them alike
    x = torch.from_numpy(feats)
    w0 = som_train.initial_codebook(x, (8, 8))
    cpu32 = som_train.fit_som(x, w0, (8, 8), 200).numpy()
    cpu64 = som_train.fit_som(x.double(), w0.double(), (8, 8), 200).numpy()
    spread = float(np.linalg.norm(feats - feats.mean(axis=0), axis=1).mean())
    quality = {
        name: som_train.fit_quality(feats, w, som_train.assign_clusters(
            feats, w, dev))
        for name, w, dev in (("card", codebook, "cuda"),
                             ("cpu fp32", cpu32, "cpu"),
                             ("cpu float64", cpu64, "cpu"))}
    print(f"  SOM fit values: card vs cpu fp32 max "
          f"{np.abs(codebook - cpu32).max():.3e}, cpu fp32 vs cpu float64 "
          f"max {np.abs(cpu32 - cpu64).max():.3e}, card vs cpu float64 max "
          f"{np.abs(codebook - cpu64).max():.3e}; quantization error / BMU "
          "gap: " + ", ".join(f"{k} {q:.6e} / {g:.2e}"
                              for k, (q, g) in quality.items())
          + f" (data spread {spread:.6e})")
    qe64 = quality["cpu float64"][0]
    qe, gap = quality["card"]
    check(abs(qe - qe64) <= 0.05 * spread, f"the card's SOM fit: "
          f"quantization error {qe:.6e} against float64's {qe64:.6e}")
    check(gap <= 1e-5, f"the card's SOM assignment misses a nearest unit "
          f"by {gap:.2e}")
    print(f"  {card}")


def off_path(row: dict) -> None:
    """Print a row that was held against its plain version and timed, but
    that no path of the package launches: it stays out of the kernel line.
    A row whose new form was timed beside its library sequence and its
    first version (fp32 rows 8-10) prints those too."""
    extra = "".join(
        f", {label} {row[key]:.4f} ms" for key, label in (
            ("device_ms", "device"), ("library_ms", "library sequence "
                                                    "(device)"),
            ("first_version_ms", "first version"),
            ("first_version_device_ms", "first version (device)"))
        if row.get(key) is not None)
    print(f"  on no path, out of the kernel line: {row['name']}: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}){extra}")


def host_cost() -> dict:
    """``--host-cost``: the host time of one call (µs, ``host_us``, the
    median of five rounds) of the four wrappers with a tensor-core form, as
    the package beside this file ships them, on bf16 operands whose kernels
    take a few µs, and of the two with an fp32 form (``linear_fwd``,
    ``matmul_nt``; "[fp32]") on fp32 operands, each beside the one PyTorch
    call of the same function; and of one Adam update of a tree shaped as
    the deep model's and as the dense model's (22 and 10 leaves, of 256
    elements here so that the device never holds the host back):
    ``fused_adam_apply`` (one launch of the tree kernel), its first version
    (a launch a leaf), ``Adam.update`` and
    ``torch.optim.Adam(fused=True)``'s ``step``.  Needs nothing of this
    script's other phases, so a copy of it in another checkout times that
    checkout's wrappers."""
    import torch.nn.functional as F

    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import adam, linear, mlp, toeplitz
    from rawaudiovae_kelsey_tpu_torch.probes import common
    from rawaudiovae_kelsey_tpu_torch.train import Adam, TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves, unflatten

    dev = torch.device("cuda")
    bf16 = dict(device=dev, dtype=torch.bfloat16)
    x, w, b = (torch.zeros(sh, **bf16) for sh in ((128, 64), (64, 128),
                                                   (128,)))
    wt = w.t().contiguous()
    xs, ws = (torch.zeros(sh, **bf16) for sh in ((2, 64, 64), (3, 64, 64)))
    bs = torch.zeros((64,), **bf16)
    xc, wc = xs.transpose(1, 2).contiguous(), ws.permute(2, 1, 0).contiguous()
    calls = {
        "matmul_nt": lambda: mlp.matmul_nt(x, wt),
        "a @ w.t()": lambda: x @ wt.t(),
        "linear_ksplit_fwd": lambda: linear.linear_ksplit_fwd(x, w, b),
        "linear_fwd": lambda: linear.linear_fwd(x, w, b),
        "torch.addmm": lambda: torch.addmm(b, x, w),
        "toeplitz_fwd": lambda: toeplitz.toeplitz_fwd(xs, ws, bs, "none", 64,
                                                      1),
        "F.conv1d": lambda: F.conv1d(xc, wc, bs, padding=1),
    }
    x32, w32, b32, wt32 = (t.float() for t in (x, w, b, wt))
    calls.update({
        "matmul_nt[fp32]": lambda: mlp.matmul_nt(x32, wt32),
        "a @ w.t()[fp32]": lambda: x32 @ wt32.t(),
        "linear_fwd[fp32]": lambda: linear.linear_fwd(x32, w32, b32),
        "torch.addmm[fp32]": lambda: torch.addmm(b32, x32, w32),
    })
    opt = Adam(learning_rate=1e-4)
    for arch in ("deep", "dense"):
        shape_of = build_model(common.build_cfg(arch, DEEP_BATCH, "bfloat16",
                                                "xla"), dev).init(
            torch.Generator().manual_seed(0))

        def small_tree():
            return unflatten(shape_of, [torch.zeros(256, device=dev)
                                        for _ in leaves(shape_of)])

        state, grads = TrainState.create(small_tree(), 0), small_tree()
        plain = state.clone()
        lib_params = [torch.nn.Parameter(t.clone())
                      for t in leaves(state.params)]
        for t, grad in zip(lib_params, leaves(grads)):
            t.grad = grad
        tag = f"[{len(lib_params)} leaves]"
        calls.update({
            f"fused_adam_apply{tag}": (
                lambda state=state, grads=grads: adam.fused_adam_apply(
                    opt, state, grads)),
            f"fused_adam_apply[first]{tag}": (
                lambda state=state, grads=grads: adam.fused_adam_apply(
                    opt, state, grads, kernel="first")),
            f"Adam.update{tag}": (
                lambda plain=plain, grads=grads: opt.update(plain, grads)),
            f"torch.optim.Adam(fused=True){tag}": torch.optim.Adam(
                lib_params, lr=1e-4, fused=True).step,
        })
    # the host's rate drifts: five rounds of every call in turn, the median
    rounds = [{name: host_us(fn) for name, fn in calls.items()}
              for _ in range(5)]
    return {name: round(statistics.median(r[name] for r in rounds), 2)
            for name in calls}


# ------------------------------------------------------------- phase 13
#
# Data parallelism (parallel/mesh.py): two ranks that share the one card
# over gloo, each a process started with torch.multiprocessing (spawn), the
# group initialised here so the port uses it as it stands; then NCCL at one
# rank a card.  A rank's results come back pickled.

MESH_RANKS = 2
# the collectives that are called on CUDA tensors under gloo, held first:
# the port calls all_reduce (the step's bucket, n_real, the stop flag's
# CPU copy under gloo), broadcast (params, text), all_gather (row counts,
# encodes, reconstructions) and all_to_all_single (the two-pass shuffle)
MESH_COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
                    "all_to_all_single", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "all_to_all")


def mesh_device() -> torch.device:
    """This rank's card: cuda:0 for the ranks that share it, the rank's
    own under NCCL (``mesh_rank`` set it current)."""
    return torch.device("cuda", torch.cuda.current_device())


def mesh_launches(dense_tc=(), fp32_sgemm=()):
    """Reset every wrapper's launch counts; returns a reader of them (with
    "<name>@tc" / "@sgemm" for the forms a wrapper names)."""
    from rawaudiovae_kelsey_tpu_torch import ops

    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    for w in dense_tc:
        w.tensor_core_launches = 0
    for w in fp32_sgemm:
        w.sgemm_launches = 0

    def read():
        counts = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
        counts.update((f"{w.__name__}@tc", w.tensor_core_launches)
                      for w in dense_tc)
        counts.update((f"{w.__name__}@sgemm", w.sgemm_launches)
                      for w in fp32_sgemm)
        return counts
    return read


def mesh_digest(params) -> str:
    import hashlib

    from rawaudiovae_kelsey_tpu_torch.tree import flatten

    h = hashlib.sha256()
    for name, t in flatten(params):
        h.update(name.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def mesh_collectives(rank, world, data):
    """Which collectives gloo takes on CUDA tensors with this torch."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.ones(4 * world, device=dev)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x),
        "broadcast": lambda: dist.broadcast(x, 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(4, device=dev) for _ in range(world)],
            torch.ones(4, device=dev)),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=dev), torch.ones(4, device=dev)),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), x),
        "all_to_all": lambda: dist.all_to_all(
            [torch.empty(4, device=dev) for _ in range(world)],
            [torch.ones(4, device=dev) for _ in range(world)]),
    }
    out = {}
    for name in MESH_COLLECTIVES:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as err:
            out[name] = str(err).splitlines()[0][:120]
    return out


def mesh_config(name: str, data: Path, **changes):
    from rawaudiovae_kelsey_tpu_torch.config import load_config

    cfg = load_config(ROOT / "configs" / name)
    cfg.dataset.datapath = str(data)
    cfg.training.save_best_model_after = 0
    for key, value in changes.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, value)
    return cfg


def mesh_epoch_trainer(rank, world, data):
    """The epoch trainer of configs/default.ini (bf16, pallas, batch
    131072, microbatch 8192), host-fed, 2 epochs of one global batch."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.train import epoch

    cfg = mesh_config("default.ini", data, training__epochs=2,
                      training__checkpoint_interval=1,
                      tpu__device_resident="never")
    dense_tc = (ops.encoder_fwd, ops.decoder_fwd, ops.dec_bwd_fused,
                ops.grad_accum, ops.enc_bwd_dw1, ops.grad_accum2)
    read = mesh_launches(dense_tc)
    t0 = time.perf_counter()
    ctx = epoch.train(cfg, verbose=False, device=mesh_device())
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "launches": read(),
            "step": ctx.state.step, "digest": mesh_digest(ctx.state.params),
            "workdir": str(ctx.workspace.workdir),
            "writer": None if ctx.writer.path is None
            else str(ctx.writer.path)}


def mesh_global_batch(data: Path, rows: int, seg: int, hop: int):
    """``rows`` frames of the whole folder, the same on every rank."""
    from rawaudiovae_kelsey_tpu_torch.data.corpus import build_corpus
    from rawaudiovae_kelsey_tpu_torch.data.datasets import AudioFrameDataset

    corpus = build_corpus(data / "audio", SR)[0]
    return next(AudioFrameDataset(corpus, seg, hop, SR).batches(
        rows, seed=99))


def mesh_step_pair(rank, world, cfg, batch, label, timed=0):
    """One mesh step of ``cfg`` on this rank's rows of ``batch`` against
    the one-rank step on the whole batch (run on rank 0), from the same
    init and the same global noise: the relative update difference, the
    losses, the mesh step's launches on this rank, and, with ``timed``,
    the wall time of ``timed`` mesh steps (both ranks) and one-rank steps
    (rank 0, the other rank waiting)."""
    import torch.distributed as dist

    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import (
        build_train_step,
        make_mesh,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import local_rows
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves, tree_map

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(device=dev)

    def noise(step, i, shape):
        g = torch.Generator().manual_seed(1000 * step + (i or 0))
        return torch.randn(shape, generator=g)

    model = build_model(cfg, dev)
    init = model.init(torch.Generator().manual_seed(0))
    rows = local_rows(mesh, len(batch), cfg.tpu.microbatch_size)
    x_local = torch.from_numpy(np.ascontiguousarray(batch[rows])).to(dev)
    fast = [(w, attr, tag) for w in ops.KERNEL_WRAPPERS
            for attr, tag in (("tensor_core_launches", "tc"),
                              ("sgemm_launches", "sgemm"))
            if hasattr(w, attr)]

    def run(step, state, x):
        before = tree_map(torch.clone, state.params)
        state, m = step(state, x)
        delta = torch.cat([(a - b).ravel() for a, b in
                           zip(leaves(state.params), leaves(before))])
        return float(m["loss"]), delta

    mesh_step = build_train_step(model, cfg, noise=noise, mesh=mesh)
    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
    on_fast = [getattr(w, attr) for w, attr, _ in fast]
    loss_m, delta_m = run(mesh_step, TrainState.create(
        tree_map(torch.clone, init), 0), x_local)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in ops.KERNEL_WRAPPERS}
    counts.update((f"{w.__name__}@{tag}", getattr(w, attr) - n)
                  for (w, attr, tag), n in zip(fast, on_fast))
    out = {"label": label, "launches": counts, "loss_mesh": loss_m,
           "digest": mesh_digest_tensor(delta_m)}
    if rank == 0:
        one_step = build_train_step(model, cfg, noise=noise)
        x_all = torch.from_numpy(batch).to(dev)
        loss_1, delta_1 = run(one_step, TrainState.create(
            tree_map(torch.clone, init), 0), x_all)
        out.update(loss_one=loss_1, update_rel=float(
            (delta_m - delta_1).norm() / delta_1.norm()),
            max_param_diff=float((delta_m - delta_1).abs().max()))
    if timed:
        # timed with the steps' own noise (drawn on the card), as the
        # trainers run them
        mesh_step = build_train_step(model, cfg, mesh=mesh)
        if rank == 0:
            one_step = build_train_step(model, cfg)
        state = TrainState.create(tree_map(torch.clone, init), 0)
        mesh_step(state, x_local)                     # warm
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, m = mesh_step(state, x_local)
        float(m["loss"])
        torch.cuda.synchronize()
        out["mesh_ms"] = (time.perf_counter() - t0) / timed * 1e3
        dist.barrier()
        if rank == 0:
            state = TrainState.create(tree_map(torch.clone, init), 0)
            one_step(state, x_all)                    # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(timed):
                state, m = one_step(state, x_all)
            float(m["loss"])
            torch.cuda.synchronize()
            out["one_ms"] = (time.perf_counter() - t0) / timed * 1e3
        dist.barrier()
    return out


def mesh_digest_tensor(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[
        :16]


def mesh_steps(rank, world, data):
    """The default.ini step at bf16 (timed), `high` and `highest` on 2
    ranks against the one-rank step, then one 2-rank step of
    configs/deep_wide.ini (pallas, bf16, batch 4096)."""
    cfg = mesh_config("default.ini", data)
    batch = mesh_global_batch(data, cfg.training.batch_size, SEG,
                              cfg.audio.hop_length)
    out = [mesh_step_pair(rank, world, cfg, batch, "bfloat16", timed=3)]
    for precision in ("high", "highest"):
        cfg.tpu.precision = precision
        out.append(mesh_step_pair(rank, world, cfg, batch, precision))
    del batch
    deep = mesh_config("deep_wide.ini", data, tpu__backend="pallas")
    rng = np.random.default_rng(3)
    seg = deep.audio.segment_length
    t = np.arange(deep.training.batch_size * seg).reshape(-1, seg) / SR
    xb = (0.3 * np.sin(2 * np.pi * 220 * t)
          + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    out.append(mesh_step_pair(rank, world, deep, xb, "deep_wide bfloat16"))
    return out


def mesh_resident(rank, world, data):
    """The sharded resident epochs of configs/perf_bf16.ini (tpu_prng, the
    block shuffle: two passes on a mesh), 2 epochs, kernels by name; the
    sampler's seed words recorded, and the first held against the plain
    Philox of the folded seed."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.ops import rng
    from rawaudiovae_kelsey_tpu_torch.parallel import noise_seed
    from rawaudiovae_kelsey_tpu_torch.train import epoch

    cfg = mesh_config("perf_bf16.ini", data, training__epochs=2,
                      training__checkpoint_interval=1, tpu__backend="pallas")
    seen = []
    original = rng.reparameterize

    def recording(seed, mu, logvar):
        if len(seen) < 4:
            seen.append((tuple(seed), tuple(mu.shape)))
        return original(seed, mu, logvar)

    dense_tc = (ops.encoder_fwd, ops.decoder_fwd, ops.dec_bwd_fused,
                ops.grad_accum, ops.enc_bwd_dw1, ops.grad_accum2)
    read = mesh_launches(dense_tc)
    rng.reparameterize = recording
    try:
        ctx = epoch.train(cfg, verbose=False, device=mesh_device())
    finally:
        rng.reparameterize = original
    counts = read()
    seed, shape = seen[0]
    dev = torch.device("cuda", torch.cuda.current_device())
    read_words = mesh_launches()
    words = rng.philox_words(seed, shape[0], shape[1], dev).cpu()
    ref = rng.philox_words_ref(seed, shape[0], shape[1])
    want = rng.shard_seed(rng.seed_words(noise_seed(cfg.tpu.seed, 0)), rank)
    return {"launches": counts, "step": ctx.state.step,
            "digest": mesh_digest(ctx.state.params), "seed": seed,
            "folded_as_the_mesh_folds": seed == want, "rows": shape[0],
            "words_equal": bool(torch.equal(words, ref)),
            "words": words[:4, :4].numpy().tolist(),
            "sampler_check_launches": read_words()["reparameterize_prng"]}


def mesh_stream(rank, world, data):
    """configs/default_iterable.ini on 2 ranks, 48 batches: host-fed and
    resident at batch 4096 (equal losses), then resident at 4095 (the
    ranks' blocks of 2048 and 2047 rows padded to one size: the weighted
    loss)."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.train import stream

    dense_tc = (ops.encoder_fwd, ops.decoder_fwd, ops.dec_bwd_fused,
                ops.grad_accum, ops.enc_bwd_dw1, ops.grad_accum2)
    out = {}
    # the host feed casts to bf16 as the resident upload does, so both
    # engines' steps compare the reconstruction with the same target
    for label, batch, mode in (("host-fed", 4096, "never"),
                               ("resident", 4096, "always"),
                               ("resident, batch 4095", 4095, "always")):
        cfg = mesh_config("default_iterable.ini", data,
                          training__batch_size=batch,
                          training__total_num_frames=48 * batch,
                          training__checkpoint_interval=16,
                          tpu__histogram_interval=16,
                          tpu__device_resident=mode,
                          tpu__feed_dtype="bfloat16")
        read = mesh_launches(dense_tc)
        t0 = time.perf_counter()
        ctx = stream.train(cfg, verbose=False, device=mesh_device())
        torch.cuda.synchronize()
        out[label] = {"seconds": time.perf_counter() - t0,
                      "launches": read(), "step": ctx.state.step,
                      "digest": mesh_digest(ctx.state.params),
                      "workdir": str(ctx.workspace.workdir),
                      "losses": (read_scalars(ctx.workspace.log_dir,
                                              "Loss/Batch")
                                 if rank == 0 else None)}
    return out


def mesh_encode(rank, world, data):
    """encode_trajectory_sharded of a 60 s clip (fp32, the dense model's
    server weights) on every rank against encode_trajectory on one."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.config import load_config
    from rawaudiovae_kelsey_tpu_torch.infer.api import (
        encode_trajectory,
        encode_trajectory_sharded,
    )
    from rawaudiovae_kelsey_tpu_torch.models import DenseVAE, build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = load_config(ROOT / "configs" / "default.ini")
    cfg.tpu.precision = "float32"
    model = build_model(cfg, dev)
    params = DenseVAE(SEG, UNITS, LATENT, torch.Generator().manual_seed(7),
                      dev).params()
    t = np.arange(60 * SR) / SR
    clip = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(
        2 * np.pi * 1375 * t)).astype(np.float32)
    read = mesh_launches((), (ops.encoder_fwd,))
    mu, lv = encode_trajectory_sharded(model, params, clip, make_mesh(
        device=dev), batch_frames=1024)
    counts = read()
    pmu, plv = encode_trajectory(model, params, clip)
    return {"frames": len(mu), "launches": counts,
            "max_err": float(max(np.abs(mu - pmu).max(),
                                 np.abs(lv - plv).max())),
            "digest": mesh_digest_tensor(torch.from_numpy(mu))}


def mesh_rank(rank, world, init, backend, jobs, out):
    """One rank of phase 13: join the group (``backend``; the port uses it
    as it stands), run ``jobs`` in order, pickle their results."""
    import pickle
    from datetime import timedelta

    import torch.distributed as dist

    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed,
    )

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if init is None:
        # NCCL at one rank a card, through the port's own start: backend
        # None on a CUDA device takes NCCL
        import socket

        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     device=dev,
                                     timeout=timedelta(seconds=300))
    else:
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=300), **kwargs)
    results = {"backend": dist.get_backend()}
    try:
        for name, data in jobs:
            results[name] = globals()[name](rank, world, data)
    finally:
        dist.destroy_process_group()
    with open(Path(out) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(results, fh)


def mesh_start(world, backend, jobs, tmp: Path, init=True):
    """Start ``world`` ranks of ``jobs``; their results in rank order."""
    import pickle

    import torch.multiprocessing as mp

    out = tmp / f"ranks-{backend}-{world}-{time.monotonic_ns()}"
    out.mkdir()
    store = f"file://{out}/store" if init else None
    mp.start_processes(mesh_rank, args=(world, store, backend, jobs,
                                        str(out)),
                       nprocs=world, join=True, start_method="spawn")
    res = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return res


def mesh_report(ranks, where: str, card: str) -> dict:
    """Check and print what ``ranks`` (the jobs of :func:`phase_mesh`) found
    on ``where``; returns the rows the kernel line reads."""
    world = len(ranks)

    def same(values) -> bool:
        return all(v == values[0] for v in values)

    # which collectives the backend takes on CUDA tensors
    col = ranks[0]["mesh_collectives"]
    print(f"  {ranks[0]['backend']} on CUDA tensors: " + ", ".join(
        f"{k} {v if v == 'ok' else 'NO (' + v + ')'}" for k, v in col.items()))
    for name in ("all_reduce", "broadcast", "all_gather",
                 "all_to_all_single"):
        check(col[name] == "ok", f"{where}: {name} refused on CUDA "
              "tensors, which the port calls")

    # the epoch trainer: one workspace, equal replicas, the kernels
    runs = [r["mesh_epoch_trainer"] for r in ranks]
    print(f"  epoch trainer, configs/default.ini (bf16, batch 131072 = "
          f"{131072 // world} a rank, microbatch 8192 = {8192 // world} a "
          f"rank): {runs[0]['step']} steps in {runs[0]['seconds']:.1f} s "
          "(ingest, checkpoints and reconstructions included)")
    check(same([r["workdir"] for r in runs]), "several workspaces")
    check(runs[0]["writer"] is not None
          and all(r["writer"] is None for r in runs[1:]),
          "a rank other than 0 wrote TensorBoard")
    check(same([r["digest"] for r in runs]),
          "the replicas' params differ after the epoch trainer")
    check(runs[0]["step"] == 2, f"{runs[0]['step']} steps, expected 2")
    for rank, run in enumerate(runs):
        counts = run["launches"]
        tc = {k: v for k, v in counts.items() if k.endswith("@tc")}
        print(f"  rank {rank}: rows 1, 2, 7-10 on the tensor cores "
              f"(launches; the test-set reconstructions' fp32 encoder and "
              f"decoder take csrc/sgemm.cuh): {tc} of "
              + str({k: v for k, v in counts.items()
                     if v and not k.endswith("@tc")}))
        # 2 steps of 16 local microbatches: every one on the tensor cores
        for name, n in tc.items():
            check(n == 2 * 16, f"rank {rank}: {name[:-3]} {n} launches on "
                  "the tensor cores, expected 32")
    print("  replicas after the run: equal bits (params digest "
          f"{runs[0]['digest']})")

    # the steps against the one-rank step, same global batch and noise
    rows = {}
    for pair in zip(*(r["mesh_steps"] for r in ranks)):
        r0 = pair[0]
        tol = 5e-2 if "bfloat16" in r0["label"] else 1e-3
        print(f"  one {world}-rank {r0['label']} step vs the one-rank step: "
              f"loss {r0['loss_mesh']:.7f} vs {r0['loss_one']:.7f}; |update "
              f"difference| / |update| = {r0['update_rel']:.3e} (tolerance "
              f"{tol:g}); max |param difference| "
              f"{r0['max_param_diff']:.3e}; replicas' updates equal: "
              f"{same([r['digest'] for r in pair])}")
        check(r0["update_rel"] <= tol
              and abs(r0["loss_mesh"] / r0["loss_one"] - 1) <= tol,
              f"{r0['label']}: the {world}-rank step and the one-rank step "
              "disagree")
        check(same([r["digest"] for r in pair]), f"{r0['label']}: the "
              "ranks' updates differ")
        for rank, r in enumerate(pair):
            got = {k: v for k, v in r["launches"].items() if v}
            print(f"    rank {rank} launches: {got}")
        rows[r0["label"]] = pair
    bf = rows["bfloat16"]
    for rank, r in enumerate(bf):
        for name in ("encoder_fwd", "decoder_fwd", "grad_accum",
                     "enc_bwd_dw1", "grad_accum2", "dec_bwd_fused"):
            n, tc = r["launches"][name], r["launches"].get(f"{name}@tc")
            check(n == 16 and tc == 16, f"rank {rank}: bf16 step {name} "
                  f"{tc} of {n} on the tensor cores, expected 16 of 16")
    for rank, r in enumerate(rows["high"]):
        for name in ("enc_bwd_full", "dec_bwd_full"):
            check(r["launches"][name] == 16, f"rank {rank}: `high` step "
                  f"{r['launches'][name]} {name} launches, expected 16")
    for rank, r in enumerate(rows["highest"]):
        for name in ("matmul_nt", "matmul_nt_mask", "matmul_nt2_mask",
                     "grad_accum"):
            check(r["launches"][name] > 0 and r["launches"][
                f"{name}@sgemm"] == r["launches"][name],
                f"rank {rank}: `highest` step {name} not all on sgemm.cuh")
    for rank, r in enumerate(rows["deep_wide bfloat16"]):
        for name in ("linear_ksplit_fwd", "linear_fwd"):
            check(r["launches"][name] > 0 and r["launches"][
                f"{name}@tc"] == r["launches"][name],
                f"rank {rank}: deep step {name} not all on the tensor cores")
    shared = "gloo" in where
    print(f"  wall time of a default.ini bf16 step (batch 131072, the "
          f"steps' own noise), host clock over 3 steps ending in a sync: "
          f"{world} ranks, {where}: "
          + " / ".join(f"{r['mesh_ms']:.1f}" for r in bf)
          + f" ms (rank 0 / ...), one rank {bf[0]['one_ms']:.1f} ms [{card}]"
          + (" — not a scaling figure: the ranks share one card" if shared
             else " — one rank a card"))

    # the sharded resident epochs: the rank fold of row 13
    res = [r["mesh_resident"] for r in ranks]
    check(same([r["digest"] for r in res]),
          "resident: the replicas' params differ")
    for rank, r in enumerate(res):
        print(f"  resident (perf_bf16.ini, tpu_prng, two passes), rank "
              f"{rank}: {r['step']} steps; first sampler seed {r['seed']} "
              f"(the step's words, word 0 ^ {rank} * 0x85EBCA6B: "
              f"{r['folded_as_the_mesh_folds']}); kernel words = plain "
              f"Philox: {r['words_equal']}; row 13 launches "
              f"{r['launches']['reparameterize_prng']}; tensor cores "
              + str({k: v for k, v in r["launches"].items()
                     if k.endswith("@tc")}))
        check(r["folded_as_the_mesh_folds"] and r["words_equal"],
              f"resident rank {rank}: the sampler's words")
        check(r["launches"]["reparameterize_prng"] > 0,
              f"resident rank {rank}: row 13 never launched")
    check(len({r["seed"] for r in res}) == world
          and len({str(r["words"]) for r in res}) == world,
          "two ranks drew the same words")

    # the stream, host-fed and resident
    st = [r["mesh_stream"] for r in ranks]
    for label in st[0]:
        check(same([s_[label]["digest"] for s_ in st])
              and same([s_[label]["workdir"] for s_ in st]),
              f"stream {label}: replicas or workspaces differ")
        a = st[0][label]
        loss = a["losses"]
        check(sorted(loss) == list(range(48))
              and all(np.isfinite(v) for v in loss.values()),
              f"stream {label}: Loss/Batch steps {sorted(loss)}")
        print(f"  stream {label}: 48 steps in {a['seconds']:.1f} s, loss "
              f"{loss[0]:.6f} -> {loss[47]:.6f}; launches rank 0 "
              + str({k: v for k, v in a["launches"].items() if v}))
    check(st[0]["host-fed"]["losses"] == st[0]["resident"]["losses"]
          and st[0]["host-fed"]["digest"] == st[0]["resident"]["digest"],
          "stream: the resident run's losses differ from the host-fed run's")
    print("  stream: the resident run's 48 losses and params equal the "
          "host-fed run's bit for bit")

    enc = [r["mesh_encode"] for r in ranks]
    print(f"  encode_trajectory_sharded of 60 s ({enc[0]['frames']} "
          f"frames, chunks of 1024): max |difference| to encode_trajectory "
          + " / ".join(f"{e['max_err']:.3e}" for e in enc)
          + "; row 1 on csrc/sgemm.cuh: "
          + str({k: v for k, v in enc[0]["launches"].items() if v}))
    check(max(e["max_err"] for e in enc) <= HTTP_ATOL
          and same([e["digest"] for e in enc]),
          "encode_trajectory_sharded differs from encode_trajectory")
    return {"epoch": runs, "steps": rows, "resident": res}


def mesh_command(data: Path, tmp: Path, cards: int) -> None:
    """The ``train`` command on every visible card: ``data_parallel = 0``
    starts one rank a card (NCCL), joins them; one workspace."""
    from rawaudiovae_kelsey_tpu_torch.config import save_config
    from rawaudiovae_kelsey_tpu_torch.config.workspace import iter_runs
    from rawaudiovae_kelsey_tpu_torch.train.cli import main as train_cli

    cfg = mesh_config("default.ini", data, training__epochs=1,
                      training__checkpoint_interval=0,
                      extra__description="mesh_command")
    check(cfg.tpu.data_parallel == 0, "default.ini sets data_parallel")
    ini = tmp / "mesh_command.ini"
    save_config(cfg, ini)
    t0 = time.perf_counter()
    out = tee_stdout(lambda: train_cli(["--config", str(ini)]))
    runs = iter_runs(data / "mesh_command")
    losses = read_scalars(runs[0] / "logs", "Loss/Batch") if runs else {}
    print(f"  the train command, data_parallel = 0 on {cards} cards: "
          f"{time.perf_counter() - t0:.1f} s, {len(runs)} workspace, "
          f"losses {losses}")
    check(f"train: starting {cards} ranks (cuda, nccl)" in out
          and len(runs) == 1 and losses
          and all(np.isfinite(v) for v in losses.values())
          and (runs[0] / "model" / "last_model.npz").is_file(),
          "the train command did not train on every card")


def phase_mesh(tmp: Path, card: str) -> dict:
    """Phase 13: data parallelism through the trainers' entry points."""
    t_phase = time.perf_counter()
    data = {"epoch": tmp / "epoch", "resident": tmp / "resident",
            "stream": tmp / "stream"}
    # each rank reads its file shard (files 0, 2 / 1, 3): default.ini's
    # global batch of 131072 is 65536 rows a rank, one full batch each
    write_corpus(data["epoch"], 2 * 70000, 128, SEG)
    write_corpus(data["resident"], 24000, 128, SEG)
    write_corpus(data["stream"], 16000, 128, SEG)
    jobs = [("mesh_collectives", None),
            ("mesh_epoch_trainer", data["epoch"]),
            ("mesh_steps", data["epoch"]),
            ("mesh_resident", data["resident"]),
            ("mesh_stream", data["stream"]),
            ("mesh_encode", None)]
    t0 = time.perf_counter()
    ranks = mesh_start(MESH_RANKS, "gloo", jobs, tmp)
    print(f"  {MESH_RANKS} ranks sharing the card over gloo (torch "
          f"{torch.__version__}): {time.perf_counter() - t0:.1f} s, the "
          "ranks' start included")
    check(all(r["backend"] == "gloo" for r in ranks), "not a gloo group")
    rows = mesh_report(ranks, "sharing ONE card over gloo", card)

    # NCCL at one rank a card: the port's own start (backend None)
    t0 = time.perf_counter()
    nccl = mesh_start(1, "nccl", [("mesh_nccl_step", data["epoch"])], tmp,
                      init=False)[0]
    r = nccl["mesh_nccl_step"]
    print(f"  NCCL, 1 rank on 1 card ({nccl['backend']}, "
          f"{time.perf_counter() - t0:.1f} s): the bf16 mesh step (its "
          f"all-reduce on NCCL) equals the plain step bit for bit: "
          f"{r['equal']}")
    check(nccl["backend"] == "nccl" and r["equal"],
          "NCCL: the one-rank mesh step differs from the plain step")
    cards = torch.cuda.device_count()
    if cards >= 2:
        # every job again, one rank a card on NCCL, then the train command
        t0 = time.perf_counter()
        across = mesh_start(cards, "nccl", jobs, tmp)
        print(f"  {cards} ranks, one a card, over NCCL: "
              f"{time.perf_counter() - t0:.1f} s, the ranks' start "
              "included")
        check(all(r["backend"] == "nccl" for r in across), "not NCCL")
        mesh_report(across, f"one a card over NCCL ({cards} cards)", card)
        mesh_command(data["epoch"], tmp, cards)
    else:
        print(f"  NCCL across cards: not run ({cards} card visible; NCCL "
              "refuses two ranks on one GPU in one communicator) — the "
              "2-rank checks above ran on gloo, all_to_all_single included")
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")
    return rows


def mesh_nccl_step(rank, world, data):
    """The bf16 mesh step of configs/default.ini on a one-rank NCCL group
    against the plain step, same init, batch and noise."""
    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.parallel import (
        build_train_step,
        make_mesh,
    )
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.tree import leaves, tree_map

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = mesh_config("default.ini", data)
    batch = torch.from_numpy(mesh_global_batch(
        data, cfg.training.batch_size, SEG, cfg.audio.hop_length)).to(dev)

    def noise(step, i, shape):
        g = torch.Generator().manual_seed(1000 * step + (i or 0))
        return torch.randn(shape, generator=g)

    model = build_model(cfg, dev)
    init = model.init(torch.Generator().manual_seed(0))
    out = []
    for mesh in (make_mesh(device=dev), None):
        state = TrainState.create(tree_map(torch.clone, init), 0)
        state, m = build_train_step(model, cfg, noise=noise,
                                    mesh=mesh)(state, batch)
        out.append((float(m["loss"]), [t.clone() for t in
                                        leaves(state.params)]))
    (la, pa), (lb, pb) = out
    return {"equal": la == lb and all(torch.equal(a, b)
                                      for a, b in zip(pa, pb))}


# ------------------------------------------------------------- phase 14
#
# Tensor parallelism (parallel/sharding.py, parallel/tensor_parallel.py):
# the Megatron split of the model axis, every rank computing on its shards.
# First the row-parallel forms of rows 1, 2, 15 and 16 (the kernels run on
# the shards with their epilogue apart: fp32 partial sums, no bias, no
# activation) against their plain versions at model 2's shard shapes; then
# two ranks at model 2 that share the one card over gloo (as phase 13's
# do), and on four cards a 2x2 mesh over NCCL with the train command.

TP_MODEL = 2
TP_SOURCE = {"encoder_fwd": "rawaudiovae_kelsey_tpu_torch/csrc/mlp.cu",
             "decoder_fwd": "rawaudiovae_kelsey_tpu_torch/csrc/mlp.cu",
             "linear_ksplit_fwd": "rawaudiovae_kelsey_tpu_torch/csrc/linear.cu",
             "linear_fwd": "rawaudiovae_kelsey_tpu_torch/csrc/linear.cu"}
TP_REPLACES = {
    "encoder_fwd": "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py:246",
    "decoder_fwd": "rawaudiovae_kelsey_tpu/ops/pallas_mlp.py:294",
    "linear_ksplit_fwd": "rawaudiovae_kelsey_tpu/ops/pallas_linear.py:77",
    "linear_fwd": "rawaudiovae_kelsey_tpu/ops/pallas_linear.py:119"}
# the deep_wide model's row-parallel layers at model 2, batch 4096: (layer,
# local contraction, width); the last is the decoder's forced one, its
# input's columns sliced locally
TP_DEEP_ROWS = (("enc.1", 2048, 2048), ("enc.3", 512, 512),
                ("dec.1", 256, 1024), ("dec.3", 1024, 4096),
                ("dec.4", 2048, 4096))
TP_DEEP_BATCH = 4096
# the partial sums against the sums the kernel owes on its own hidden
# layer (fp32 products of the same rounded operands in another order), fp32
# and bf16; the hidden layer against the plain version's as the full forms'
# is held (BF16_REL / GRAD_REL: a bf16 element may sit an ulp off)
TP_REL = {"fp32": 1e-5, "bf16": 1e-5}
# the forms held: the kernel "auto" picks, and the first version
TP_FORMS = ("auto", "cuda_cores")


def tp_partial_kernels():
    """Phase 14's kernel forms against their plain versions on the card:
    ``encoder_fwd_partial`` / ``decoder_fwd_partial`` at the dense model's
    shards (units 1024 of 2048) and ``linear_partial`` at deep_wide's
    row-parallel layers, bf16 (tensor cores) and fp32 (csrc/sgemm.cuh, the
    `high` and `highest` steps), each form's first version
    (``kernel="cuda_cores"``) too, each timed in turns with its plain
    version and its first version and, where one call computes the same
    function (``torch.mm``, an fp32 output), the library; equal bits on a
    second launch.  Returns the rows of the kernel line (launches filled
    later)."""
    from rawaudiovae_kelsey_tpu_torch.ops import linear, mlp, tensor_cores

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1414)
    units = UNITS // TP_MODEL
    rows = {}

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return ((torch.rand(shape, generator=g, device=dev) * 2 - 1)
                * scale).to(dt)

    def held(label, got, want, shard_rows, hidden_rel, rel):
        """``got`` (the partial sums, then the hidden layer) against the
        sums on its own hidden layer and the plain version's hidden
        layer; returns the sums' largest error against the plain
        version."""
        for t, w in zip(got, want):
            check(t.shape == w.shape and t.dtype == w.dtype
                  and bool(torch.isfinite(t).all()),
                  f"{label}: shape, dtype or a non-finite value")
        own = [got[-1].float() @ w.float() for w in shard_rows]
        e = rel_err(got[:-1], own)
        e_h = rel_err(got[-1:], want[-1:])
        print(f"  {label}: rel |sums - own h @ w| {e:.3e}, hidden vs plain "
              f"{e_h:.3e}")
        check(e <= rel and e_h <= hidden_rel, f"{label}: error")
        return max_err(got[:-1], want[:-1])

    for kind, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        enc = (rnd(SEG, units, scale=0.03, dt=dt), rnd(units, scale=0.1,
                                                        dt=dt),
               rnd(units, LATENT, scale=0.03, dt=dt),
               rnd(units, LATENT, scale=0.03, dt=dt))
        dec = (rnd(LATENT, units, scale=0.06, dt=dt),
               rnd(units, scale=0.1, dt=dt),
               rnd(units, SEG, scale=0.03, dt=dt))
        forms = {
            "encoder_fwd": (
                lambda b: rnd(b, SEG, dt=dt),
                lambda x, k="auto": mlp.encoder_fwd_partial(*enc, x,
                                                            kernel=k),
                lambda x: mlp.encoder_fwd_partial_ref(*enc, x),
                lambda b: 2 * b * (SEG * units + 2 * units * LATENT),
                enc, enc[2:]),
            "decoder_fwd": (
                lambda b: torch.randn((b, LATENT), generator=g,
                                      device=dev).to(dt),
                lambda z, k="auto": mlp.decoder_fwd_partial(*dec, z,
                                                            kernel=k),
                lambda z: mlp.decoder_fwd_partial_ref(*dec, z),
                lambda b: 2 * b * (LATENT * units + units * SEG), dec,
                dec[2:])}
        hidden_rel = BF16_REL if kind == "bf16" else GRAD_REL
        for name, (make, kernel, plain, flops, weights, heads) in \
                forms.items():
            err = 0.0
            for b in (TRAIN_BATCH, TRAIN_RAGGED, 1):
                x = make(b)
                want = plain(x)
                for form in TP_FORMS:
                    label = f"{name}_partial[{kind}] {form} batch {b:>4}"
                    got = kernel(x, form)
                    torch.cuda.synchronize()
                    e = held(label, got, want, heads, hidden_rel,
                             TP_REL[kind])
                    check(all(torch.equal(a, c) for a, c in
                              zip(got, kernel(x, form))),
                          f"{label}: bits differ on a second launch")
                    if form == "auto":
                        err = max(err, e)
            x = make(TRAIN_BATCH)
            t, runs = time_in_turns({
                "kernel": lambda: kernel(x), "plain": lambda: plain(x),
                "cuda_cores": lambda: kernel(x, "cuda_cores")}, 20)
            print(f"  {name}_partial[{kind}] batch {TRAIN_BATCH}: kernel "
                  f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, first "
                  f"version {t['cuda_cores']:.4f} ms (runs {runs})")
            rows[f"{name}_partial[{kind}]"] = {
                "name": f"{name}_partial[{kind}]", "route": "cuda",
                "source": TP_SOURCE[name], "replaces": TP_REPLACES[name],
                "max_abs_err": err, "ms": t["kernel"],
                "plain_ms": t["plain"],
                **bound(flops(TRAIN_BATCH),
                        nbytes(x, *weights, *kernel(x)), kind),
                "library_ms": None, "first_version_ms": t["cuda_cores"]}

    # deep_wide's row-parallel layers: bf16 on the tensor cores (the
    # step's), fp32 on csrc/sgemm.cuh, and each one's first version
    timed = {}
    for kind, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        auto = (tensor_cores.TENSOR_CORES if kind == "bf16"
                else tensor_cores.SGEMM)
        for layer, k, n in TP_DEEP_ROWS:
            ksplit = linear.takes_ksplit(TP_DEEP_BATCH, k, n)
            name = "linear_ksplit_fwd" if ksplit else "linear_fwd"
            x = rnd(TP_DEEP_BATCH, k, dt=dt)
            w = rnd(k, n, scale=k ** -0.5, dt=dt)
            code = tensor_cores.resolve_kernel(name, "auto", dt,
                                               TP_DEEP_BATCH, k, n)
            check(code == auto, f"{name}_partial[{kind}] {layer}: kernel "
                  f"{code}, expected {auto}")
            for form in TP_FORMS:
                errs = []
                for b in (TP_DEEP_BATCH, TRAIN_RAGGED, 1):
                    got = linear.linear_partial(x[:b], w, ksplit, form)
                    want = linear.linear_partial_ref(x[:b], w, ksplit)
                    torch.cuda.synchronize()
                    errs.append(rel_err([got], [want]))
                    check(got.dtype == torch.float32
                          and errs[-1] <= TP_REL[kind] and torch.equal(
                              got, linear.linear_partial(x[:b], w, ksplit,
                                                         form)),
                          f"{name}_partial[{kind}] {layer} {form} batch "
                          f"{b}: error {errs[-1]:.3e}")
                print(f"  {name}_partial[{kind}] {layer} {form} "
                      f"{TP_DEEP_BATCH}x{k}->{n}: rel |kernel - plain| at "
                      f"batch {TP_DEEP_BATCH}, {TRAIN_RAGGED}, 1: "
                      + ", ".join(f"{e:.3e}" for e in errs))
            if kind == "bf16":
                timed.setdefault(name, (layer, k, n, x, w, ksplit))
    for name, (layer, k, n, x, w, ksplit) in timed.items():
        t, runs = time_in_turns({
            "kernel": lambda: linear.linear_partial(x, w, ksplit),
            "plain": lambda: linear.linear_partial_ref(x, w, ksplit),
            "cuda_cores": lambda: linear.linear_partial(x, w, ksplit,
                                                        "cuda_cores"),
            "library": lambda: torch.mm(x, w, out_dtype=torch.float32)}, 20)
        print(f"  {name}_partial[bf16] {layer}: kernel {t['kernel']:.4f} ms, "
              f"plain {t['plain']:.4f}, first version "
              f"{t['cuda_cores']:.4f}, torch.mm(out_dtype=float32) "
              f"{t['library']:.4f} (runs {runs})")
        out = linear.linear_partial(x, w, ksplit)
        rows[f"{name}_partial[bf16]"] = {
            "name": f"{name}_partial[bf16]", "route": "cuda",
            "source": TP_SOURCE[name], "replaces": TP_REPLACES[name],
            "max_abs_err": float((out - linear.linear_partial_ref(
                x, w, ksplit)).abs().max()),
            "ms": t["kernel"], "plain_ms": t["plain"],
            **bound(2 * TP_DEEP_BATCH * k * n, nbytes(x, w, out), "bf16"),
            "library_ms": t["library"], "first_version_ms": t["cuda_cores"]}
    return rows


def tp_counts():
    """Reset every wrapper's counters; returns a reader ("<name>",
    "<name>@tc", "@sgemm", "@partial", "@split")."""
    from rawaudiovae_kelsey_tpu_torch import ops

    tags = (("tensor_core_launches", "tc"), ("sgemm_launches", "sgemm"),
            ("partial_launches", "partial"), ("split_launches", "split"))
    for w in ops.KERNEL_WRAPPERS:
        w.launches = 0
        for attr, _ in tags:
            if hasattr(w, attr):
                setattr(w, attr, 0)

    def read():
        out = {}
        for w in ops.KERNEL_WRAPPERS:
            out[w.__name__] = w.launches
            for attr, tag in tags:
                if hasattr(w, attr):
                    out[f"{w.__name__}@{tag}"] = getattr(w, attr)
        return out
    return read


def tp_step_pair(rank, world, cfg, batch, label, timed=0, ckpt_dir=None):
    """One tensor-parallel step (model 2; data = world / 2) of ``cfg`` on
    this rank's rows of ``batch`` against the one-rank step on the whole
    batch (rank 0), same init and global noise: the relative update
    difference, the gradient's (Adam's first moment, ``0.1 · g`` after one
    step) relative difference in the leaf where it is largest, the losses,
    this rank's launches, the digest of the gathered update; with ``timed``, the wall time of ``timed`` steps of
    each; with ``ckpt_dir``, the state after the step saved in the sharded
    format and read back whole on rank 0 (model 1)."""
    import torch.distributed as dist

    from rawaudiovae_kelsey_tpu_torch.models import build_model
    from rawaudiovae_kelsey_tpu_torch.ops import rng
    from rawaudiovae_kelsey_tpu_torch.parallel import (
        build_train_step,
        make_mesh,
    )
    from rawaudiovae_kelsey_tpu_torch.parallel.mesh import local_rows
    from rawaudiovae_kelsey_tpu_torch.parallel.sharding import (
        gather_params,
        param_specs,
        shard_params,
    )
    from rawaudiovae_kelsey_tpu_torch.train import TrainState
    from rawaudiovae_kelsey_tpu_torch.train import checkpoint as ckpt
    from rawaudiovae_kelsey_tpu_torch.tree import flatten, leaves, tree_map

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(0, TP_MODEL, device=dev)
    model = build_model(cfg, dev)
    init = model.init(torch.Generator().manual_seed(0))
    specs = param_specs(model.name, init, TP_MODEL)

    def noise(step, i, shape):
        g = torch.Generator().manual_seed(1000 * step + (i or 0))
        return torch.randn(shape, generator=g)

    def sharded():
        return TrainState.create(shard_params(tree_map(torch.clone, init),
                                              mesh, specs), 0)

    rows = local_rows(mesh, len(batch), cfg.tpu.microbatch_size)
    x_local = torch.from_numpy(np.ascontiguousarray(batch[rows])).to(dev)
    seeds = []
    original = rng.reparameterize

    def recording(seed, mu, logvar):
        seeds.append(tuple(seed))
        return original(seed, mu, logvar)

    tp_step = build_train_step(model, cfg, noise=noise, mesh=mesh)
    read = tp_counts()
    rng.reparameterize = recording
    try:
        state, m = tp_step(sharded(), x_local)
    finally:
        rng.reparameterize = original
    torch.cuda.synchronize()
    counts = read()
    whole = gather_params(state.params, mesh, specs)
    whole_mu = gather_params(state.mu, mesh, specs)
    delta = torch.cat([(a - b).ravel() for a, b in zip(leaves(whole),
                                                       leaves(init))])
    out = {"label": label, "launches": counts, "loss_tp": float(m["loss"]),
           "digest": mesh_digest_tensor(delta), "seeds": seeds[:1],
           "position": (mesh.data_index, mesh.model_index)}
    if ckpt_dir is not None:
        path = ckpt.save_checkpoint_sharded(Path(ckpt_dir), state,
                                            {"label": label}, label=1,
                                            mesh=mesh, specs=specs)
        full = TrainState(params=whole, mu=whole_mu,
                          nu=gather_params(state.nu, mesh, specs),
                          count=state.count, seed=state.seed,
                          step=state.step)
        if rank == 0:
            got, _ = ckpt.restore_checkpoint(path, TrainState.create(
                tree_map(torch.zeros_like, init), 0))
            out["restored_equal"] = all(
                torch.equal(a, b) for part in ("params", "mu", "nu")
                for a, b in zip(leaves(getattr(got, part)),
                                leaves(getattr(full, part))))
            out["ckpt_files"] = sorted(p.name for p in path.iterdir())
        dist.barrier()
    if rank == 0:
        one = TrainState.create(tree_map(torch.clone, init), 0)
        one, m1 = build_train_step(model, cfg, noise=noise)(
            one, torch.from_numpy(batch).to(dev))
        d1 = torch.cat([(a - b).ravel() for a, b in
                        zip(leaves(one.params), leaves(init))])
        # the gradient leaf by leaf: a leaf's gradient scaled by a
        # constant (a replicated bias's summed over the model group) moves
        # Adam's first update by nothing, its first moment by the factor
        grad_rel = {name: float((a.float() - b.float()).norm()
                                / b.float().norm())
                    for (name, a), (_, b) in zip(flatten(whole_mu),
                                                 flatten(one.mu))
                    if float(b.float().norm()) > 0}
        worst = max(grad_rel, key=grad_rel.get)
        out.update(loss_one=float(m1["loss"]), update_rel=float(
            (delta - d1).norm() / d1.norm()),
            max_param_diff=float((delta - d1).abs().max()),
            grad_rel=grad_rel[worst], grad_worst=worst)
        del one
    if timed:
        tp_step = build_train_step(model, cfg, mesh=mesh)
        state = sharded()
        tp_step(state, x_local)                       # warm
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, m = tp_step(state, x_local)
        float(m["loss"])
        torch.cuda.synchronize()
        out["tp_ms"] = (time.perf_counter() - t0) / timed * 1e3
        dist.barrier()
        if rank == 0:
            one_step = build_train_step(model, cfg)
            x_all = torch.from_numpy(batch).to(dev)
            state = TrainState.create(tree_map(torch.clone, init), 0)
            one_step(state, x_all)                    # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(timed):
                state, m = one_step(state, x_all)
            float(m["loss"])
            torch.cuda.synchronize()
            out["one_ms"] = (time.perf_counter() - t0) / timed * 1e3
            del state
        dist.barrier()
    return out


def tp_steps(rank, world, data):
    """The default.ini step (bf16 timed, with the sharded checkpoint; a
    `tpu_prng` one; `high`; `highest`) at model 2 against the one-rank
    step, then one step of configs/deep_wide.ini (pallas, bf16, batch
    4096)."""
    cfg = mesh_config("default.ini", data["epoch"])
    batch = mesh_global_batch(data["epoch"], cfg.training.batch_size, SEG,
                              cfg.audio.hop_length)
    out = [tp_step_pair(rank, world, cfg, batch, "bfloat16", timed=3,
                        ckpt_dir=data["ckpt"])]
    cfg.tpu.rng = "tpu_prng"
    out.append(tp_step_pair(rank, world, cfg, batch, "bfloat16 tpu_prng"))
    cfg.tpu.rng = "threefry"
    for precision in ("high", "highest"):
        cfg.tpu.precision = precision
        out.append(tp_step_pair(rank, world, cfg, batch, precision))
    del batch
    deep = mesh_config("deep_wide.ini", data["epoch"], tpu__backend="pallas")
    r = np.random.default_rng(3)
    seg = deep.audio.segment_length
    t = np.arange(deep.training.batch_size * seg).reshape(-1, seg) / SR
    xb = (0.3 * np.sin(2 * np.pi * 220 * t)
          + 0.05 * r.standard_normal(t.shape)).astype(np.float32)
    out.append(tp_step_pair(rank, world, deep, xb, "deep_wide bfloat16"))
    return out


def tp_report(ranks, where: str, card: str) -> dict:
    """Check and print what the ranks of :func:`tp_steps` found on
    ``where``; returns the steps by label (each a list over the ranks)."""
    world = len(ranks)
    steps = {}
    for pair in zip(*(r["tp_steps"] for r in ranks)):
        r0 = pair[0]
        label = r0["label"]
        tol = 5e-2 if "bfloat16" in label else 1e-3
        print(f"  one {world}-rank model-{TP_MODEL} {label} step vs the "
              f"one-rank step: loss {r0['loss_tp']:.7f} vs "
              f"{r0['loss_one']:.7f}; |update difference| / |update| = "
              f"{r0['update_rel']:.3e} (tolerance {tol:g}); max |param "
              f"difference| {r0['max_param_diff']:.3e}; the gradient's "
              f"|difference| / |gradient|, its worst leaf "
              f"({r0['grad_worst']}): {r0['grad_rel']:.3e} (tolerance "
              f"{tol:g}); every rank's "
              f"gathered update equal: "
              f"{len({r['digest'] for r in pair}) == 1}")
        if "tpu_prng" in label and world > TP_MODEL:
            # the sampler folds the data index into its seed words: two
            # data indices draw another noise than one rank does (JAX's
            # sharded sampler too), so the update is not compared
            print("    (tpu_prng on several data indices: the noise is "
                  "another draw than one rank's; not compared)")
            check(np.isfinite(r0["loss_tp"]), f"{label}: loss not finite")
        else:
            check(r0["update_rel"] <= tol and r0["grad_rel"] <= tol
                  and abs(r0["loss_tp"] / r0["loss_one"] - 1) <= tol,
                  f"{label}: the tensor-parallel step and the one-rank "
                  "step disagree")
        # equal gathered updates: the data replicas and the replicated
        # leaves of every model rank agree bit for bit
        check(len({r["digest"] for r in pair}) == 1,
              f"{label}: the ranks' updates differ")
        for rank, r in enumerate(pair):
            got = {k: v for k, v in r["launches"].items() if v}
            print(f"    rank {rank} {r['position']} launches: {got}")
        steps[label] = pair
    micro = 16
    for rank, r in enumerate(steps["bfloat16"]):
        c = r["launches"]
        for name in ("encoder_fwd", "decoder_fwd", "grad_accum",
                     "enc_bwd_dw1", "grad_accum2", "dec_bwd_fused"):
            check(c[name] == micro and c[f"{name}@tc"] == micro,
                  f"rank {rank}: bf16 step {name} {c[f'{name}@tc']} of "
                  f"{c[name]} on the tensor cores, expected {micro} of "
                  f"{micro}")
        for name in ("encoder_fwd", "decoder_fwd"):
            check(c[f"{name}@partial"] == micro, f"rank {rank}: {name} "
                  f"{c[f'{name}@partial']} row-parallel launches, expected "
                  f"{micro}")
    for label in ("high", "highest"):
        # `highest` on csrc/sgemm.cuh, `high` in three passes on the tensor
        # cores (the step binds the tier)
        on = "split" if label == "high" else "sgemm"
        for rank, r in enumerate(steps[label]):
            c = r["launches"]
            for name in ("encoder_fwd", "decoder_fwd"):
                check(c[f"{name}@partial"] == micro
                      and c[f"{name}@{on}"] == micro
                      and c[f"{name}@split"] + c[f"{name}@sgemm"] == micro,
                      f"rank {rank}: `{label}` {name}: the fp32 partial "
                      f"form not on its kernel ({on}) every microbatch")
            names = (("enc_bwd_full", "dec_bwd_full") if label == "high"
                     else ("matmul_nt", "matmul_nt_mask", "matmul_nt2_mask",
                           "grad_accum"))
            for name in names:
                check(c[name] > 0, f"rank {rank}: `{label}` {name} never "
                      "launched")
    for rank, r in enumerate(steps["deep_wide bfloat16"]):
        c = r["launches"]
        for name in ("linear_ksplit_fwd", "linear_fwd"):
            check(c[name] > 0 and c[f"{name}@tc"] == c[name]
                  and c[f"{name}@partial"] > 0,
                  f"rank {rank}: deep step {name}: {c[f'{name}@tc']} of "
                  f"{c[name]} on the tensor cores, "
                  f"{c[f'{name}@partial']} row-parallel")
    prng = steps["bfloat16 tpu_prng"]
    by_data = {}
    for r in prng:
        check(r["launches"]["reparameterize_prng"] > 0 and r["seeds"],
              "tpu_prng: row 13 never launched")
        by_data.setdefault(r["position"][0], set()).add(r["seeds"][0])
    check(all(len(s) == 1 for s in by_data.values())
          and len({next(iter(s)) for s in by_data.values()}) == len(by_data),
          "tpu_prng: the model ranks of a data index drew different seed "
          "words, or two data indices drew the same")
    print(f"  tpu_prng: the sampler's seed words by data index {by_data} "
          "(equal on the model ranks of a data index)")
    r0 = steps["bfloat16"][0]
    check(r0["restored_equal"] and "shard_00001-of-00002.npz"
          in r0["ckpt_files"], "the sharded checkpoint saved at model 2 "
          "does not restore at model 1 with equal bits")
    print(f"  sharded checkpoint at model {TP_MODEL} ({r0['ckpt_files']}) "
          "restored at model 1: equal bits for every leaf of params, mu "
          "and nu")
    bf = steps["bfloat16"]
    shared = "gloo" in where
    print(f"  wall time of a default.ini bf16 step (batch 131072, the "
          f"steps' own noise), host clock over 3 steps ending in a sync: "
          f"{world} ranks at model {TP_MODEL}, {where}: "
          + " / ".join(f"{r['tp_ms']:.1f}" for r in bf)
          + f" ms (rank 0 / ...), one rank {bf[0]['one_ms']:.1f} ms [{card}]"
          + (" — no scaling figure: the ranks share one card" if shared
             else " — one rank a card"))
    return steps


def tp_command(data: Path, tmp: Path, cards: int) -> None:
    """The ``train`` command with ``model_parallel = 2`` and the sharded
    format on every visible card (``data_parallel = 0``: cards / 2 data
    indices), then ``--resume``: the step count continues."""
    from rawaudiovae_kelsey_tpu_torch.config import save_config
    from rawaudiovae_kelsey_tpu_torch.config.workspace import iter_runs
    from rawaudiovae_kelsey_tpu_torch.train.cli import main as train_cli

    cfg = mesh_config("default.ini", data, training__epochs=1,
                      training__checkpoint_interval=0,
                      extra__description="tp_command",
                      tpu__model_parallel=TP_MODEL,
                      tpu__checkpoint_format="orbax",
                      tpu__async_checkpoint=True)
    ini = tmp / "tp_command.ini"
    save_config(cfg, ini)
    t0 = time.perf_counter()
    first = tee_stdout(lambda: train_cli(["--config", str(ini)]))
    cfg.training.epochs = 2
    save_config(cfg, ini)
    second = tee_stdout(lambda: train_cli(["--config", str(ini),
                                           "--resume"]))
    runs = iter_runs(data / "tp_command")
    found = [sorted(p.name for p in (r / "model" / "checkpoints").iterdir())
             for r in runs]
    losses = [read_scalars(r / "logs", "Loss/Batch") for r in runs]
    steps = [json.loads((r / "model" / "checkpoints" / f[0] / "index.json")
                        .read_text())["step"] for r, f in zip(runs, found)]
    print(f"  the train command, model_parallel = {TP_MODEL} on {cards} "
          f"cards, then --resume: {time.perf_counter() - t0:.1f} s, "
          f"checkpoints {found} at steps {steps}, Loss/Batch steps "
          f"{[sorted(x) for x in losses]}")
    # the resumed run trains the second epoch alone: its first logged step
    # is the first run's last step + 1, and its checkpoint's step twice it
    check(f"train: starting {cards} ranks (cuda, nccl)" in first
          and f"train: starting {cards} ranks (cuda, nccl)" in second
          and len(runs) == 2
          and found == [["orbax_00001"], ["orbax_00002"]]
          and steps[1] == 2 * steps[0] > 0
          and min(losses[1]) == steps[0] == max(losses[0]) + 1
          and all((r / "model" / "last_model.npz").is_file() for r in runs)
          and (runs[0] / "model" / "checkpoints" / "orbax_00001" /
               f"shard_00001-of-{TP_MODEL:05d}.npz").is_file(),
          "the train command did not train at model 2, save the sharded "
          "format and resume from it")


def phase_tp(tmp: Path, card: str) -> dict:
    """Phase 14: tensor parallelism through the step and the trainers."""
    t_phase = time.perf_counter()
    data = {"epoch": tmp / "epoch", "ckpt": tmp / "tp_ckpt"}
    write_corpus(data["epoch"], 2 * 70000, 128, SEG)
    jobs = [("tp_steps", data)]
    t0 = time.perf_counter()
    ranks = mesh_start(TP_MODEL, "gloo", jobs, tmp)
    print(f"  {TP_MODEL} ranks at model {TP_MODEL} sharing the card over "
          f"gloo: {time.perf_counter() - t0:.1f} s, the ranks' start "
          "included")
    steps = tp_report(ranks, "sharing ONE card over gloo", card)
    cards = torch.cuda.device_count()
    if cards >= 2 * TP_MODEL:
        t0 = time.perf_counter()
        data["ckpt"] = tmp / "tp_ckpt_nccl"
        across = mesh_start(2 * TP_MODEL, "nccl", [("tp_steps", data)], tmp)
        print(f"  {2 * TP_MODEL} ranks, one a card, a {2}x{TP_MODEL} mesh "
              f"over NCCL: {time.perf_counter() - t0:.1f} s, the ranks' "
              "start included")
        check(all(r["backend"] == "nccl" for r in across), "not NCCL")
        tp_report(across, f"one a card over NCCL ({2 * TP_MODEL} cards)",
                  card)
        tp_command(data["epoch"], tmp, cards)
    else:
        print(f"  the 2x{TP_MODEL} mesh over NCCL: not run ({cards} card "
              "visible)")
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")
    return steps


# phase 15: the Oobleck model's SnakeBeta (row 21, csrc/snake.cu) at the
# shapes of configs/port/stable_audio_vae.ini's step: batch 48, 65,536 stereo
# frames, each stage's (channels, length)
OOBLECK_BATCH = 48
SNAKE_SHAPES = ((128, 65536), (128, 32768), (256, 8192), (512, 2048),
                (1024, 256), (2048, 32))
# SnakeBeta calls a step: 5 stages x 3 residual units x 2, each stage's
# own, the encoder's last, in the encoder and the decoder alike
SNAKE_CALLS = 72
SNAKE_ROWS = 4   # rows of a batch the float64 plain version takes at a time


def snake_inputs(shape, dtype, g, dev):
    """The card test's operands: x ~ 2·N(0, 1), dy ~ N(0, 1), alpha and
    beta ~ 0.5·N(0, 1), drawn on the card in fp32 and rounded once."""
    x = (2.0 * torch.randn(shape, generator=g, device=dev)).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    alpha = (0.5 * torch.randn(shape[1], generator=g, device=dev)).to(dtype)
    beta = (0.5 * torch.randn(shape[1], generator=g, device=dev)).to(dtype)
    return x, alpha, beta, dy


def hold_snake(snake, x, alpha, beta, dy):
    """Row 21's forward and backward on ``x`` against the float64 plain
    versions on the same rounded operands, within bounds that carry the
    arguments' size (tests/test_torch_cuda.py's): y within tol · (|x| +
    inv · (1 + 2|t|)), dx within tol · |dy| · (1 + inv · A · (1 + 2|t|)),
    tol 4e-7 in fp32 and 2^-8 in bf16; d alpha and d beta within 1e-5 of
    the sum of their terms' bounds, plus one bf16 rounding in bf16.  The
    float64 work runs SNAKE_ROWS rows at a time.  Returns the largest
    absolute error of y, dx, d alpha and d beta."""
    fp32 = x.dtype == torch.float32
    tol = 4e-7 if fp32 else 2.0 ** -8
    ptol = 1e-5 if fp32 else 1e-5 + 2.0 ** -8
    y = snake.snake_fwd(x, alpha, beta)
    dx, da, db = snake.snake_bwd(x, alpha, beta, dy)
    check(y.dtype == dx.dtype == x.dtype and da.dtype == db.dtype
          == alpha.dtype, "row 21: output dtypes")
    a64, b64 = alpha.double(), beta.double()
    a = torch.exp(a64)[:, None]
    eb = torch.exp(b64)
    inv = (1.0 / (eb + 1e-9))[:, None]
    want_da = torch.zeros_like(a64)
    want_db = torch.zeros_like(b64)
    sum_a = torch.zeros_like(a64)
    sum_b = torch.zeros_like(b64)
    err_y = err_dx = 0.0
    for r in range(0, x.shape[0], SNAKE_ROWS):
        xs, gs = x[r:r + SNAKE_ROWS].double(), dy[r:r + SNAKE_ROWS].double()
        want_y = snake.snake_ref(xs, a64, b64)
        want_dx, part_a, part_b = snake.snake_bwd_ref(xs, a64, b64, gs)
        want_da += part_a
        want_db += part_b
        t = a * xs
        grow = 1.0 + 2.0 * t.abs()
        off_y = (y[r:r + SNAKE_ROWS].double() - want_y).abs()
        off_dx = (dx[r:r + SNAKE_ROWS].double() - want_dx).abs()
        check(bool((off_y <= tol * (xs.abs() + inv * grow)).all()),
              f"snake_fwd {tuple(x.shape)} {x.dtype}: y off its bound")
        check(bool((off_dx <= tol * gs.abs() * (1.0 + inv * a * grow))
                   .all()),
              f"snake_bwd {tuple(x.shape)} {x.dtype}: dx off its bound")
        err_y = max(err_y, float(off_y.max()))
        err_dx = max(err_dx, float(off_dx.max()))
        g_ = gs.abs() * grow
        sum_a += (g_ * t.abs()).sum(dim=(0, 2))
        sum_b += g_.sum(dim=(0, 2))
        del xs, gs, want_y, want_dx, t, grow, off_y, off_dx, g_
    bound_a = inv[:, 0] * sum_a + want_da.abs()
    bound_b = inv[:, 0] ** 2 * eb * sum_b + want_db.abs()
    off_a = (da.double() - want_da).abs()
    off_b = (db.double() - want_db).abs()
    check(bool((off_a <= ptol * bound_a).all()),
          f"snake_bwd {tuple(x.shape)} {x.dtype}: d alpha off its bound "
          f"(worst {float((off_a / bound_a).max()):.3e} of the sum's bound)")
    check(bool((off_b <= ptol * bound_b).all()),
          f"snake_bwd {tuple(x.shape)} {x.dtype}: d beta off its bound "
          f"(worst {float((off_b / bound_b).max()):.3e} of the sum's bound)")
    again = snake.snake_bwd(x, alpha, beta, dy)
    check(all(torch.equal(p, q) for p, q in zip((dx, da, db), again)),
          f"snake_bwd {tuple(x.shape)} {x.dtype}: a second launch differs")
    return {"y": err_y, "dx": err_dx, "d_alpha": float(off_a.max()),
            "d_beta": float(off_b.max())}


def snake_rows(dev):
    """Row 21 at each stage's shape of the cell's step in bf16 and fp32:
    held against the plain versions, then timed against them (device time
    by events, kernel and plain in turns) beside the bytes bound (x read
    and y written; x and dy read and dx written).  The rows carry stage
    0's shape, the largest, and each stage's numbers under ``stages``."""
    from rawaudiovae_kelsey_tpu_torch.ops import snake

    g = torch.Generator(device=dev)
    g.manual_seed(21)
    rows = {}
    for kind, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        per = {"snake_fwd": [], "snake_bwd": []}
        err = {"snake_fwd": 0.0, "snake_bwd": 0.0}
        for channels, length in SNAKE_SHAPES:
            shape = (OOBLECK_BATCH, channels, length)
            x, alpha, beta, dy = snake_inputs(shape, dt, g, dev)
            e = hold_snake(snake, x, alpha, beta, dy)
            err["snake_fwd"] = max(err["snake_fwd"], e["y"])
            err["snake_bwd"] = max(err["snake_bwd"], e["dx"], e["d_alpha"],
                                   e["d_beta"])
            calls = {
                "snake_fwd": (lambda: snake.snake_fwd(x, alpha, beta),
                              lambda: snake.snake_ref(x, alpha, beta),
                              nbytes(x) * 2),
                "snake_bwd": (lambda: snake.snake_bwd(x, alpha, beta, dy),
                              lambda: snake.snake_bwd_ref(x, alpha, beta,
                                                          dy),
                              nbytes(x) * 3)}
            iters = 10 if channels * length >= 1 << 23 else 50
            for name, (kern, plain, moved) in calls.items():
                ms, plain_ms, t_kern, t_plain = time_both(kern, plain, iters)
                b = bound(0, moved, "fp32")
                per[name].append({"shape": list(shape), "ms": ms,
                                  "plain_ms": plain_ms, **b})
                print(f"  {name + '[' + kind + ']':<16} {str(shape):<18} "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bytes "
                      f"bound {b['bound_ms']:.4f} ms: {b['bound_ms'] / ms:.1%}"
                      f" of it (runs {[round(t, 4) for t in t_kern]} / "
                      f"{[round(t, 4) for t in t_plain]})")
            print(f"  row 21 [{kind}] {str(shape):<18} held: max abs err y "
                  f"{e['y']:.3e}, dx {e['dx']:.3e}, d alpha "
                  f"{e['d_alpha']:.3e}, d beta {e['d_beta']:.3e}; a second "
                  "backward equal bit for bit")
            del x, alpha, beta, dy
            torch.cuda.empty_cache()
        for name, stages in per.items():
            first = stages[0]
            rows[f"{name}[{kind}]"] = {
                "name": f"{name}[{kind}]", "route": "cuda",
                "source": "rawaudiovae_kelsey_tpu_torch/csrc/snake.cu",
                "replaces": "none: a port-only kernel (plain version "
                            "rawaudiovae_kelsey_tpu_torch/ops/snake.py "
                            f"{name.replace('_fwd', '')}_ref)",
                "shape": first["shape"], "ms": first["ms"],
                "plain_ms": first["plain_ms"],
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "max_abs_err": err[name], "library_ms": None,
                "stages": stages}
    return rows


def oobleck_epoch_launches(dev, precision: str, batch: int) -> dict:
    """The launches of one resident epoch of two steps of
    ``configs/port/stable_audio_vae.ini`` at ``precision`` and ``batch``
    (the engine the cell runs: ``build_model``, ``resident_model``,
    ``build_resident_epoch``), every wrapper's counter set to 0 just
    before it; and the epoch's losses."""
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.config import load_config
    from rawaudiovae_kelsey_tpu_torch.models.registry import (
        build_model,
        resident_model,
    )
    from rawaudiovae_kelsey_tpu_torch.ops import snake
    from rawaudiovae_kelsey_tpu_torch.parallel import resident
    from rawaudiovae_kelsey_tpu_torch.train.optim import build_optimizer
    from rawaudiovae_kelsey_tpu_torch.train.state import TrainState

    cfg = load_config(ROOT / "configs" / "port" / "stable_audio_vae.ini")
    check((cfg.vae.arch, cfg.vae.io_channels, cfg.training.batch_size,
           cfg.tpu.precision, cfg.tpu.backend)
          == ("oobleck", 2, OOBLECK_BATCH, "bfloat16", "pallas"),
          "configs/port/stable_audio_vae.ini is not the bf16 pallas stereo "
          "Oobleck trainer at batch 48")
    cfg.tpu.precision, cfg.training.batch_size = precision, batch
    cfg.validate()
    seg = cfg.audio.segment_length
    n_samples = 2 * batch * seg
    t = torch.arange(n_samples, device=dev, dtype=torch.float64) / SR
    host = (0.3 * torch.sin(2 * np.pi * 220 * t)
            + 0.2 * torch.sin(2 * np.pi * 1375 * t)).float().cpu().numpy()
    del t
    model = resident_model(cfg, build_model(cfg, dev))
    layout = resident.choose_layout(
        n_samples, seg, cfg.audio.hop_length,
        2 if precision == "bfloat16" else 4,
        int(cfg.tpu.resident_budget_gb * (1 << 30)))
    run_epochs, n_batches = resident.build_resident_epoch(
        model, cfg, build_optimizer(cfg), n_samples, layout=layout)
    data = resident.put_resident(host, cfg, layout, dev)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              seed=0)
    wrappers = (*ops.KERNEL_WRAPPERS, snake.snake_fwd, snake.snake_bwd)
    for w in wrappers:
        w.launches = 0
    state, losses = run_epochs(state, data, 0, k=1)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    out = {"steps": n_batches, "layout": layout,
           "losses": losses[0].tolist(),
           "launches": {k: v for k, v in launches.items() if v}}
    del state, data, run_epochs, model
    torch.cuda.empty_cache()
    return out


def phase_oobleck(card: str) -> dict:
    """Phase 15: the Oobleck model (``configs/port/stable_audio_vae.ini``):
    row 21 against its plain versions at the step's shapes, and its
    launches on the resident path, bf16 at the cell's batch and fp32
    (``highest``) at a batch of 4."""
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    with torch.no_grad():
        rows = snake_rows(dev)
    runs = {"bf16": oobleck_epoch_launches(dev, "bfloat16", OOBLECK_BATCH),
            "fp32": oobleck_epoch_launches(dev, "highest", 4)}
    for kind, run in runs.items():
        steps, seen = run["steps"], run["launches"]
        print(f"  resident epoch [{kind}], {steps} steps ({run['layout']} "
              f"layout): losses {[round(v, 6) for v in run['losses']]}, "
              f"launches {seen}")
        check(bool(np.isfinite(run["losses"]).all()),
              f"oobleck [{kind}]: a loss is not finite")
        check(seen.get("snake_fwd") == SNAKE_CALLS * steps
              and seen.get("snake_bwd") == SNAKE_CALLS * steps,
              f"oobleck [{kind}]: row 21 launched {seen.get('snake_fwd')} / "
              f"{seen.get('snake_bwd')} times in {steps} steps, not "
              f"{SNAKE_CALLS} + {SNAKE_CALLS} a step")
        # Adam: row 20's whole-tree kernel, 365 leaves in 8 launches
        check(seen.get("adam_tree") == 8 * steps and not seen.get(
              "leaf_update"), f"oobleck [{kind}]: adam_tree launched "
              f"{seen.get('adam_tree')} times in {steps} steps, not 8 a step")
        for name in ("snake_fwd", "snake_bwd"):
            rows[f"{name}[{kind}]"]["launches"] = seen[name]
            rows[f"{name}[{kind}]"]["path"] = (
                f"phase 15: a resident epoch of {steps} steps, {kind}")
    seen = runs["bf16"]["launches"]
    check(seen.get("loss_sums") == seen.get("loss_grads")
          == runs["bf16"]["steps"], "oobleck [bf16]: row 14's loss kernels "
          f"launched {seen.get('loss_sums')} / {seen.get('loss_grads')} "
          f"times in {runs['bf16']['steps']} steps")
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return rows


def main() -> int:
    check(torch.cuda.is_available(), "no CUDA device (torch.cuda."
          "is_available() is false)")
    if sys.argv[1:] == ["--host-cost"]:
        print(json.dumps({"host_us_a_call": host_cost(),
                          "package": str(ROOT)}))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    sys.path.insert(0, str(ROOT))
    check((ROOT / "rawaudiovae_kelsey_tpu_torch").is_dir(),
          f"the port's package is not beside {Path(__file__).name}: run "
          "from a checkout of the repository")
    from rawaudiovae_kelsey_tpu_torch.config import load_config, save_config
    from rawaudiovae_kelsey_tpu_torch.infer.api import frame_audio
    from rawaudiovae_kelsey_tpu_torch.infer.synthesis import overlap_add
    from rawaudiovae_kelsey_tpu_torch.models import DenseVAE
    from rawaudiovae_kelsey_tpu_torch import ops
    from rawaudiovae_kelsey_tpu_torch.ops import _build
    from rawaudiovae_kelsey_tpu_torch.train import save_params

    print("phase 1: card")
    print(smi.stdout.strip())
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    print("phase 2: build")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"  built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # plain versions in true fp32: TF32 off for matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if sys.argv[1:] == ["--mesh"]:
        # phases 13 and 14 alone (a machine with several cards runs their
        # NCCL halves across them)
        print("phase 13: data parallelism")
        with tempfile.TemporaryDirectory() as tmp:
            phase_mesh(Path(tmp), smi.stdout.strip())
        print("phase 14: tensor parallelism")
        with tempfile.TemporaryDirectory() as tmp:
            phase_tp(Path(tmp), smi.stdout.strip())
        print(smi.stdout.strip())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if sys.argv[1:] == ["--oobleck"]:
        # phase 15 alone
        print("phase 15: the Oobleck model (configs/port/"
              "stable_audio_vae.ini): row 21 and its resident path")
        oobleck_rows = phase_oobleck(smi.stdout.strip())
        print(smi.stdout.strip())
        print(json.dumps({"kernels": list(oobleck_rows.values())}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    def gen_params(seed):
        g = torch.Generator().manual_seed(seed)
        return DenseVAE(1024, 2048, 256, g, "cuda").params()

    print("phase 3: serving kernels against their plain versions")
    with torch.inference_mode():
        rows = phase_kernels(gen_params)
        forward_sgemm(rows, gen_params)
        quantized_sgemm(rows, gen_params)

    print("phase 3b: training kernels against their plain versions")
    with torch.inference_mode():
        train_rows = phase_train_kernels(gen_params)

    print("phase 3c: the input-gradient kernels and the sampler against "
          "their plain versions")
    with torch.no_grad():
        new_rows = phase_new_kernels(gen_params)
        grad_accum_sgemm(train_rows["grad_accum[fp32]"])

    print("phase 3d: the full backward chains and the loss reduction "
          "against their plain versions")
    with torch.no_grad():
        full_rows, full_at_train_batch = phase_full_kernels(gen_params)

    print("phase 3g: the `high` tier's 3-pass forms (rows 1, 2, 6, 4 and "
          "the row-parallel rows 1, 2) against their plain versions")
    with torch.no_grad():
        high_rows = phase_high_forward(gen_params)

    print("phase 3h: the backward-fusion switch (the 3-pass forms of rows 5 "
          "and 7-10, rows 11-12 in one fp32 pass, a step of every mode and "
          "tier, probes/fusion_ab.py)")
    fusion_rows, fusion_steps, _ = phase_fusion(gen_params,
                                                smi.stdout.strip())

    print("phase 3e: the variants' kernels (linear_ksplit_fwd, linear_fwd, "
          "toeplitz_fwd) against their plain versions")
    with torch.no_grad():
        variant_rows = phase_variant_kernels()

    print("phase 3f: the probes' kernels (dw_fused, dx_fused, adam_tree) "
          "against their plain versions")
    with torch.no_grad():
        probe_rows = phase_probe_kernels()
        row_libraries({**rows, **new_rows, **full_rows}, gen_params)

    print("phase 4: the serving path (configs/default.ini)")
    cfg = load_config(ROOT / "configs" / "default.ini")
    check(cfg.tpu.backend == "pallas" and cfg.vae.arch == "dense"
          and (cfg.audio.segment_length, cfg.vae.n_units,
               cfg.vae.latent_dim) == (1024, 2048, 256),
          "configs/default.ini is not the dense 1024/2048/256 pallas model")
    rng = np.random.default_rng(0)
    t = np.arange(int(CLIP_S * SR)) / SR
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)
             + 0.2 * np.sin(2 * np.pi * 1375 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "run-001"
        save_config(cfg, run_dir / "config.ini")
        params = gen_params(7)
        save_params(run_dir / "model" / "best_model.npz", params)
        # the fp32 encoder and decoder and the int8 decoder: every serving
        # launch on csrc/sgemm.cuh
        dense = (ops.encoder_fwd, ops.decoder_fwd, ops.quantized_decoder_fwd)
        for w in ops.KERNEL_WRAPPERS:
            w.launches = 0
        for w in dense:
            w.sgemm_launches = 0
        fp32, fp32_ms = phase_serve(run_dir, audio, False)
        int8, int8_ms = phase_serve(run_dir, audio, True)
        launches = {w.__name__: w.launches for w in ops.SERVING_KERNELS}
        on_sgemm = {w.__name__: w.sgemm_launches for w in dense}
    print(f"  kernel launches in the serving path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched by the serving path")
    # the fp32 encoder and decoder and the int8 decoder (--quantize): every
    # launch on csrc/sgemm.cuh
    print("  serving launches on csrc/sgemm.cuh: "
          + ", ".join(f"{name} {n}/{launches[name]}"
                      for name, n in on_sgemm.items()))
    for name, n in on_sgemm.items():
        check(n == launches[name], f"{name}: {n} of {launches[name]} "
              "serving launches on csrc/sgemm.cuh")

    # the same requests through the plain versions on the same card
    frames = frame_audio(audio, 1024)
    hop_frames = frame_audio(audio, 1024, 128)
    qp = ops.quantize_decoder(params)
    with torch.inference_mode():
        def plain(fr, quantize):
            x = torch.from_numpy(np.ascontiguousarray(fr)).cuda()
            mu, _, _ = ops.encoder_fwd_ref(
                *[params[n][k] for n in ("fc1", "fc21", "fc22")
                  for k in ("w", "b")], x)
            if quantize:
                y = ops.quantized_decode_ref(qp, mu)
            else:
                y, _ = ops.decoder_fwd_ref(
                    *[params[n][k] for n in ("fc3", "fc4")
                      for k in ("w", "b")], mu)
            return y.cpu().numpy()

        for label, out, q in (("fp32", fp32, False), ("int8", int8, True)):
            e_flat = float(np.abs(out["flat"][:, 0]
                                  - plain(frames, q).reshape(-1)).max())
            e_ola = float(np.abs(out["ola"][:, 0] - overlap_add(
                plain(hop_frames, q), 128)).max())
            print(f"  {label}: /reconstruct vs plain path: max err "
                  f"{e_flat:.3e} (flat), {e_ola:.3e} (hop+OLA)")
            check(max(e_flat, e_ola) <= HTTP_ATOL,
                  f"{label} /reconstruct differs from the plain path")

    for name, row in rows.items():
        # the rows describe csrc/sgemm.cuh's forms: the launches that took
        # them (all of them, checked above)
        row["launches"] = on_sgemm[name]
    print(f"  /reconstruct latency: fp32 {fp32_ms:.2f} ms, int8 "
          f"{int8_ms:.2f} ms")

    print("phase 5: the training path (configs/default.ini)")
    card = smi.stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, step_launches, high_step_launches = phase_train(
            Path(tmp) / "data", card)
        print("phase 6: the device-resident path (configs/perf_bf16.ini)")
        resident_launches, primitive_launches, dx_launches = phase_resident(
            Path(tmp) / "data", card)
    print("phase 7: the streaming path (configs/default_iterable.ini)")
    with tempfile.TemporaryDirectory() as tmp:
        stream_launches, high_launches = phase_stream(Path(tmp))
    print("phase 8: the deep/wide model (configs/deep_wide.ini)")
    with tempfile.TemporaryDirectory() as tmp:
        deep_launches, deep_fp32_launches, deep_serve_launches = phase_deep(
            Path(tmp), audio, card)
        print("phase 9: the conv1d model (configs/conv1d.ini)")
        conv_launches = phase_conv(Path(tmp), card)
    print("phase 10: the probes (deep_bwd, deep_step, adam_fusion)")
    probe_launches = phase_probes(card)
    print("phase 11: the library path (configs/default.ini)")
    with tempfile.TemporaryDirectory() as tmp:
        phase_library(Path(tmp), card, gen_params)
    print("phase 12: the resident stream (configs/default_iterable.ini)")
    with tempfile.TemporaryDirectory() as tmp:
        phase_resident_stream(Path(tmp), card)
    print("phase 13: data parallelism (two ranks sharing the card over "
          "gloo; NCCL at one rank a card)")
    with tempfile.TemporaryDirectory() as tmp:
        mesh = phase_mesh(Path(tmp), card)
    print("phase 14: tensor parallelism (the row-parallel kernel forms; two "
          "ranks at model 2 sharing the card over gloo)")
    with torch.no_grad():
        tp_rows = tp_partial_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        tp = phase_tp(Path(tmp), card)
    print("phase 15: the Oobleck model (configs/port/stable_audio_vae.ini): "
          "row 21 and its resident path")
    torch.cuda.empty_cache()
    oobleck_rows = phase_oobleck(card)
    # the 3-pass chains against the same products in one fp32 pass: the
    # fp32 split kernels launch the chains' GEMMs without the split
    ms = {k: r["ms"] for k, r in train_rows.items()}
    for chain, parts in (("enc_bwd_full", ("enc_bwd_dw1", "grad_accum2")),
                         ("dec_bwd_full", ("dec_bwd_fused", "grad_accum"))):
        one = sum(ms[f"{p}[fp32]"] for p in parts)
        three = full_at_train_batch[f"{chain}[fp32]"]
        print(f"  {chain}[fp32] at batch {TRAIN_BATCH}: {three:.4f} ms in "
              f"three passes, {one:.4f} ms in one fp32 pass ("
              f"{' + '.join(parts)}): {three / one:.2f}x")
    # these three run on fp32 operands with the switch forced to "split"
    # (phase 3h's `highest` step gives their launches, at the end)
    forced_rows = {f"{name}[fp32]": train_rows.pop(f"{name}[fp32]")
                   for name in ("enc_bwd_dw1", "grad_accum2",
                                "dec_bwd_fused")}
    for key, row in train_rows.items():
        name, kind = key[:-1].split("[")
        counts = step_launches if kind == "fp32" else train_launches
        # the bf16 dense rows describe the tensor-core kernel, fp32
        # grad_accum's the fp32 kernel of csrc/sgemm.cuh
        on_fast = f"{name}@tc" if kind == "bf16" else f"{name}@sgemm"
        row["launches"] = counts[on_fast if on_fast in counts else name]
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(train_rows)
    # matmul_nt_mask runs on bf16 operands with the switch forced to
    # "primitive" (phase 3h's bf16 step, at the end)
    forced_rows["matmul_nt_mask[bf16]"] = new_rows.pop("matmul_nt_mask[bf16]")
    for key, row in new_rows.items():
        name, kind = key[:-1].split("[")
        if name == "reparameterize_prng":
            row["launches"] = resident_launches[name]
        elif kind == "fp32":
            # the rows describe the fp32 kernel: the launches that took it
            row["launches"] = primitive_launches[f"{name}@sgemm"]
        else:
            # matmul_nt2_mask's describes the tensor cores: its launches
            # that took them (the dx checks hold matmul_nt's there)
            counts = dx_launches["bf16"]
            row["launches"] = counts.get(f"{name}@tc", counts[name])
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(new_rows)
    # the full chains run in fp32 under `high`; their bf16 forms run with
    # the switch forced to "full" (phase 3h's bf16 step, at the end); the
    # loss reduction's bf16 row (all four operands bf16; the bf16 step
    # passes fp32 mu and logvar) is reported off the path (phase 3d held it)
    off_path(full_rows.pop("loss_sums[bf16]"))
    # row 14 in the steps of phase 7's stream runs (counters reset before
    # each): the fp32 rows in the `high` run's, the bf16-fp32 rows in the
    # bf16 run's
    for key in [k for k in full_rows if k.startswith("loss_")]:
        row = full_rows.pop(key)
        counts = (stream_launches if key.endswith("[bf16-fp32]")
                  else high_launches)
        row["launches"] = counts[key.split("[")[0]]
        check(row["launches"] > 0, f"{key}: no launch on its main path")
        rows[key] = row
    for key in ("enc_bwd_full[bf16]", "dec_bwd_full[bf16]"):
        forced_rows[key] = full_rows.pop(key)
    for key, row in full_rows.items():
        # the full chains' rows describe the tensor-core form: its launches
        name = key[:-1].split("[")[0]
        row["launches"] = high_launches.get(f"{name}@tc",
                                            high_launches[name])
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(full_rows)
    for w in ops.TRAINING_KERNELS:
        check(stream_launches[w.__name__] > 0,
              f"{w.__name__}: no launch in the bf16 stream run")
    # the variants' kernels: bf16 linear layers in the deep training runs,
    # fp32 k-split in the deep `highest` step, fp32 whole-k in the deep
    # server; the Toeplitz kernel in the conv1d op-level steps.  A bf16 row
    # describes the tensor-core kernel: its launches are those that took it
    for key, row in variant_rows.items():
        name, kind = key[:-1].split("[")
        if name.startswith("toeplitz_fwd"):
            counts = conv_launches[{"bf16": "bfloat16", "fp32": "highest",
                                    "4-pass": "high"}[kind]]
        elif kind == "bf16":
            counts = deep_launches
        elif name == "linear_fwd":
            counts = deep_serve_launches
        else:
            counts = deep_fp32_launches
        # a bf16 row describes the tensor-core kernel, an fp32 one
        # csrc/sgemm.cuh, the 4-pass one the tensor cores' 4-pass form (the
        # `high` op-level step's); the toeplitz_fwd_narrow rows the narrow
        # kernel
        row["launches"] = counts[
            "toeplitz_fwd@narrow" if name == "toeplitz_fwd_narrow"
            else "toeplitz_fwd@split" if kind == "4-pass"
            else f"{name}@tc" if kind == "bf16" else f"{name}@sgemm"]
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(variant_rows)
    # the probes' kernels: the deep_bwd runs in each dtype, the adam_fusion
    # runs
    for key, row in probe_rows.items():
        name, kind = key[:-1].split("[")
        # dw_fused / dx_fused rows describe the new form: its launches
        counts = probe_launches[kind]
        tag = f"{name}@{'tc' if kind == 'bf16' else 'sgemm'}"
        row["launches"] = counts.get(tag, counts[name])
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(probe_rows)
    # phase 13's launches a rank of the rows on its path: the bf16 step's
    # rows 1, 2, 7-10, the `high` step's 11-12, the `highest` step's fp32
    # rows 4-7, the deep step's 15-16, the resident epochs' row 13
    steps = mesh["steps"]
    for key, row in rows.items():
        name, kind = (key[:-1].split("[") if "[" in key else (key, "fp32"))
        if name == "reparameterize_prng":
            pair = [r["launches"] for r in mesh["resident"]]
        elif name in ("linear_ksplit_fwd", "linear_fwd"):
            pair = ([r["launches"] for r in steps["deep_wide bfloat16"]]
                    if kind == "bf16" else None)
        elif name in ("enc_bwd_full", "dec_bwd_full"):
            pair = [r["launches"] for r in steps["high"]]
        elif kind.startswith("bf16"):
            pair = [r["launches"] for r in steps["bfloat16"]]
        else:
            pair = [r["launches"] for r in steps["highest"]]
        if pair is not None and all(p.get(name) for p in pair):
            row["mesh_launches_per_rank"] = [p[name] for p in pair]
    # phase 14's launches a rank of the rows on its path: the bf16 steps'
    # rows 1, 2, 7-10 and 13, the `high` step's 11-12, the `highest`
    # step's fp32 rows 1, 2, 4-7, the deep step's bf16 15-16
    for key, row in rows.items():
        name, kind = (key[:-1].split("[") if "[" in key else (key, "fp32"))
        if name == "reparameterize_prng":
            label = "bfloat16 tpu_prng"
        elif name in ("linear_ksplit_fwd", "linear_fwd"):
            label = "deep_wide bfloat16" if kind == "bf16" else None
        elif name in ("enc_bwd_full", "dec_bwd_full"):
            label = "high"
        else:
            label = "bfloat16" if kind.startswith("bf16") else "highest"
        ranks_ = tp.get(label, ()) if label else ()
        if ranks_ and all(r["launches"].get(name) for r in ranks_):
            row["tp_launches_per_rank"] = [r["launches"][name]
                                           for r in ranks_]
    # the row-parallel forms: their launches in phase 14's steps (rank 0;
    # the fp32 ones on csrc/sgemm.cuh, the `highest` step's)
    for key, row in tp_rows.items():
        name, kind = key[:-1].split("[")
        name = name[:-len("_partial")]
        label = ("deep_wide bfloat16" if name.startswith("linear")
                 else "bfloat16" if kind == "bf16" else "highest")
        row["launches"] = tp[label][0]["launches"][f"{name}@partial"]
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(tp_rows)
    # the `high` tier's 3-pass forms: rows 1-2 in phase 5's `high` step,
    # rows 6 and 4 in phase 6's `high` dx, the row-parallel forms in phase
    # 14's `high` model-2 step (rank 0); each launch on the 3-pass tensor
    # cores; per rank in phases 13 and 14's `high` steps
    for key, row in high_rows.items():
        name = key[:-len("[3-pass]")]
        if name.endswith("_partial"):
            row["launches"] = tp["high"][0]["launches"][
                f"{name[:-len('_partial')]}@split"]
            row["tp_launches_per_rank"] = [
                r["launches"][f"{name[:-len('_partial')]}@split"]
                for r in tp["high"]]
        elif name in ("encoder_fwd", "decoder_fwd"):
            row["launches"] = high_step_launches[f"{name}@split"]
            row["mesh_launches_per_rank"] = [
                r["launches"][name] for r in mesh["steps"]["high"]]
        else:
            row["launches"] = dx_launches["high"][f"{name}@split"]
        check(row["launches"] > 0, f"{key}: no launch on its main path")
    rows.update(high_rows)
    # the backward-fusion switch's forms and the forms it puts on a path:
    # their launches in phase 3h's step of the (tier, mode) that runs them,
    # on the form the row describes
    where = {"matmul_nt_mask[3-pass]": ("high", "primitive", "split"),
             "grad_accum[3-pass]": ("high", "primitive", "split"),
             "enc_bwd_dw1[3-pass]": ("high", "split", "split"),
             "grad_accum2[3-pass]": ("high", "split", "split"),
             "dec_bwd_fused[3-pass]": ("high", "split", "split"),
             "enc_bwd_full[fp32-1pass]": ("highest", "full", "sgemm"),
             "dec_bwd_full[fp32-1pass]": ("highest", "full", "sgemm"),
             "enc_bwd_dw1[fp32]": ("highest", "split", "sgemm"),
             "grad_accum2[fp32]": ("highest", "split", "sgemm"),
             "dec_bwd_fused[fp32]": ("highest", "split", "sgemm"),
             "matmul_nt_mask[bf16]": ("bfloat16", "primitive", "tc"),
             "enc_bwd_full[bf16]": ("bfloat16", "full", "tc"),
             "dec_bwd_full[bf16]": ("bfloat16", "full", "tc")}
    for key, row in {**fusion_rows, **forced_rows}.items():
        tier, mode, tag = where[key]
        row["launches"] = fusion_steps[(tier, mode)][
            f"{key.split('[')[0]}@{tag}"]
        row["path"] = (f"phase 3h: a {tier} step with BWD_FUSION forced to "
                       f"{mode!r}")
        check(row["launches"] > 0, f"{key}: no launch on its main path")
        rows[key] = row
    rows.update(oobleck_rows)
    for key, row in rows.items():
        row.setdefault("library_ms", None)
        missing = [k for k in ("name", "route", "source", "replaces",
                               "launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by") if k not in row]
        check(not missing, f"{key}: the kernel line's row lacks {missing}")
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
