#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any mismatch:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, all started together; print each instantiation's
   registers and spills (``-Xptxas -v``) and the tensor-core instructions
   in each tensor-core instantiation's SASS (``cuobjdump -sass``: ``IMMA``
   in the conv kernels and ``matmul_ws``'s int8 mma form, ``HGMMA`` in its
   bf16 long-M form, none in the conv kernels' six f32 simt instantiations
   each);
   fail on a spill in any of them, in a simt, dw or nk instantiation or in a
   ``flash_attention`` ``wgmma`` instantiation (D = 256 included), a
   missing ``IMMA`` or ``HGMMA``, a tensor-core instruction in a simt
   instantiation, a missing compiler report or a missing ``cuobjdump``;
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (``vgg_imagenet``'s six convs at
   224×224, the ``lenet`` convs, the §5.2 layer, depthwise / stride-2 /
   dilation-2 / per-channel-requant layers, the tensor-core path's edge
   geometries (``TC_CASES`` of ``tests/test_torch_cuda.py``) in int8 and,
   with ``CASES``, in f32 (the simt path, or where the groups are
   narrower than 8 the dw or the nk path: each simt result
   also within ``f32_sum_bound`` of ``conv2d_ws_simt_emulate``, the two
   kernels and a second call bit-equal), the dw path's edges
   (``DW_CASES``, with ``CASES``' depthwise layers) in int8 and f32, each
   dw result equal to ``conv2d_ws_dw_emulate`` in int8 and within
   ``f32_sum_bound`` of it in f32, the two kernels, a tiled call and a
   second call bit-equal (``check_dw``), the nk path's edges
   (``NK_CASES``, with ``CASES``' ``groups2``) in int8 and f32, each nk
   result equal to ``conv2d_ws_nk_emulate`` bit for bit (it rounds each
   f32 FFMA as the card does), the two kernels, a tiled call and a second
   call bit-equal (``check_nk``), the first port's scalar kernels
   (which no table geometry reaches) launched directly on their tile
   plan at three of those geometries in int8 and f32 against the plain
   version (``check_scalar_kernel``), the dense
   heads; every ``matmul_ws`` form at its edge shapes (M from 1 to 3000,
   K and N off the tiles, the head's N = 1000) and at the LM's MLP
   shapes (llama3.2-3b's, and recurrentgemma-9b's at M = 4 on the stream
   form and M = 4096 on ``wgmma``, K up to 12,288; deepseek-moe-16b's
   shared experts', internvl2-26b's and seamless-m4t-medium's, each on
   the form its serving runs); llama3.2-3b's
   attention at S = 512, 777, 2048, 3000, seamless-m4t-medium's full and
   causal attention at [1, 2048, 16, 64] and full attention at D = 128,
   the bf16 attention kernel's other head dims 16, 32, 64,
   and the head dims it runs padded, at D = 256 or on f32 copies — bf16
   D = 8, 96 and 256 at [1, 2048, H, D] with H·D = 3072, bf16 D = 320, f32
   D = 6 and 160, and f32 B·H = 65,600 — each asserting the variant
   ``kernel_variant`` names): int paths ``torch.equal``, f32 within 1e-4,
   bf16 attention within
   one bf16 ulp, bf16 GEMMs within the bound ``bf16_gemm_bound`` derives;
   each conv and GEMM check also asserts which path or form launched.  Time each kernel's call and its plain version with CUDA
   events around back-to-back calls (``ms``, ``plain_ms``: host work
   included), and each kernel's call again as the sum of every device
   event it issues under ``torch.profiler`` (``device_ms``: its kernel and
   whatever else it runs on the card, such as the scale fill; the mean
   over the calls whose events all reached the trace), beside its
   bound (and, for attention, ``scaled_dot_product_attention``, for the
   bf16 GEMMs ``torch.matmul``, and the achieved TFLOP/s); print the
   ``vgg_imagenet`` per-layer table and ``matmul_ws``'s host cost a call;
   hold ``matmul_ws`` int8 at w8 serving's GEMM shapes (llama3.2-3b's,
   yi-34b's and gemma-7b's, the mma form at a prefill's M and the
   stream form at a 4-slot decode's, each ``torch.equal``, form asserted;
   the long-M ones timed beside ``torch._int_mm`` with the weight stored
   row-major and column-major); and the int8 KV cache's two decode
   contractions at 4 slots × 4096 positions (D = 128 and 256, random
   and worst-case operands) to the CPU's int64 sums; hold
   ``ops.conv1d_depthwise`` at recurrentgemma-9b's temporal conv ([1,
   4096, 4096], K = 4, f32 with a bias: one ``conv2d_ws`` launch on the
   dw path, 4096 one-lane groups) within 1e-4 of
   ``conv1d_depthwise_ref`` and of the block's ``causal_conv1d``, timed
   beside ``F.conv1d(groups=W)`` with its byte bound; and time
   ``mobilenet_small``'s three depthwise convs at 224 and batch 8 on the
   dw path of both kernels, in int8 as served and in f32, beside the plain
   version, the byte bound and, in f32, ``F.conv2d(groups=C)``; and time
   the nk path (C/g > 1, K/g < 8) of both kernels at ``unet_small``'s and
   ``dilated_context``'s 3-class heads at 224, batch 8 (int8 as served,
   int32 out), at ``unet_small``'s head in f32 (its QAT forward, f32 out)
   and at ``CASES``' ``groups2`` in f32, each held to the plain version and
   the emulation (``check_conv``), beside its bound, the plain version
   and, in f32, ``F.conv2d``;
4. run the §5.2 layer through ``ConvCore(ConvCoreConfig(int8=True))``;
   with ``relu`` and ``pool`` under ``wrap8=True`` (int8 out, equal to the
   plain backend, accumulators outside int8 present); and under
   ``auto_bank=False`` (the whole map as one tile, past a block's shared
   memory) on both kernels, equal to the fitted plan's result, on each
   path: the §5.2 layer in int8 (tc) and f32 (simt), a 224² depthwise
   layer in int8 and f32 (dw) and a grouped layer of 4-channel groups
   with 2 outputs each (nk), the path asserted by the launch counts;
5. the conv main path: ``vgg_imagenet`` (224×224×4, 1000 classes, random
   weights from a seed) quantized on a 16-image calibration batch, served
   to 16 requests through ``ConvNetEngine(batch=8)`` (the facade of the
   continuous-batching engine): logits bit-equal to
   the plain backend, launch counts read around the run, every conv launch
   on the tensor-core path, the device-busy share of one submit; again
   with ``kernel="sequential"``; then ``lenet``, whose card logits must
   also equal the CPU run of the same program;
6. the LM main path: llama3.2-3b as published (28 layers, bf16 compute,
   random weights from a seed) served to 8 requests of 64–3000 prompt
   tokens through ``ServingEngine(slots=4, max_seq=4096)`` with
   ``attn_impl="flash"``: one kernel launch per layer per prefill, 16
   tokens per request, prefill logits against the plain attention; the
   same requests again with ``gemm_backend="pallas_ws"`` on the same
   weights (three ``matmul_ws`` launches per layer per forward, admit
   and decode times beside the ``xla`` run's; the longest prompt's
   prefill with each of its ``matmul_ws`` calls held to
   ``matmul_ws_plain`` on the same operands within ``bf16_gemm_bound``,
   and every prompt's prefill logits against the ``xla`` run's); then
   two full-width layers in f32 (logits within 1e-4, tokens equal to the
   plain attention), and the reduced model (tokens equal to the CPU
   run);
6b. w8 serving with the int8 KV cache (``quantize_weights``, scale 0.25)
   on the same engine timing: llama3.2-3b with phase 6's weights and
   requests (7 × 28 ``matmul_ws`` launches a forward, the mma form at
   the prefills and the stream form at the decode steps; prefill logits
   ``torch.equal`` to the same prefill with ``matmul_ws_plain`` in the
   kernel's place; admit and decode times beside phase 6's bf16 ones;
   relative L2 and top-1 against bf16 of the same weights, a diagnostic;
   a decode step and a 3000-token prefill split by kernel under
   ``torch.profiler``); gemma-7b at full width in bf16 (8 requests, one
   D = 256 ``flash_attention`` launch a layer a prefill, prefill logits
   against the plain attention) and in w8 (4 requests of 64–2048
   tokens, each prefill equal to the plain GEMMs'), with the peak
   memory; yi-34b at full width and depth in w8 (drawn and quantized one
   layer group at a time, 3 requests of 64–1024 tokens; resident bytes,
   shortest prefill equal to the plain GEMMs');
   and the reduced w8 models, whose card tokens must equal the CPU run's;
6c. the hybrid and attention-free families as published, on the same
   engine timing with prompts of 64, 512, 2048, 2560 and 4096 tokens (the
   last two past the 2048 window; all multiples of 512) and a 4112-position
   pool: recurrentgemma-9b (38 layers, 12 × R,R,A + R,R; rnn_width 4096,
   MQA, window 2048; drawn in bf16) with ``gemm_backend="xla"`` and again
   ``"pallas_ws"`` on the same weights (3 × 38 ``matmul_ws`` launches a
   forward on the forms ``mm_path`` names, no ``flash_attention`` launch
   although ``attn_impl="flash"``: the windowed layers take the chunked
   attention; the 4096-token prefill's 114 GEMMs each held to
   ``matmul_ws_plain`` and the prefill logits within phase 6's bf16 bound
   of ``xla``'s, as in phase 6), admits, decode steps, busy shares, peak
   memory and a 4096-token admit split by part under ``torch.profiler``
   (bf16 GEMMs, the f32 gate GEMMs, the RG-LRU scan, the chunked
   attention, the logits, the rest; each device event counted once,
   through the op whose correlation id it carries);
   one R,R,A group and the R,R tail at full width in f32, a 2560-token
   prefill (the ring rolled by 512) and 3 decode steps within 2e-3 of
   ``forward_train``'s logits; rwkv6-1.6b (24 layers, d_model 2048, 32
   heads of 64) on ``xla`` (no kernel on its path), with the chunked wkv6
   of layer 0's real inputs at S = 2048 held to the sequential one; and
   the reduced models of both families, card tokens equal to the CPU's;
6d. the MoE, VLM and encoder-decoder families as published, drawn in
   bf16 on the card one model at a time (each freed before the next, its
   peak memory logged): deepseek-moe-16b (28 layers, 64 routed experts
   top-6 + 2 shared) served to prompts of 64–4096 tokens on ``xla`` +
   ``chunked`` and again on ``pallas_ws`` + ``flash`` (84 ``matmul_ws``
   launches a forward: the shared experts; 28 ``flash_attention`` a
   prefill), with the share of routed choices the capacity dropped at
   each prefill (``moe.route`` recorded); qwen3-moe-30b-a3b (48 layers,
   128 experts top-8, GQA 32/4, ``qk_norm``; 61.1 GB) on ``xla`` +
   ``flash`` (0 ``matmul_ws``, 48 ``flash_attention`` a prefill);
   internvl2-26b (48 layers, d_model 6144) through ``lm.prefill`` with
   1024 patches of width 3200 before 3072 tokens and 8 decode steps (144
   ``matmul_ws`` a forward, 48 ``flash_attention``), then served to text
   prompts; seamless-m4t-medium (12 + 12 layers) through ``lm.prefill``
   with 2048 frames and 2048 tokens and 8 decode steps against the cross
   cache (72 ``matmul_ws`` a prefill, 36 ``flash_attention``: 12 encoder
   and 12 cross layers full, 12 causal).  Each model's prefill logits
   are held to the plain attention and GEMMs (``attn_impl="dense"``,
   ``gemm_backend="xla"``) within one bf16 ulp a kernel launch of a
   forward, relative L2 (phase 6's bound); one prefill of each kernel
   run has every ``matmul_ws`` and ``flash_attention`` call held to its
   plain version on its own operands; admits, decode steps, busy shares
   and device-event counts are logged, and the MoE models' 4-slot decode
   step and 4096-token prefill split by part (router, expert GEMMs,
   dispatch and combine, the kernels, the rest); the reduced models of
   the four give the CPU's tokens (seamless: logits within 1e-4) on the
   card;
7. continuous batching: ``ContinuousBatchingEngine`` serves
   ``vgg_imagenet`` 224 at batch 8 under 4 virtual cores in each of the
   batch, kout and spatial modes, ``unet_small`` at 224×224×4 (transposed
   convs up to 112 and 224 rows) and ``lenet``, each bit-equal to the
   plain backend, with every kernel's launches, tensor-core launches and
   ``matmul_ws`` forms held to what ``conv_path`` / ``mm_path`` give the
   calls the program makes (recorded through the same scheduler); one
   batch dispatched under ``torch.cuda.set_sync_debug_mode("error")``; one
   engine with a 2-program cache serving all three models to 64 requests
   from 4 threads at both priorities (an evict and rebuild asserted,
   results bit-equal); images/s, latency percentiles, formation counts and
   the device-busy share of an open-loop load beside phase 5's
   synchronous submit;
8. training through the kernels' backward, f32 with TF32 off: at each of
   ``vgg_imagenet``'s six layer shapes (batch 8) a whole-map f32 conv on
   both kernels' simt path (its blocks sized by geometry alone)
   ``torch.equal`` to the same call with 8×16 tiles, within 1e-4 of its
   plain version and within ``f32_sum_bound`` of
   ``conv2d_ws_simt_emulate``, the two kernels bit-equal, timed beside
   ``F.conv2d``; each of the five input-gradient convs timed
   beside ``torch.nn.grad.conv2d_input`` and its bound;
   and its VJP through autograd (``check_conv_vjp`` of
   ``tests/test_torch_cuda.py``: the saved ReLU / pool masks equal the
   float64 accumulator's except within rounding of 0 or of a tie, dx, dw
   and db against the plain gradient oracles in float64, each element
   within ``f32_sum_bound`` of its contraction and each gradient within
   ``GRAD_REL_L2`` relative L2, which its TF32-operand control must
   fail), conv 5 also with ``pipelined=True``, timed beside ``F.conv2d``
   and, for the weight gradient, ``torch.matmul``; the head's
   ``matmul_ws`` VJP and ``unet_small``'s two transposed-conv VJPs at 224
   likewise; then the main paths: 3 ``fit``
   steps of ``vgg_imagenet`` as the repo defines it (QAT per channel,
   batch 8, 1000 classes) with the launches a step held to what the plan
   gives (11 ``conv2d_ws`` on the simt path, 57 ``matmul_ws`` on the simt
   form), ms a step, one
   more step under ``torch.profiler`` split by part (the first of 3
   marker-separated steps a window whose every launch reached the
   trace), and the trained net
   quantized on 8 training images and served bit-equal to the plain
   backend; the ``lenet`` QAT round trip at the reference test's settings
   (float accuracy ≥ 0.9, int8 within 0.02); 3 steps of ``unet_small`` at
   224×224×4; each f32 forward conv is timed on ``conv2d_ws_pipe`` too;
9. the calibrated cost model: ``calibration_sweep`` times the smoke grid
   and ``vgg_imagenet``'s six convs at batch 8 on both kernels and fits a
   table (into ``build/``), failing if no term was fit, if more than half
   the samples are noisy, or if a sample launched on another path or
   ``TcPlan`` than ``conv_path`` / ``tc_plan`` give; prints each
   ``vgg_imagenet`` layer's calibrated ``kernel="auto"`` verdict beside
   both kernels' measured times; tunes ``vgg_imagenet``, ``unet_small``
   and ``mobilenet_small`` at 224×224×4 with ``autotune_network(...,
   calib=)`` and serves 16 requests of each through
   ``ConvNetEngine(tune=)``, bit-equal to the plain backend, launches held
   to what the tuned plans give; serves ``vgg_imagenet`` through one
   ``ContinuousBatchingEngine(n_cores=4, route=True, calib=,
   drift_band=(0.5, 2.0))``: three single images released by the
   deadline, then two full batches, bit-equal, with the route counters,
   the first batch's per-layer measured/predicted ratios and the drift
   events; and loads the committed ``CALIBRATION_h100.json``, whose
   provenance must name the card;
10. train an LM (TF32 off): one f32 step of the reduced llama3.2-3b on
   ``xla`` and ``pallas_ws`` and of the reduced recurrentgemma-9b,
   rwkv6-1.6b and deepseek-moe-16b on ``xla``, card == CPU within 1e-4
   (loss, every gradient, every updated param, m and v, at lr 5e-4; a
   param whose gradient is near zero on either side held to 2·lr);
   ``matmul_ws``'s
   f32 VJP at llama3.2-3b's MLP backward shapes (``check_matmul_vjp``)
   and its dx / dw times beside ``torch.matmul``; llama3.2-3b at full
   width with 2 layers in f32 on ``pallas_ws``: every ``matmul_ws`` call
   of one step (forward, remat recompute, dx, dw) held to
   ``matmul_ws_plain`` and the float64 product, the step's gradients
   within a relative L2 of the same step on ``xla`` that the per-call
   readings set; llama3.2-3b as published (28 layers, f32 params, bf16
   compute, remat ``"minimal"``, chunked attention) trained a recording
   step and 3 timed ones on ``xla``, then on ``pallas_ws``, at 2 × 4096
   tokens in two microbatches: ms a step, tokens/s, peak memory,
   ``matmul_ws`` launches a step by form held to the recording step, in
   which every call (bf16 forward and recompute, f32 dx and dw) is held
   to ``matmul_ws_plain``, each run's first loss against
   ``make_eval_step``'s, one profiled step's device time by part, and
   one step at the config's own attention chunk; ``Trainer`` at full
   width with 2 layers, a failure injected at step 3 and a
   ``Checkpointer`` restore, the losses equal to an uninterrupted run's
   bit for bit under deterministic algorithms (checkpoints under
   ``build/``, removed after); the training launcher on the card;
11. distribution on ``torch.distributed`` (DTensor): (a) on a one-rank
   NCCL mesh ``(data=1, model=1)`` in this process, llama3.2-3b at full
   width with 4 layers (f32 state, bf16 compute, remat ``"minimal"``,
   ``pallas_ws``) placed by ``ShardingPlan(fsdp=True, mode="train")``:
   one train step at 2 × 4096 tokens in two microbatches against the
   unsharded step from the same state and batch, gradients, params, m, v
   and metrics bit for bit (under deterministic algorithms), every
   ``matmul_ws`` call of both held to ``matmul_ws_plain`` on its local
   operands and their counts by form equal; the two steps timed in turns
   and one sharded step profiled for its collectives' and redistributes'
   share; a ``mode="decode"`` step of 4 slots × 4096 positions after a
   3000-token prefill against the unsharded decode within phase 6's bf16
   bound; the sharded params restored from a checkpoint onto the
   unsharded tree and back, bit for bit; deepseek-moe-16b at full width
   with 2 layers, one train step of 2 × 2048 tokens on the FSDP plan
   (``pallas_ws``: the MoE layer's routed experts and router on local
   shards, its 2 shared experts on ``matmul_ws``) against the unsharded
   step, as llama's, its ``matmul_ws`` calls by form those the shared
   experts' GEMMs predict, both steps timed; rwkv6-1.6b at full width
   and depth, a sharded prefill of 4 × 1024 tokens (the wkv core on local
   rows and heads) and 2 decode steps against the unsharded ones within
   phase 6's bf16 bound, the state bit for bit.  (b) 4 ranks spawned on the
   card (gloo where they share it, NCCL with a card each):
   ``compressed_psum`` of a full-width gradient leaf ([3072, 8192] f32)
   bit-equal to the sum of the ranks' own quantized shards, and
   ``pipeline_apply`` over 4 stages of one full-width block each, 8
   microbatches, forward and backward, against the sequential stack.
   The sharded train and decode steps run in (b) only where DTensor's
   all-gather works on the ranks' backend, which a 4-rank probe
   (``tools/collectives_probe.py``) decides first; where it does not
   (gloo with CUDA tensors aborts on it), the log names each check left
   for a machine with one card per rank;
12. the roofline of llama3.2-3b's steps and the dry run: (a) as
   published (28 layers, bf16 compute) a prefill of 4096 tokens
   (``attn_impl="flash"``), a decode step of 4 slots × 4096 positions and
   phase 10(c)'s train step, each on ``xla`` and on ``pallas_ws``, run on
   the card under ``roofline.counts.CostCounter``: each count equal to
   the dry run's fake count of the same one-card cell
   (``launch.dryrun.count_cell``, mesh ``"one"``: one and two layer
   groups extrapolated to 28), FLOPs equal across the backends but for
   the train step's recomputed ``matmul_ws`` GEMMs (remat ``"minimal"``
   saves aten dots only), ``matmul_ws`` launches by form as ``mm_path``
   predicts; per step the TFLOP by dtype, traffic, the three terms
   against ``roofline.analysis.H100``, the bottleneck, the measured ms
   (the prefill and decode timed here, the train step phase 10(c)'s
   median) and bound ÷ measured, which must not pass 1.05; (b) ``python
   -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k
   --mesh single`` in a subprocess (fake CUDA tensors over 256 fake
   ranks): its cell has 256 chips, ``argument_bytes`` equal to the local
   shards of the plan's specs, and a named bottleneck; then the
   ``train_4k`` cells on ``single`` of deepseek-moe-16b, rwkv6-1.6b and
   seamless-m4t-medium, each cell's terms, peak and host seconds printed
   (their subprocesses start in phase 1, niced, and run on the host
   beside the card phases: rwkv6-1.6b's takes 195-231 s); (c) the conv
   programs: the int8 forwards of ``vgg_imagenet``, ``mobilenet_small`` and
   ``unet_small`` at 224, batch 8 (``make_int8_program``), and phase 8's
   QAT step of ``vgg_imagenet``, each counted under ``CostCounter`` on the
   card and again on fake CUDA tensors (equal field for field: the conv
   kernels are the ``torch.library`` ops ``repro_torch::conv2d_ws`` and
   ``repro_torch::conv2d_ws_pipe``, with their own FLOP formula), the
   counted conv and ``matmul_ws`` ops equal to the wrappers' launches (one
   conv op a conv layer in a forward), printed with the launches by path,
   the TFLOP by dtype, traffic, the three terms, the bottleneck, the
   measured ms (median of CUDA events around a call) and bound ÷
   measured, which must not pass 1.05; (d) the host time that the
   ``repro_torch::matmul_ws`` op adds to a call, at the decode step's
   three MLP GEMMs (M = 4 slots), and that ``repro_torch::conv2d_ws`` adds
   at the §5.2 layer (int8, its ``ConvCore`` plan): the public wrapper,
   the op alone and the wrapper as it was before the op (the same checks,
   then the launch called directly), each issuing back-to-back calls in
   interleaved windows, outputs ``torch.equal``; printed as the median of
   the windows' differences a call (for ``matmul_ws`` also times the
   ``pallas_ws`` decode step's calls);
13. the examples (``repro_torch.examples``), each ``main`` called in
   process on the card with its output logged indented, launches read
   around each: ``conv_acceleration`` whole (the §5.2 anchors exact, the
   4-core program and the lone async request exact, the int8 errors at
   or below the levels the reference's example prints, QAT's loss falling
   and its int8 accuracy within 2 points of the float shadow, the §5.2
   int8 layer's median µs a call beside its bound and the card's name and
   power limit, a launch on each of the tc, simt and dw paths and of
   ``matmul_ws``), ``serve_batched`` float and ``--w8`` (every request
   served with ``--max-new`` tokens, tokens/s; ``matmul_ws`` launched
   under w8), ``quickstart`` (60 steps, the loss falling) and
   ``train_llama_tiny --preset 100m --batch 32 --seq 512`` at 30 steps
   with a failure injected at step 25 (one restart, the steps replayed
   from the step-20 checkpoint, the loss falling; ms a step and
   tokens/s); each example's seconds against the phase's 90 s budget;
14. print the per-kernel JSON line and, last, the run's device line.  A
   kernel timed over several shapes reports the sum of their times (each
   of ``ms``, ``plain_ms``, ``device_ms``) and the sum of their per-launch
   bounds; ``matmul_ws``'s ``library_ms`` sums ``torch.matmul`` over its
   four bf16 shapes (the int8 head has no library call), and the convs'
   and ``matmul_ws``'s ``launches`` add phases 7 and 8 to their main
   paths', and phase 9's tuned and routed serving.  The two convs and
   ``matmul_ws`` also carry phase 8's f32 sums (``f32_ms``,
   ``f32_bound_ms``, ``f32_library_ms``: the six forward convs beside
   ``F.conv2d``, the 54 weight-gradient taps beside ``torch.matmul``, each
   bound that of the whole function: x, the cotangent and dw moved once
   for the weight gradient); the convs' rows carry their simt path apart
   (``simt_launches`` on phase 8's training runs, ``simt_max_abs_err``,
   ``f32_plain_ms``, ``f32_bound_by``; on ``conv2d_ws``
   ``f32_dx_ms``, ``f32_dx_bound_ms`` and ``f32_dx_library_ms``: the five
   input-gradient convs beside ``torch.nn.grad.conv2d_input``) and their
   dw path apart (``dw_launches`` over the main paths' serving and
   training runs, ``dw_max_abs_err`` over phase 3's dw checks, and phase
   3's
   ``mobilenet_small`` depthwise sums: ``dw_int8_ms``,
   ``dw_int8_device_ms``, ``dw_int8_plain_ms``, ``dw_int8_bound_ms``, the
   same ``dw_f32_*`` and ``dw_f32_library_ms``, ``F.conv2d(groups=C)``)
   and their nk path apart (``nk_launches`` and, for what is left on the
   first port's kernel, ``scalar_launches`` over the same runs,
   ``nk_max_abs_err`` over phase 3's nk checks, and phase 3's sums:
   ``nk_int8_ms``, ``nk_int8_device_ms``, ``nk_int8_plain_ms``,
   ``nk_int8_bound_ms`` over the two int8 heads, the same ``nk_f32_*``
   over ``unet_small``'s f32 head and ``groups2``, and
   ``nk_f32_library_ms``, ``F.conv2d``) and ``scalar_max_abs_err`` over
   phase 3's direct launches of the scalar kernel;
   ``matmul_ws``'s ``int8_ms``, ``int8_device_ms``, ``int8_bound_ms`` and
   ``int8_library_ms`` sum its twelve long-M int8 shapes of phase 3 (the
   library ``torch._int_mm``, each shape's faster of its two weight
   layouts),
   and its and ``flash_attention``'s ``launches`` count every served
   run of phases 6, 6b, 6c and 6d (``serve_held``) and phase 6d's
   direct prefills and decode steps, and the
   ``conv2d_ws`` row carries phase 3's ``conv1d_depthwise`` apart
   (``conv1d_ms``, ``conv1d_device_ms``, ``conv1d_bound_ms``,
   ``conv1d_plain_ms``: ``conv1d_depthwise_ref``, ``conv1d_library_ms``:
   ``F.conv1d``); the ``matmul_ws`` row carries phase 10's f32 backward
   GEMMs at llama3.2-3b's MLP shapes apart (``lm_bwd_ms``,
   ``lm_bwd_bound_ms``, ``lm_bwd_library_ms``: ``torch.matmul``, TF32
   off), its
   ``form_launches`` count its launches by form over the runs whose
   counts were read by form (phases 6–6d's served runs, 8's fits, 10, 11(a)
   and 12),
   and its ``launches`` add phase 10's training steps and phase 11(a)'s
   sharded and unsharded steps and decode steps (llama3.2-3b's and
   deepseek-moe-16b's); ``matmul_ws``'s and
   ``flash_attention``'s add phase 12's counted and timed steps, and the
   convs' and ``matmul_ws``'s phase 12(c)'s counted and timed runs; every
   row's launches (and the convs' ``simt_launches``, ``dw_launches``,
   ``nk_launches`` and ``scalar_launches``, ``matmul_ws``'s
   ``form_launches``) add phase
   13's examples.

It needs a CUDA device and the repository's ``src`` and ``tests`` beside
it.
"""

import collections
import contextlib
import ctypes
import dataclasses
import gc
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# cuBLAS reads this when CUDA starts; phase 10 turns deterministic
# algorithms on, which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# the caching allocator grows its segments in place: phases 10(c) and 12
# run llama3.2-3b's train step at 73 GB of 80 after steps and checks of
# other shapes, and with fixed-size segments such a step has run out of
# memory with 12 GB reserved but split among them (PERF.md §6)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))     # the card tests' conv cases

BATCH = 8
REQUESTS = 16
F32_TOL = 1e-4
LM_ARCH = "llama3p2_3b"
LM_PROMPTS = (64, 512, 777, 1024, 1536, 2048, 2500, 3000)
LM_NEW_TOKENS = 16
LM_SLOTS, LM_MAX_SEQ = 4, 4096
FLASH_SEQS = (512, 777, 2048, 3000)   # bf16 [1, S, 24, 128] checks
FLASH_ROW_SEQ = 2048                  # the S of the JSON row's numbers
FLASH_SMALL_DIMS = (16, 32, 64)       # bf16 head dims besides 128
MARK_CYCLES = 1000                    # device_ms's marker between calls
PROFILED_STEPS = 3                    # phase 8's profiled QAT steps a window
# head dims the kernels take padded, at D = 256 or on f32 copies:
# (B, S, H, D, dtype, variant); the bf16 ones at S = 2048 with H·D = 3072,
# llama3.2-3b's attention width, so their work is comparable to its
FLASH_REPAIRED = ((1, 2048, 384, 8, "bfloat16", "wgmma_padded"),
                  (1, 2048, 32, 96, "bfloat16", "wgmma_padded"),
                  (1, 2048, 12, 256, "bfloat16", "wgmma"),
                  (1, 300, 2, 320, "bfloat16", "scalar_f32_copies"),
                  (2, 300, 4, 6, "float32", "scalar_padded"),
                  (2, 300, 4, 160, "float32", "scalar"),
                  (1, 16, 65600, 4, "float32", "scalar"))   # B·H > 65535
# matmul_ws: the shapes timed (the vgg_imagenet head; llama3.2-3b's MLP
# GEMMs in a 3000-token prefill and in a 4-slot decode step); its edge
# shapes are the card tests' MM_CASES
MM_TIMED = (("vgg_imagenet head", 8, 256, 1000, "int8"),
            ("prefill wi", 3000, 3072, 8192, "bfloat16"),
            ("prefill wo", 3000, 8192, 3072, "bfloat16"),
            ("decode wi", 4, 3072, 8192, "bfloat16"),
            ("decode wo", 4, 8192, 3072, "bfloat16"))
# w8a8 serving's int8 GEMMs (K, N) in llama3.2-3b, yi-34b and gemma-7b: the
# attention's q / k / v and output projections, the MLP's up and down
# projections; each at a prefill M (the mma form: the longest prompt
# each model is served with in phase 6b) and at the 4-slot decode M (the
# stream form).  The long-M ones make the JSON row's int8_* sums
W8_MM = (("llama3.2-3b", 3000, ((3072, 3072), (3072, 1024), (3072, 8192),
                                (8192, 3072))),
         ("yi-34b", 1024, ((7168, 7168), (7168, 1024), (7168, 20480),
                           (20480, 7168))),
         ("gemma-7b", 2048, ((3072, 4096), (4096, 3072), (3072, 24576),
                             (24576, 3072))))
# the int8 cache's decode contractions: (model, B, S, KV, G, D)
W8_DECODE = (("llama3.2-3b", 4, 4096, 8, 3, 128),
             ("yi-34b", 4, 4096, 8, 7, 128),
             ("gemma-7b", 4, 4096, 16, 1, 256))
W8_KV_SCALE = 0.25                    # the launcher's int8 cache scale
GEMMA_ARCH, YI_ARCH = "gemma_7b", "yi_34b"
# phase 6c: the hybrid and attention-free families, as published; prompts
# are multiples of 512, so chunked_attention keeps 512-position chunks and
# wkv6_chunked 32-token ones (a length such as 3000 would halve the
# attention's chunk to 8 positions, 10^5-10^6 host iterations a layer)
RG_ARCH, RWKV_ARCH = "recurrentgemma_9b", "rwkv6_1p6b"
HYBRID_PROMPTS = (64, 512, 2048, 2560, 4096)
HYBRID_MAX_SEQ = 4112                 # the longest prompt + 16 new tokens
RG_CONV_SEQ = 4096                    # phase 3's conv1d_depthwise: [1, S, W]
RG_CHECK_PROMPT, RG_CHECK_STEPS = 2560, 3   # the 5-layer f32 ring check
RG_CHECK_TOL = 2e-3                   # tests/test_models_decode.py's own
RWKV_CHECK_SEQ = 2048                 # wkv6 chunked against recurrent
RWKV_SHARD_SEQ = 1024                 # phase 11(a)'s sharded rwkv6 prefill
# phase 6d: the MoE, VLM and encoder-decoder families, as published
DS_ARCH, QWEN_ARCH = "deepseek_moe_16b", "qwen3_moe_30b_a3b"
VLM_ARCH, ENCDEC_ARCH = "internvl2_26b", "seamless_m4t_medium"
VLM_TOKENS = 3072                     # after the 1024 patches: 4096 positions
ENCDEC_SEQ = 2048                     # frames and tokens of one length
LM_DIRECT_STEPS = 8                   # decode steps after a direct prefill
# phase 11(a)'s sharded MoE train step: deepseek-moe-16b at full width
# with 2 layers (two f32 train states with AdamW moments, ~37 GB)
DS_TRAIN_LAYERS, DS_TRAIN_SEQ = 2, 2048
# phase 12(b)'s dry-run cells beside llama3.2-3b's decode cell: the
# train_4k cells on single that the sharded MoE backward, rwkv6 on local
# shards and seamless's frontend projection on local shards made run.
# They take host time only (rwkv6-1.6b's 195-231 s), so their
# subprocesses start in phase 1 and are collected in phase 12
REPAIRED_TRAIN_CELLS = ("deepseek_moe_16b", "rwkv6_1p6b",
                        "seamless_m4t_medium")
TRAIN_CELLS_DIR = ROOT / "build" / "dryrun_torch_train"
CHILDREN = []           # the subprocesses started early, stopped at exit
# phase 3's flash_attention at the new families' shapes: (B, S, H, D,
# causal); seamless-m4t-medium's full (encoder, cross) and causal
# attention, 16 heads of 64, and full attention at D = 128
LM_FLASH = ((1, ENCDEC_SEQ, 16, 64, False), (1, ENCDEC_SEQ, 16, 64, True),
            (1, ENCDEC_SEQ, 16, 128, False))
# phase 10's full-depth training: the chunked attention's chunk.  At the
# config's 512 a 4096-token causal layer runs 36 chunk pairs, and a step
# issued 223k device ops at 22% busy (14.8 s a step on xla, on an H100
# 80GB HBM3 at 700 W); at 2048 it runs 3 pairs of [24, 2048, 2048] f32
# scores (the same function, summed in fewer online-softmax rescalings).
# The config's own chunk, which the launcher and ``Trainer`` take, is
# timed for one step beside it.  Since the layer takes its chunk pairs
# one key chunk at a time (all query chunks that see it batched), a
# causal 4096-token layer runs 8 key-chunk iterations at 512, not 36
# pairs
TRAIN_ATTN_CHUNK = 2048
GEMMA_W8_PROMPTS = (64, 512, 1024, 2048)
YI_PROMPTS = (64, 512, 1024)
# phase 13: the examples.  The int8 datapath's relative errors that the
# reference's examples/conv_acceleration.py prints on the same numpy
# inputs (the port's may not exceed them at that precision); the 100m
# preset's steps (cut from the reference's 300) and its injected failure
EXAMPLE_INT8_ERR = {"paper": 0.0125, "lenet": 0.0262, "resnet": 0.0217,
                    "mobilenet": 0.0481}
EXAMPLE_TRAIN_STEPS = 30
EXAMPLE_TRAIN_FAIL = 25
EXAMPLES_BUDGET_S = 90
KERNELS = {
    "conv2d_ws": ("src/repro_torch/kernels/csrc/conv2d_ws.cu",
                  "src/repro/kernels/conv2d_ws.py:255"),
    "conv2d_ws_pipe": ("src/repro_torch/kernels/csrc/conv2d_ws_pipe.cu",
                       "src/repro/kernels/conv2d_ws_pipe.py:193"),
    "matmul_ws": ("src/repro_torch/kernels/csrc/matmul_ws.cu",
                  "src/repro/kernels/matmul_ws.py:47"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
}
# matmul_ws's device kernels by name: one of the first five a launch, and
# the reduce kernel after it where the stream or simt form splits K
MM_KERNEL_NAMES = ("matmul_ws_kernel", "mm_stream_kernel", "mm_wgmma_kernel",
                   "mm_simt_kernel", "mm_imma_kernel", "mm_split_reduce")


# the conv kernels' device kernels by name: the scalar, simt, dw and nk
# kernels of both sources (the tensor-core ones are "conv_ws_tc_kernel" and
# "conv_ws_pipe_tc_kernel"), and the simt path's split-K reduce
CONV_F32_KERNEL_NAMES = ("conv_ws_kernel", "conv_ws_pipe_kernel",
                         "conv_ws_simt_kernel", "conv_ws_pipe_simt_kernel",
                         "conv_ws_dw_kernel", "conv_ws_pipe_dw_kernel",
                         "conv_ws_nk_kernel", "conv_ws_pipe_nk_kernel",
                         "conv_simt_reduce_kernel")
# the paths an int8 conv program's launches may take (no simt launch is
# served)
SERVED_PATHS = ("tc", "dw", "nk", "scalar")


def is_mm_kernel(name):
    return any(t in name for t in MM_KERNEL_NAMES)


def is_conv_kernel(name):
    return any(t in name for t in CONV_F32_KERNEL_NAMES)


def log(*parts):
    print(*parts, flush=True)


def start_train_cells():
    """Start ``launch.dryrun``'s ``train_4k`` cell on ``single`` of each
    of ``REPAIRED_TRAIN_CELLS``, a subprocess each, niced so that the card
    phases' host work comes first; each writes its output to a log beside
    its cell → {arch: Popen}."""
    shutil.rmtree(TRAIN_CELLS_DIR, ignore_errors=True)
    TRAIN_CELLS_DIR.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    for arch in REPAIRED_TRAIN_CELLS:
        with open(TRAIN_CELLS_DIR / f"{arch}.log", "w") as out:
            procs[arch] = subprocess.Popen(
                nice + [sys.executable, "-m",
                 "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 "train_4k", "--mesh", "single", "--out",
                 str(TRAIN_CELLS_DIR)],
                env=env, stdout=out, stderr=subprocess.STDOUT)
        CHILDREN.append(procs[arch])
    return procs


# mangled template arguments; in these sources the only argument that
# mangles as a back-reference (S_, S2_, ...) is __nv_bfloat16
_TEMPLATE_ARGS = {"a": "int8", "i": "int32", "f": "float",
                  "13__nv_bfloat16": "bf16"}
_ARG = r"[aif]|13__nv_bfloat16|S\d*_|L[ib]\d+E"


def kernel_name(mangled):
    """``conv_ws_tc_kernel<4, true>`` from its mangled name: the
    length-prefixed identifier that ends in "kernel", and its template
    arguments (types, ints, bools)."""
    for num in re.finditer(r"(?=(\d+))", mangled):   # every digit suffix
        end = num.start() + len(num.group(1))
        name = mangled[end:end + int(num.group(1))]
        if name.endswith("kernel") and name.isidentifier():
            rest = mangled[end + len(name):]
            args = re.match(rf"I((?:{_ARG})+)E", rest)
            if not args:
                return name
            out = []
            for tok in re.findall(_ARG, args.group(1)):
                if tok in _TEMPLATE_ARGS:
                    out.append(_TEMPLATE_ARGS[tok])
                elif tok.startswith("S"):
                    out.append("bf16")
                elif tok.startswith("Lb"):
                    out.append("true" if tok[2:-1] == "1" else "false")
                else:
                    out.append(tok[2:-1])
            return f"{name}<{', '.join(out)}>"
    return mangled


def sass_tensor_ops(lib_path):
    """{kernel name: count of IMMA / HMMA / HGMMA-family instructions} in
    a library's SASS (``cuobjdump``, which comes with ``nvcc``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise FileNotFoundError("cuobjdump is not installed beside nvcc: "
                                "the tensor-core SASS cannot be read")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = kernel_name(found.group(1))
            counts[name] = 0
        elif name and re.search(r"\b(IMMA|HMMA|[HIQ]GMMA)\b", line):
            counts[name] += 1
    return counts


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs.base import (get_config, param_count,
                                          reduce_config)
    from repro_torch.core import network, perfmodel
    from repro_torch.core.perfmodel import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                            HBM_BYTES_PER_S, INT8_OPS_PER_S)
    from repro_torch.core.convcore import (ConvCore, ConvCoreConfig,
                                           get_backend, paper_workload,
                                           register_backend,
                                           unregister_backend)
    from repro_torch.core.scheduler import MultiCoreScheduler, SchedulerConfig
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.conv2d_ws import (CONV_PATHS, conv2d_ws,
                                               conv2d_ws_plain, conv_path,
                                               launch_conv, reset_launches,
                                               scalar_tiles, setup_conv)
    from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
    from repro_torch.kernels.conv2d_ws_trans import transpose_eq_conv_geometry
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     kernel_variant)
    from repro_torch.kernels.matmul_ws import (PATHS, matmul_ws,
                                               matmul_ws_plain, mm_path)
    from repro_torch.kernels.matmul_ws import simt_plan
    from repro_torch.core.quantize import (quantize_weight_specs,
                                           quantize_weights)
    from repro_torch.layers.attention import _int8_contract as int8_contract
    from repro_torch.layers import attention as attn_lib
    from repro_torch.layers import moe as moe_lib
    from repro_torch.layers import rglru as rglru_lib
    from repro_torch.layers import rwkv as rwkv_lib
    from repro_torch.layers.common import (materialize, stack_specs,
                                           torch_dtype, tree_map)
    from repro_torch.layers.rglru import causal_conv1d
    from repro_torch.models import lm
    from repro_torch.models import blocks as blocks_lib
    from repro_torch.models.blocks import block_specs
    from repro_torch.serving.batching import (ContinuousBatchingEngine,
                                              FormedBatch, ServeRequest)
    from repro_torch.serving.engine import (ConvNetEngine, Request,
                                            ServingEngine)
    from repro_torch import obs
    from repro_torch.core import autotune, calibration_sweep, training
    from repro_torch.core.calibration import (CalibrationTable,
                                              fit_calibration)
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.conv2d_ws import simt_plan as simt_plan_conv
    from repro_torch.kernels.conv2d_ws_bwd import (conv2d_ws_input_grad,
                                                   conv2d_ws_weight_grad)
    from test_torch_cuda import (CASES, DW_CASES, F32_CASES, MM_CASES,
                                 NK_CASES, TC_CASES, check_nk, one_more,
                                 bf16_gemm_bound, GRAD_REL_L2, LM_MLP_CASES,
                                 RG_MLP_CASES, bf16_ulp, case_inputs,
                                 check_dw, check_simt, check_conv_vjp,
                                 check_matmul_vjp, f32_case, legal_banks,
                                 mm_case_inputs, path_counts,
                                 tc_case_inputs, vgg_f32_layer)
    sys.path.insert(0, str(ROOT / "tools"))
    from conv_dw_probe import (conv1d_library, conv2d_library, layer_bytes,
                               mobilenet_layers)
    from conv_nk_probe import nk_layers

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    wrappers = {"conv2d_ws": conv2d_ws, "conv2d_ws_pipe": conv2d_ws_pipe,
                "matmul_ws": matmul_ws, "flash_attention": flash_attention}
    # "bound" sums the per-launch bounds of the shapes a row is timed
    # over, each credited to the side (bytes or operations) that limits it
    stats = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, device_ms=0.0,
                     launches=0,
                     bound={"bytes": 0.0, "operations": 0.0},
                     library_ms=None, ops_per_s=INT8_OPS_PER_S)
             for k in KERNELS}
    stats["flash_attention"]["ops_per_s"] = BF16_OPS_PER_S
    stats["matmul_ws"]["forms"] = dict.fromkeys(PATHS, 0)
    # each conv kernel's f32 simt path, keys of its row: its launches on
    # the training main paths (phase 8), its max error against the plain
    # version, and phase 8's forward (and, for conv2d_ws, dx) sums
    for k in ("conv2d_ws", "conv2d_ws_pipe"):
        stats[k]["simt"] = dict(launches=0, max_abs_err=0.0,
                                bound_by={"bytes": 0.0, "operations": 0.0})
    # and its dw and nk paths: launches on the main paths' runs (the nk
    # row also those left on the scalar kernel), max error against the
    # plain version, phase 3's sums; and the scalar kernel's max error in
    # phase 3's direct launches
    for k in ("conv2d_ws", "conv2d_ws_pipe"):
        stats[k]["dw"] = dict(dw_launches=0, max_abs_err=0.0)
        stats[k]["nk"] = dict(nk_launches=0, scalar_launches=0,
                              max_abs_err=0.0)
        stats[k]["scalar"] = dict(max_abs_err=0.0)

    def mem_note(where):
        """Log the caching allocator's state: bytes live, bytes reserved,
        and of the reserved the free blocks split off segments that also
        hold live ones (what a request larger than each cannot use)."""
        ms_ = torch.cuda.memory_stats()
        log(f"  memory at {where}: allocated "
            f"{ms_['allocated_bytes.all.current'] / 1e9:.2f} GB, reserved "
            f"{ms_['reserved_bytes.all.current'] / 1e9:.2f} GB, of it free "
            f"but split {ms_['inactive_split_bytes.all.current'] / 1e9:.2f} "
            f"GB (allocator {os.environ.get('PYTORCH_CUDA_ALLOC_CONF')})")

    def credit_forms():
        """Add ``matmul_ws.path_launches`` (the counts since the last
        reset, read where a run's launches are credited) to the row's
        launches by form."""
        for p_, v in matmul_ws.path_launches.items():
            stats["matmul_ws"]["forms"][p_] += v

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    train_cells = start_train_cells()
    t_cells = time.perf_counter()
    log(f"  phase 12(b)'s train_4k cells ({', '.join(train_cells)}) "
        f"started on the host, one niced subprocess each")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    spilled = []
    for name in _build.SOURCES:
        entry, report = "", _build.build_log(name)
        if "Used" not in report:
            raise AssertionError(f"{name}: no -Xptxas -v report beside its "
                                 f"library")
        for line in report.splitlines():
            found = re.search(r"entry function '([^']*)'", line)
            if found:
                entry = kernel_name(found.group(1))
            elif "Used" in line or "Performance Loss" in line or re.search(
                    r"[1-9]\d* bytes spill", line) or (
                    "spill" in line and ("wgmma_kernel" in entry
                                         or "flash_bf16_kernel" in entry)):
                log(f"  {name} {entry}: {line.strip()}")
                if re.search(r"[1-9]\d* bytes spill", line) and (
                        "tc_kernel" in entry or "simt_kernel" in entry
                        or "dw_kernel" in entry or "nk_kernel" in entry
                        or "wgmma_kernel" in entry
                        or "imma_kernel" in entry
                        or "flash_bf16_kernel" in entry):
                    spilled.append(entry)
    if spilled:
        raise AssertionError(f"tensor-core, simt, dw or nk kernels spill: "
                             f"{spilled}")
    for name in ("conv2d_ws", "conv2d_ws_pipe"):
        ops = sass_tensor_ops(_build.library_path(name))
        tc = {k: v for k, v in sorted(ops.items()) if "tc_kernel" in k}
        log(f"  {name} SASS, tensor-core instructions per instantiation: "
            + ", ".join(f"{k} {v}" for k, v in tc.items()))
        if len(tc) != 4 or not all(tc.values()):
            raise AssertionError(f"{name}: an int8 tensor-core instantiation "
                                 f"holds no IMMA: {tc}")
        simt = {k: v for k, v in sorted(ops.items()) if "simt_kernel" in k}
        log(f"  {name} SASS, tensor-core instructions per f32 simt "
            f"instantiation (FFMA only: none): "
            + ", ".join(f"{k} {v}" for k, v in simt.items()))
        if len(simt) != 6 or any(simt.values()):
            raise AssertionError(f"{name}: the f32 simt instantiations are "
                                 f"not six FFMA-only kernels: {simt}")
    ops = sass_tensor_ops(_build.library_path("matmul_ws"))
    hg = {k: v for k, v in sorted(ops.items()) if "wgmma_kernel" in k}
    log("  matmul_ws SASS, HGMMA instructions per bf16 long-M "
        "instantiation: " + ", ".join(f"{k} {v}" for k, v in hg.items()))
    if len(hg) != 2 or not all(hg.values()):
        raise AssertionError(f"matmul_ws: a bf16 long-M instantiation holds "
                             f"no HGMMA: {hg}")
    im = {k: v for k, v in sorted(ops.items()) if "imma_kernel" in k}
    log("  matmul_ws SASS, IMMA instructions per int8 mma-form "
        "instantiation: " + ", ".join(f"{k} {v}" for k, v in im.items()))
    if len(im) != 2 or not all(im.values()):
        raise AssertionError(f"matmul_ws: an int8 mma-form instantiation "
                             f"holds no IMMA: {im}")

    def elapsed_ms(fn, reps, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound_ms(nbytes, ops, ops_per_s=INT8_OPS_PER_S):
        return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)

    def add_bound(name, nbytes, ops, ops_per_s=None):
        """Add one timed launch shape's bound to ``name``'s row → (bound
        ms, the side that limits it)."""
        ops_per_s = ops_per_s or stats[name]["ops_per_s"]
        side = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / ops_per_s
                else "operations")
        ms = bound_ms(nbytes, ops, ops_per_s)
        stats[name]["bound"][side] += ms
        return ms, side

    def device_ms(fn, reps, windows=6):
        """Device time of one call of ``fn``: the durations of the device
        events (kernels, copies, fills) of one call under torch.profiler,
        averaged over ``reps`` calls after a warm-up.  A ``spin_kernel``
        (``torch.cuda._sleep``) is launched before each call and after the
        last, and splits the device timeline into calls.  torch.profiler
        now and then loses a device event (one in 3, 10 or 20 calls; once
        in every window of a run), so a call whose event count is not the
        most common one is left out of the mean, and said so.  A window in
        which fewer than half the calls are whole (some windows hold no
        device event at all) is profiled again, up to ``windows`` times;
        if every window is short, it raises."""
        fn()
        torch.cuda.synchronize()
        act = torch.profiler.ProfilerActivity
        cuda = torch.autograd.DeviceType.CUDA
        for window in range(windows):
            with torch.profiler.profile(
                    activities=[act.CPU, act.CUDA]) as prof:
                fn()                 # the window's first call is not timed
                for _ in range(reps):
                    torch.cuda._sleep(MARK_CYCLES)
                    fn()
                torch.cuda._sleep(MARK_CYCLES)
                torch.cuda.synchronize()
            evs = sorted((k for k in prof.profiler.kineto_results.events()
                          if k.device_type() == cuda),
                         key=lambda k: k.start_ns())
            calls, call = [], None
            for k in evs:
                if "spin_kernel" in k.name():
                    if call is not None:
                        calls.append(call)
                    call = []
                elif call is not None:
                    call.append(k.end_ns() - k.start_ns())
            sizes = collections.Counter(map(len, calls)).most_common()
            size = max(n for n, c in sizes if c == sizes[0][1]) \
                if sizes else 0
            whole = [sum(c) for c in calls if size and len(c) == size]
            if 2 * len(whole) >= reps:
                break
            names = "" if calls else \
                f"; no marker among {sorted({k.name() for k in evs})[:4]}"
            log(f"  torch.profiler window {window + 1} of {windows}: "
                f"{len(whole)} of {reps} calls whole ({len(evs)} device "
                f"events, {len(calls)} calls between markers){names}")
        if 2 * len(whole) < reps:
            raise AssertionError(f"torch.profiler: {len(whole)} of {reps} "
                                 f"calls whole in each of {windows} windows")
        if len(whole) < reps:
            log(f"  torch.profiler lost device events of "
                f"{reps - len(whole)} of {reps} calls; the time is the "
                f"mean of the other {len(whole)}")
        return sum(whole) / len(whole) / 1e6

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def rand_bias(k):
        return torch.randint(-4000, 4000, (k,), generator=gen, device=dev,
                             dtype=torch.int32)

    def compare(name, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
        if want.is_floating_point():
            ok = torch.allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max abs err {err})")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        return err

    # -- 3. kernels against their plain versions ---------------------------
    conv_rows = []

    def check_conv(label, x, w, b, scale, kw, timed=False):
        """Both conv kernels against ``conv2d_ws_plain``, each launch on the
        path ``conv_path`` rules; ``scale`` is "scalar" / "per_k" (derived
        from the plain accumulator so the int8 outputs span the grid), a
        given scale, or None (int32 / f32 out).  An f32 result on the simt
        path is also held within ``f32_sum_bound`` of
        ``conv2d_ws_simt_emulate``, and the two kernels' results and a
        second call to each other bit for bit (``check_simt``); a result
        on the dw path to ``conv2d_ws_dw_emulate`` (int8 equal, f32 within
        ``f32_sum_bound``), and the two kernels, a second call and a tiled
        call to each other (``check_dw``); a result on the nk path to
        ``conv2d_ws_nk_emulate`` and all of those bit for bit
        (``check_nk``)."""
        if isinstance(scale, str):
            acc = conv2d_ws_plain(x, w, b, None, **kw).double().abs()
            if scale == "per_k":
                amax = acc.reshape(-1, acc.shape[-1]).amax(0).clamp(min=1)
                scale = (100.0 / amax).float()
            else:
                scale = 100.0 / max(float(acc.max()), 1.0)
        want = conv2d_ws_plain(x, w, b, scale, **kw)
        geo = {k: v for k, v in kw.items() if k not in ("relu", "pool")}
        path = conv_path(setup_conv(
            tuple(x.shape), tuple(w.shape), pool=kw.get("pool", False),
            requant=scale is not None, int_path=x.dtype == torch.int8,
            **geo))
        torch.cuda.synchronize()
        row, outs = {}, []
        for name in ("conv2d_ws", "conv2d_ws_pipe"):
            fn = wrappers[name]
            before = path_counts(fn)
            got = fn(x, w, b, scale, **kw)
            torch.cuda.synchronize()
            if path_counts(fn) != one_more(before, path):
                raise AssertionError(f"{label}: {name} did not launch once "
                                     f"on the {path} path")
            err = compare(name, got, want)
            if path in ("simt", "dw", "nk"):
                sub = stats[name][path]
                sub["max_abs_err"] = max(sub["max_abs_err"], err)
            outs.append(got)
            if timed:
                call = lambda: fn(x, w, b, scale, **kw)   # noqa: E731
                row[name] = (elapsed_ms(call, reps=10), device_ms(call, 20))
                stats[name]["ms"] += row[name][0]
                stats[name]["device_ms"] += row[name][1]
        if path == "simt":      # the emulation's bound, both kernels' bits
            check_simt([x, w, b, scale], kw, outs)
        if path == "dw":        # the emulation, both kernels' and tiles' bits
            check_dw([x, w, b, scale], kw, outs)
        if path == "nk":        # the same, bit for bit in f32 too
            check_nk([x, w, b, scale], kw, outs)
        if timed:
            n, h, wd, c = x.shape
            kh, kwd, cg, k = w.shape
            oh, ow = ref.conv_out_shape(h, wd, kh, kwd, kw.get("stride", 1),
                                        kw.get("padding", "VALID"),
                                        kw.get("dilation", 1))
            nbytes = (x.numel() * x.element_size() + w.numel()
                      * w.element_size() + 8 * k
                      + want.numel() * want.element_size())
            ops = 2 * n * oh * ow * k * kh * kwd * cg
            plain = elapsed_ms(lambda: conv2d_ws_plain(x, w, b, scale, **kw),
                               reps=3, warmup=1)
            for name in ("conv2d_ws", "conv2d_ws_pipe"):
                stats[name]["plain_ms"] += plain
                bound, side = add_bound(name, nbytes, ops)
            # cuDNN's fp16 channels-last conv at the same shape: a different
            # function (no int8, no fused epilogue), timed for scale only
            xh = x.permute(0, 3, 1, 2).half().contiguous(
                memory_format=torch.channels_last)
            wh = w.permute(3, 2, 0, 1).half().contiguous(
                memory_format=torch.channels_last)
            pad = ref.normalize_padding(kw.get("padding", "VALID"), kh, kwd,
                                        kw.get("stride", 1), h, wd,
                                        kw.get("dilation", 1))
            xh = F.pad(xh, (pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
            cudnn = elapsed_ms(lambda: F.conv2d(
                xh, wh, stride=kw.get("stride", 1),
                dilation=kw.get("dilation", 1)), reps=20)
            conv_rows.append((label, ops, nbytes, row, plain, bound, side,
                              cudnn))
        log(f"  {label}: x{tuple(x.shape)} w{tuple(w.shape)} {kw} "
            f"equal, {path} path")

    def mm_operands(m, k, n, dtype, bias=True):
        if dtype == torch.int8:
            x, w, b = rand_i8(m, k), rand_i8(k, n), rand_bias(n)
        else:
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            w = (torch.randn(k, n, generator=gen, device=dev)
                 / k ** 0.5).to(dtype)
            b = torch.randn(n, generator=gen, device=dev)
        return x, w, b if bias else None

    def check_mm(x, w, b):
        """One ``matmul_ws`` launch on the form ``mm_path`` names, against
        ``matmul_ws_plain`` → (form, max abs err, the kernel's output)."""
        (m, k), n = x.shape, w.shape[1]
        path = mm_path(m, k, n, x.dtype)
        before = (matmul_ws.launches, matmul_ws.path_launches[path])
        got = matmul_ws(x, w, b)
        torch.cuda.synchronize()
        if (matmul_ws.launches, matmul_ws.path_launches[path]) != (
                before[0] + 1, before[1] + 1):
            raise AssertionError(f"matmul_ws [{m},{k}]@[{k},{n}] {x.dtype}: "
                                 f"not one launch on the {path} form")
        want = matmul_ws_plain(x, w, b)
        if x.dtype != torch.bfloat16:
            return path, compare("matmul_ws", got, want), got
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"matmul_ws: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err_t = (got.float() - want.float()).abs()
        err = float(err_t.max())
        if not bool((err_t <= bf16_gemm_bound(x, w, b, got, want)).all()):
            raise AssertionError(f"matmul_ws [{m},{k}]@[{k},{n}] bf16 ({path}) "
                                 f"disagrees with its plain version beyond "
                                 f"the bound (max abs err {err})")
        st = stats["matmul_ws"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        return path, err, got

    def check_matmuls():
        """Every form at its edge shapes, then the timed main-path shapes
        and the wrapper's host cost → {timed label: device ms}."""
        forms = dict.fromkeys(PATHS, 0)
        dev_times = {}
        line = []
        for m, k, n, dname, bias in MM_CASES:
            path, err, _ = check_mm(*(None if t is None else t.to(dev)
                                      for t in mm_case_inputs(m, k, n, dname,
                                                              bias)))
            # the LM MLP shapes run stream at a decode step, wgmma at a
            # prefill
            served = "stream" if m <= 16 else "wgmma"
            if (m, k, n, dname, bias) in RG_MLP_CASES + LM_MLP_CASES and (
                    path != served):
                raise AssertionError(f"matmul_ws [{m},{k}]@[{k},{n}]: {path} "
                                     f"form, the served model runs "
                                     f"{served}")
            forms[path] += 1
            line.append(f"[{m},{k}]@[{k},{n}] {dname} {path} {err:.3g}")
        log(f"  matmul_ws edges (shape dtype form max-abs-err; int8 equal, "
            f"f32 within {F32_TOL}, bf16 within bf16_gemm_bound): "
            + "; ".join(line))
        if not all(forms.values()):
            raise AssertionError(f"matmul_ws: a form was never checked: "
                                 f"{forms}")
        st = stats["matmul_ws"]
        st["library_ms"] = 0.0
        for label, m, k, n, dname in MM_TIMED:
            dt = getattr(torch, dname)
            # short M reads the weights once a call, like a decode step
            # over 28 layers: rotate four copies so that the 50 MB L2
            # cannot hold them from one call to the next
            copies = 4 if m <= 16 else 1
            x, w, b = mm_operands(m, k, n, dt, bias=dt == torch.int8)
            ws = [w] + [mm_operands(m, k, n, dt)[1] for _ in range(copies - 1)]
            path, _, _ = check_mm(x, w, b)
            turn = itertools.count()
            call = lambda: matmul_ws(x, ws[next(turn) % copies], b)  # noqa
            ms = elapsed_ms(call, reps=20)
            dev_ms = device_ms(call, 20)
            plain = elapsed_ms(lambda: matmul_ws_plain(x, w, b), reps=3,
                               warmup=1)
            lib = lib_dev = None
            if dt == torch.bfloat16:
                lib_call = lambda: torch.matmul(  # noqa: E731
                    x, ws[next(turn) % copies])
                lib = elapsed_ms(lib_call, reps=20)
                lib_dev = device_ms(lib_call, 20)
                st["library_ms"] += lib
            out_es = 4 if dt == torch.int8 else 2
            nbytes = ((m * k + k * n) * x.element_size() + 4 * n
                      + out_es * m * n)
            ops = 2 * m * k * n
            bound, side = add_bound("matmul_ws", nbytes, ops,
                                    INT8_OPS_PER_S if dt == torch.int8
                                    else BF16_OPS_PER_S)
            st["ms"] += ms
            st["device_ms"] += dev_ms
            st["plain_ms"] += plain
            dev_times[label] = dev_ms
            lib_txt = ("none (no PyTorch call computes an int8 GEMM at "
                       "M = 8)" if lib is None else
                       f"{lib:.4f} ms ({lib_dev:.4f} ms on the device)")
            log(f"  matmul_ws {label} [{m},{k}]@[{k},{n}] {dname}, {path} "
                f"form: {ms:.4f} ms a call, {dev_ms:.4f} ms on the device "
                f"({ops / dev_ms / 1e9:.1f} TFLOP/s, "
                f"{nbytes / dev_ms / 1e6:.0f} GB/s), bound {bound:.5f} ms "
                f"({side}), plain {plain:.3f} ms, torch.matmul {lib_txt}")

        def host_us(fn, reps):
            """Host time of one call of ``fn``, over ``reps`` calls
            enqueued without a synchronize."""
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            return 1e6 * (t1 - t0) / reps

        x, w, _ = mm_operands(4, 3072, 8192, torch.bfloat16, bias=False)
        call_us = host_us(lambda: matmul_ws(x, w), 200)
        entry = _build.load("matmul_ws").matmul_ws_stream

        def sign():                 # the first port's wrapper, every call
            entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            entry.restype = ctypes.c_int

        sign_us = host_us(sign, 2000)
        zeros_us = host_us(lambda: torch.zeros((8192,), dtype=torch.float32,
                                               device=dev), 200)
        log(f"  matmul_ws host cost: {call_us:.1f} us a call at "
            f"[4,3072]@[3072,8192] bf16 without bias (host clock over 200 "
            f"enqueued calls); the first port's wrapper also set the C "
            f"signature ({sign_us:.2f} us) and made a zero bias "
            f"({zeros_us:.1f} us and a fill kernel) on every call: "
            f"{sign_us + zeros_us:.1f} us a call, "
            f"{84 * (sign_us + zeros_us) / 1e3:.2f} ms of host time per "
            f"84-launch decode step")
        return dev_times

    def check_w8_matmuls():
        """``matmul_ws`` int8 at w8 serving's GEMM shapes, each equal to
        its plain version on the form ``mm_path`` names; the long-M ones
        (the mma form) timed beside ``torch._int_mm`` and their bound at
        the int8 tensor-core peak, into the JSON row's int8_* sums."""
        st = stats["matmul_ws"]
        st["int8"] = dict.fromkeys(("int8_ms", "int8_device_ms",
                                    "int8_bound_ms", "int8_library_ms"),
                                   0.0)
        st["int8_library_layouts"] = dict.fromkeys(("row-major",
                                                    "column-major"), 0)
        for model, m_long, shapes in W8_MM:
            for k, n in shapes:
                for m in (m_long, LM_SLOTS):
                    x, w, _ = mm_operands(m, k, n, torch.int8, bias=False)
                    path, _, _ = check_mm(x, w, None)
                    want = "mma" if m > 16 else "stream"
                    if path != want:
                        raise AssertionError(f"matmul_ws int8 [{m},{k}]@"
                                             f"[{k},{n}] ran the {path} "
                                             f"form, not {want}")
                    call = lambda: matmul_ws(x, w)         # noqa: E731
                    reps = 3 if m > 16 else 20
                    ms = elapsed_ms(call, reps=reps, warmup=1)
                    dev_ms = device_ms(call, reps)
                    nbytes = m * k + k * n + 4 * m * n
                    ops = 2 * m * k * n
                    bound = bound_ms(nbytes, ops, INT8_OPS_PER_S)
                    lib = ""
                    if m > 16:
                        # the weight as a deployment would store it for
                        # the library: row-major [K,N] as given, and
                        # column-major (packed once, outside the timing)
                        w_col = w.t().contiguous().t()
                        lib_ms = {lay: elapsed_ms(
                            lambda w_=w_: torch._int_mm(x, w_), reps=reps,
                            warmup=1)
                            for lay, w_ in (("row-major", w),
                                            ("column-major", w_col))}
                        fast = min(lib_ms, key=lib_ms.get)
                        st["int8_library_layouts"][fast] += 1
                        for key, v in zip(st["int8"], (ms, dev_ms, bound,
                                                       lib_ms[fast])):
                            st["int8"][key] += v
                        lib = (", torch._int_mm " + ", ".join(
                            f"{v:.4f} ms {lay}" for lay, v in lib_ms.items())
                            + f" ({ms / lib_ms[fast]:.2f}x the faster)")
                    log(f"  matmul_ws int8 {model} [{m},{k}]@[{k},{n}], "
                        f"{path} form, equal: {ms:.4f} ms a call, "
                        f"{dev_ms:.4f} ms on the device "
                        f"({ops / dev_ms / 1e9:.1f} TOP/s, "
                        f"{nbytes / dev_ms / 1e6:.0f} GB/s), bound "
                        f"{bound:.5f} ms{lib}")
        log("  matmul_ws int8 at the long-M shapes, summed: "
            + ", ".join(f"{k} {v:.4f}" for k, v in st["int8"].items())
            + "; torch._int_mm faster with the weight "
            + ", ".join(f"{lay} on {c}" for lay, c in
                        st["int8_library_layouts"].items()))

    def check_int8_decode():
        """The int8 cache's two decode contractions on the card equal to
        the int64 ones on the CPU: random operands (pq from a softmax of
        random scores, as the decode makes it) and the worst cases, every
        q and k entry −128 and the largest Σ pq a softmax gives against
        v = −128."""
        for model, b, s, kv, g, d in W8_DECODE:
            qq, kc, vc = rand_i8(b, kv, g, d), rand_i8(b, s, kv, d), \
                rand_i8(b, s, kv, d)
            p = torch.softmax(3 * torch.randn(b, kv, g, s, generator=gen,
                                              device=dev), -1)
            pq = torch.round(p * 127.0).clamp(0, 127).to(torch.int8)
            worst = torch.zeros_like(p)
            worst[..., :253] = 0.501 / 127      # each rounds up to 1
            worst[..., 253] = 1 - 253 * 0.501 / 127
            wq = torch.round(worst * 127.0).clamp(0, 127).to(torch.int8)
            minus = torch.full_like(vc, -128)
            cases = (("q·k", "bkgd,bskd->bkgs", qq, kc),
                     ("q·k all -128", "bkgd,bskd->bkgs",
                      torch.full_like(qq, -128), minus),
                     ("p·v", "bkgs,bskd->bkgd", pq, vc),
                     ("p·v at the bound", "bkgs,bskd->bkgd", wq, minus))
            for label, sub, a, c in cases:
                got = int8_contract(sub, a, c)
                torch.cuda.synchronize()
                want = torch.einsum(sub, a.cpu().long(), c.cpu().long())
                if got.dtype != torch.float32 or not torch.equal(
                        got.cpu().long(), want):
                    raise AssertionError(f"int8 decode {model} {label}: the "
                                         f"card's f32 contraction is not the "
                                         f"exact int sum")
            log(f"  int8 cache decode contractions {model} B={b} S={s} "
                f"KV={kv} G={g} D={d}: q·k (random, all -128: "
                f"{128 * 128 * d}) and p·v (softmax pq, Σpq = "
                f"{int(wq[0, 0, 0].long().sum())} against v = -128) equal "
                f"to the CPU's int64 sums")

    def net_layers(plan):
        """(input shape, weight shape, conv kwargs) of every conv of
        ``plan`` under its default Hopper tile plan."""
        acts, ins = plan.activation_shapes(), plan.resolved_inputs()
        pshapes, geoms = plan.param_shapes(), plan.conv_geometries()
        plans = network.program_tile_plans(plan, ConvCoreConfig(int8=True))
        for i, tp in enumerate(plans):
            if tp is None:
                continue
            sp = plan.layers[i]
            src = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
            yield (BATCH, *src), pshapes[i]["w"], dict(
                stride=sp.stride, padding=sp.padding, groups=geoms[i][1],
                cin_banks=tp.cin_banks, kout_banks=tp.kout_banks,
                h_tile=tp.h_tile, w_tile=tp.w_tile, relu=sp.relu,
                pool=sp.pool, dilation=sp.dilation)

    log("phase 3: kernels against their plain versions")
    for i, (xs, ws, kw) in enumerate(net_layers(network.vgg_imagenet())):
        check_conv(f"vgg_imagenet conv{i}", rand_i8(*xs), rand_i8(*ws),
                   rand_bias(ws[3]), "scalar", kw, timed=True)
    log(f"  vgg_imagenet at batch {BATCH}, per layer (ms: CUDA events "
        f"around back-to-back calls, host work included; device ms: every "
        f"device event of a call under torch.profiler; TOP/s from device "
        f"ms; cudnn fp16: F.conv2d on fp16 channels-last operands, a "
        f"different function):")
    log("    layer  GOP     MB      bound us (by)        conv2d_ws ms "
        "(device)    conv2d_ws_pipe ms (device)  TOP/s seq/pipe  plain ms  "
        "cudnn fp16 ms")
    for label, ops, nbytes, row, plain, bound, side, cudnn in conv_rows:
        (sc, sd), (pc, pd) = row["conv2d_ws"], row["conv2d_ws_pipe"]
        log(f"    {label[-5:]}  {ops / 1e9:.3f}  {nbytes / 1e6:6.2f}  "
            f"{1e3 * bound:7.2f} ({side:10s})  {sc:.4f} ({sd:.4f})      "
            f"{pc:.4f} ({pd:.4f})            {ops / sd / 1e9:6.1f} / "
            f"{ops / pd / 1e9:6.1f}  {plain:.3f}     {cudnn:.4f}")
    seq, pipe = stats["conv2d_ws"], stats["conv2d_ws_pipe"]
    log(f"    sum: conv2d_ws {seq['ms']:.4f} ms ({seq['device_ms']:.4f} ms "
        f"on the device), conv2d_ws_pipe {pipe['ms']:.4f} ms "
        f"({pipe['device_ms']:.4f} ms on the device), bound "
        f"{sum(seq['bound'].values()):.4f} ms (the sum of the per-layer "
        f"bounds), plain {seq['plain_ms']:.3f} ms")
    for i, (xs, ws, kw) in enumerate(net_layers(network.lenet())):
        check_conv(f"lenet conv{i}", rand_i8(*xs), rand_i8(*ws),
                   rand_bias(ws[3]), "scalar", kw)
    shp = paper_workload()
    tp = ConvCore(ConvCoreConfig(int8=True)).plan(shp["x"], shp["w"])
    check_conv("§5.2 layer, int32 out", rand_i8(*shp["x"]), rand_i8(*shp["w"]),
               rand_bias(8), None, dict(
                   cin_banks=tp.cin_banks, kout_banks=tp.kout_banks,
                   h_tile=tp.h_tile, w_tile=tp.w_tile))
    check_conv("depthwise", rand_i8(BATCH, 56, 56, 32), rand_i8(3, 3, 1, 32),
               rand_bias(32), "scalar",
               dict(padding="SAME", groups=32, cin_banks=1, kout_banks=32,
                    relu=True, h_tile=28, w_tile=28))
    check_conv("stride 2", rand_i8(BATCH, 57, 57, 16), rand_i8(3, 3, 16, 32),
               rand_bias(32), "scalar",
               dict(stride=2, padding="SAME", relu=True))
    check_conv("dilation 2", rand_i8(BATCH, 40, 40, 16),
               rand_i8(3, 3, 16, 16), rand_bias(16), "scalar",
               dict(padding=((2, 1), (0, 3)), dilation=2, h_tile=10,
                    w_tile=20))
    check_conv("per-channel requant", rand_i8(BATCH, 28, 28, 64),
               rand_i8(3, 3, 64, 64), rand_bias(64), "per_k",
               dict(padding="SAME", relu=True, pool=True))
    for label in TC_CASES:              # the tensor-core path's edges
        x, w, b, s, kw = tc_case_inputs(label)
        check_conv(label, *(None if a is None else torch.as_tensor(
            np.array(a), device=dev) for a in (x, w, b, s)), kw)
    xf = torch.randn(BATCH, 30, 30, 32, generator=gen, device=dev)
    wf = torch.randn(3, 3, 32, 64, generator=gen, device=dev) / 16
    check_conv("f32", xf, wf, torch.randn(64, generator=gen, device=dev),
               None, dict(padding="SAME", relu=True, pool=True, h_tile=8,
                          w_tile=10))
    for label in F32_CASES:     # the conv edges in f32: simt, dw or nk
        x, w, b, kw = f32_case(label)
        check_conv(f"{label} f32", *(torch.as_tensor(np.array(a), device=dev)
                                     for a in (x, w, b)), None, kw)
    narrow = [(n, CASES) for n, (_, ws_, kw_, _) in CASES.items()
              if ws_[2] == 1 and ws_[3] // kw_.get("groups", 1) < 8]
    for label, table in narrow + [(n, DW_CASES) for n in DW_CASES]:
        for f32_ in (False, True):      # every dw case, int8 and f32
            x, w, b, s_, kw = legal_banks(*case_inputs(
                label, f32=f32_, table=table))
            check_conv(f"{label} {'f32' if f32_ else 'int8'}", *(
                None if a is None else torch.as_tensor(np.array(a),
                                                       device=dev)
                for a in (x, w, b, s_)), kw)
    for label in NK_CASES:      # every nk edge, int8 and f32
        for f32_ in (False, True):
            x, w, b, s_, kw = legal_banks(*case_inputs(
                label, f32=f32_, table=NK_CASES))
            check_conv(f"{label} {'f32' if f32_ else 'int8'}", *(
                None if a is None else torch.as_tensor(np.array(a),
                                                       device=dev)
                for a in (x, w, b, s_)), kw)

    def check_scalar_kernel():
        """The first port's scalar kernels, which keep the geometries no
        plan takes (none of the tables' or the zoo's since the nk path),
        launched directly on the tile plan ``scalar_tiles`` fits (one slot
        for ``conv2d_ws``, two for the pipe's cin-bank ring) at
        ``groups2``, ``tiled_pool_requant`` and ``c6_k3_bytes``, int8 and
        f32, as ``test_cuda_scalar_kernel_equals_plain`` launches them:
        int8 equal to ``conv2d_ws_plain``, f32 within ``F32_TOL`` → the
        conv rows' ``scalar_max_abs_err``."""
        for label in ("groups2", "tiled_pool_requant", "c6_k3_bytes"):
            table = CASES if label in CASES else NK_CASES
            for f32_ in (False, True):
                x, w, b, s_, kw = legal_banks(*case_inputs(
                    label, f32=f32_, table=table))
                args = [None if a is None else torch.as_tensor(
                    np.array(a), device=dev) for a in (x, w, b, s_)]
                want = conv2d_ws_plain(*args, **kw)
                geo = {k: v for k, v in kw.items()
                       if k not in ("relu", "pool")}
                for name, slots in (("conv2d_ws", 1), ("conv2d_ws_pipe", 2)):
                    g = scalar_tiles(setup_conv(
                        tuple(x.shape), tuple(w.shape),
                        pool=kw.get("pool", False), requant=s_ is not None,
                        int_path=not f32_, **geo), slots)
                    got, path = launch_conv(name, slots == 2, *args, g, None,
                                            kw.get("relu", False),
                                            kw.get("pool", False))
                    torch.cuda.synchronize()
                    if path != "scalar":
                        raise AssertionError(f"{label}: {name} launched on "
                                             f"the {path} path, not scalar")
                    sub = stats[name]["scalar"]
                    sub["max_abs_err"] = max(sub["max_abs_err"],
                                             compare(name, got, want))
        log("  the scalar kernels launched directly (groups2, "
            "tiled_pool_requant, c6_k3_bytes; int8 and f32): equal to the "
            "plain version in int8, max abs err "
            + ", ".join(f"{k} {stats[k]['scalar']['max_abs_err']:.3g}"
                        for k in ("conv2d_ws", "conv2d_ws_pipe"))
            + f" (within {F32_TOL} in f32)")

    check_scalar_kernel()
    mm_device_ms = check_matmuls()
    check_w8_matmuls()
    check_int8_decode()

    def check_conv1d():
        """``ops.conv1d_depthwise`` at recurrentgemma-9b's temporal conv, [1,
        4096, 4096] with K = 4, f32 with a bias: one ``conv2d_ws`` launch on
        the dw path (4096 one-lane groups), within 1e-4 of
        ``ref.conv1d_depthwise_ref`` and of the block's ``causal_conv1d``;
        timed beside ``F.conv1d(groups=W)`` (cuDNN, TF32 off, on the
        channels-first [1, W, S + K − 1] layout it takes, laid out outside
        the timing) → the conv2d_ws row's ``conv1d_*`` keys."""
        rg_full = get_config(RG_ARCH)
        s_len, width, k = RG_CONV_SEQ, rg_full.rnn_width, rg_full.conv1d_width
        x = torch.randn(1, s_len, width, generator=gen, device=dev)
        w = torch.randn(k, width, generator=gen, device=dev) / k ** 0.5
        bias = torch.randn(width, generator=gen, device=dev)
        before = path_counts(conv2d_ws)
        got = kops.conv1d_depthwise(x, w, bias)
        torch.cuda.synchronize()
        if path_counts(conv2d_ws) != one_more(before, "dw"):
            raise AssertionError("conv1d_depthwise: not one conv2d_ws launch "
                                 "on the dw path")
        err = compare("conv2d_ws", got, ref.conv1d_depthwise_ref(x, w, bias))
        dw_err = stats["conv2d_ws"]["dw"]
        dw_err["max_abs_err"] = max(dw_err["max_abs_err"], err)
        shifted = causal_conv1d(x, w, bias)
        if not torch.allclose(got, shifted, rtol=F32_TOL, atol=F32_TOL):
            raise AssertionError("conv1d_depthwise disagrees with the "
                                 "recurrent block's causal_conv1d")
        lib_call = conv1d_library(x, w, bias)
        if not torch.allclose(lib_call().transpose(1, 2), got, rtol=F32_TOL,
                              atol=F32_TOL):
            raise AssertionError("F.conv1d(groups=W) computes another "
                                 "function than conv1d_depthwise")
        call = lambda: kops.conv1d_depthwise(x, w, bias)    # noqa: E731
        ms = elapsed_ms(call, reps=10)
        dev_ms = device_ms(call, 10)
        plain = elapsed_ms(lambda: ref.conv1d_depthwise_ref(x, w, bias),
                           reps=5)
        lib = elapsed_ms(lib_call, reps=10)
        nbytes = layer_bytes(x, w, False, s_len * width, 4)
        ops = 2 * s_len * width * k
        side = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                else "operations")
        bound = bound_ms(nbytes, ops, F32_OPS_PER_S)
        stats["conv2d_ws"]["conv1d"] = dict(
            conv1d_ms=ms, conv1d_device_ms=dev_ms, conv1d_bound_ms=bound,
            conv1d_plain_ms=plain, conv1d_library_ms=lib)
        log(f"  conv1d_depthwise [1,{s_len},{width}] K={k} f32 (recurrentgemma"
            f"-9b's temporal conv) on conv2d_ws's dw path: max abs err "
            f"{err:.3g} against conv1d_depthwise_ref, within {F32_TOL} of "
            f"causal_conv1d; {ms:.4f} ms a call, {dev_ms:.4f} ms on the "
            f"device ({nbytes / dev_ms / 1e6:.0f} GB/s), bound {bound:.4f} ms"
            f" ({side}), plain {plain:.3f} ms, F.conv1d(groups={width}) "
            f"{lib:.4f} ms")

    check_conv1d()

    def time_dw_layers():
        """``mobilenet_small``'s three depthwise convs at 224 and batch 8
        on both kernels' dw path, in int8 as served (requantized to int8,
        the network's default tile plan's banks and tiles) and in f32 (f32
        out): each held to its plain version and the emulation
        (``check_conv``), timed (``ms``: CUDA events around back-to-back
        calls; ``device_ms``), beside the plain version, the byte bound
        and, in f32, ``F.conv2d(groups=C)`` (cuDNN, TF32 off, on the same
        values laid out channels-last NCHW and padded outside the timing)
        → the conv rows' ``dw_*`` keys, summed over the three layers.  The
        layers, their bytes and the library calls are
        ``tools/conv_dw_probe.py``'s, which times them on any tree."""
        layers = list(mobilenet_layers())
        if len(layers) != 3:
            raise AssertionError(f"mobilenet_small: {len(layers)} depthwise "
                                 f"layers")
        keys = ("ms", "device_ms", "plain_ms", "bound_ms")
        names = ("conv2d_ws", "conv2d_ws_pipe")
        for name in names:
            stats[name]["dw"].update(
                {f"{t}_{k}": 0.0 for t in ("int8", "f32") for k in keys},
                f32_library_ms=0.0)
        log(f"  mobilenet_small's depthwise convs at 224, batch {BATCH}, "
            f"on the dw path (us: CUDA events around back-to-back calls, "
            f"host work included / device time under torch.profiler; bound "
            f"at 3.35 TB/s; F.conv2d(groups=C) TF32 off):")
        for i, (_, xs, ws, kw, _) in enumerate(layers):
            n, h, wd, c = xs
            oh, ow = ref.conv_out_shape(h, wd, ws[0], ws[1], kw["stride"],
                                        kw["padding"], kw["dilation"])
            geo = {k: v for k, v in kw.items() if k not in ("relu", "pool")}
            for dtype in ("int8", "f32"):
                if dtype == "int8":
                    x, w, b = rand_i8(*xs), rand_i8(*ws), rand_bias(ws[3])
                    acc = conv2d_ws_plain(x, w, b, None, **kw)
                    scale = 100.0 / max(float(acc.abs().max()), 1.0)
                    out_es, ops_per_s = 1, INT8_OPS_PER_S
                else:
                    x = torch.randn(xs, generator=gen, device=dev)
                    w = torch.randn(ws, generator=gen, device=dev) / 3
                    b = torch.randn((ws[3],), generator=gen, device=dev)
                    scale, out_es, ops_per_s = None, 4, F32_OPS_PER_S
                label = f"mobilenet_small d{i + 1} {dtype}"
                path = conv_path(setup_conv(
                    xs, ws, pool=kw["pool"], requant=scale is not None,
                    int_path=dtype == "int8", **geo))
                if path != "dw":
                    raise AssertionError(f"{label}: the {path} path")
                check_conv(label, x, w, b, scale, kw)
                nbytes = layer_bytes(x, w, scale is not None,
                                     n * oh * ow * ws[3], out_es)
                bound = bound_ms(nbytes, 2 * n * oh * ow * ws[3] * ws[0]
                                 * ws[1], ops_per_s)
                plain = elapsed_ms(lambda: conv2d_ws_plain(
                    x, w, b, scale, **kw), reps=3, warmup=1)
                times = {}
                for name in names:
                    fn = wrappers[name]
                    call = (lambda fn=fn: fn(x, w, b, scale, **kw))
                    times[name] = (elapsed_ms(call, reps=20),
                                   device_ms(call, 20))
                    dw = stats[name]["dw"]
                    for k, v in zip(keys, (*times[name], plain, bound)):
                        dw[f"{dtype}_{k}"] += v
                lib = ""
                if dtype == "f32":
                    lib_call = conv2d_library(x, w, b, kw)
                    if not torch.allclose(
                            lib_call().permute(0, 2, 3, 1),
                            conv2d_ws(x, w, b, **geo), rtol=F32_TOL,
                            atol=F32_TOL):
                        raise AssertionError(f"{label}: F.conv2d(groups=C) "
                                             f"computes another function")
                    lib_ms = elapsed_ms(lib_call, reps=20)
                    lib_dev = device_ms(lib_call, 20)
                    for name in names:
                        stats[name]["dw"]["f32_library_ms"] += lib_ms
                    lib = (f", F.conv2d(groups={c}) {1e3 * lib_ms:.2f} / "
                           f"{1e3 * lib_dev:.2f} us")
                (sm, sd), (pm, pd) = times["conv2d_ws"], \
                    times["conv2d_ws_pipe"]
                log(f"    d{i + 1} {dtype:4s} x{tuple(xs)} stride "
                    f"{kw['stride']}: conv2d_ws {1e3 * sm:.2f} / "
                    f"{1e3 * sd:.2f} us, conv2d_ws_pipe {1e3 * pm:.2f} / "
                    f"{1e3 * pd:.2f} us, bound {1e3 * bound:.2f} us "
                    f"({nbytes / 1e6:.2f} MB), plain {plain:.3f} ms{lib}")

    time_dw_layers()

    def time_nk_layers():
        """The nk path (C/g > 1 with K/g < 8) at the four layers it was
        redesigned for: ``unet_small``'s and ``dilated_context``'s 3-class
        heads at 224, batch 8, in int8 as served (int32 out: the last conv
        dequantizes; the network's default tile plan), ``unet_small``'s
        head in f32 (its QAT forward: f32 out) and ``CASES``' ``groups2``
        in f32; each held to its plain version and the emulation
        (``check_conv``), timed as ``time_dw_layers`` times (``ms``,
        ``device_ms``), beside the plain version, the bound and, in f32,
        ``F.conv2d`` (cuDNN, TF32 off) → the conv rows' ``nk_*`` keys,
        summed by type.  ``tools/conv_nk_probe.py`` times the same layers
        on any tree (``nk_layers``)."""
        layers = []
        for label, dtype, xs, ws, kw in nk_layers():
            if dtype == "int8":
                args = (rand_i8(*xs), rand_i8(*ws), rand_bias(ws[3]))
            else:
                args = (torch.randn(xs, generator=gen, device=dev),
                        torch.randn(ws, generator=gen, device=dev) / 3,
                        torch.randn((ws[3],), generator=gen, device=dev))
            layers.append((label, dtype, args, kw))
        gx, gw, gb, g_kw = f32_case("groups2")
        layers.append(("groups2 f32", "f32", tuple(
            torch.as_tensor(np.array(a), device=dev) for a in (gx, gw, gb)),
            g_kw))
        keys = ("ms", "device_ms", "plain_ms", "bound_ms")
        names = ("conv2d_ws", "conv2d_ws_pipe")
        for name in names:
            stats[name]["nk"].update(
                {f"{t}_{k}": 0.0 for t in ("int8", "f32") for k in keys},
                f32_library_ms=0.0)
        log(f"  [{smi}] the nk path (C/g > 1, K/g < 8; us: CUDA events "
            f"around back-to-back calls, host work included / device time "
            f"under torch.profiler; bound at 3.35 TB/s and the dtype's "
            f"peak; F.conv2d TF32 off):")
        for label, dtype, (x, w, b), kw in layers:
            n, h, wd, _ = x.shape
            kh, kwd, cg, k = w.shape
            oh, ow = ref.conv_out_shape(h, wd, kh, kwd, kw.get("stride", 1),
                                        kw.get("padding", "VALID"),
                                        kw.get("dilation", 1))
            geo = {k_: v for k_, v in kw.items() if k_ not in ("relu",
                                                               "pool")}
            path = conv_path(setup_conv(
                tuple(x.shape), tuple(w.shape), pool=kw.get("pool", False),
                int_path=dtype == "int8", **geo))
            if path != "nk":
                raise AssertionError(f"{label}: the {path} path")
            check_conv(label, x, w, b, None, kw)
            want = conv2d_ws_plain(x, w, b, **kw)
            nbytes = layer_bytes(x, w, False, want.numel(),
                                 want.element_size())
            bound = bound_ms(nbytes, 2 * n * oh * ow * k * cg * kh * kwd,
                             INT8_OPS_PER_S if dtype == "int8"
                             else F32_OPS_PER_S)
            plain = elapsed_ms(lambda: conv2d_ws_plain(x, w, b, **kw),
                               reps=3, warmup=1)
            times = {}
            for name in names:
                fn = wrappers[name]
                call = (lambda fn=fn: fn(x, w, b, **kw))
                times[name] = (elapsed_ms(call, reps=20), device_ms(call, 20))
                sub = stats[name]["nk"]
                for k_, v in zip(keys, (*times[name], plain, bound)):
                    sub[f"{dtype}_{k_}"] += v
            lib = ""
            if dtype == "f32":
                lib_call = conv2d_library(x, w, b, kw)
                if not torch.allclose(lib_call().permute(0, 2, 3, 1),
                                      conv2d_ws(x, w, b, **geo),
                                      rtol=F32_TOL, atol=F32_TOL):
                    raise AssertionError(f"{label}: F.conv2d(groups="
                                         f"{kw.get('groups', 1)}) computes "
                                         f"another function")
                lib_ms = elapsed_ms(lib_call, reps=20)
                for name in names:
                    stats[name]["nk"]["f32_library_ms"] += lib_ms
                lib = (f", F.conv2d(groups={kw.get('groups', 1)}) "
                       f"{1e3 * lib_ms:.2f} / "
                       f"{1e3 * device_ms(lib_call, 20):.2f} us")
            (sm, sd), (pm, pd) = times["conv2d_ws"], times["conv2d_ws_pipe"]
            log(f"    {label} x{tuple(x.shape)} w{tuple(w.shape)}: conv2d_ws "
                f"{1e3 * sm:.2f} / {1e3 * sd:.2f} us, conv2d_ws_pipe "
                f"{1e3 * pm:.2f} / {1e3 * pd:.2f} us, bound "
                f"{1e3 * bound:.3f} us ({nbytes / 1e6:.3f} MB), "
                f"device / bound {sd / bound:.2f} / {pd / bound:.2f}, plain "
                f"{plain:.3f} ms{lib}")

    time_nk_layers()

    # bf16 attention: the kernel and the plain version each round an f32
    # result once, from sums taken in another order, so they may differ by
    # one bf16 ulp; 1e-5 more absolute covers outputs near zero, where the
    # f32 sums' own rounding (about 1e-7) can exceed an ulp
    BF16_ATOL = 1e-5
    flash_ms = {}

    def check_flash(b, s, h, d, dtype, causal, timed=False, variant=None):
        """One ``flash_attention`` call against its plain version, on the
        kernel ``variant`` names (asserted); ``timed`` adds its times, and
        llama3.2-3b's [1, 2048, 24, 128] ones make the JSON row."""
        want_variant = variant or (
            "wgmma" if dtype == torch.bfloat16 else "scalar")
        if kernel_variant(dtype, d) != want_variant:
            raise AssertionError(f"flash_attention D = {d} {dtype}: variant "
                                 f"{kernel_variant(dtype, d)}, expected "
                                 f"{want_variant}")
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal=causal)
        err_t = (got.float() - want.float()).abs()
        err = float(err_t.max())
        if dtype == torch.float32:
            ok, tol = torch.allclose(got, want, rtol=F32_TOL,
                                     atol=F32_TOL), f"within {F32_TOL}"
        else:
            ok = bool((err_t <= bf16_ulp(want) + BF16_ATOL).all())
            tol = f"within one bf16 ulp + {BF16_ATOL}"
        if got.dtype != dtype or not ok:
            raise AssertionError(f"flash_attention [{b},{s},{h},{d}] {dtype} "
                                 f"causal={causal} disagrees with its plain "
                                 f"version (max abs err {err})")
        st = stats["flash_attention"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        row = ""
        if timed:
            ms = elapsed_ms(lambda: flash_attention(q, k, v, causal=causal),
                            reps=10)
            dev_ms = device_ms(lambda: flash_attention(q, k, v,
                                                       causal=causal), 10)
            plain = elapsed_ms(lambda: flash_attention_plain(
                q, k, v, causal=causal), reps=3, warmup=1)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = elapsed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), reps=10)
            pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
            ops, nbytes = 4 * d * pairs, 4 * b * s * h * d * q.element_size()
            if (h, d) == (lm_full.num_heads, lm_full.head_dim):
                flash_ms[s] = dev_ms
            if (s, h, d) == (FLASH_ROW_SEQ, lm_full.num_heads,
                             lm_full.head_dim):
                st.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                          library_ms=lib)
                add_bound("flash_attention", nbytes, ops)
            row = (f"; kernel {ms:.4f} ms a call, {dev_ms:.4f} ms on the "
                   f"device ({ops / dev_ms / 1e9:.1f} TFLOP/s at "
                   f"4·D flops per pair), plain {plain:.3f} ms, sdpa "
                   f"{lib:.4f} ms, bound "
                   f"{bound_ms(nbytes, ops, BF16_OPS_PER_S):.4f} ms")
        log(f"  flash_attention [{b},{s},{h},{d}] {str(dtype)[6:]} "
            f"causal={causal}, {want_variant}: max abs err {err:.3g} "
            f"({tol}){row}")

    lm_full = get_config(LM_ARCH)
    for s_len in FLASH_SEQS:
        check_flash(1, s_len, lm_full.num_heads, lm_full.head_dim,
                    torch.bfloat16, True, timed=True)
    for d in FLASH_SMALL_DIMS:         # the tensor-core kernel's other dims
        check_flash(2, 777, 4, d, torch.bfloat16, True)
        check_flash(2, 300, 4, d, torch.bfloat16, False)
    for causal in (True, False):
        check_flash(2, 300, 4, 64, torch.float32, causal)
    for b, s_len, h, d, causal in LM_FLASH:
        check_flash(b, s_len, h, d, torch.bfloat16, causal)
    for b, s_len, h, d, dname, variant in FLASH_REPAIRED:
        check_flash(b, s_len, h, d, getattr(torch, dname), True,
                    timed=s_len == FLASH_ROW_SEQ, variant=variant)

    # -- 4. the §5.2 layer through ConvCore --------------------------------
    log("phase 4: the §5.2 layer through ConvCore(int8=True)")
    x, w, b = rand_i8(*shp["x"]), rand_i8(*shp["w"]), rand_bias(8)
    got = ConvCore(ConvCoreConfig(int8=True)).apply_layer(x, w, b)
    want = ConvCore(ConvCoreConfig(int8=True, backend="ref")).apply_layer(
        x, w, b)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("§5.2 layer: ConvCore differs from the plain "
                             "backend")
    anchors = perfmodel.paper_reference_numbers()
    log(f"  out {tuple(got.shape)} {got.dtype} equal to the plain backend; "
        f"psums {anchors['psums']:,} (paper model: "
        f"{anchors['gops_1core']:.3f} GOPS on one FPGA core)")
    if anchors["psums"] != 3_154_176:
        raise AssertionError(f"§5.2 psum count {anchors['psums']}")

    # the Fig. 6 wrap: ReLU and pool on the int32 accumulator, then int8
    wrap = dict(relu=True, pool=True)
    got = ConvCore(ConvCoreConfig(int8=True, wrap8=True)).apply_layer(
        x, w, b, **wrap)
    want = ConvCore(ConvCoreConfig(int8=True, wrap8=True, backend="ref")
                    ).apply_layer(x, w, b, **wrap)
    acc = ConvCore(ConvCoreConfig(int8=True)).apply_layer(x, w, b, **wrap)
    torch.cuda.synchronize()
    wrapped = int(((acc < -128) | (acc > 127)).sum())
    if got.dtype != torch.int8 or not torch.equal(got, want) or not wrapped:
        raise AssertionError(f"§5.2 layer, wrap8: {got.dtype}, equal to the "
                             f"plain backend {torch.equal(got, want)}, "
                             f"{wrapped} accumulators outside int8")
    log(f"  wrap8 (relu, pool): out {tuple(got.shape)} {got.dtype} equal to "
        f"the plain backend; {wrapped} of {acc.numel()} accumulators wrapped")

    # auto_bank=False: the whole map as one tile, which overflows a block's
    # shared memory; each path of both kernels must give the fitted plan's
    # bits
    def by_path(fn):
        return {p: getattr(fn, f"{p}_launches") for p in CONV_PATHS}

    xf = torch.randn(shp["x"], generator=gen, device=dev)
    wf = torch.randn(shp["w"], generator=gen, device=dev) * 0.1
    bf = torch.randn(8, generator=gen, device=dev)
    xd8, xdf = rand_i8(2, 224, 224, 32), torch.randn(
        (2, 224, 224, 32), generator=gen, device=dev)
    paper_kw = dict(padding="VALID", groups=1, relu=False, pool=False)
    pooled = dict(padding="SAME", relu=True, pool=True)
    whole_map = (
        ("tc", "§5.2 int8", x, w, b, paper_kw),
        ("simt", "§5.2 f32", xf, wf, bf, paper_kw),
        ("dw", "depthwise int8 [2,224,224,32], relu, pool", xd8,
         rand_i8(3, 3, 1, 32), rand_bias(32), dict(pooled, groups=32)),
        ("dw", "depthwise f32 [2,224,224,32], relu, pool", xdf, torch.randn(
            (3, 3, 1, 32), generator=gen, device=dev), torch.randn(
            32, generator=gen, device=dev), dict(pooled, groups=32)),
        ("nk", "grouped int8 [2,224,224,8] (2 groups of 4 -> 2), relu, "
         "pool", rand_i8(2, 224, 224, 8), rand_i8(3, 3, 4, 4), rand_bias(4),
         dict(pooled, groups=2)))
    for path, name, x_, w_, b_, kw in whole_map:
        int8 = x_.dtype == torch.int8
        for kernel, fn in (("sequential", conv2d_ws),
                           ("pipelined", conv2d_ws_pipe)):
            outs, plans = [], []
            for auto in (True, False):
                core = ConvCore(ConvCoreConfig(int8=int8, auto_bank=auto,
                                               kernel=kernel))
                plans.append(core.plan(tuple(x_.shape), tuple(w_.shape),
                                       padding=kw["padding"],
                                       pool=kw["pool"], groups=kw["groups"]))
                before = by_path(fn)
                outs.append(core.apply_layer(x_, w_, b_, **kw))
                after = by_path(fn)
                if after[path] != before[path] + 1:
                    raise AssertionError(
                        f"{name} {kernel} auto_bank={auto}: launches by "
                        f"path {before} -> {after}, expected one on {path}")
            torch.cuda.synchronize()
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"{name} {kernel}: auto_bank=False "
                                     f"differs from the fitted plan")
            fit, whole = plans
            if whole.fits_smem or fit.n_h_tiles * fit.n_w_tiles == 1:
                raise AssertionError(f"{name}: the whole map fits a block "
                                     f"({whole}) or the fitted plan is one "
                                     f"tile ({fit})")
            log(f"  auto_bank=False, {name}, {fn.__name__} ({path} path): "
                f"one {whole.h_tile}x{whole.w_tile} tile, working set "
                f"{whole.working_set_bytes:,} B against {whole.budget:,} "
                f"(fitted: {fit.n_h_tiles}x{fit.n_w_tiles} tiles of "
                f"{fit.h_tile}x{fit.w_tile}, {fit.working_set_bytes:,} B); "
                f"out {tuple(outs[1].shape)} {outs[1].dtype} equal")

    # -- 5. the main path --------------------------------------------------
    convs = ("conv2d_ws", "conv2d_ws_pipe")

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        for k in convs:
            reset_launches(wrappers[k])
        matmul_ws.path_launches = dict.fromkeys(PATHS, 0)

    def counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    def conv_paths():
        """Each conv kernel's launches on the tensor-core, dw, nk and scalar
        paths (``SERVED_PATHS``: no simt launch is served)."""
        return {k: {p_: getattr(wrappers[k], f"{p_}_launches")
                    for p_ in SERVED_PATHS} for k in convs}

    def credit_paths():
        """Add the conv kernels' dw, nk and scalar launches since the last
        reset to their rows (read where a main-path run's launches are
        credited)."""
        for k in convs:
            fn = wrappers[k]
            stats[k]["dw"]["dw_launches"] += fn.dw_launches
            stats[k]["nk"]["nk_launches"] += fn.nk_launches
            stats[k]["nk"]["scalar_launches"] += fn.scalar_launches

    def device_busy(fn, part=None, ranges=None, once=False):
        """(wall ms of ``fn`` unprofiled, device ms and device event count
        of ``fn`` under torch.profiler, and with ``part`` the device ms by
        label); device ms is None where the trace holds no device events.
        With ``once`` (for an ``fn`` that changes state) ``fn`` runs only
        under the profiler, and its output takes the wall ms's place.
        ``ranges`` ({(module, attribute): label}) runs those functions
        inside a ``record_function`` range of that label in both calls;
        the spans a range leaves on the device timeline are not counted.
        ``part(kernel, op, scope, fwd)`` labels a device event by its
        kernel name, the op that launched it (the CPU op whose correlation
        id the event carries; None if there is none), the innermost range
        around that op (or None), and ``fwd``: None outside the autograd
        engine's backward, else the innermost range around the forward op
        that made the node the op runs for ("" if none).  Each event is
        counted once, so the labels add up to the device ms."""
        saved = []
        for (mod, attr), label in (ranges or {}).items():
            orig = getattr(mod, attr)

            def scoped(*a, _orig=orig, _label=label, **k):
                with torch.profiler.record_function(_label):
                    return _orig(*a, **k)
            setattr(mod, attr, scoped)
            saved.append((mod, attr, orig))
        try:
            if not once:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                first = 1e3 * (time.perf_counter() - t0)
            act = torch.profiler.ProfilerActivity
            with torch.profiler.profile(
                    activities=[act.CPU, act.CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
        finally:
            for mod, attr, orig in saved:
                setattr(mod, attr, orig)
        if once:
            first = out
        scopes = set((ranges or {}).values())
        kind = torch.autograd.DeviceType
        raw = prof.profiler.kineto_results.events()
        evs = [k for k in raw if k.device_type() == kind.CUDA
               and k.name() not in scopes]
        busy = sum(k.end_ns() - k.start_ns() for k in evs) / 1e6
        if part is None:
            return first, (busy if evs else None), len(evs)
        engine = "autograd::engine::evaluate_function"

        def up_from(e):
            """(the innermost range around ``e``, the innermost autograd
            node ``e`` runs in)."""
            scope = node = None
            while e is not None and (scope is None or node is None):
                if scope is None and e.name in scopes:
                    scope = e.name
                if node is None and e.name.startswith(engine):
                    node = e
                e = e.cpu_parent
            return scope, node
        # an op's event carries its own correlation id and links to none;
        # its kernels link to it.  An op that records an autograd node
        # carries the node's sequence number
        launchers = {k.correlation_id() for k in raw
                     if k.device_type() == kind.CPU
                     and k.linked_correlation_id() == 0}
        ops, made_in = {}, {}
        for e in prof.events():
            if e.device_type != kind.CPU or e.is_async:
                continue
            if e.id in launchers:
                inner = ops.get(e.id)
                if inner is None or e.time_range.start > \
                        inner.time_range.start:
                    ops[e.id] = e
            if e.sequence_nr >= 0 and not e.name.startswith(engine):
                made_in[(e.thread, e.sequence_nr)] = up_from(e)[0] or ""
        by_part = {}
        for k in evs:
            op = ops.get(k.linked_correlation_id())
            scope, node = up_from(op)
            fwd = None if node is None else made_in.get(
                (node.fwd_thread, node.sequence_nr), "")
            label = part(k.name(), op, scope, fwd)
            by_part[label] = (by_part.get(label, 0.0)
                              + (k.end_ns() - k.start_ns()) / 1e6)
        return first, (busy if evs else None), len(evs), by_part

    def log_split(name, fn, part, labels, ranges=None):
        """Device ms of one call of ``fn`` under torch.profiler, by
        ``part`` (``device_busy``), in the order of ``labels``."""
        wall, busy, n, parts = device_busy(fn, part=part, ranges=ranges)
        if set(parts) - set(labels):
            raise AssertionError(f"{name}: parts {sorted(parts)} outside "
                                 f"{labels}")
        if busy is None:
            log(f"  {name}: {wall:.1f} ms of host clock; device time not "
                f"measured (no device events in the trace)")
            return
        log(f"  {name}: {wall:.1f} ms of host clock, device busy "
            f"{busy:.1f} ms ({100 * busy / wall:.0f}%), {n} device events; "
            f"device ms by part: " + ", ".join(
                f"{k} {parts.get(k, 0.0):.2f} "
                f"({100 * parts.get(k, 0.0) / busy:.0f}%)" for k in labels))

    def serve(name, plan, seed, params=None, calib=None,
              per_channel=False):
        """Quantize ``plan`` (random weights from ``seed``, or the given
        ``params`` and calibration images) and serve it through
        ``ConvNetEngine`` on both kernels, bit-equal to the plain
        backend."""
        rng = np.random.default_rng(seed)
        if params is None:
            params = plan.init_params(rng, device=dev)
            calib = torch.from_numpy(rng.normal(
                size=(REQUESTS, *plan.input_shape)).astype(
                    np.float32)).to(dev)
        t0 = time.perf_counter()
        qnet = network.quantize_network(plan, params, calib,
                                        per_channel=per_channel)
        torch.cuda.synchronize()
        log(f"  {name}: quantized on {calib.shape[0]} calibration images "
            f"in {time.perf_counter() - t0:.2f} s")
        images = rng.normal(size=(REQUESTS, *plan.input_shape)).astype(
            np.float32)
        with torch.no_grad():
            float_logits = plan.apply_ref(
                params, torch.from_numpy(images).to(dev)).cpu().numpy()
        ref_engine = ConvNetEngine(qnet, batch=BATCH, core_config=ConvCoreConfig(
            int8=True, backend="ref"))
        ref_logits = ref_engine.submit(images)
        ref_engine.close()
        results = {}
        for kernel, expect in (("auto", "conv2d_ws_pipe"),
                               ("sequential", "conv2d_ws")):
            engine = ConvNetEngine(qnet, batch=BATCH, core_config=ConvCoreConfig(
                int8=True, kernel=kernel))
            reset_counts()
            logits = engine.submit(images)
            seen, served = counts(), engine.stats
            tc = {k: wrappers[k].tc_launches for k in convs}
            credit_paths()
            batches = -(-REQUESTS // BATCH)
            n_conv = sum(sp.kind == "conv" for sp in plan.layers)
            n_dense = sum(sp.kind == "dense" for sp in plan.layers)
            want = {k: 0 for k in wrappers}
            want[expect] = n_conv * batches
            want["matmul_ws"] = n_dense * batches
            if seen != want:
                raise AssertionError(f"{name} kernel={kernel}: launches "
                                     f"{seen}, expected {want}")
            if tc != {k: seen[k] for k in convs}:
                raise AssertionError(f"{name} kernel={kernel}: conv "
                                     f"launches {seen}, of them on the "
                                     f"tensor-core path {tc}")
            forms = dict.fromkeys(PATHS, 0)
            for i, sp in enumerate(plan.layers):
                if sp.kind == "dense":
                    k_in, k_out = plan.param_shapes()[i]["w"]
                    forms[mm_path(BATCH, k_in, k_out, torch.int8)] += batches
            if matmul_ws.path_launches != forms:
                raise AssertionError(f"{name} kernel={kernel}: matmul_ws "
                                     f"forms {matmul_ws.path_launches}, "
                                     f"expected {forms}")
            if logits.shape != (REQUESTS, plan.activation_shapes()[-1][0]) \
                    or not np.isfinite(logits).all():
                raise AssertionError(f"{name}: bad logits {logits.shape}")
            if not np.array_equal(logits, ref_logits):
                raise AssertionError(f"{name} kernel={kernel}: logits differ "
                                     f"from the plain backend")
            t0 = time.perf_counter()
            reps = 5
            for _ in range(reps):
                engine.submit(images)
            wall = (time.perf_counter() - t0) / reps
            _, busy, n_ev = device_busy(lambda: engine.submit(images))
            share = ("not measured (no device events in the trace)"
                     if busy is None else
                     f"device busy {busy:.3f} ms = {100 * busy / 1e3 / wall:.0f}"
                     f"% of it over {n_ev} device events (torch.profiler)")
            log(f"  {name} kernel={kernel}: launches {seen}, all "
                f"{tc[expect]} conv launches on the tensor-core path, "
                f"matmul_ws forms {forms}; logits "
                f"{logits.shape} bit-equal to the plain backend; "
                f"{REQUESTS} requests in {1e3 * wall:.2f} ms "
                f"({REQUESTS / wall:.1f} images/s, mean of {reps}); {share}; "
                f"stats {served}")
            results[kernel] = (seen, logits, wall)
            engine.close()
        rel = np.linalg.norm(logits - float_logits) / np.linalg.norm(
            float_logits)
        log(f"  {name}: int8 logits vs the float oracle: relative error "
            f"{rel:.4f}")
        return qnet, images, results, ref_logits

    log("phase 5: the conv main path")
    vq, vimages, results, vref = serve("vgg_imagenet",
                                       network.vgg_imagenet(), seed=0)
    for k in ("conv2d_ws_pipe", "matmul_ws"):
        stats[k]["launches"] = results["auto"][0][k]
    stats["conv2d_ws"]["launches"] = results["sequential"][0]["conv2d_ws"]
    for kernel, conv in (("auto", "conv2d_ws_pipe"),
                         ("sequential", "conv2d_ws")):
        wall_ms = 1e3 * results[kernel][2]
        busy = (-(-REQUESTS // BATCH) * (
            stats[conv]["device_ms"] + mm_device_ms["vgg_imagenet head"]))
        log(f"  vgg_imagenet kernel={kernel}: kernels {busy:.3f} ms of the "
            f"{wall_ms:.3f} ms submit (phase-3 device times x batches); "
            f"the rest, {wall_ms - busy:.3f} ms, is host work, plain glue "
            f"ops and launch gaps")
    lq, limages, lres, lref = serve("lenet", network.lenet(), seed=1)
    cpu_engine = ConvNetEngine(lq, batch=BATCH, device="cpu")
    cpu = cpu_engine.submit(limages)
    cpu_engine.close()
    if not np.array_equal(cpu, lres["auto"][1]):
        raise AssertionError("lenet: card logits differ from the CPU run")
    log("  lenet: card logits bit-equal to the CPU run of the same program")

    # -- 6. the LM main path ----------------------------------------------
    class TimedEngine(ServingEngine):
        """``ServingEngine`` with a host clock around each admit (batch-1
        prefill + cache scatter) and each decode step; both end in a
        device sync, since the sampled token is read on the host."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.admit_ms, self.step_ms = {}, []

        def admit(self, req):
            t0 = time.perf_counter()
            ok = super().admit(req)
            if ok:
                self.admit_ms[req.uid] = 1e3 * (time.perf_counter() - t0)
            return ok

        def step(self):
            busy = sum(r is not None for r in self.active)
            t0 = time.perf_counter()
            done = super().step()
            if busy:
                self.step_ms.append((busy, 1e3 * (time.perf_counter() - t0)))
            return done

    def lm_requests(cfg, lengths, new, seed):
        rng = np.random.default_rng(seed)
        return [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lengths)]

    def fresh(reqs):
        return [Request(uid=r.uid, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens) for r in reqs]

    def check_served(name, cfg, reqs):
        for r in reqs:
            if not r.done or len(r.output) != r.max_new_tokens or not all(
                    0 <= t < cfg.vocab_size for t in r.output):
                raise AssertionError(f"{name}: request {r.uid} ended with "
                                     f"{r.output}")

    def last_logits(params, cfg, prompt):
        with torch.no_grad():
            lg, _ = lm.prefill(params, {"tokens": torch.as_tensor(
                prompt, dtype=torch.long, device=dev)[None]}, cfg)
        return lg[0].float()

    def layer_gemms(c, w8=False):
        """(K, N) of each matmul_ws call a layer makes in a forward: the
        gated MLP's three under ``pallas_ws``, and with ``w8`` the
        attention's q / k / v / output projections before them."""
        mlp = [(c.d_model, c.d_ff)] * 2 + [(c.d_ff, c.d_model)]
        if not w8:
            return mlp
        q = c.num_heads * c.head_dim
        kv = c.num_kv_heads * c.head_dim
        return [(c.d_model, q), (c.d_model, kv), (c.d_model, kv),
                (q, c.d_model)] + mlp

    def serve_held(name, eng, c, reqs, gemms=(), flash=0,
                   dtype=torch.bfloat16):
        """Serve ``reqs`` with the counts reset just before; hold every
        kernel's launches to what the run must make: ``flash``
        flash_attention launches a prefill (none where the attention has a
        window, which takes the chunked path, or where there is none), no
        conv, and a matmul_ws launch a layer a forward for each (K, N) in
        ``gemms``, on the form ``mm_path`` names for it in ``dtype`` (int8
        with w8 weights): M = the prompt at a prefill, the slots at a
        decode step.  Adds the launches to the JSON rows → the wall s of
        the run."""
        eng.step_ms.clear()
        reset_counts()
        t0 = time.perf_counter()
        eng.run(reqs)
        wall = time.perf_counter() - t0
        seen, forms = counts(), dict(matmul_ws.path_launches)
        steps = len(eng.step_ms)
        want = {k: 0 for k in wrappers}
        want["flash_attention"] = flash * len(reqs)
        want_forms = dict.fromkeys(PATHS, 0)
        for m in [len(r.prompt) for r in reqs] + [eng.slots] * steps:
            for k, n in gemms:
                want_forms[mm_path(m, k, n, dtype)] += c.num_layers
        want["matmul_ws"] = sum(want_forms.values())
        if seen != want or forms != want_forms:
            raise AssertionError(f"{name}: launches {seen}, matmul_ws forms "
                                 f"{forms}; expected {want}, {want_forms}")
        check_served(name, c, reqs)
        for k in ("matmul_ws", "flash_attention"):
            stats[k]["launches"] += seen[k]
        credit_forms()
        log(f"  {name}: launches {seen}, matmul_ws forms {forms} over "
            f"{len(reqs)} prefills and {steps} decode steps; {len(reqs)} "
            f"requests × {reqs[0].max_new_tokens} tokens, all in range")
        return wall

    def ws_against_xla(name, ws_eng, c_ws, xla_eng, c, reqs, wreqs):
        """The ``pallas_ws`` run against the ``xla`` one on the same
        weights: the longest prompt's prefill with every ``matmul_ws``
        call held to ``matmul_ws_plain`` on its own operands
        (``check_mm``: the form ``mm_path`` names, within
        ``bf16_gemm_bound``), then each prompt's last-token logits against
        the ``xla`` backend's within a bf16 bound, and the greedy tokens
        equal to the ``xla`` run counted."""
        longest = max((r.prompt for r in wreqs), key=len)
        held = collections.Counter()

        def hold(x, w, bias=None):
            path, _, got = check_mm(x, w, bias)
            held[path] += 1
            return got
        kops._matmul_kernel = hold
        try:
            last_logits(ws_eng.params, c_ws, longest)
        finally:
            kops._matmul_kernel = matmul_ws
        if sum(held.values()) != 3 * c.num_layers:
            raise AssertionError(f"{name} pallas_ws: {dict(held)} matmul_ws "
                                 f"calls in a prefill, not 3 × "
                                 f"{c.num_layers}")
        # each layer's MLP rounds three bf16 GEMM outputs, each of which
        # may move by one bf16 ulp (at most 2^-7 relative) between
        # matmul_ws and the xla backend's torch.einsum; 3 × L such moves
        # add at most linearly unless the network amplifies them
        ws_bound = 3 * c.num_layers * 2.0 ** -7
        worst = 0.0
        for r in wreqs:
            a = last_logits(ws_eng.params, c_ws, r.prompt)
            b = last_logits(xla_eng.params, c, r.prompt)
            rel = float((a - b).norm() / b.norm())
            if not bool(torch.isfinite(a).all()) or rel > ws_bound:
                raise AssertionError(f"{name} pallas_ws prompt "
                                     f"{len(r.prompt)}: prefill logits off "
                                     f"the xla backend's by {rel:.4g} "
                                     f"(bound {ws_bound:.4g})")
            worst = max(worst, rel)
        same = sum(a == b for r, w in zip(reqs, wreqs)
                   for a, b in zip(r.output, w.output))
        log(f"  {name} pallas_ws: the {len(longest)}-token prefill's "
            f"{sum(held.values())} matmul_ws calls (forms {dict(held)}) each "
            f"within bf16_gemm_bound of matmul_ws_plain on its operands; "
            f"prefill last-token logits against gemm_backend='xla': "
            f"relative L2 at most {worst:.4g} over {len(wreqs)} prompts "
            f"(bound {ws_bound:.4g}); greedy tokens equal to the xla run: "
            f"{same} of {sum(len(r.output) for r in reqs)} (counted, not "
            f"required)")

    def log_admits(name, eng, reqs, ref_ms, ref_label):
        for r in reqs:
            ms = eng.admit_ms[r.uid]
            ref = ref_ms.get(r.uid)
            beside = ("" if ref is None else f", {ref_label} {ref:.1f} ms "
                      f"({ms / ref:.2f}×)")
            log(f"    {name} prompt {len(r.prompt):5d}: admit {ms:.1f} "
                f"ms{beside}")

    log("phase 6: the LM main path")
    cfg = dataclasses.replace(lm_full, attn_impl="flash")
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    t0 = time.perf_counter()
    params = materialize(lm.param_specs(cfg), torch.Generator(
        device=dev).manual_seed(0), device=dev)
    engine = TimedEngine(cfg, params, slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    del params                          # the engine keeps its bf16 copy
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {param_count(cfg) / 1e9:.2f} B parameters "
        f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
        f"{cfg.vocab_size}), drawn on the card from seed 0 and cast to "
        f"{cfg.compute_dtype} in {time.perf_counter() - t0:.1f} s; "
        f"{LM_SLOTS} slots × {LM_MAX_SEQ} positions")
    reqs = lm_requests(cfg, LM_PROMPTS, LM_NEW_TOKENS, seed=0)
    last_logits(engine.params, cfg, reqs[0].prompt)    # warm-up, uncounted
    wall = serve_held(cfg.name, engine, cfg, reqs, flash=cfg.num_layers)
    for r in reqs:
        n, ms = len(r.prompt), engine.admit_ms[r.uid]
        share = ""
        if n in flash_ms:
            share = (f"; flash_attention {cfg.num_layers} × "
                     f"{flash_ms[n]:.3f} ms = "
                     f"{100 * cfg.num_layers * flash_ms[n] / ms:.1f}% of it "
                     f"(phase-3 device time)")
        log(f"    prompt {n:5d}: admit (prefill + cache scatter) "
            f"{ms:.1f} ms{share}")
    def log_decode(eng, reqs, wall):
        busy_tokens = sum(b for b, _ in eng.step_ms)
        step_s = sum(ms for _, ms in eng.step_ms) / 1e3
        full = [ms for b, ms in eng.step_ms if b == LM_SLOTS]
        generated = sum(len(r.output) for r in reqs)
        steps = len(eng.step_ms)
        median_full = np.median(full) if full else float("nan")
        log(f"  decode: {steps} steps, {1e3 * step_s / steps:.2f} ms per "
            f"step on average, {median_full:.2f} ms median with all "
            f"{LM_SLOTS} slots busy; {busy_tokens / step_s:.1f} "
            f"tokens/s over the decode steps; {generated} tokens in "
            f"{wall:.2f} s of run ({generated / wall:.1f} tokens/s, "
            f"prefills included)")
        return generated

    def log_busy(eng, c, reqs, longest):
        """Device-busy share of a 4-slot decode step and of the longest
        prompt's prefill."""
        for r in reqs[:LM_SLOTS]:            # four busy slots again
            eng.admit(fresh([r])[0])
        for label, fn in (("decode step, 4 slots", eng.step),
                          (f"prefill of {len(longest)} tokens",
                           lambda: last_logits(eng.params, c, longest))):
            wall, busy, n = device_busy(fn)
            share = ("not measured (no device events in the trace)"
                     if busy is None else
                     f"device busy {busy:.1f} ms = {100 * busy / wall:.0f}% "
                     f"of it")
            log(f"  {label}: {wall:.1f} ms of host clock, {n} device events "
                f"under torch.profiler; {share}")

    generated = log_decode(engine, reqs, wall)
    xla_admit_ms = dict(engine.admit_ms)    # before log_busy admits again
    xla_step_ms = [ms for b, ms in engine.step_ms if b == LM_SLOTS]
    longest = max((r.prompt for r in reqs), key=len)
    log_busy(engine, cfg, reqs, longest)

    # each layer's attention output may move by one bf16 ulp (at most
    # 2^-7 relative) between the kernel and the plain softmax; 28 such
    # moves add at most linearly unless the network amplifies them
    logit_bound = cfg.num_layers * 2.0 ** -7
    worst = 0.0
    for r in reqs:
        a = last_logits(engine.params, cfg, r.prompt)
        b = last_logits(engine.params, plain_cfg, r.prompt)
        rel = float((a - b).norm() / b.norm())
        if not bool(torch.isfinite(a).all()) or rel > logit_bound:
            raise AssertionError(f"{cfg.name} prompt {len(r.prompt)}: "
                                 f"prefill logits off the plain attention's "
                                 f"by {rel:.4g} (bound {logit_bound:.4g})")
        worst = max(worst, rel)
    log(f"  prefill last-token logits against attn_impl='dense': relative "
        f"L2 error at most {worst:.4g} over the {len(reqs)} prompts "
        f"(bound {logit_bound:.4g})")
    plain_engine = ServingEngine(plain_cfg, engine.params, slots=LM_SLOTS,
                                 max_seq=LM_MAX_SEQ)
    preqs = fresh(reqs)
    plain_engine.run(preqs)
    check_served(f"{cfg.name} (plain attention)", cfg, preqs)
    same = sum(a == b for r, p in zip(reqs, preqs)
               for a, b in zip(r.output, p.output))
    log(f"  greedy tokens equal to a run with the plain attention: {same} "
        f"of {generated} (not required: a near tie among "
        f"{cfg.vocab_size:,} bf16-rounded logits can flip an argmax, and "
        f"the request's later tokens follow the flip)")
    del plain_engine

    # the same requests with the MLP's three GEMMs a layer on matmul_ws
    cfg_ws = dataclasses.replace(cfg, gemm_backend="pallas_ws")
    ws_engine = TimedEngine(cfg_ws, engine.params, slots=LM_SLOTS,
                            max_seq=LM_MAX_SEQ)
    last_logits(ws_engine.params, cfg_ws, reqs[0].prompt)    # warm-up
    wreqs = fresh(reqs)
    wall = serve_held(f"{cfg.name} pallas_ws", ws_engine, cfg_ws, wreqs,
                      layer_gemms(cfg), flash=cfg.num_layers)
    log_admits(f"{cfg.name} pallas_ws", ws_engine, wreqs, xla_admit_ms,
               "xla")
    log_decode(ws_engine, wreqs, wall)
    log_busy(ws_engine, cfg_ws, wreqs, longest)

    ws_against_xla(cfg.name, ws_engine, cfg_ws, engine, cfg, reqs, wreqs)
    del engine, ws_engine
    torch.cuda.empty_cache()

    f32 = dataclasses.replace(cfg, num_layers=2, compute_dtype="float32")
    params = materialize(lm.param_specs(f32), torch.Generator(
        device=dev).manual_seed(1), device=dev)
    reqs = lm_requests(f32, (64, 777, 1536, 3000), 8, seed=1)
    worst = 0.0
    for r in reqs:
        a = last_logits(params, f32, r.prompt)
        b = last_logits(params, dataclasses.replace(f32, attn_impl="dense"),
                        r.prompt)
        if not torch.allclose(a, b, rtol=F32_TOL, atol=F32_TOL):
            raise AssertionError(f"f32 2-layer prompt {len(r.prompt)}: "
                                 f"logits differ from the plain attention")
        worst = max(worst, float((a - b).abs().max()))
    outs = []
    for c in (f32, dataclasses.replace(f32, attn_impl="dense")):
        run = fresh(reqs)
        ServingEngine(c, params, slots=LM_SLOTS, max_seq=LM_MAX_SEQ).run(run)
        check_served("f32 2-layer", c, run)
        outs.append([r.output for r in run])
    if outs[0] != outs[1]:
        raise AssertionError("f32 2-layer: greedy tokens differ from the "
                             "plain attention")
    log(f"  full width, 2 layers, f32: prefill logits within {F32_TOL} of "
        f"the plain attention (max abs err {worst:.3g}); greedy tokens of "
        f"{len(reqs)} requests equal")
    del params
    torch.cuda.empty_cache()

    small = dataclasses.replace(reduce_config(lm_full), attn_impl="flash")
    params = materialize(lm.param_specs(small), torch.Generator().manual_seed(
        2), device="cpu")
    reqs = lm_requests(small, (5, 17, 70, 130), 8, seed=2)
    outs = []
    for d in (dev, "cpu"):
        run = fresh(reqs)
        ServingEngine(small, params, slots=2, max_seq=256, device=d).run(run)
        check_served(f"reduced on {d}", small, run)
        outs.append([r.output for r in run])
    if outs[0] != outs[1]:
        raise AssertionError("reduced llama3.2-3b: card tokens differ from "
                             "the CPU run")
    log("  reduced llama3.2-3b: card tokens equal to the CPU run of the same "
        "engine")

    # -- 6b. w8a8 serving with the int8 KV cache; gemma-7b and yi-34b ------
    log("phase 6b: w8 weights with the int8 KV cache (matmul_ws int8), "
        "gemma-7b and yi-34b at full width")

    def w8_cfg(c):
        return dataclasses.replace(c, kv_cache_dtype="int8",
                                   kv_cache_scale=W8_KV_SCALE)

    W8_PARTS = ("matmul_ws mma", "matmul_ws stream", "matmul_ws scalar",
                "flash_attention", "cuBLAS", "the rest")

    def w8_part(kernel, *_):
        """The label of a device event in a w8 admit or decode step:
        matmul_ws's mma, stream and scalar forms, flash_attention, cuBLAS
        (the einsums: bf16 GEMMs and logits, the decode attention's f32
        contractions; by kernel-name fragments, ``nvjet`` among them) and
        the rest (the int8 cache's f32 upcasts, quantization, norms,
        elementwise)."""
        return ("matmul_ws mma" if "mm_imma_kernel" in kernel else
                "matmul_ws scalar" if "matmul_ws_kernel" in kernel else
                "matmul_ws stream" if "mm_stream" in kernel
                or "mm_split_reduce" in kernel else
                "flash_attention" if "flash_" in kernel else
                "cuBLAS" if any(t in kernel for t in (
                    "gemm", "gemv", "cutlass", "xmma", "nvjet"))
                else "the rest")

    def median_step(eng):
        """The median decode step with the most slots busy, and that
        count."""
        busy = max(b for b, _ in eng.step_ms)
        return float(np.median([ms for b, ms in eng.step_ms
                                if b == busy])), busy

    def w8_against_bf16(name, w8_params, c8, bf_params, c, prompts):
        """Relative L2 and top-1 agreement of w8 prefill logits against
        the bf16 model of the same weights (a diagnostic, no limit)."""
        rels, same = [], 0
        for prompt in prompts:
            a = last_logits(w8_params, c8, prompt)
            b = last_logits(bf_params, c, prompt)
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: w8 prefill logits not finite")
            rels.append(float((a - b).norm() / b.norm()))
            same += int(a.argmax()) == int(b.argmax())
        log(f"  {name} against bf16 of the same weights (diagnostic): "
            f"prefill logits' relative L2 {min(rels):.4f}–{max(rels):.4f}, "
            f"top-1 equal on {same} of {len(prompts)} prompts")

    def equal_to_plain_gemms(name, params_, c, prompts):
        """Prefill logits with the matmul_ws kernel and with
        ``matmul_ws_plain`` in its place: the int8 GEMMs are exact, so
        nothing may differ."""
        for prompt in prompts:
            a = last_logits(params_, c, prompt)
            kops._matmul_kernel = matmul_ws_plain
            try:
                b = last_logits(params_, c, prompt)
            finally:
                kops._matmul_kernel = matmul_ws
            if not torch.equal(a, b):
                raise AssertionError(f"{name} prompt {len(prompt)}: prefill "
                                     f"logits differ from matmul_ws_plain's "
                                     f"(max abs {float((a - b).abs().max())})")
        log(f"  {name}: prefill logits torch.equal to the same prefill with "
            f"matmul_ws_plain in the kernel's place, {len(prompts)} prompts")

    # llama3.2-3b as published, w8 + int8 KV, phase 6's requests
    t0 = time.perf_counter()
    params = materialize(lm.param_specs(cfg), torch.Generator(
        device=dev).manual_seed(0), device=dev)     # phase 6's weights
    bf = lm.compute_params(params, cfg)
    q = quantize_weights(params, lm.param_specs(cfg))
    del params
    cfg8 = w8_cfg(cfg)
    w8_engine = TimedEngine(cfg8, q, slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    del q
    torch.cuda.synchronize()
    log(f"  {cfg.name} w8: weights quantized per layer on the card in "
        f"{time.perf_counter() - t0:.1f} s; int8 KV cache at scale "
        f"{W8_KV_SCALE}, attn_impl='flash'")
    reqs = lm_requests(cfg, LM_PROMPTS, LM_NEW_TOKENS, seed=0)
    last_logits(w8_engine.params, cfg8, reqs[0].prompt)     # warm-up
    wall = serve_held(f"{cfg.name} w8", w8_engine, cfg8, reqs,
                      layer_gemms(cfg8, w8=True), cfg8.num_layers, torch.int8)
    log_admits(cfg.name, w8_engine, reqs, xla_admit_ms, "bf16 (phase 6, xla)")
    log(f"  {cfg.name} w8 decode: median %.2f ms a step with %d slots "
        f"busy, bf16 (phase 6, xla) {float(np.median(xla_step_ms)):.2f} ms"
        % median_step(w8_engine))
    log_decode(w8_engine, reqs, wall)
    prompts = [r.prompt for r in reqs]
    equal_to_plain_gemms(f"{cfg.name} w8", w8_engine.params, cfg8, prompts)
    w8_against_bf16(f"{cfg.name} w8", w8_engine.params, cfg8, bf, cfg,
                    prompts)
    for r in reqs[:LM_SLOTS]:                # four busy slots again
        w8_engine.admit(fresh([r])[0])
    log_split(f"{cfg.name} w8 decode step, {LM_SLOTS} slots", w8_engine.step,
              w8_part, W8_PARTS)
    log_split(f"{cfg.name} w8 prefill of {len(longest)} tokens",
              lambda: last_logits(w8_engine.params, cfg8, longest),
              w8_part, W8_PARTS)
    log_split(f"{cfg.name} bf16 prefill of {len(longest)} tokens",
              lambda: last_logits(bf, cfg, longest), w8_part, W8_PARTS)
    del w8_engine, bf
    torch.cuda.empty_cache()

    # gemma-7b at full width: bf16 with the D = 256 flash kernel, then w8
    gemma = dataclasses.replace(get_config(GEMMA_ARCH), attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(lm.param_specs(gemma), torch.Generator(
        device=dev).manual_seed(4), device=dev)
    q = quantize_weights(params, lm.param_specs(gemma))
    bf = lm.compute_params(params, gemma)
    del params                               # q keeps the f32 embedding
    g_engine = TimedEngine(gemma, bf, slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    torch.cuda.synchronize()
    log(f"  {gemma.name}: {param_count(gemma) / 1e9:.2f} B parameters "
        f"({gemma.num_layers} layers, d_model {gemma.d_model}, "
        f"{gemma.num_heads}/{gemma.num_kv_heads} heads of "
        f"{gemma.head_dim}, d_ff {gemma.d_ff}, vocab {gemma.vocab_size}), "
        f"drawn in f32 from seed 4, quantized and cast to bf16 in "
        f"{time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated")
    if kernel_variant(torch.bfloat16, gemma.head_dim) != "wgmma":
        raise AssertionError(f"{gemma.name}: D = {gemma.head_dim} is not "
                             f"on the wgmma attention kernel")
    reqs = lm_requests(gemma, LM_PROMPTS, LM_NEW_TOKENS, seed=4)
    last_logits(bf, gemma, reqs[0].prompt)                  # warm-up
    wall = serve_held(f"{gemma.name} bf16", g_engine, gemma, reqs,
                      flash=gemma.num_layers)
    g_admit = dict(g_engine.admit_ms)
    g_step = median_step(g_engine)
    log_admits(gemma.name, g_engine, reqs, {}, "")
    log_decode(g_engine, reqs, wall)
    bound = gemma.num_layers * 2.0 ** -7     # as phase 6, one ulp a layer
    worst = 0.0
    plain_gemma = dataclasses.replace(gemma, attn_impl="dense")
    for r in reqs:
        a = last_logits(bf, gemma, r.prompt)
        b = last_logits(bf, plain_gemma, r.prompt)
        rel = float((a - b).norm() / b.norm())
        if not bool(torch.isfinite(a).all()) or rel > bound:
            raise AssertionError(f"{gemma.name} prompt {len(r.prompt)}: "
                                 f"prefill logits off the plain attention's "
                                 f"by {rel:.4g} (bound {bound:.4g})")
        worst = max(worst, rel)
    log(f"  {gemma.name} bf16 prefill logits against attn_impl='dense': "
        f"relative L2 at most {worst:.4g} over {len(reqs)} prompts (bound "
        f"{bound:.4g}); D = {gemma.head_dim} flash_attention, one launch a "
        f"layer a prefill")
    del g_engine
    gemma8 = w8_cfg(gemma)
    g8_engine = TimedEngine(gemma8, q, slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    del q
    g8_reqs = [r for r in lm_requests(gemma, LM_PROMPTS, LM_NEW_TOKENS,
                                      seed=4)
               if len(r.prompt) in GEMMA_W8_PROMPTS]
    last_logits(g8_engine.params, gemma8, reqs[0].prompt)    # warm-up
    wall = serve_held(f"{gemma.name} w8", g8_engine, gemma8, g8_reqs,
                      layer_gemms(gemma8, w8=True), gemma8.num_layers,
                      torch.int8)
    log_admits(f"{gemma.name} w8", g8_engine, g8_reqs, g_admit, "bf16")
    log(f"  {gemma.name} w8 decode: median %.2f ms a step with %d slots "
        f"busy, bf16 %.2f ms with %d" % (median_step(g8_engine) + g_step))
    equal_to_plain_gemms(f"{gemma.name} w8", g8_engine.params, gemma8,
                         [r.prompt for r in g8_reqs])
    w8_against_bf16(f"{gemma.name} w8", g8_engine.params, gemma8, bf, gemma,
                    [r.prompt for r in g8_reqs])
    log(f"  {gemma.name}: peak {torch.cuda.max_memory_allocated() / 1e9:.1f}"
        f" GB allocated over the part")
    del g8_engine, bf
    torch.cuda.empty_cache()

    # yi-34b at full width and depth, w8 + int8 KV: drawn and quantized one
    # layer group at a time, so no f32 or bf16 copy of the model is held
    yi = w8_cfg(dataclasses.replace(get_config(YI_ARCH), attn_impl="flash"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    specs = lm.param_specs(yi)
    group = {f"b{i}": block_specs(yi, k)
             for i, k in enumerate(yi.layer_pattern)}
    one_specs = {"blocks": stack_specs(group, 1)}
    yq = {"blocks": tree_map(
        lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                              device=dev),
        quantize_weight_specs(specs)["blocks"])}
    ygen = torch.Generator(device=dev).manual_seed(5)
    for g_ in range(yi.num_groups_scan):
        one = quantize_weights(
            {"blocks": materialize(one_specs["blocks"], ygen, device=dev)},
            one_specs)
        tree_map(lambda dst, src: dst[g_:g_ + 1].copy_(src), yq["blocks"],
                 one["blocks"])
        del one
    for k in ("embedding", "final_norm"):
        yq[k] = materialize(specs[k], ygen, device=dev)
    y_engine = TimedEngine(yi, yq, slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    del yq
    torch.cuda.synchronize()

    def nbytes(tree):
        sizes = []
        tree_map(lambda t: sizes.append(t.numel() * t.element_size()), tree)
        return sum(sizes)

    log(f"  {yi.name}: {param_count(yi) / 1e9:.2f} B parameters "
        f"({yi.num_layers} layers, d_model {yi.d_model}, {yi.num_heads}/"
        f"{yi.num_kv_heads} heads, d_ff {yi.d_ff}, vocab {yi.vocab_size}), "
        f"drawn from seed 5 and quantized one layer group at a time in "
        f"{time.perf_counter() - t0:.1f} s; resident: weights "
        f"{nbytes(y_engine.params) / 1e9:.2f} GB (int8 blocks, bf16 "
        f"embeddings), int8 KV cache {nbytes(y_engine.cache) / 1e9:.2f} GB; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated")
    y_reqs = lm_requests(yi, YI_PROMPTS, LM_NEW_TOKENS, seed=5)
    last_logits(y_engine.params, yi, y_reqs[0].prompt)       # warm-up
    wall = serve_held(f"{yi.name} w8", y_engine, yi, y_reqs,
                      layer_gemms(yi, w8=True), yi.num_layers, torch.int8)
    log_admits(yi.name, y_engine, y_reqs, {}, "")
    log_decode(y_engine, y_reqs, wall)
    log(f"  {yi.name} w8 decode: median %.2f ms a step with %d slots busy"
        % median_step(y_engine))
    equal_to_plain_gemms(f"{yi.name} w8", y_engine.params, yi,
                         [y_reqs[0].prompt])
    log(f"  {yi.name}: peak {torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"GB allocated over the part")
    del y_engine
    torch.cuda.empty_cache()

    # the reduced w8 models: the card's tokens equal the CPU run's
    for arch in (LM_ARCH, GEMMA_ARCH, YI_ARCH):
        small = w8_cfg(dataclasses.replace(reduce_config(get_config(arch)),
                                           num_layers=2, attn_impl="flash"))
        sp = quantize_weights(materialize(
            lm.param_specs(small), torch.Generator().manual_seed(6),
            device="cpu"), lm.param_specs(small))
        reqs = lm_requests(small, (5, 17, 70, 130), 8, seed=6)
        outs = []
        for d in (dev, "cpu"):
            run = fresh(reqs)
            ServingEngine(small, sp, slots=2, max_seq=256, device=d).run(run)
            check_served(f"reduced w8 {arch} on {d}", small, run)
            outs.append([r.output for r in run])
        if outs[0] != outs[1]:
            raise AssertionError(f"reduced w8 {arch}: card tokens differ "
                                 f"from the CPU run")
    log("  reduced w8 llama3.2-3b, gemma-7b and yi-34b (2 layers, int8 KV): "
        "card tokens equal to the CPU run of the same engine")

    # -- 6c. the hybrid and attention-free LMs at full width ----------------
    log("phase 6c: recurrentgemma-9b (RG-LRU + local attention) and "
        "rwkv6-1.6b at full width")
    t_phase = time.perf_counter()
    mem_note("phase 6c's entry")

    RG_PARTS = ("bf16 GEMMs", "f32 gate GEMMs", "RG-LRU scan",
                "chunked attention", "logits (f32)", "the rest",
                "linked to no op")
    RG_RANGES = {(rglru_lib, "_gates"): "gates",
                 (rglru_lib, "linear_scan"): "RG-LRU scan",
                 (attn_lib, "chunked_attention"): "chunked attention",
                 (lm, "logits"): "logits (f32)"}
    MM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")

    def rg_part(kernel, op, scope, _):
        """The part of a recurrentgemma prefill (xla backend) that a
        device event belongs to, from the op that launched it and the
        ``RG_RANGES`` range around that op: a GEMM op in the gates is an
        f32 gate GEMM, one outside every range a bf16 GEMM (on xla every
        other GEMM of a layer is a bf16 einsum); the rest of each range is
        its part, except the gates' elementwise work, which is the
        rest."""
        if op is None:
            return "linked to no op"
        if scope == "gates":
            return "f32 gate GEMMs" if op.name in MM_OPS else "the rest"
        if scope is not None:
            return scope
        return "bf16 GEMMs" if op.name in MM_OPS else "the rest"

    # recurrentgemma-9b as published, drawn in bf16 (f32 weights alone are
    # 37.6 GB), on xla and then pallas_ws with the same weights
    rg = dataclasses.replace(get_config(RG_ARCH), attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(lm.param_specs(rg), torch.Generator(
        device=dev).manual_seed(7), device=dev, dtype_override="bfloat16")
    rg_engine = TimedEngine(rg, params, slots=LM_SLOTS,
                            max_seq=HYBRID_MAX_SEQ)
    del params
    torch.cuda.synchronize()
    log(f"  {rg.name}: {param_count(rg) / 1e9:.2f} B parameters "
        f"({rg.num_layers} layers: {rg.num_groups_scan} × "
        f"{'/'.join(rg.layer_pattern)} + {'/'.join(rg.tail_blocks)}; "
        f"d_model {rg.d_model}, {rg.num_heads}/{rg.num_kv_heads} heads of "
        f"{rg.head_dim}, rnn_width {rg.rnn_width}, d_ff {rg.d_ff} GeGLU, "
        f"vocab {rg.vocab_size}, window {rg.attention_window}), drawn in "
        f"bf16 on the card from seed 7 in {time.perf_counter() - t0:.1f} s;"
        f" resident {nbytes(rg_engine.params) / 1e9:.2f} GB of weights, "
        f"{nbytes(rg_engine.cache) / 1e6:.1f} MB of cache ({LM_SLOTS} slots, "
        f"a {min(HYBRID_MAX_SEQ, rg.attention_window)}-slot ring a local "
        f"layer)")
    reqs = lm_requests(rg, HYBRID_PROMPTS, LM_NEW_TOKENS, seed=7)
    last_logits(rg_engine.params, rg, reqs[0].prompt)        # warm-up
    wall = serve_held(f"{rg.name} xla", rg_engine, rg, reqs)
    rg_admit = dict(rg_engine.admit_ms)
    log_admits(rg.name, rg_engine, reqs, {}, "")
    log_decode(rg_engine, reqs, wall)
    log(f"  {rg.name} decode: median %.2f ms a step with %d slots busy"
        % median_step(rg_engine))
    rg_longest = max((r.prompt for r in reqs), key=len)
    log_busy(rg_engine, rg, reqs, rg_longest)
    log_split(f"{rg.name} prefill of {len(rg_longest)} tokens (xla)",
              lambda: last_logits(rg_engine.params, rg, rg_longest),
              rg_part, RG_PARTS, ranges=RG_RANGES)
    log(f"  {rg.name}: peak {torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"GB allocated")

    rg_ws = dataclasses.replace(rg, gemm_backend="pallas_ws")
    ws_engine = TimedEngine(rg_ws, rg_engine.params, slots=LM_SLOTS,
                            max_seq=HYBRID_MAX_SEQ)
    last_logits(ws_engine.params, rg_ws, reqs[0].prompt)     # warm-up
    wreqs = fresh(reqs)
    wall = serve_held(f"{rg.name} pallas_ws", ws_engine, rg_ws, wreqs,
                      layer_gemms(rg))
    log_admits(f"{rg.name} pallas_ws", ws_engine, wreqs, rg_admit, "xla")
    log(f"  {rg.name} pallas_ws decode: median %.2f ms a step with %d slots "
        f"busy" % median_step(ws_engine))
    log_decode(ws_engine, wreqs, wall)
    log_busy(ws_engine, rg_ws, wreqs, rg_longest)
    ws_against_xla(rg.name, ws_engine, rg_ws, rg_engine, rg, reqs, wreqs)
    del rg_engine, ws_engine
    torch.cuda.empty_cache()

    # the ring and the recurrent state at the real width: one R,R,A group
    # and the R,R tail in f32, a prompt past the window (the ring rolled by
    # 512, decode writing from slot 512) and decode steps, against
    # forward_train's logits at the same positions; forward_train runs on
    # a 512-multiple length, whose first positions are the same sequence
    # (the model is causal)
    rg5 = dataclasses.replace(get_config(RG_ARCH), num_layers=5,
                              compute_dtype="float32")
    params = materialize(lm.param_specs(rg5), torch.Generator(
        device=dev).manual_seed(8), device=dev)
    n_total = -(-(RG_CHECK_PROMPT + RG_CHECK_STEPS) // 512) * 512
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, rg5.vocab_size, n_total), dtype=torch.long, device=dev)[None]
    with torch.no_grad():
        full, _ = lm.forward_train(params, {"tokens": toks}, rg5)
        got = []
        lg, cache = lm.prefill(params, {"tokens": toks[:, :RG_CHECK_PROMPT]},
                               rg5, cache_len=RG_CHECK_PROMPT
                               + RG_CHECK_STEPS + 1)
        got.append(lg)
        for j in range(RG_CHECK_STEPS):
            p = RG_CHECK_PROMPT + j
            lg, cache = lm.decode_step(params, rg5, token=toks[:, p],
                                       pos=torch.full((1,), p, device=dev),
                                       cache=cache)
            got.append(lg)
    worst = 0.0
    for j, lg in enumerate(got):
        want = full[:, RG_CHECK_PROMPT - 1 + j]
        if not torch.allclose(lg, want, rtol=RG_CHECK_TOL, atol=RG_CHECK_TOL):
            raise AssertionError(
                f"{rg5.name} 5 layers f32: position "
                f"{RG_CHECK_PROMPT - 1 + j} off forward_train by "
                f"{float((lg - want).abs().max()):.4g}")
        worst = max(worst, float((lg - want).abs().max()))
    log(f"  {rg5.name} at full width, 5 layers (R,R,A + R,R), f32: a "
        f"{RG_CHECK_PROMPT}-token prefill (the {rg5.attention_window}-slot "
        f"ring rolled by {RG_CHECK_PROMPT % rg5.attention_window}) and "
        f"{RG_CHECK_STEPS} decode steps within {RG_CHECK_TOL} of "
        f"forward_train's logits (max abs err {worst:.3g}, logits up to "
        f"{float(full.abs().max()):.3g})")
    del params, full, cache, got
    torch.cuda.empty_cache()

    # rwkv6-1.6b as published: no kernel on its path (its GEMMs pass no
    # backend in the reference), served once on xla
    rw = get_config(RWKV_ARCH)
    t0 = time.perf_counter()
    params = materialize(lm.param_specs(rw), torch.Generator(
        device=dev).manual_seed(9), device=dev)
    rw_engine = TimedEngine(rw, params, slots=LM_SLOTS,
                            max_seq=HYBRID_MAX_SEQ)
    del params
    torch.cuda.synchronize()
    log(f"  {rw.name}: {param_count(rw) / 1e9:.2f} B parameters "
        f"({rw.num_layers} layers, d_model {rw.d_model}, "
        f"{rw.d_model // rw.rwkv_head_size} heads of {rw.rwkv_head_size}, "
        f"d_ff {rw.d_ff}, vocab {rw.vocab_size}, {rw.norm}), drawn on the "
        f"card from seed 9 in {time.perf_counter() - t0:.1f} s; state "
        f"{nbytes(rw_engine.cache) / 1e6:.1f} MB for {LM_SLOTS} slots")
    rw_reqs = lm_requests(rw, HYBRID_PROMPTS, LM_NEW_TOKENS, seed=9)
    last_logits(rw_engine.params, rw, rw_reqs[0].prompt)     # warm-up
    wall = serve_held(f"{rw.name} xla", rw_engine, rw, rw_reqs)
    log_admits(rw.name, rw_engine, rw_reqs, {}, "")
    log_decode(rw_engine, rw_reqs, wall)
    log(f"  {rw.name} decode: median %.2f ms a step with %d slots busy"
        % median_step(rw_engine))
    log_busy(rw_engine, rw, rw_reqs,
             max((r.prompt for r in rw_reqs), key=len))
    # the reference's own cross-check, on one layer's real inputs: the
    # chunked wkv6 of a prefill against the sequential recurrence, in f32
    seen_wkv = []
    chunked = rwkv_lib.wkv6_chunked

    def record(*a, **k):
        seen_wkv.append(a)
        return chunked(*a, **k)
    rwkv_lib.wkv6_chunked = record
    try:
        last_logits(rw_engine.params, rw, np.random.default_rng(10)
                    .integers(0, rw.vocab_size, RWKV_CHECK_SEQ))
    finally:
        rwkv_lib.wkv6_chunked = chunked
    r_, k_, v_, lw_, u_ = seen_wkv[0]
    with torch.no_grad():
        o1, s1 = rwkv_lib.wkv6_chunked(r_, k_, v_, lw_, u_)
        o2, s2 = rwkv_lib.wkv6_recurrent(r_, k_, v_, lw_, u_)
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in ((o1, o2), (s1, s2)))
    if not (r_.dtype == torch.float32 and rel <= F32_TOL):
        raise AssertionError(f"{rw.name}: wkv6_chunked off wkv6_recurrent by "
                             f"{rel:.3g} of the largest magnitude at S = "
                             f"{RWKV_CHECK_SEQ} ({r_.dtype})")
    log(f"  {rw.name} layer 0's wkv6 inputs at S = {RWKV_CHECK_SEQ} "
        f"(r, k, v, log w [1,{RWKV_CHECK_SEQ},{r_.shape[2]},{r_.shape[3]}] "
        f"f32): wkv6_chunked against wkv6_recurrent, output and state within "
        f"{rel:.3g} of their largest magnitude (limit {F32_TOL})")
    del rw_engine
    torch.cuda.empty_cache()

    # the reduced models: the card's tokens equal the CPU run's
    for arch, backend in ((RG_ARCH, "pallas_ws"), (RWKV_ARCH, "xla")):
        small = reduce_config(get_config(arch))
        small = dataclasses.replace(small, num_layers=max(small.num_layers,
                                                          2),
                                    attn_impl="flash", gemm_backend=backend)
        sp = materialize(lm.param_specs(small), torch.Generator()
                         .manual_seed(11), device="cpu")
        reqs = lm_requests(small, (5, 17, 70, 130), 8, seed=11)
        outs = []
        for d in (dev, "cpu"):
            run = fresh(reqs)
            ServingEngine(small, sp, slots=2, max_seq=256, device=d).run(run)
            check_served(f"reduced {arch} on {d}", small, run)
            outs.append([r.output for r in run])
        if outs[0] != outs[1]:
            raise AssertionError(f"reduced {arch}: card tokens differ from "
                                 f"the CPU run")
    log("  reduced recurrentgemma-9b (5 layers, pallas_ws) and rwkv6-1.6b (2 "
        "layers): card tokens equal to the CPU run of the same engine")
    log(f"  phase 6c: {time.perf_counter() - t_phase:.1f} s")

    # -- 6d. the MoE, VLM and encoder-decoder LMs at full width -------------
    log("phase 6d: deepseek-moe-16b, qwen3-moe-30b-a3b, internvl2-26b and "
        "seamless-m4t-medium at full width")
    t_phase = time.perf_counter()
    mem_note("phase 6d's entry")

    def draw_bf16(c, seed):
        """``c``'s weights drawn in bf16 on the card from ``seed`` (the
        peak memory counted from here) → (params, seconds)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p = materialize(lm.param_specs(c), torch.Generator(
            device=dev).manual_seed(seed), device=dev,
            dtype_override="bfloat16")
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0

    def describe(c, params, secs, seed):
        moe_txt = ("" if c.moe is None else
                   f", {c.moe.num_experts} experts top-{c.moe.top_k} + "
                   f"{c.moe.num_shared} shared of {c.moe.expert_ff}")
        enc_txt = (f" + {c.encoder_layers} encoder layers"
                   if c.kind == "encdec" else "")
        log(f"  {c.name}: {param_count(c) / 1e9:.2f} B parameters "
            f"({c.num_layers} layers{enc_txt}, d_model {c.d_model}, "
            f"{c.num_heads}/{c.num_kv_heads} heads of {c.head_dim}, d_ff "
            f"{c.d_ff}{moe_txt}, vocab {c.vocab_size}), drawn in bf16 on "
            f"the card from seed {seed} in {secs:.1f} s; resident "
            f"{nbytes(params) / 1e9:.2f} GB of weights")

    def log_peak(name):
        log(f"  {name}: peak {torch.cuda.max_memory_allocated() / 1e9:.1f} "
            f"GB allocated")

    def with_drops(run):
        """``run()`` with each MoE layer's routing recorded → (its
        result, {a one-group prefill's tokens, or the decode steps:
        (choices dropped by capacity, choices routed, the busiest
        expert's share of a layer's choices at most)})."""
        seen = []
        real = moe_lib.route

        def record(router, xg, m, capacity, **kw):
            r = real(router, xg, m, capacity, **kw)
            seen.append((xg.shape[0], xg.shape[1], r.keep, r.gate_idx,
                         m.num_experts))
            return r
        moe_lib.route = record
        try:
            out = run()
        finally:
            moe_lib.route = real
        by = {}
        for g, tg, keep, idx, e in seen:
            key = f"prefill {tg}" if g == 1 else f"decode ({g}×{tg})"
            d, n, top = by.get(key, (0, 0, 0.0))
            load = torch.bincount(idx.flatten(), minlength=e)
            by[key] = (d + int((~keep).sum()), n + keep.numel(),
                       max(top, float(load.max()) / idx.numel()))
        return out, by

    def log_drops(name, by):
        log(f"  {name}: routed (token, expert) choices dropped by capacity, "
            f"over all layers (and the busiest expert's share of one "
            f"layer's choices, at most): " + ", ".join(
                f"{k} {100 * d / n:.2f}% ({d:,} of {n:,}; {100 * top:.1f}%)"
                for k, (d, n, top) in by.items()))

    MOE_PARTS = ("expert GEMMs", "MoE router", "MoE dispatch and combine",
                 "flash_attention", "matmul_ws", "chunked attention",
                 "other GEMMs", "logits (f32)", "the rest", "linked to no op")
    MOE_RANGES = {(blocks_lib, "apply_moe"): "MoE",
                  (moe_lib, "route"): "MoE router",
                  (attn_lib, "chunked_attention"): "chunked attention",
                  (lm, "logits"): "logits (f32)"}

    def moe_part(kernel, op, scope, _):
        """The part of an MoE model's prefill or decode step that a device
        event belongs to: the two kernels by name; inside the MoE layer
        (``blocks.apply_moe``, the shared experts included) its GEMM ops
        and the rest (gathers, the scatter-min, the activation, the f32
        combine), the router apart; outside, the chunked attention, the
        logits, the other GEMMs (projections) and the rest."""
        if "flash_" in kernel:
            return "flash_attention"
        if is_mm_kernel(kernel):
            return "matmul_ws"
        if op is None:
            return "linked to no op"
        if scope == "MoE":
            return ("expert GEMMs" if op.name in MM_OPS
                    else "MoE dispatch and combine")
        if scope is not None:
            return scope
        return "other GEMMs" if op.name in MM_OPS else "the rest"

    def batch_len(batch):
        """The positions of a batch: its patches, then its tokens."""
        return batch["tokens"].shape[1] + (
            batch["patches"].shape[1] if "patches" in batch else 0)

    def batch_logits(params, c, batch, cache_len=None):
        """Last-token prefill logits (f32) and the cache of one batch
        ({"tokens", "patches" / "frames"}) on the card."""
        with torch.no_grad():
            lg, cache = lm.prefill(params, batch, c, cache_len=cache_len)
        return lg[0].float(), cache

    def launches_per_forward(c, gemms):
        """(flash_attention launches of a prefill, matmul_ws launches of
        a prefill's forward) for ``c``: a causal self-attention layer
        each, plus the encoder's and the cross attention's full ones; the
        ``gemms`` (a layer's matmul_ws calls) in every decoder and encoder
        layer."""
        layers = c.num_layers + (c.encoder_layers if c.kind == "encdec"
                                 else 0)
        flash = (layers + (c.num_layers if c.kind == "encdec" else 0)
                 if c.attn_impl == "flash" else 0)
        return flash, len(gemms) * layers

    def against_plain(name, params, c, batches, launches):
        """Last-token prefill logits of ``c`` against the plain attention
        and plain GEMMs (attn_impl="dense", gemm_backend="xla") on the
        same weights.  Each kernel output may move by one bf16 ulp (2^-7
        relative at most) between a kernel and its plain version; the
        ``launches`` of a forward add at most linearly unless the network
        amplifies them, as phase 6 derives."""
        plain = dataclasses.replace(c, attn_impl="dense", gemm_backend="xla")
        bound = launches * 2.0 ** -7
        worst = 0.0
        for batch in batches:
            a, _ = batch_logits(params, c, batch)
            b, _ = batch_logits(params, plain, batch)
            rel = float((a - b).norm() / b.norm())
            if not bool(torch.isfinite(a).all()) or rel > bound:
                raise AssertionError(f"{name}: prefill logits off the plain "
                                     f"attention and GEMMs by {rel:.4g} "
                                     f"(bound {bound:.4g})")
            worst = max(worst, rel)
        log(f"  {name}: prefill last-token logits against attn_impl="
            f"'dense' + gemm_backend='xla': relative L2 at most {worst:.4g} "
            f"over {len(batches)} prefills (bound {launches} × 2^-7 = "
            f"{bound:.4g})")
        return worst

    def held_prefill(name, params, c, batch, want):
        """One prefill with every ``matmul_ws`` call held to
        ``matmul_ws_plain`` on its operands (``check_mm``: the form
        ``mm_path`` names, within ``bf16_gemm_bound``) and every
        ``flash_attention`` call to ``flash_attention_plain`` (within one
        bf16 ulp + BF16_ATOL); ``want`` the calls of each kernel."""
        held = collections.Counter()

        def hold_mm(x, w, bias=None):
            path, _, got = check_mm(x, w, bias)
            held[f"matmul_ws {path}"] += 1
            return got

        def hold_flash(q, k, v, *, causal=True, **_):
            got = flash_attention(q, k, v, causal=causal)
            want_ = flash_attention_plain(q, k, v, causal=causal)
            err_t = (got.float() - want_.float()).abs()
            if not bool((err_t <= bf16_ulp(want_) + BF16_ATOL).all()):
                raise AssertionError(f"{name}: flash_attention "
                                     f"{tuple(q.shape)} causal={causal} off "
                                     f"its plain version by "
                                     f"{float(err_t.max()):.4g}")
            st = stats["flash_attention"]
            st["max_abs_err"] = max(st["max_abs_err"], float(err_t.max()))
            held[f"flash_attention causal={causal}"] += 1
            return got
        kops._matmul_kernel, kops.flash_attention = hold_mm, hold_flash
        try:
            batch_logits(params, c, batch)
        finally:
            kops._matmul_kernel, kops.flash_attention = (matmul_ws,
                                                         flash_attention)
        got = {k: sum(v for n, v in held.items() if n.startswith(k))
               for k in want}
        if got != want:
            raise AssertionError(f"{name}: held calls {dict(held)}, "
                                 f"expected {want}")
        log(f"  {name}: one prefill's calls {dict(held)} each held to its "
            f"plain version on its own operands (matmul_ws within "
            f"bf16_gemm_bound, flash_attention within one bf16 ulp + "
            f"{BF16_ATOL})")

    def direct_run(name, params, c, batch, steps, gemms):
        """The main path without the engine: one prefill of ``batch`` and
        ``steps`` decode steps (the greedy tokens fed back), the counts
        reset just before and held to ``launches_per_forward``; the
        prefill's busy share → the prefill's and the steps' logits."""
        flash, mm = launches_per_forward(c, gemms)
        s_total = batch_len(batch)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        lg, cache = batch_logits(params, c, batch,
                                 cache_len=s_total + steps)
        torch.cuda.synchronize()
        pre_ms = 1e3 * (time.perf_counter() - t0)
        out, tok = [lg], lg.argmax()[None]
        t0 = time.perf_counter()
        with torch.no_grad():
            for j in range(steps):
                step_lg, cache = lm.decode_step(
                    params, c, token=tok, pos=torch.full(
                        (1,), s_total + j, device=dev), cache=cache)
                tok = step_lg.argmax(-1)
                out.append(step_lg[0].float())
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        seen = counts()
        want = {k: 0 for k in wrappers}
        want["flash_attention"] = flash
        want["matmul_ws"] = mm + steps * len(gemms) * c.num_layers
        if seen != want or not all(bool(torch.isfinite(t).all())
                                   for t in out):
            raise AssertionError(f"{name}: launches {seen}, expected "
                                 f"{want}, or logits not finite")
        for k in ("matmul_ws", "flash_attention"):
            stats[k]["launches"] += seen[k]
        credit_forms()
        wall, busy, n = device_busy(lambda: batch_logits(params, c, batch))
        share = ("device time not measured (no device events in the trace)"
                 if busy is None else f"device busy {busy:.1f} ms = "
                 f"{100 * busy / wall:.0f}% of {wall:.1f} ms")
        log(f"  {name}: prefill of {s_total} positions {pre_ms:.1f} ms "
            f"({n} device events under torch.profiler, {share}), {steps} "
            f"decode steps {step_ms:.2f} ms a step; launches {seen} "
            f"({flash} flash_attention and {mm} matmul_ws a prefill, "
            f"{len(gemms) * c.num_layers} matmul_ws a step)")
        return out

    def plain_steps(name, params, c, batch, out, steps, launches):
        """The same prefill and decode steps under the plain attention
        and GEMMs, fed the kernel run's tokens: each step's logits within
        the ``against_plain`` bound."""
        plain = dataclasses.replace(c, attn_impl="dense", gemm_backend="xla")
        s_total = batch_len(batch)
        bound = launches * 2.0 ** -7
        lg, cache = batch_logits(params, plain, batch,
                                 cache_len=s_total + steps)
        rels = [float((out[0] - lg).norm() / lg.norm())]
        with torch.no_grad():
            for j in range(steps):
                tok = out[j].argmax()[None]
                lg, cache = lm.decode_step(
                    params, plain, token=tok, pos=torch.full(
                        (1,), s_total + j, device=dev), cache=cache)
                lg = lg[0].float()
                rels.append(float((out[j + 1] - lg).norm() / lg.norm()))
        if max(rels) > bound:
            raise AssertionError(f"{name}: logits off the plain attention "
                                 f"and GEMMs by {max(rels):.4g} (bound "
                                 f"{bound:.4g})")
        log(f"  {name}: the prefill's and {steps} decode steps' logits "
            f"against attn_impl='dense' + gemm_backend='xla' on the same "
            f"tokens: relative L2 {min(rels):.4g}–{max(rels):.4g} (bound "
            f"{launches} × 2^-7 = {bound:.4g})")

    def mlp_gemms(c, d_ff=None):
        f = d_ff or c.d_ff
        return [(c.d_model, f)] * 2 + [(f, c.d_model)]

    def serve_lm(c, params, reqs, gemms, ref=None):
        """Serve ``reqs`` on a new ``TimedEngine`` with any MoE routing
        recorded: launches held (``serve_held``), admits, decode, busy
        shares and dropped choices logged → the engine."""
        eng = TimedEngine(c, params, slots=LM_SLOTS, max_seq=HYBRID_MAX_SEQ)
        last_logits(eng.params, c, reqs[0].prompt)           # warm-up
        flash, _ = launches_per_forward(c, gemms)
        label = f"{c.name} {c.gemm_backend}+{c.attn_impl}"
        wall, by = with_drops(lambda: serve_held(
            label, eng, c, reqs, gemms, flash=flash))
        log_admits(label, eng, reqs, ref.admit_ms if ref else {},
                   "xla+chunked")
        log_decode(eng, reqs, wall)
        log(f"  {label} decode: median %.2f ms a step with %d slots busy"
            % median_step(eng))
        longest = max((r.prompt for r in reqs), key=len)
        log_busy(eng, c, reqs, longest)
        if by:
            log_drops(label, by)
            log_split(f"{label} decode step, {LM_SLOTS} slots", eng.step,
                      moe_part, MOE_PARTS, ranges=MOE_RANGES)
            log_split(f"{label} prefill of {len(longest)} tokens",
                      lambda: last_logits(eng.params, c, longest),
                      moe_part, MOE_PARTS, ranges=MOE_RANGES)
        return eng

    # deepseek-moe-16b: xla + chunked, then matmul_ws (its shared experts)
    # + flash_attention on the same weights
    ds = get_config(DS_ARCH)
    params, secs = draw_bf16(ds, 12)
    describe(ds, params, secs, 12)
    reqs = lm_requests(ds, HYBRID_PROMPTS, LM_NEW_TOKENS, seed=12)
    ds_x = dataclasses.replace(ds, attn_impl="chunked")
    x_engine = serve_lm(ds_x, params, reqs, ())
    ds_k = dataclasses.replace(ds, attn_impl="flash", gemm_backend="pallas_ws")
    shared = mlp_gemms(ds, ds.moe.num_shared * ds.moe.expert_ff)
    kreqs = fresh(reqs)
    k_engine = serve_lm(ds_k, x_engine.params, kreqs, shared, ref=x_engine)
    flash, mm = launches_per_forward(ds_k, shared)
    against_plain(f"{ds.name} pallas_ws+flash", k_engine.params, ds_k,
                  [{"tokens": torch.as_tensor(r.prompt, dtype=torch.long,
                                              device=dev)[None]}
                   for r in reqs], flash + mm)
    longest = max((r.prompt for r in reqs), key=len)
    held_prefill(f"{ds.name} pallas_ws+flash", k_engine.params, ds_k,
                 {"tokens": torch.as_tensor(longest, dtype=torch.long,
                                            device=dev)[None]},
                 {"matmul_ws": mm, "flash_attention": flash})
    same = sum(a == b for r, k in zip(reqs, kreqs)
               for a, b in zip(r.output, k.output))
    log(f"  {ds.name}: greedy tokens of the kernel run equal to the xla + "
        f"chunked run: {same} of {sum(len(r.output) for r in reqs)} "
        f"(counted, not required)")
    log_peak(ds.name)
    del params, x_engine, k_engine
    torch.cuda.empty_cache()

    # qwen3-moe-30b-a3b: 128 experts top-8, no shared expert, so no GEMM
    # reaches matmul_ws; the attention on flash_attention
    qw = dataclasses.replace(get_config(QWEN_ARCH), attn_impl="flash")
    params, secs = draw_bf16(qw, 13)
    describe(qw, params, secs, 13)
    reqs = lm_requests(qw, HYBRID_PROMPTS, LM_NEW_TOKENS, seed=13)
    q_engine = serve_lm(qw, params, reqs, ())
    del params
    flash, _ = launches_per_forward(qw, ())
    against_plain(f"{qw.name} flash", q_engine.params, qw,
                  [{"tokens": torch.as_tensor(r.prompt, dtype=torch.long,
                                              device=dev)[None]}
                   for r in reqs], flash)
    log_peak(qw.name)
    del q_engine
    torch.cuda.empty_cache()

    # internvl2-26b: 1024 patches + 3072 tokens through lm.prefill and 8
    # decode steps on matmul_ws + flash_attention; then the engine on text
    iv = dataclasses.replace(get_config(VLM_ARCH), attn_impl="flash",
                             gemm_backend="pallas_ws")
    params, secs = draw_bf16(iv, 14)
    describe(iv, params, secs, 14)
    g14 = torch.Generator(device=dev).manual_seed(14)
    vbatch = {"tokens": torch.randint(0, iv.vocab_size, (1, VLM_TOKENS),
                                      generator=g14, device=dev),
              "patches": torch.randn((1, iv.frontend_tokens,
                                      iv.frontend_dim), generator=g14,
                                     device=dev).bfloat16()}
    gemms = mlp_gemms(iv)
    flash, mm = launches_per_forward(iv, gemms)
    batch_logits(params, iv, vbatch)                          # warm-up
    out = direct_run(f"{iv.name} patches", params, iv, vbatch,
                           LM_DIRECT_STEPS, gemms)
    plain_steps(f"{iv.name} patches", params, iv, vbatch, out,
                LM_DIRECT_STEPS, flash + mm)
    held_prefill(f"{iv.name} patches", params, iv, vbatch,
                 {"matmul_ws": mm, "flash_attention": flash})
    reqs = lm_requests(iv, HYBRID_PROMPTS, LM_NEW_TOKENS, seed=14)
    v_engine = serve_lm(iv, params, reqs, gemms)
    del params, v_engine, vbatch
    log_peak(iv.name)
    torch.cuda.empty_cache()

    # seamless-m4t-medium: frames and tokens of one length, so the
    # encoder's and the cross attention's full attention run the kernel
    sm = dataclasses.replace(get_config(ENCDEC_ARCH), attn_impl="flash",
                             gemm_backend="pallas_ws")
    params, secs = draw_bf16(sm, 15)
    describe(sm, params, secs, 15)
    g15 = torch.Generator(device=dev).manual_seed(15)
    sbatch = {"tokens": torch.randint(0, sm.vocab_size, (1, ENCDEC_SEQ),
                                      generator=g15, device=dev),
              "frames": torch.randn((1, ENCDEC_SEQ, sm.frontend_dim),
                                    generator=g15, device=dev).bfloat16()}
    gemms = mlp_gemms(sm)
    flash, mm = launches_per_forward(sm, gemms)
    batch_logits(params, sm, sbatch)                          # warm-up
    out = direct_run(f"{sm.name} frames", params, sm, sbatch,
                           LM_DIRECT_STEPS, gemms)
    plain_steps(f"{sm.name} frames", params, sm, sbatch, out,
                LM_DIRECT_STEPS, flash + mm)
    held_prefill(f"{sm.name} frames", params, sm, sbatch,
                 {"matmul_ws": mm, "flash_attention": flash})
    del params, sbatch
    log_peak(sm.name)
    torch.cuda.empty_cache()

    # the reduced models: the card's tokens (seamless: logits) equal the
    # CPU run's
    for arch, backend in ((DS_ARCH, "pallas_ws"), (QWEN_ARCH, "xla"),
                          (VLM_ARCH, "pallas_ws")):
        small = dataclasses.replace(reduce_config(get_config(arch)),
                                    num_layers=2, attn_impl="flash",
                                    gemm_backend=backend)
        sp = materialize(lm.param_specs(small), torch.Generator()
                         .manual_seed(16), device="cpu")
        reqs = lm_requests(small, (5, 17, 70, 130), 8, seed=16)
        outs = []
        for d in (dev, "cpu"):
            run = fresh(reqs)
            ServingEngine(small, sp, slots=2, max_seq=256, device=d).run(run)
            check_served(f"reduced {arch} on {d}", small, run)
            outs.append([r.output for r in run])
        if outs[0] != outs[1]:
            raise AssertionError(f"reduced {arch}: card tokens differ from "
                                 f"the CPU run")
    small = dataclasses.replace(reduce_config(get_config(ENCDEC_ARCH)),
                                attn_impl="flash", gemm_backend="pallas_ws")
    sp = materialize(lm.param_specs(small), torch.Generator().manual_seed(
        17), device="cpu")
    g17 = torch.Generator().manual_seed(17)
    sb = {"tokens": torch.randint(0, small.vocab_size, (2, 64), generator=g17),
          "frames": torch.randn((2, 64, small.frontend_dim), generator=g17)}
    runs = []
    for d in (dev, "cpu"):
        p = tree_map(lambda t: t.to(d), sp)
        with torch.no_grad():
            lg, cache = lm.prefill(p, {k: v.to(d) for k, v in sb.items()},
                                   small, cache_len=72)
            got = [lg.cpu()]
            for j in range(4):
                lg, cache = lm.decode_step(
                    p, small, token=torch.tensor([3 + j, 9 + j], device=d),
                    pos=torch.full((2,), 64 + j, device=d), cache=cache)
                got.append(lg.cpu())
        runs.append(got)
    for a, b in zip(*runs):
        if not torch.allclose(a, b, rtol=F32_TOL, atol=F32_TOL):
            raise AssertionError("reduced seamless-m4t-medium: card logits "
                                 "off the CPU run's")
    log("  reduced deepseek-moe-16b (pallas_ws), qwen3-moe-30b-a3b and "
        "internvl2-26b (pallas_ws), 2 layers, f32, flash: card tokens equal "
        "to the CPU run of the same engine; reduced seamless-m4t-medium "
        f"(2 + 2 layers): prefill and 4 decode steps within {F32_TOL} of "
        "the CPU's")
    log(f"  phase 6d: {time.perf_counter() - t_phase:.1f} s")

    # -- 7. continuous batching --------------------------------------------
    log("phase 7: continuous batching and the multi-core scheduler")

    class Recorder:
        """A backend that records every conv, transposed conv and GEMM it
        is handed (shapes, arguments, tile plan) and computes it on the
        kernels: the launches a program's run must make, read back as
        paths by ``conv_path`` and forms by ``mm_path``."""

        name = "record"

        def __init__(self):
            self.calls = []
            self.inner = get_backend("cuda")

        def conv(self, x, w, bias=None, **kw):
            self.calls.append(("conv", tuple(x.shape), tuple(w.shape), kw))
            return self.inner.conv(x, w, bias, **kw)

        def conv_transpose(self, x, w, bias=None, **kw):
            self.calls.append(("conv_transpose", tuple(x.shape),
                               tuple(w.shape), kw))
            return self.inner.conv_transpose(x, w, bias, **kw)

        def matmul(self, x, w, bias=None):
            self.calls.append(("matmul", tuple(x.shape), tuple(w.shape),
                               x.dtype))
            return self.inner.matmul(x, w, bias)

    def expected_launches(qnet, mode, cores, batches, tile_plans=None):
        """(launches, conv launches by path, matmul forms) that
        ``batches`` batches of ``qnet`` make under (mode, cores) and
        ``tile_plans`` (None: the default plans): one batch runs through
        the same scheduler around ``Recorder`` and each recorded call
        becomes one kernel launch, on the conv kernel its tile plan names
        and the path ``conv_path`` gives its geometry (a transposed conv's:
        its stride-1 lowering; by path as ``conv_paths`` reads them), or
        on the ``mm_path`` form."""
        rec = Recorder()
        register_backend(rec)
        sched = MultiCoreScheduler(SchedulerConfig(cores, mode))
        name = rec.name
        if mode != "batch":
            sb = sched.shard_backend(rec.name)
            register_backend(sb)
            name = sb.name
        program = network.make_int8_program(qnet, ConvCoreConfig(
            int8=True, backend=name), tile_plans=tile_plans)
        sched.run(program, torch.zeros((BATCH, *qnet.plan.input_shape),
                                       device=dev))
        torch.cuda.synchronize()
        unregister_backend(name)
        unregister_backend(rec.name)
        want = {k: 0 for k in wrappers}
        paths = {k: dict.fromkeys(SERVED_PATHS, 0) for k in convs}
        forms = dict.fromkeys(PATHS, 0)
        for kind, xs, ws, kw in rec.calls:
            if kind == "matmul":
                forms[mm_path(xs[0], xs[1], ws[1], kw)] += batches
                want["matmul_ws"] += batches
                continue
            stride, pad = kw["stride"], kw["padding"]
            if kind == "conv_transpose":
                hd, wd, pad = transpose_eq_conv_geometry(
                    xs[1], xs[2], ws[0], ws[1], stride, pad, kw["dilation"])
                xs, stride = (xs[0], hd, wd, xs[3]), 1
            groups = kw.get("groups", 1)     # a dense kout shard omits it
            g = setup_conv(xs, ws, stride=stride, padding=pad,
                           groups=groups, cin_banks=1, kout_banks=groups,
                           pool=kw["pool"],
                           requant=kw["out_scale"] is not None,
                           dilation=kw["dilation"])
            plan = kw["plan"]
            k = "conv2d_ws_pipe" if plan and plan.pipelined else "conv2d_ws"
            want[k] += batches
            paths[k][conv_path(g)] += batches
        return want, paths, forms

    def cbe_serve(label, qnet, images, want_logits, mode="batch", cores=1,
                  reps=3):
        """Serve ``images`` through a ContinuousBatchingEngine under (mode,
        cores): logits bit-equal to the plain backend's, launch counts per
        kernel, path and form as ``expected_launches`` works them out;
        then the mean of ``reps`` more submits → (launches, submit s)."""
        backend, n_cores = "cuda", cores
        if mode != "batch":
            sb = MultiCoreScheduler(SchedulerConfig(cores, mode)) \
                .shard_backend("cuda")
            register_backend(sb)
            backend, n_cores = sb.name, 1
        eng = ContinuousBatchingEngine(batch=BATCH, n_cores=n_cores,
                                       backend=backend, device=dev)
        eng.add_model(qnet)
        batches = -(-len(images) // BATCH)
        want, want_paths, want_forms = expected_launches(qnet, mode, cores,
                                                         batches)
        reset_counts()
        logits = eng.submit(images)
        seen = counts()
        paths = conv_paths()
        forms = dict(matmul_ws.path_launches)
        if (seen, paths, forms) != (want, want_paths, want_forms):
            raise AssertionError(
                f"{label} {mode}×{cores}: launches {seen}, by path "
                f"{paths}, matmul forms {forms}; expected {want}, "
                f"{want_paths}, {want_forms}")
        credit_paths()
        if logits.shape != want_logits.shape or not np.isfinite(
                logits).all() or not np.array_equal(logits, want_logits):
            raise AssertionError(f"{label} {mode}×{cores}: logits differ "
                                 f"from the plain backend")
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.submit(images)
        wall = (time.perf_counter() - t0) / reps
        log(f"  {label} {mode} × {cores} cores: launches {seen} "
            f"(by path {paths}, matmul_ws forms {forms}, as conv_path / "
            f"mm_path give them); logits {logits.shape} bit-equal to the "
            f"plain backend; submit of {len(images)} in {1e3 * wall:.2f} ms "
            f"({len(images) / wall:.1f} images/s, mean of {reps}); "
            f"formation {eng.formation_counts()}")
        eng.close()
        if mode != "batch":
            unregister_backend(backend)
        return seen, wall

    cbe_launches = {k: 0 for k in wrappers}
    for mode in ("batch", "kout", "spatial"):
        seen, _ = cbe_serve("vgg_imagenet 224", vq, vimages, vref, mode, 4)
        for k in wrappers:
            cbe_launches[k] += seen[k]

    rng = np.random.default_rng(2)
    uplan = network.unet_small(input_shape=(224, 224, 4), classes=3)
    uparams = uplan.init_params(rng, device=dev)
    ucal = torch.from_numpy(rng.normal(size=(REQUESTS, *uplan.input_shape))
                            .astype(np.float32)).to(dev)
    uq = network.quantize_network(uplan, uparams, ucal)
    uimages = rng.normal(size=(REQUESTS, *uplan.input_shape)).astype(
        np.float32)
    uref_engine = ContinuousBatchingEngine(batch=BATCH, backend="ref",
                                           device=dev)
    uref_engine.add_model(uq)
    uref = uref_engine.submit(uimages)
    uref_engine.close()
    log(f"  unet_small 224×224×4, 3 classes: transposed convs up1 "
        f"{uplan.activation_shapes()[4][:2]} → "
        f"{uplan.activation_shapes()[5][:2]} and up2 → "
        f"{uplan.activation_shapes()[8][:2]}")
    seen, _ = cbe_serve("unet_small 224", uq, uimages, uref)
    for k in wrappers:
        cbe_launches[k] += seen[k]
    seen, _ = cbe_serve("lenet", lq, limages, lref)
    for k in wrappers:
        cbe_launches[k] += seen[k]

    # no hidden host sync in a dispatch: one formed batch through
    # _dispatch with torch's sync debug mode raising on any synchronizing
    # call (a fresh engine whose worker is idle after one warm batch)
    eng = ContinuousBatchingEngine(batch=BATCH, n_cores=4, device=dev)
    eng.add_model(vq)
    eng.submit(vimages[:BATCH])
    now = time.perf_counter_ns()
    fb = FormedBatch(model=vq.plan.name, reason="drain", requests=[
        ServeRequest(uid=10_000 + i, model=vq.plan.name, image=vimages[i],
                     priority="interactive", enqueue_ns=now,
                     deadline_ns=now, future=Future())
        for i in range(BATCH)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._dispatch(fb)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng._retire_one()
    got = np.stack([r.future.result(timeout=60) for r in fb.requests])
    if not np.array_equal(got, vref[:BATCH]):
        raise AssertionError("sync-debug dispatch: logits differ")
    eng.close()
    log("  one vgg_imagenet batch dispatched under "
        "torch.cuda.set_sync_debug_mode('error'): no synchronizing call, "
        "logits bit-equal")

    # one engine, three models, a 2-program cache, four submitters
    models = {"vgg_imagenet": (vq, vimages, vref),
              "unet_small": (uq, uimages, uref),
              "lenet": (lq, limages, lref)}
    eng = ContinuousBatchingEngine(batch=BATCH, n_cores=4, device=dev,
                                   cache_capacity=2, deadline_ms=2.0)
    for name, (q, _, _) in models.items():
        eng.add_model(q, name=name)
    names = list(models)
    # thread t, chunk j: 4 images of one model, the models in turn
    per_thread = [[(names[(t + j) % 3], 4 * ((t + j) % 4)) for j in range(4)]
                  for t in range(4)]
    errors, outs = [], {}

    def submitter(t):
        try:
            mine = []
            for j, (name, start) in enumerate(per_thread[t]):
                mine.append((name, start, eng.submit_async(
                    models[name][1][start:start + 4], model=name,
                    priority=("interactive", "bulk")[(t + j) % 2])))
            outs[t] = [(name, start, [f.result(timeout=300) for f in futs])
                       for name, start, futs in mine]
        except BaseException as e:      # reported below
            errors.append((t, e))

    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"multi-model submitters failed: {errors}")
    n_req = 0
    for name, start, logits in (c for chunks in outs.values()
                                for c in chunks):
        want = models[name][2][start:start + 4]
        if not np.array_equal(np.stack(logits), want):
            raise AssertionError(f"multi-model {name}[{start}:]: logits "
                                 f"differ from the plain backend")
        n_req += len(logits)
    cache = eng.cache_stats()
    if n_req < 64 or cache["evictions"] < 1 or cache["misses"] <= 3:
        raise AssertionError(f"multi-model: {n_req} requests, cache {cache}: "
                             f"no evict and rebuild")
    for k, v in counts().items():
        cbe_launches[k] += v
    credit_paths()
    log(f"  one engine, 3 models, cache capacity 2, 4 submitter threads "
        f"(interactive and bulk): {n_req} requests in {wall:.3f} s "
        f"({n_req / wall:.1f} images/s), all bit-equal to the plain "
        f"backend; cache {cache}; formation {eng.formation_counts()}; "
        f"latency {eng.latency_percentiles()}")
    eng.close()

    # throughput: the synchronous submit beside an open-loop async load
    eng = ContinuousBatchingEngine(batch=BATCH, n_cores=4, device=dev,
                                   max_inflight=2)
    eng.add_model(vq)
    eng.submit(vimages)
    n_async = 8 * REQUESTS

    def async_load():
        futs = []
        for i in range(n_async // REQUESTS):
            futs += eng.submit_async(vimages, priority="bulk")
        for f in futs:
            f.result(timeout=300)

    async_ms, busy, n_ev = device_busy(async_load)
    lat = eng.latency_percentiles()
    forms_async = eng.formation_counts()
    async_wall = async_ms / 1e3
    share = ("not measured (no device events in the trace)" if busy is None
             else f"{busy:.3f} ms = {100 * busy / async_ms:.0f}%")
    sync_wall = results["auto"][2]
    log(f"  vgg_imagenet 224 throughput (batch 8, 4 virtual cores, "
        f"max_inflight 2): open-loop {n_async} bulk requests in "
        f"{1e3 * async_wall:.1f} ms = {n_async / async_wall:.1f} images/s; "
        f"latency enqueue → result p50 {lat['p50']:.0f} us, p90 "
        f"{lat['p90']:.0f} us, p99 {lat['p99']:.0f} us over "
        f"{lat['count']} requests; formation {forms_async}; device busy "
        f"{share} of the async load (torch.profiler, {n_ev} device events); "
        f"phase 5's synchronous submit of {REQUESTS} (kernel=auto, same "
        f"run): {1e3 * sync_wall:.2f} ms = {REQUESTS / sync_wall:.1f} "
        f"images/s")
    eng.close()

    for k in wrappers:
        stats[k]["launches"] += cbe_launches[k]

    # -- 8. training -------------------------------------------------------
    log("phase 8: training through the kernels' backward (f32, TF32 off)")
    mem_note("phase 8's entry")
    f32 = {k: 0.0 for k in ("conv_ms", "pipe_ms",
                            "conv_lib_ms", "conv_plain_ms", "conv_bound",
                            "dx_ms", "dx_lib_ms", "dx_bound", "mm_ms",
                            "mm_lib_ms", "mm_bound")}
    log("  vgg_imagenet f32 at batch 8, whole map, per layer (ms: CUDA "
        "events around back-to-back calls; the forward on the simt path of "
        "conv2d_ws and conv2d_ws_pipe; "
        "F.conv2d, torch.nn.grad.conv2d_input and torch.matmul on the same "
        "operands, TF32 off; bounds at 3.35 TB/s and 67 TFLOP/s f32; grad "
        "errors against the plain oracles in float64, each element within "
        "f32_sum_bound, each gradient within GRAD_REL_L2 = "
        f"{GRAD_REL_L2:g} relative L2 and its TF32 control outside it):")
    log("    layer  GFLOP    fwd ms (pipe)      F.conv2d ms  "
        "bound ms  simt plan            dx ms   conv2d_input ms  dx bound  "
        "dw ms    taps on matmul_ws ms  torch.matmul ms  dw bound  "
        "max err y / dx / dw / db")
    for i in range(6):
        x, w, b, kw = vgg_f32_layer(i)
        geo = {k: v for k, v in kw.items() if k not in ("relu", "pool")}
        want = conv2d_ws_plain(x, w, b, **kw)
        outs = []
        for name in convs:      # simt: the TilePlan's tiles shape no block
            fn = wrappers[name]
            before = fn.simt_launches
            whole = fn(x, w, b, **kw)
            tiled = fn(x, w, b, **{**kw, "h_tile": 8, "w_tile": 16})
            torch.cuda.synchronize()
            if fn.simt_launches != before + 2:
                raise AssertionError(f"vgg_imagenet conv{i} f32: {name} did "
                                     f"not launch the simt path")
            if not torch.equal(whole, tiled):
                raise AssertionError(f"vgg_imagenet conv{i} f32: {name} "
                                     f"whole map differs from 8x16 tiles")
            sim = stats[name]["simt"]
            sim["max_abs_err"] = max(sim["max_abs_err"],
                                     compare(name, whole, want))
            outs.append(whole)
        # within f32_sum_bound of the emulation; the kernels bit-equal
        check_simt([x, w, b, None], kw, outs)
        g = setup_conv(tuple(x.shape), tuple(w.shape), pool=kw["pool"],
                       int_path=False, **geo)
        plan = simt_plan_conv(g, kw["relu"])
        n, h, wd, c = x.shape
        kh, kwd, _, k = w.shape
        oh, ow = ref.conv_out_shape(h, wd, kh, kwd, kw["stride"],
                                    kw["padding"])
        flop = 2 * n * oh * ow * k * kh * kwd * c
        fwd_ms = elapsed_ms(lambda: conv2d_ws(x, w, b, **kw), reps=3)
        pipe_ms = elapsed_ms(lambda: conv2d_ws_pipe(x, w, b, **kw), reps=3)
        plain_ms = elapsed_ms(lambda: conv2d_ws_plain(x, w, b, **kw), reps=3)
        pad = ref.normalize_padding(kw["padding"], kh, kwd, kw["stride"], h,
                                    wd)
        assert pad[0][0] == pad[0][1] and pad[1][0] == pad[1][1], pad
        xc = x.permute(0, 3, 1, 2)                  # NHWC: channels_last
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib_ms = elapsed_ms(lambda: F.conv2d(
            xc, wc, b, stride=kw["stride"], padding=(pad[0][0], pad[1][0])),
            reps=3)
        fwd_bytes = 4 * (x.numel() + w.numel() + k + want.numel())
        fwd_bound = bound_ms(fwd_bytes, flop, F32_OPS_PER_S)
        side = ("bytes" if fwd_bytes / HBM_BYTES_PER_S >= flop / F32_OPS_PER_S
                else "operations")
        for name in convs:
            stats[name]["simt"]["bound_by"][side] += fwd_bound
        # the VJP through autograd, then its two pieces timed alone
        xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
        xr.requires_grad_(i > 0)        # the network's input needs none
        gy = torch.randn(want.shape, generator=gen, device=dev)
        errs = check_conv_vjp(xr, wr, br, gy, kw)
        if i == 5:
            perrs = check_conv_vjp(xr, wr, br, gy, dict(kw, pipelined=True))
        acc = conv2d_ws(x, w, b, **geo)
        _, relu_mask, pool_idx = kops.epilogue_masks(acc, kw["relu"],
                                                    kw["pool"])
        dacc = kops.epilogue_backward(gy, relu_mask, pool_idx, acc.shape)
        dx_ms = dx_lib = dx_bound = 0.0
        if i > 0:                   # the network's input takes no gradient
            dx_ms = elapsed_ms(lambda: conv2d_ws_input_grad(
                dacc, w, tuple(x.shape), **geo), reps=3)
            dc = dacc.permute(0, 3, 1, 2)           # NHWC: channels_last
            dx_want = torch.nn.grad.conv2d_input(
                xc.shape, wc, dc, stride=kw["stride"],
                padding=(pad[0][0], pad[1][0]))
            dx = conv2d_ws_input_grad(dacc, w, tuple(x.shape), **geo)
            if not torch.allclose(dx_want.permute(0, 2, 3, 1), dx,
                                  rtol=F32_TOL, atol=F32_TOL):
                raise AssertionError(f"vgg_imagenet conv{i}: "
                                     f"torch.nn.grad.conv2d_input computes "
                                     f"another dx")
            dx_lib = elapsed_ms(lambda: torch.nn.grad.conv2d_input(
                xc.shape, wc, dc, stride=kw["stride"],
                padding=(pad[0][0], pad[1][0])), reps=3)
            dx_bound = bound_ms(4 * (dacc.numel() + w.numel() + x.numel()),
                                flop, F32_OPS_PER_S)
            del dx, dx_want
        dw_ms = elapsed_ms(lambda: conv2d_ws_weight_grad(
            x, dacc, kh, kwd, stride=kw["stride"], padding=kw["padding"]),
            reps=1, warmup=1)
        xp = F.pad(x, (0, 0, pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
        m = n * oh * ow
        st = kw["stride"]
        xts = [xp[:, dy:dy + (oh - 1) * st + 1:st,
                  dx:dx + (ow - 1) * st + 1:st].permute(3, 0, 1, 2).reshape(
            c, m) for dy in range(kh) for dx in range(kwd)]
        gm = dacc.reshape(m, k)
        mm_ms = elapsed_ms(lambda: [matmul_ws(t, gm) for t in xts], reps=1,
                           warmup=1)
        mm_lib = elapsed_ms(lambda: [torch.matmul(t, gm) for t in xts],
                            reps=3)
        if i == 1:      # split K, added in slice order: the same bits
            twice = [matmul_ws(xts[4], gm) for _ in range(2)]
            torch.cuda.synchronize()
            if not torch.equal(*twice):
                raise AssertionError("matmul_ws f32 at a conv 1 tap: two "
                                     "calls differ")
            log(f"    conv1 tap [{c},{m}]@[{m},{k}] on the "
                f"{mm_path(c, m, k, torch.float32)} form, plan "
                f"{simt_plan(c, m, k)}: two calls bit-identical")
            del twice
        dw_bound = bound_ms(4 * (x.numel() + dacc.numel() + w.numel()),
                            2 * kh * kwd * c * m * k, F32_OPS_PER_S)
        for key, v in (("conv_ms", fwd_ms), ("pipe_ms", pipe_ms),
                       ("conv_lib_ms", lib_ms),
                       ("conv_plain_ms", plain_ms), ("conv_bound", fwd_bound),
                       ("dx_ms", dx_ms), ("dx_lib_ms", dx_lib),
                       ("dx_bound", dx_bound), ("mm_ms", mm_ms),
                       ("mm_lib_ms", mm_lib), ("mm_bound", dw_bound)):
            f32[key] += v
        shape = (f"{plan.rh}x{plan.rw}/{plan.bn} cs{plan.cs} "
                 f"split{plan.split}")
        log(f"    conv{i}  {flop / 1e9:7.3f}  {fwd_ms:8.3f} ({pipe_ms:8.3f})"
            f"  {lib_ms:9.3f}    {fwd_bound:7.4f}  "
            f"{shape:19s}  {dx_ms:7.3f}  {dx_lib:9.3f}        "
            f"{dx_bound:7.4f}   {dw_ms:8.3f} {mm_ms:8.3f}              "
            f"{mm_lib:7.3f}          {dw_bound:7.4f}   {errs['y']:.2e} / "
            f"{errs.get('dx', 0.0):.2e} / {errs['dw']:.2e} / "
            f"{errs['db']:.2e}")
        log("           rel L2 (TF32 control) " + ", ".join(
            f"{g_} {r_:.2e} ({c_:.2e})" for g_, (r_, c_) in
            errs["rel"].items()) + f"; positions within rounding of a "
            f"mask's decision {errs['near']}")
        if i == 5:
            log("           pipelined=True: conv2d_ws_pipe forward, rel L2 "
                + ", ".join(f"{g_} {r_:.2e}" for g_, (r_, _) in
                            perrs["rel"].items()))
        del xts, xr, wr, br, dacc, acc
    log(f"    sum: forward conv2d_ws {f32['conv_ms']:.3f} ms (simt), "
        f"conv2d_ws_pipe {f32['pipe_ms']:.3f} ms (simt), F.conv2d "
        f"{f32['conv_lib_ms']:.3f} ms, plain {f32['conv_plain_ms']:.3f} ms, "
        f"bound {f32['conv_bound']:.4f} ms; the five dx convs on conv2d_ws "
        f"{f32['dx_ms']:.3f} ms (simt), torch.nn.grad.conv2d_input "
        f"{f32['dx_lib_ms']:.3f} ms, bound {f32['dx_bound']:.4f} ms; "
        f"weight-grad taps on matmul_ws {f32['mm_ms']:.3f} ms, torch.matmul "
        f"{f32['mm_lib_ms']:.3f} ms, bound {f32['mm_bound']:.4f} ms")
    hx, hw, hb = mm_operands(BATCH, 256, 1000, torch.float32)
    herr = check_matmul_vjp(hx.requires_grad_(), hw.requires_grad_(),
                            hb.requires_grad_(),
                            torch.randn(BATCH, 1000, generator=gen,
                                        device=dev))
    log(f"  head matmul_ws VJP [8,256]@[256,1000] f32 (max abs err, rel "
        f"L2, TF32 control's rel L2): {herr}")
    for label, xs_, ws_ in (("up1", (BATCH, 56, 56, 32), (2, 2, 32, 16)),
                            ("up2", (BATCH, 112, 112, 16), (2, 2, 16, 8))):
        ux = torch.randn(xs_, generator=gen, device=dev).requires_grad_()
        uw = (torch.randn(ws_, generator=gen, device=dev)
              / (4 * ws_[2]) ** 0.5).requires_grad_()
        ub = torch.randn(ws_[3], generator=gen, device=dev).requires_grad_()
        ug = torch.randn((xs_[0], 2 * xs_[1], 2 * xs_[2], ws_[3]),
                         generator=gen, device=dev)
        uerr = check_conv_vjp(ux, uw, ub, ug, dict(stride=2, relu=True),
                              transpose=True)
        log(f"  unet_small {label} transposed-conv VJP x{xs_} w{ws_} "
            f"stride 2 at 224: {uerr}")

    def train_launches(plan, batch):
        """(conv2d_ws launches, of them on the simt path, matmul_ws
        launches by form) of one training step of ``plan``: each conv or
        transposed conv runs one forward launch, one input-gradient launch
        where its input needs a gradient (not the network's input) and
        KH·KW·groups weight-gradient GEMMs; each dense layer a forward
        GEMM, its weight-gradient GEMM and an input-gradient GEMM where its
        input needs one.  A conv launch is simt where its output groups
        are 8 or more channels wide (the forward's K/g, the input
        gradient's C/g), else dw or nk: the path rule on f32."""
        ins, acts = plan.resolved_inputs(), plan.activation_shapes()
        shapes, geoms = plan.param_shapes(), plan.conv_geometries()
        needs, n_conv, n_simt = [], 0, 0
        forms = dict.fromkeys(PATHS, 0)
        for i, sp in enumerate(plan.layers):
            src_need = any(j >= 0 and needs[j] for j in ins[i])
            needs.append(sp.kind in network.PARAM_KINDS or src_need)
            if sp.kind not in network.PARAM_KINDS:
                continue
            s0 = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
            if sp.kind == "dense":
                k_in, k_out = shapes[i]["w"]
                gemms = [(batch, k_in, k_out), (k_in, batch, k_out)] + (
                    [(batch, k_out, k_in)] if src_need else [])
            else:
                kh, kwd, cg, k = shapes[i]["w"]
                groups = geoms[i][1]
                n_conv += 1 + src_need
                n_simt += (k // groups >= 8) + (src_need and cg >= 8)
                if sp.kind == "conv":
                    oh, ow = ref.conv_out_shape(s0[0], s0[1], kh, kwd,
                                                sp.stride, sp.padding,
                                                sp.dilation)
                    gemm = (cg, batch * oh * ow, k // groups)
                else:       # the taps contract over the transpose's input
                    gemm = (k // groups, batch * s0[0] * s0[1], cg)
                gemms = [gemm] * (kh * kwd * groups)
            for mm, kk, nn in gemms:
                forms[mm_path(mm, kk, nn, torch.float32)] += 1
        return n_conv, n_simt, forms

    def train_main_path(label, plan, x, y, steps, batch, cfg, seed):
        """``fit`` ``steps`` steps on the card with the counts reset just
        before and read just after: launches equal to ``train_launches``,
        by path (no tensor-core launch, the simt ones counted by
        ``simt_launches``), finite metrics, every parametric weight moved
        → (final state, history, histogram summary)."""
        state0 = training.init_train_state(plan, np.random.default_rng(0),
                                           device=dev)
        hist_us = obs.metrics.histogram(f"train.step_us.{plan.name}")
        hist_us.reset()
        n_conv, n_simt, forms = train_launches(plan, batch)
        reset_counts()
        state, hist = training.fit(plan, x, y, steps=steps, batch=batch,
                                   cfg=cfg, seed=seed, state=state0)
        torch.cuda.synchronize()
        seen, pf = counts(), dict(matmul_ws.path_launches)
        want = {k: 0 for k in wrappers}
        want["conv2d_ws"] = steps * n_conv
        want["matmul_ws"] = steps * sum(forms.values())
        if seen != want or conv2d_ws.tc_launches or (
                conv2d_ws.simt_launches != steps * n_simt) or pf != {
                k: steps * v for k, v in forms.items()}:
            raise AssertionError(
                f"{label}: launches {seen} (tensor-core "
                f"{conv2d_ws.tc_launches}, simt {conv2d_ws.simt_launches}), "
                f"matmul_ws forms {pf}; expected {want}, {steps * n_simt} "
                f"on the simt path, forms x{steps} {forms}")
        for k in wrappers:
            stats[k]["launches"] += seen[k]
        stats["conv2d_ws"]["simt"]["launches"] += conv2d_ws.simt_launches
        credit_paths()
        credit_forms()
        if not all(np.isfinite(hh["loss"]) and np.isfinite(hh["grad_norm"])
                   for hh in hist):
            raise AssertionError(f"{label}: non-finite metrics {hist}")
        for i, (p0, p1) in enumerate(zip(state0.params, state.params)):
            if p0 is not None and torch.equal(p0["w"], p1["w"]):
                raise AssertionError(f"{label}: node {i}'s weights did not "
                                     f"move")
        summ = hist_us.summary()
        log(f"  {label}: {steps} fit steps of batch {batch}, launches "
            f"{seen} a run = {n_conv} conv2d_ws ({n_simt} on the simt path, "
            f"the rest dw or nk) and {sum(forms.values())} matmul_ws a step "
            f"({forms}), no tensor-core launch; loss {[round(hh['loss'], 4) for hh in hist]}"
            f", grad norm {[round(hh['grad_norm'], 3) for hh in hist]}; "
            f"ms a step (host clock, train.step_us) min "
            f"{summ['min'] / 1e3:.2f}, mean {summ['mean'] / 1e3:.2f}, max "
            f"{summ['max'] / 1e3:.2f}")
        return state, hist, summ

    vplan = network.vgg_imagenet()
    vx, vy = training.synthetic_digits(
        np.random.default_rng(1), 32, input_shape=vplan.input_shape,
        classes=1000, device=dev)
    vcfg = training.TrainConfig(qat=True, per_channel=True)
    vstate, _, vsumm = train_main_path(
        "vgg_imagenet 224 QAT per channel", vplan, vx, vy, 3, BATCH, vcfg, 2)

    # one more step under torch.profiler: the device time by part
    step_fn = training.make_train_step(vplan, vcfg)
    xb, yb = vx[:BATCH], vy[:BATCH]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_fn(vstate, xb, yb)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    act = torch.profiler.ProfilerActivity
    n_fwd = sum(sp.kind == "conv" for sp in vplan.layers)
    n_conv, _, forms = train_launches(vplan, BATCH)
    # torch.profiler now and then loses device events (see device_ms;
    # once a conv event in every one of three one-step windows): each
    # window profiles PROFILED_STEPS steps, a spin_kernel marker before
    # each and after the last, and the first step whose launches all
    # reached the trace (the counters above hold them exactly) is split;
    # a window with none is profiled again, up to three times, and said so
    for window in range(3):
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                torch.cuda._sleep(MARK_CYCLES)
                step_fn(vstate, xb, yb)
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        steps_evs, cur = [], None
        for e in sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start):
            if "spin_kernel" in e.name:
                if cur is not None:
                    steps_evs.append(cur)
                cur = []
            elif cur is not None:
                cur.append(e)
        found = []
        for evs in steps_evs:
            # a conv launch's kernel (simt here, every layer of the
            # network), and its split-K reduce kernel apart
            conv_all = [e for e in evs if is_conv_kernel(e.name)]
            conv_evs = [e for e in conv_all
                        if "conv_simt_reduce" not in e.name]
            # a launch's GEMM kernel, and its split-K reduce kernel apart
            mm_evs = [e for e in evs if is_mm_kernel(e.name)]
            n_mm = sum("mm_split_reduce" not in e.name for e in mm_evs)
            found.append((len(conv_evs), n_mm))
            if len(conv_evs) == n_conv and n_mm == sum(forms.values()):
                break
        else:
            msg = (f"profiled steps: (conv, GEMM) kernels {found} between "
                   f"{len(steps_evs) + 1 if steps_evs else 0} markers, "
                   f"expected ({n_conv}, {sum(forms.values())}) a step")
            if window == 2:
                raise AssertionError(f"{msg} in each of 3 windows")
            log(f"  torch.profiler window {window + 1} of 3: {msg}; "
                f"profiled again")
            continue
        if len(found) > 1:
            log(f"  torch.profiler: step {len(found)} of the window whole, "
                f"the ones before short: (conv, GEMM) kernels {found}")
        break
    conv_ids, mm_ids = {id(e) for e in conv_all}, {id(e) for e in mm_evs}
    bwd0 = conv_evs[n_fwd].time_range.start
    last = max(e.time_range.end for e in conv_evs + mm_evs)
    split = dict.fromkeys(("forward convs", "input grads",
                           "weight-grad GEMMs", "head", "optimizer",
                           "the rest"), 0.0)
    for e in evs:
        us = e.time_range.elapsed_us() / 1e3
        if id(e) in conv_ids:
            split["forward convs" if e.time_range.start < bwd0
                  else "input grads"] += us
        elif id(e) in mm_ids:
            split["head" if e.time_range.start < bwd0
                  else "weight-grad GEMMs"] += us
        elif e.time_range.start >= last:
            split["optimizer"] += us
        else:
            split["the rest"] += us
    busy = sum(split.values())
    log(f"  vgg_imagenet 224 step under torch.profiler: device busy "
        f"{busy:.3f} ms of a {wall:.3f} ms step (host clock, unprofiled) = "
        f"{100 * busy / wall:.1f}%, {len(evs)} device events; device ms by "
        f"part: " + ", ".join(f"{k} {v:.3f} ({100 * v / busy:.1f}%)"
                              for k, v in split.items()))

    reset_counts()
    _, _, vres, _ = serve("vgg_imagenet trained", vplan, seed=3,
                          params=vstate.params, calib=vx[:8],
                          per_channel=True)
    for k in wrappers:
        stats[k]["launches"] += vres["auto"][0][k] + vres["sequential"][0][k]

    # the QAT round trip at the reference test's settings, on the card
    lplan = network.lenet(input_shape=(12, 12, 1))
    for per_channel in (False, True):
        rng = np.random.default_rng(7)
        lx, ly = training.synthetic_digits(rng, 384, device=dev)
        lxe, lye = training.synthetic_digits(rng, 192, device=dev)
        lcfg = training.TrainConfig(qat=True, per_channel=per_channel)
        reset_counts()
        lstate, _ = training.fit(lplan, lx, ly, steps=50, batch=32,
                                 cfg=lcfg, seed=8, device=dev)
        with torch.no_grad():
            float_acc = float(training.accuracy(
                training.float_forward(lplan, lstate.params, lxe), lye))
        qnet = network.quantize_network(lplan, lstate.params, lx[:128],
                                        per_channel=per_channel)
        program = network.make_int8_program(qnet, ConvCoreConfig(int8=True))
        int8_acc = float(training.accuracy(program(lxe), lye))
        seen = counts()
        for k in wrappers:
            stats[k]["launches"] += seen[k]
        stats["conv2d_ws"]["simt"]["launches"] += conv2d_ws.simt_launches
        credit_paths()
        if float_acc < 0.9 or abs(float_acc - int8_acc) > 0.02:
            raise AssertionError(f"lenet QAT per_channel={per_channel}: "
                                 f"float {float_acc}, int8 {int8_acc}")
        log(f"  lenet QAT round trip per_channel={per_channel} (50 steps of "
            f"32, seeds 7/8): float accuracy {float_acc:.4f}, int8 "
            f"{int8_acc:.4f} on 192 held-out images; launches {seen}")

    uplan = network.unet_small(input_shape=(224, 224, 4), classes=3)
    ux, uy = training.synthetic_segmentation(
        np.random.default_rng(5), 16, input_shape=uplan.input_shape,
        classes=3, device=dev)
    train_main_path("unet_small 224 QAT per channel", uplan, ux, uy, 3,
                    BATCH, training.TrainConfig(qat=True, per_channel=True),
                    6)
    stats["conv2d_ws"]["f32"] = (f32["conv_ms"], f32["conv_bound"],
                                 f32["conv_lib_ms"])
    stats["conv2d_ws_pipe"]["f32"] = (f32["pipe_ms"], f32["conv_bound"],
                                      f32["conv_lib_ms"])
    stats["matmul_ws"]["f32"] = (f32["mm_ms"], f32["mm_bound"],
                                 f32["mm_lib_ms"])
    # the simt path of each conv kernel, keys of its row in the JSON line
    for name in convs:
        stats[name]["simt"].update(plain_ms=f32["conv_plain_ms"])
    stats["conv2d_ws"]["simt"].update(
        dx_ms=f32["dx_ms"], dx_bound_ms=f32["dx_bound"],
        dx_library_ms=f32["dx_lib_ms"])

    # -- 9. the calibrated cost model, the autotuner, routing ---------------
    log("phase 9: a calibration table fitted on the card; the calibrated "
        "planner; tuned and routed serving")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    samples = calibration_sweep.sweep(smoke=True)
    table = fit_calibration(samples,
                            provenance=calibration_sweep.provenance(True))
    table_path = ROOT / "build" / "CALIBRATION_smoke.json"
    table_path.parent.mkdir(exist_ok=True)
    table.save(str(table_path))
    fit = table.fit
    log(f"  sweep: {len(samples)} points (the smoke grid and vgg_imagenet's "
        f"six convs at batch 8 on both kernels) timed and fitted in "
        f"{time.perf_counter() - t0:.1f} s; mean |error| "
        f"{fit['mean_abs_error_pct']:.1f}%, max {fit['max_abs_error_pct']:.1f}%"
        f", {fit['n_rejected_noisy']} of {fit['n_samples']} rejected as "
        f"noisy")
    log(f"  table ({table_path.relative_to(ROOT)}): "
        + json.dumps(table.to_dict()))
    if not fit["terms_fit"] or fit["n_rejected_noisy"] > len(samples) / 2:
        raise AssertionError(f"calibration fit: {dict(fit)}")
    for smp in samples:
        rule = calibration_sweep.launch_plan(smp.meta["geometry"])
        if {k: smp.meta[k] for k in rule} != rule:
            raise AssertionError(f"{smp.name}: launched {smp.meta}, the "
                                 f"path rule gives {rule}")
    paths = {p: sum(smp.meta["conv_path"] == p for smp in samples)
             for p in SERVED_PATHS}
    log(f"  every sample launched on the path conv_path gives and with the "
        f"TcPlan (bn, stages, slots) tc_plan or the DwPlan (rectangle, "
        f"run, slots) dw_plan gives: {paths}")

    measured = {smp.name: smp for smp in samples}
    device = {r[0]: r[3] for r in conv_rows}      # phase 3's device ms
    cal_plans = network.program_tile_plans(
        vq.plan, ConvCoreConfig(int8=True, calib=table))
    ana_plans = network.program_tile_plans(vq.plan, ConvCoreConfig(int8=True))
    agree = agree_dev = 0
    log("  vgg_imagenet 224, kernel='auto' per conv (us: the sweep's median "
        "at batch 8, CUDA events around each call, host work included; "
        "device us: phase 3's device events of one call):")
    for i, (cp, ap) in enumerate(
            (c, a) for c, a in zip(cal_plans, ana_plans) if c is not None):
        seq = measured[f"vgg_imagenet/conv{i}/seq"]
        pipe = measured[f"vgg_imagenet/conv{i}/pipe"]
        faster = "pipe" if pipe.measured_us < seq.measured_us else "seq"
        verdict = "pipe" if cp.pipelined else "seq"
        agree += verdict == faster
        dev_row = device[f"vgg_imagenet conv{i}"]
        dseq, dpipe = (1e3 * dev_row[k][1] for k in convs)
        dev_faster = "pipe" if dpipe < dseq else "seq"
        agree_dev += verdict == dev_faster
        log(f"    conv{i}: calibrated {verdict}, analytic "
            f"{'pipe' if ap.pipelined else 'seq'}; measured seq "
            f"{seq.measured_us:.2f} (IQR {seq.iqr_us:.2f}), pipe "
            f"{pipe.measured_us:.2f} (IQR {pipe.iqr_us:.2f}): {faster} "
            f"faster; device seq {dseq:.2f}, pipe {dpipe:.2f}: "
            f"{dev_faster} faster")
    log(f"  the calibrated 'auto' picks the kernel that measured faster in "
        f"the sweep on {agree} of 6 layers, in device time on {agree_dev}")

    rng = np.random.default_rng(3)
    mplan = network.mobilenet_small(input_shape=(224, 224, 4))
    mparams = mplan.init_params(rng, device=dev)
    mq = network.quantize_network(mplan, mparams, torch.from_numpy(
        rng.normal(size=(REQUESTS, *mplan.input_shape)).astype(
            np.float32)).to(dev))
    mimages = rng.normal(size=(REQUESTS, *mplan.input_shape)).astype(
        np.float32)
    ref_engine = ConvNetEngine(mq, batch=BATCH, core_config=ConvCoreConfig(
        int8=True, backend="ref"))
    mref = ref_engine.submit(mimages)
    ref_engine.close()
    tuned_nets = {"vgg_imagenet": (vq, vimages, vref),
                  "unet_small": (uq, uimages, uref),
                  "mobilenet_small": (mq, mimages, mref)}
    tunes = {}
    tuned_launches = {k: 0 for k in wrappers}
    for name, (q, images, want_logits) in tuned_nets.items():
        t0 = time.perf_counter()
        tune = autotune.autotune_network(q.plan, calib=table)
        tune_s = time.perf_counter() - t0
        tunes[name] = tune
        log(f"  {name} {q.plan.input_shape}: tuned in {tune_s:.2f} s, "
            f"layers_differ {tune.layers_differ}, speedup "
            f"{tune.speedup:.4f} (calibrated cycles, greedy / tuned), mode "
            f"{tune.scheduler_mode} × {tune.n_cores} cores")
        batches = -(-len(images) // BATCH)
        want, want_paths, want_forms = expected_launches(
            q, tune.scheduler_mode, tune.n_cores, batches,
            tile_plans=tune.tile_plans)
        eng = ConvNetEngine(q, batch=BATCH, tune=tune, calib=table)
        eng.submit(images[:1])               # build outside the counted run
        reset_counts()
        t0 = time.perf_counter()
        logits = eng.submit(images)
        wall = time.perf_counter() - t0
        seen = counts()
        paths = conv_paths()
        forms = dict(matmul_ws.path_launches)
        eng.close()
        if (seen, paths, forms) != (want, want_paths, want_forms):
            raise AssertionError(
                f"tuned {name}: launches {seen}, by path {paths}, forms "
                f"{forms}; expected {want}, {want_paths}, {want_forms}")
        n_dw = sum(p_["dw"] for p_ in paths.values())
        if (name == "mobilenet_small") != (n_dw >= 3 * batches > 0):
            raise AssertionError(f"tuned {name}: {n_dw} dw launches (a "
                                 f"batch of mobilenet_small's three "
                                 f"depthwise layers makes 3 at least, one a "
                                 f"shard)")
        credit_paths()
        if logits.shape != want_logits.shape or not np.array_equal(
                logits, want_logits):
            raise AssertionError(f"tuned {name}: logits differ from the "
                                 f"plain backend")
        for k in wrappers:
            tuned_launches[k] += seen[k]
        log(f"    served {len(images)} requests through ConvNetEngine(tune=) "
            f"in {1e3 * wall:.2f} ms: launches {seen} (by path {paths}, "
            f"matmul_ws forms {forms}, as conv_path / mm_path give them); "
            f"logits {logits.shape} bit-equal to the plain backend")

    # one routed engine: deadline-released single images, then full batches
    vtune = tunes["vgg_imagenet"]
    routes = {n: autotune.route_batch(vtune.layers, n, 4, calib=table)
              for n in (1, BATCH)}
    n_single = 3
    want = {k: 0 for k in wrappers}
    want_paths = {k: dict.fromkeys(SERVED_PATHS, 0) for k in convs}
    want_forms = dict.fromkeys(PATHS, 0)
    # the first batch is profiled (one warm-up and one timed pass of the
    # routed program) before it runs
    for n, n_batches in ((1, n_single + 2), (BATCH, 2)):
        mode, cores, _ = routes[n]
        w_, t_, f_ = expected_launches(vq, mode, cores, n_batches,
                                       tile_plans=vtune.tile_plans)
        for d, add in ((want, w_), (want_forms, f_)):
            for k in d:
                d[k] += add[k]
        for k in convs:
            for p_ in want_paths[k]:
                want_paths[k][p_] += t_[k][p_]
    eng = ContinuousBatchingEngine(batch=BATCH, n_cores=4, route=True,
                                   calib=table, drift_band=(0.5, 2.0),
                                   device=dev)
    eng.add_model(vq, tune=vtune)
    obs.reset()
    obs.enable()
    reset_counts()
    single_ms = []
    try:
        for i in range(n_single):
            t0 = time.perf_counter()
            got = eng.submit_async(vimages[i]).result(timeout=300)
            single_ms.append(1e3 * (time.perf_counter() - t0))
            obs.disable()                  # only the first batch profiles
            if not np.array_equal(got, vref[i]):
                raise AssertionError(f"routed single image {i}: logits "
                                     f"differ from the plain backend")
        t0 = time.perf_counter()
        futs = eng.submit_async(vimages)
        got = np.stack([f.result(timeout=300) for f in futs])
        full_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        obs.disable()
    seen = counts()
    paths = conv_paths()
    forms = dict(matmul_ws.path_launches)
    if not np.array_equal(got, vref):
        raise AssertionError("routed full batches: logits differ from the "
                             "plain backend")
    if (seen, paths, forms) != (want, want_paths, want_forms):
        raise AssertionError(
            f"routed vgg_imagenet: launches {seen}, by path {paths}, forms "
            f"{forms}; expected {want}, {want_paths}, {want_forms}")
    credit_paths()
    route_counts = {m: eng.metrics.counter(f"route.{m}").value
                    for m in ("batch", "kout", "spatial")}
    formed = eng.formation_counts()
    prof, drift = eng.layer_profile, eng.drift_events
    drift_counter = obs.metrics.counter("obs.drift.events").value
    eng.close()
    obs.reset()
    if formed["deadline"] != n_single or formed["full"] != 2:
        raise AssertionError(f"routed engine formation {formed}")
    if prof is None or not prof.calibrated or drift_counter != len(drift):
        raise AssertionError("routed engine: no calibrated profile of its "
                             "first batch")
    for k in wrappers:
        tuned_launches[k] += seen[k]
    log(f"  routed vgg_imagenet (ContinuousBatchingEngine(n_cores=4, "
        f"route=True, calib=, drift_band=(0.5, 2.0)), tune=): route_batch "
        f"at 4 cores gives batch 1 → {routes[1][:2]}, batch {BATCH} → "
        f"{routes[BATCH][:2]}; route counters {route_counts}; formation "
        f"{formed}; launches {seen} (by path {paths}, matmul_ws forms "
        f"{forms}; the first batch's profile included); every logit "
        f"bit-equal to the plain backend")
    log(f"    single images released by the deadline: "
        + ", ".join(f"{t:.2f}" for t in single_ms)
        + f" ms each, enqueue → result (the first builds the routed "
        f"program and profiles it); {REQUESTS} images as two full batches "
        f"in {full_ms:.2f} ms")
    log(f"    per layer of the first batch ({prof.batch} images, routed "
        f"{routes[1][0]}; wall us measured with a sync after each node / "
        f"predicted us for one image on the table's clock = ratio):")
    for r in prof.records:
        if r.predicted_us:
            log(f"      {r.name:8s} {r.kind:8s} {r.wall_us:9.2f} / "
                f"{r.predicted_us:9.2f} = {r.ratio:.3f}")
    log(f"    drift events (band 0.5–2.0): {len(drift)} of "
        f"{sum(1 for r in prof.records if r.predicted_us)} priced nodes: "
        + ", ".join(f"{e.name} {e.ratio:.2f}" for e in drift))
    # which conv kernel each layer runs is the table's verdict; the path
    # runs one of them for every conv and matmul_ws for every head
    if not (tuned_launches["conv2d_ws"] + tuned_launches["conv2d_ws_pipe"]
            and tuned_launches["matmul_ws"]):
        raise AssertionError(f"phase 9 launches {tuned_launches}")

    committed = CalibrationTable.load(str(ROOT / "CALIBRATION_h100.json"))
    prov = committed.provenance
    if prov.get("mode") != "native" or "H100" not in prov.get("card", ""):
        raise AssertionError(f"CALIBRATION_h100.json provenance {prov}")
    log(f"  CALIBRATION_h100.json loads: fitted on {prov['card']} (torch "
        f"{prov['torch_version']}, CUDA {prov['cuda_version']}, "
        f"{'smoke' if prov['smoke'] else 'full'} grid), fit "
        f"{dict(committed.fit)}")
    for k in wrappers:
        stats[k]["launches"] += tuned_launches[k]
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")

    # -- 10. training an LM ------------------------------------------------
    log("phase 10: LM training (train step, trainer, checkpointer, launcher; "
        "TF32 off)")
    t_phase = time.perf_counter()
    mem_note("phase 10's entry")
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_launcher
    from repro_torch.optim.adamw import (UPDATE_ROWS, AdamWConfig,
                                         adamw_update_, tree_leaves)
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from torch.utils._python_dispatch import _disable_current_modes
    from test_torch_cuda import (LM_BWD_SHAPES, f32_sum_bound, lm_bwd_inputs,
                                 lm_train_step_card_vs_cpu, rel_l2)

    import torch_dist_checks as dc

    # (a) the reduced models: one f32 step on the card equals the CPU's
    for arch, backend in (("llama3p2_3b", "xla"), ("llama3p2_3b", "pallas_ws"),
                          (RG_ARCH, "xla"), (RWKV_ARCH, "xla"),
                          (DS_ARCH, "xla")):
        out = lm_train_step_card_vs_cpu(arch, dev, backend)
        log(f"  reduced {arch} {backend}: one f32 step card == CPU within "
            f"1e-4: max abs err loss {out['loss']:.2e}, gradients "
            f"{out['grads']:.2e}, params/m/v {out['state']:.2e} (lr "
            f"5e-4; {out['near_zero']} param elements at a near-zero "
            f"gradient held to 2·lr); {out['matmul_ws']} matmul_ws launches")

    def draw_state(cfg, seed=0):
        """A train state on the card: params from ``seed``, m and v zero,
        step 0."""
        specs = ts.init_state_specs(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return {"params": materialize(specs["params"], gen, device=dev),
                "opt": materialize(specs["opt"], gen, device=dev),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def state_bytes(state):
        return sum(t.numel() * t.element_size() for t in tree_leaves(state))

    # matmul_ws's f32 VJP at the LM's backward shapes, and its time there
    # beside torch.matmul (the f32 dx and dw GEMMs of a layer's MLP at a
    # 4096-token microbatch)
    lm_bwd = dict.fromkeys(("lm_bwd_ms", "lm_bwd_bound_ms",
                            "lm_bwd_library_ms"), 0.0)
    for m_, k_, n_ in LM_BWD_SHAPES:
        x, w, b, g = lm_bwd_inputs(m_, k_, n_, dev)
        errs = check_matmul_vjp(x, w, b, g)
        x, w = x.detach(), w.detach()
        for name, a, c in (("dx", g, w.t().contiguous()),
                           ("dw", x.t().contiguous(), g)):
            mm_ms = elapsed_ms(lambda: matmul_ws(a, c), 3)
            lib_ms = elapsed_ms(lambda: torch.matmul(a, c), 3)
            (m2, k2), n2 = a.shape, c.shape[1]
            bd = bound_ms(4 * (m2 * k2 + k2 * n2 + m2 * n2),
                          2 * m2 * k2 * n2, F32_OPS_PER_S)
            lm_bwd["lm_bwd_ms"] += mm_ms
            lm_bwd["lm_bwd_library_ms"] += lib_ms
            lm_bwd["lm_bwd_bound_ms"] += bd
            log(f"  matmul_ws f32 {name} [{m2},{k2}]@[{k2},{n2}] (VJP of "
                f"[{m_},{k_}]@[{k_},{n_}]): {mm_ms:.3f} ms "
                f"({2e-9 * m2 * k2 * n2 / mm_ms:.1f} TFLOP/s) on the "
                f"{mm_path(m2, k2, n2, torch.float32)} form, torch.matmul "
                f"{lib_ms:.3f} ms, bound "
                f"{bd:.3f} ms (operations); max err "
                f"{errs[name][0]:.2e}, rel L2 {errs[name][1]:.2e} (TF32 "
                f"control {errs[name][2]:.2e})")
        del x, w, b, g
    stats["matmul_ws"]["lm_bwd"] = lm_bwd

    # (b) full width, 2 layers, f32 on pallas_ws: every matmul_ws call of
    # one step held to matmul_ws_plain and to the float64 product, the
    # step's gradients against the same step on xla
    seq = 4096
    cfg2 = dataclasses.replace(get_config(LM_ARCH), num_layers=2,
                               compute_dtype="float32",
                               remat_policy="minimal")
    state = draw_state(cfg2, seed=1)
    batch = on_card(SyntheticLM(DataConfig(
        vocab_size=cfg2.vocab_size, seq_len=seq, global_batch=1,
        seed=1)).batch_at(0))
    held = collections.Counter()
    worst = {"plain": 0.0, "ws": 0.0, "lib": 0.0, "ctl": float("inf")}

    def hold_mm(x, w, bias=None):
        """One ``matmul_ws`` call of a training step held to
        ``matmul_ws_plain`` on its own operands → (form, max abs err,
        output): bf16 through ``check_mm`` (the form ``mm_path`` names,
        within ``bf16_gemm_bound``), f32 on one simt launch within
        ``f32_sum_bound`` elementwise.  Its callers run it outside the
        dispatch modes of the remat's selective checkpoint, which would
        keep the checks' own GEMM outputs (it saves every ``mm``'s) and
        hand them back in the recompute."""
        if x.dtype == torch.bfloat16:
            return check_mm(x, w, bias)
        (m_, k_), n_ = x.shape, w.shape[1]
        path = mm_path(m_, k_, n_, x.dtype)
        before = matmul_ws.path_launches[path]
        got = matmul_ws(x, w, bias)
        torch.cuda.synchronize()
        if path != "simt" or matmul_ws.path_launches[path] != before + 1:
            raise AssertionError(f"matmul_ws f32 [{m_},{k_}]@[{k_},{n_}]: "
                                 f"{path}, not one simt launch")
        s = x.abs() @ w.abs()
        if bias is not None:
            s = s + bias.abs()
        err_t = (got - matmul_ws_plain(x, w, bias)).abs()
        if bool((err_t > f32_sum_bound(k_, s)).any()):
            raise AssertionError(f"matmul_ws f32 [{m_},{k_}]@[{k_},{n_}]: "
                                 f"{float(err_t.max())} from matmul_ws_plain, "
                                 f"past f32_sum_bound")
        err = float(err_t.max())
        st = stats["matmul_ws"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        return path, err, got

    def hold_f32(x, w, bias=None, worst=worst, held=held, control=True):
        """``hold_mm`` on one f32 call of the step, then its output and
        torch.matmul's on the same operands against the float64 product
        (``torch_dist_checks.f32_reading``: the kernel's within
        ``GRAD_REL_L2``, with ``control`` its TF32 control outside), the
        readings kept in ``worst`` → the kernel's output."""
        (m_, k_), n_ = x.shape, w.shape[1]
        with _disable_current_modes():
            _, err, got = hold_mm(x, w, bias)
            rel, lib, ctl = dc.f32_reading(x, w, bias, got, control)
        worst["plain"] = max(worst["plain"], err)
        worst["ws"] = max(worst["ws"], rel)
        worst["lib"] = max(worst["lib"], lib)
        if control:
            worst["ctl"] = min(worst["ctl"], ctl)
        held[(m_, k_, n_)] += 1
        return got

    grads = {}
    for backend in ("xla", "pallas_ws"):
        c = dataclasses.replace(cfg2, gemm_backend=backend)
        kops._matmul_kernel = hold_f32
        try:
            _, loss, _, g = ts._grads(state["params"], batch, c)
        finally:
            kops._matmul_kernel = matmul_ws
        grads[backend] = (float(loss), g)
    n_mlp = 3 * cfg2.num_layers
    # each MLP GEMM once forward, once in the remat recompute, dx and dw
    if sum(held.values()) != 4 * n_mlp:
        raise AssertionError(f"2-layer f32 step: {dict(held)} matmul_ws "
                             f"calls, not 4 × {n_mlp}")
    # the gradient bound, from this step's readings: the two steps differ
    # in their 4 × 6 MLP GEMM calls (forward, recompute, dx, dw), each
    # within w relative L2 of the exact product (w the worst reading
    # above, matmul_ws's or torch.matmul's on the same operands); a
    # gradient leaf's relative difference adds them at most linearly
    # unless the network amplifies them: 2 × 24 × w.  It must sit under
    # the TF32 control's reading, which a TF32 GEMM would reach
    per_call = max(worst["ws"], worst["lib"])
    lm_grad_bound = 2 * 4 * n_mlp * per_call
    if not lm_grad_bound < worst["ctl"]:
        raise AssertionError(f"2-layer f32 step: the gradient bound "
                             f"{lm_grad_bound} would pass a TF32 GEMM "
                             f"({worst['ctl']})")
    g_rel = max(rel_l2(a, b.double()) for a, b in zip(
        grads["pallas_ws"][1], grads["xla"][1]) if float(b.norm()) > 0)
    log(f"  full width, 2 layers, f32, one step at {seq} tokens: "
        f"{dict(held)} matmul_ws calls held (simt form; max err from "
        f"matmul_ws_plain {worst['plain']:.2e}, worst rel L2 from float64 "
        f"{worst['ws']:.2e} <= {GRAD_REL_L2:g}, torch.matmul's "
        f"{worst['lib']:.2e}, the TF32 control's at least "
        f"{worst['ctl']:.2e}); loss {grads['pallas_ws'][0]:.6f} (xla "
        f"{grads['xla'][0]:.6f}); gradients within {g_rel:.2e} relative L2 "
        f"of xla's (bound 2 × {4 * n_mlp} × {per_call:.2e} = "
        f"{lm_grad_bound:.2e})")
    if not (g_rel <= lm_grad_bound and abs(grads["pallas_ws"][0] -
                                           grads["xla"][0]) <= 1e-4):
        raise AssertionError(f"2-layer f32 step: pallas_ws against xla "
                             f"{g_rel} (bound {lm_grad_bound})")
    # the in-place update's transient memory: the global norm squares one
    # leaf at a time (the largest, the embedding, bounds it) and the update
    # holds a dozen temporaries of one row block at most
    g_tree = ts._unflatten(state["params"], grads["pallas_ws"][1])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    metrics = adamw_update_(state["params"], g_tree, state["opt"],
                            state["step"], AdamWConfig())
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    leaf = max(t.numel() * 4 for t in tree_leaves(state["params"]))
    limit = leaf + 12 * 4 * UPDATE_ROWS
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(state)):
        raise AssertionError("2-layer f32 step: a non-finite leaf")
    if extra > limit:
        raise AssertionError(f"adamw_update_ took {extra} bytes beyond the "
                             f"state, past {limit}")
    log(f"    the in-place update: lr {float(metrics['lr']):.3g}, grad norm "
        f"{float(metrics['grad_norm']):.4f}; {extra / 1e9:.3f} GB beyond "
        f"the state and gradients ({state_bytes(state) / 1e9:.2f} GB of "
        f"params, m and v; limit {limit / 1e9:.3f} GB: the largest leaf "
        f"squared for the norm, 12 row blocks)")
    del state, grads, g_tree, batch
    torch.cuda.empty_cache()

    # (c) llama3.2-3b as published, 28 layers, f32 params, bf16 compute,
    # remat "minimal", chunked attention; 2 x 4096 tokens a step in two
    # microbatches.  Timed at TRAIN_ATTN_CHUNK, then one step each at the
    # config's own chunk, which the launcher and Trainer use
    cfg = dataclasses.replace(get_config(LM_ARCH), remat_policy="minimal",
                              attn_impl="chunked")
    cfg_chunk = cfg.attn_chunk
    cfg = dataclasses.replace(cfg, attn_chunk=TRAIN_ATTN_CHUNK)
    batch_size, accum = 2, 2
    tokens = batch_size * seq
    mem_note("phase 10(c)'s entry")
    state = draw_state(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch_size, seed=0))
    log(f"  {cfg.name} as published ({cfg.num_layers} layers, "
        f"{param_count(cfg) / 1e9:.3f} B params; params, m and v "
        f"{state_bytes(state) / 1e9:.1f} GB on the card), batch "
        f"{batch_size} x {seq} in {accum} microbatches, SyntheticLM, "
        f"attention chunks of {cfg.attn_chunk} (the config's {cfg_chunk} "
        f"timed for one step apart)")
    eval_step = ts.make_eval_step(dataclasses.replace(cfg,
                                                      gemm_backend="xla"))
    hp = AdamWConfig(warmup_steps=2, total_steps=100)
    LC = "logits + cross entropy"
    TRAIN_RANGES = {(lm, "apply_block_seq"): "block",
                    (attn_lib, "chunked_attention"): "attention",
                    (lm, "logits"): "logits",
                    (ts, "cross_entropy"): "cross_entropy",
                    (ts, "adamw_update_"): "adamw"}
    FWD_PARTS = {"attention": "attention", "logits": LC,
                 "cross_entropy": LC}
    TRAIN_PARTS = ("forward", "attention", LC, "remat recompute",
                   "backward GEMMs", "matmul_ws f32 backward",
                   "backward, the rest", "AdamW update")

    def train_part(kernel, op, scope, fwd):
        """The part of a train step that a device event belongs to
        (``device_busy`` with ``TRAIN_RANGES``): the update; in the
        forward, attention, logits + cross entropy or the rest; in the
        backward, a block run again is the remat recompute, else the
        range its node's forward op ran in names attention or logits,
        else ``matmul_ws`` kernels (the simt form) are its f32 backward,
        cuBLAS GEMMs the backward GEMMs."""
        if scope == "adamw":
            return "AdamW update"
        if fwd is None:
            return FWD_PARTS.get(scope, "forward")
        if scope in ("block", "attention"):
            return "remat recompute"
        if fwd in FWD_PARTS:
            return FWD_PARTS[fwd]
        if is_mm_kernel(kernel):
            return "matmul_ws f32 backward"
        if any(t in kernel.lower() for t in ("gemm", "cutlass", "xmma",
                                             "nvjet")):
            return "backward GEMMs"
        return "backward, the rest"

    def timed_step(step_fn, state):
        """One step on the next batch → (state, metrics, ms)."""
        batch = on_card(data.batch_at(int(state["step"])))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        m = {key: float(v) for key, v in m.items()}
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"step {int(state['step']) - 1}: {m}")
        return state, m, ms

    reset_counts()
    lm_launches, lm_runs = 0, {}
    n_gemm = 3 * cfg.num_layers * accum       # MLP GEMM calls a step
    for backend in ("xla", "pallas_ws"):
        step_fn = ts.make_train_step(
            dataclasses.replace(cfg, gemm_backend=backend), hp,
            accum_steps=accum)
        times, forms, recorded = [], [], collections.Counter()
        torch.cuda.empty_cache()

        def record(x, w, bias=None):
            """The recording run: each call held to ``matmul_ws_plain``
            and counted by form."""
            with _disable_current_modes():
                path, _, got = hold_mm(x, w, bias)
            recorded[path] += 1
            return got
        for i in range(4):
            k = int(state["step"])
            before = dict(matmul_ws.path_launches)
            if i == 0:
                # the step's loss is the mean of its two microbatches'
                # token means, the eval step's (xla) the mean over all
                # tokens: the same function, computed from bf16
                # activations in GEMMs of other shapes; one bf16 rounding
                # (2^-8) of the loss bounds their difference
                eval_loss = float(eval_step(
                    state["params"], on_card(data.batch_at(k)))["loss"])
                kops._matmul_kernel = record
            try:
                state, m, ms = timed_step(step_fn, state)
            finally:
                kops._matmul_kernel = matmul_ws
            times.append(ms)
            forms.append({p: matmul_ws.path_launches[p] - before[p]
                          for p in PATHS})
            if i == 0:
                if abs(m["loss"] - eval_loss) > 2.0 ** -8 * abs(eval_loss):
                    raise AssertionError(f"{backend} step {k} loss "
                                         f"{m['loss']} against "
                                         f"make_eval_step's {eval_loss}")
                log(f"    {backend} step {k} (every matmul_ws call held to "
                    f"matmul_ws_plain): loss {m['loss']:.6f}, make_eval_step "
                    f"on the same batch {eval_loss:.6f} (bound 2^-8 "
                    f"relative)")
                # the checks' temporaries fragment the allocator's
                # cache: the timed steps start from an empty one (the
                # first of them a warm-up), and their peak is read
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            log(f"    {backend} step {k}: {times[-1]:.1f} ms, loss "
                f"{m['loss']:.4f}, grad norm {m['grad_norm']:.4f}, lr "
                f"{m['lr']:.3g}; matmul_ws by form {forms[-1]}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = {p: recorded.get(p, 0) for p in PATHS}
        # pallas_ws: each MLP GEMM runs wgmma forward and in the recompute,
        # two simt launches backward
        expect = dict.fromkeys(PATHS, 0)
        if backend == "pallas_ws":
            expect.update(wgmma=2 * n_gemm, simt=2 * n_gemm)
        if want != expect or any(f != want for f in forms):
            raise AssertionError(f"{backend}: matmul_ws launches a step "
                                 f"{forms}, the recording run {want}, "
                                 f"expected {expect}")
        ms = float(np.median(times[2:]))
        batch = on_card(data.batch_at(int(state["step"])))
        (state, _), busy, n_ev, parts = device_busy(
            lambda: step_fn(state, batch), part=train_part,
            ranges=TRAIN_RANGES, once=True)
        if busy is None or set(parts) - set(TRAIN_PARTS):
            raise AssertionError(f"{backend}: device ms {busy}, parts "
                                 f"{sorted(parts or ())}")
        # one step at the config's own attention chunk, whose blocks
        # differ in size from the cached ones: it starts, as the timed
        # steps do, from an empty cache
        gc.collect()
        torch.cuda.empty_cache()
        mem_note(f"{backend}'s step at attn_chunk {cfg_chunk}")
        state, m, cfg_ms = timed_step(ts.make_train_step(
            dataclasses.replace(cfg, gemm_backend=backend,
                                attn_chunk=cfg_chunk), hp,
            accum_steps=accum), state)
        lm_runs[backend] = (ms, busy, peak, parts, cfg_ms)
        log(f"  {backend}: {ms:.1f} ms a step (the median of the last two "
            f"of three steps after the recording one), "
            f"{tokens / ms * 1e3:.0f} tokens/s, peak {peak:.1f} GB (those "
            f"three); matmul_ws a step {want}; one profiled step: device busy "
            f"{busy:.1f} ms ({100 * busy / ms:.0f}% of the median step), "
            f"{n_ev} device events; device ms by part: " + ", ".join(
                f"{p} {parts.get(p, 0.0):.1f} "
                f"({100 * parts.get(p, 0.0) / busy:.0f}%)"
                for p in TRAIN_PARTS))
        log(f"  {backend} at the config's attn_chunk {cfg_chunk}: "
            f"{cfg_ms:.1f} ms for one step, {tokens / cfg_ms * 1e3:.0f} "
            f"tokens/s (loss {m['loss']:.4f})")
        # recorded, 3 timed, profiled, the config's chunk
        lm_launches += sum(want.values()) * 6
    if flash_attention.launches:
        raise AssertionError("LM training launched flash_attention")
    if matmul_ws.launches != lm_launches:
        raise AssertionError(f"LM training: {matmul_ws.launches} matmul_ws "
                             f"launches, the recorded steps give "
                             f"{lm_launches}")
    stats["matmul_ws"]["launches"] += matmul_ws.launches
    credit_forms()
    del state
    torch.cuda.empty_cache()

    # (d) the trainer at full width, 2 layers: an injected failure at step
    # 3 and a restore from the step-2 checkpoint give the uninterrupted
    # run's losses bit for bit (deterministic algorithms on)
    cfg_t = dataclasses.replace(get_config(LM_ARCH), num_layers=2)
    ckpt_dir = ROOT / "build" / "lm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free = shutil.disk_usage(ckpt_dir).free / 1e9
    t_data = SyntheticLM(DataConfig(vocab_size=cfg_t.vocab_size,
                                    seq_len=seq, global_batch=2, seed=2))
    t_hp = AdamWConfig(warmup_steps=2, total_steps=6)
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            st = draw_state(cfg_t, seed=3)
            fn = ts.make_train_step(cfg_t, t_hp)
            losses = []
            for k in range(6):
                st, m = fn(st, on_card(t_data.batch_at(k)))
                losses.append(float(m["loss"]))
            runs.append(losses)
            del st
        if runs[0] != runs[1]:
            raise AssertionError(f"two uninterrupted runs differ: {runs}")
        st = draw_state(cfg_t, seed=3)
        nbytes = state_bytes(st)
        trainer = Trainer(TrainerConfig(
            total_steps=6, checkpoint_every=2, fail_at_steps=(3,),
            keep_checkpoints=2, checkpoint_dir=str(ckpt_dir), log_every=0),
            ts.make_train_step(cfg_t, t_hp), t_data, st)
        timed = collections.defaultdict(list)
        for attr in ("save", "_write", "restore"):
            orig = getattr(trainer.ckpt, attr)

            def clocked(*a, _orig=orig, _attr=attr, **k):
                t0 = time.perf_counter()
                out = _orig(*a, **k)
                timed[_attr].append(1e3 * (time.perf_counter() - t0))
                return out
            setattr(trainer.ckpt, attr, clocked)
        hist = trainer.run()
    finally:
        torch.use_deterministic_algorithms(False)
    steps = [h["step"] for h in hist]
    if (trainer.restarts != 1 or sorted(set(steps)) != list(range(6))
            or any(h["loss"] != runs[0][h["step"]] for h in hist)):
        got = [(h["step"], h["loss"]) for h in hist]
        raise AssertionError(f"resumed run {got} against the "
                             f"uninterrupted {runs[0]}")
    log(f"  trainer, full width, 2 layers (state {nbytes / 1e9:.2f} GB, "
        f"{free:.0f} GB free on the checkpoint's disk before the run): "
        f"steps run {steps} (a failure injected at step 3, the step-2 "
        f"checkpoint restored); every loss equals the uninterrupted run's "
        f"bit for bit, which two runs reproduced: {runs[0]}")
    log(f"    checkpoint of {nbytes / 1e9:.2f} GB: save (host copy; the "
        f"write inline when blocking) " + ", ".join(
            f"{t:.0f}" for t in timed["save"]) + " ms; disk writes " +
        ", ".join(f"{t:.0f}" for t in timed["_write"]) + " ms; restore " +
        ", ".join(f"{t:.0f}" for t in timed["restore"]) + " ms")
    del trainer, st
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) the launcher on the card (the reduced config, the default device)
    launch_dir = ROOT / "build" / "lm_launch_ckpt"
    shutil.rmtree(launch_dir, ignore_errors=True)
    hist = train_launcher.main(["--arch", "llama3.2-3b", "--steps", "20",
                                "--ckpt-dir", str(launch_dir)])
    shutil.rmtree(launch_dir, ignore_errors=True)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    if not last < first:
        raise AssertionError(f"launcher: loss {first} -> {last}")
    log(f"  launcher (reduced llama3.2-3b, 20 steps on the card): loss "
        f"{first:.4f} -> {last:.4f}")
    log(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")

    # -- 11. distribution ----------------------------------------------------
    log("phase 11: distribution on torch.distributed (DTensor; TF32 off)")
    t_phase = time.perf_counter()
    mem_note("phase 11's entry")
    import contextlib

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.distributed.sharding import (ShardingPlan, device_put,
                                                  use_mesh)
    from repro_torch.launch.mesh import (backend_for, init_world,
                                         make_debug_mesh)
    from repro_torch.layers.common import tree_map
    sys.path.insert(0, str(ROOT / "tools"))
    from collectives_probe import probe_one

    # (a) one rank, NCCL, in this process
    backend_a = init_world(0, 1, f"tcp://localhost:{dc.free_port()}",
                           device=dev)
    mesh1 = make_debug_mesh(1, 1, device=dev)
    cfg_a = dataclasses.replace(get_config(LM_ARCH), num_layers=4,
                                remat_policy="minimal", attn_impl="chunked",
                                attn_chunk=TRAIN_ATTN_CHUNK,
                                gemm_backend="pallas_ws")
    # at lr 5e-4 a skipped update moves a param past the 1e-4 tolerance
    hp_a, accum_a = AdamWConfig(**dc.STEP_HP), 2
    specs_a = ts.init_state_specs(cfg_a)
    plan_a = ShardingPlan(mesh=mesh1, fsdp=True, mode="train")
    data_a = SyntheticLM(DataConfig(vocab_size=cfg_a.vocab_size,
                                    seq_len=seq, global_batch=2, seed=5))
    n_gemm_a = 3 * cfg_a.num_layers * accum_a
    reset_counts()
    states = {"unsharded": draw_state(cfg_a, seed=5)}
    states["sharded"] = device_put(tree_map(torch.clone,
                                            states["unsharded"]),
                                   dc.full_shardings(plan_a, specs_a))
    if not all(isinstance(t, DTensor) and t.to_local().is_cuda
               for t in tree_leaves(states["sharded"])):
        raise AssertionError("device_put left a leaf off the mesh or the "
                             "card")
    fns = {"unsharded": ts.make_train_step(cfg_a, hp_a,
                                           accum_steps=accum_a),
           "sharded": ts.make_train_step(cfg_a, hp_a, act_rules=plan_a.acts,
                                         accum_steps=accum_a)}

    def scoped(name):
        return use_mesh(mesh1) if name == "sharded" else \
            contextlib.nullcontext()

    worst_a = {"plain": 0.0, "ws": 0.0, "lib": 0.0}

    def recorder(forms):
        def record(x, w, bias=None):
            """Each call held to ``matmul_ws_plain`` on its (local)
            operands, counted by form; an f32 call also read against the
            float64 product (``hold_f32``; its operands are bf16 values,
            on which TF32 rounds nothing: no control)."""
            if isinstance(x, DTensor) or isinstance(w, DTensor):
                raise AssertionError("a DTensor reached the matmul_ws "
                                     "kernel")
            if x.dtype == torch.float32:
                forms["simt"] += 1
                return hold_f32(x, w, bias, worst=worst_a,
                                held=collections.Counter(), control=False)
            with _disable_current_modes():
                path, _, got = hold_mm(x, w, bias)
            forms[path] += 1
            return got
        return record

    batch_a = on_card(data_a.batch_at(0))
    outs, forms_a = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for name in ("unsharded", "sharded"):
            forms_a[name] = collections.Counter()
            kops._matmul_kernel = recorder(forms_a[name])
            try:
                with scoped(name):
                    outs[name], states[name] = dc.captured_step(
                        fns[name], states[name], batch_a)
            finally:
                kops._matmul_kernel = matmul_ws
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    want_forms = {"wgmma": 2 * n_gemm_a, "simt": 2 * n_gemm_a}
    if not (dict(forms_a["sharded"]) == dict(forms_a["unsharded"])
            == want_forms):
        raise AssertionError(f"matmul_ws calls by form: {forms_a}, "
                             f"expected {want_forms} each")
    # the gradient bound, derived as phase 10(b) derives its own: the
    # step's gradients come from its 2 × 24 f32 matmul_ws calls (dx and
    # dw; the forward and recompute run bf16 on the same operands in
    # both steps), each within w relative L2 of the exact product (w the
    # worst reading of either step's, matmul_ws's or torch.matmul's on the
    # same operands): 2 × 48 × w.  Phase 10(b)'s TF32 control has no
    # counterpart here: those calls' operands are bf16 values (the bf16
    # activations and cotangents, the bf16 weights), which TF32 holds
    # exactly, so a TF32 GEMM would give the same products
    per_call_a = max(worst_a["ws"], worst_a["lib"])
    bound_a = 2 * 2 * n_gemm_a * per_call_a
    differ = dc.outputs_equal(outs["sharded"], outs["unsharded"])
    if differ:
        # not bit-equal: name the differing leaves and hold them (the
        # gradients within bound_a, params / m / v by hold_step's rule)
        held_a = dc.hold_step(outs["sharded"], outs["unsharded"],
                              grad_rel=bound_a)
        log(f"  (a) sharded step differs from the unsharded one at "
            f"{differ[:12]}{' ...' if len(differ) > 12 else ''}: held "
            f"{held_a} (gradient bound {bound_a:.2e})")
    m_a = outs["sharded"][0]
    log(f"  (a) one rank, backend {backend_a}, mesh (data=1, model=1), "
        f"{cfg_a.name} at full width with {cfg_a.num_layers} layers "
        f"({param_count(cfg_a) / 1e9:.3f} B params), 2 x {seq} tokens in "
        f"{accum_a} microbatches, attention chunks of {cfg_a.attn_chunk}, "
        f"lr {m_a['lr']:.3g}: the sharded step "
        f"{'is bit-equal to' if not differ else 'held to'}"
        f" the unsharded one ({len(outs['sharded'][1])} gradients, params, "
        f"m, v and metrics; loss {m_a['loss']:.6f}, grad norm "
        f"{m_a['grad_norm']:.4f}); matmul_ws calls by form, each held to "
        f"matmul_ws_plain on its local operands: {dict(forms_a['sharded'])}"
        f" sharded, {dict(forms_a['unsharded'])} unsharded; f32 calls' "
        f"worst rel L2 from float64 {worst_a['ws']:.2e} (torch.matmul's "
        f"{worst_a['lib']:.2e}; bf16-valued operands, no TF32 control): "
        f"the bound a differing gradient would be held to, 2 × "
        f"{2 * n_gemm_a} × {per_call_a:.2e} = {bound_a:.2e}")
    del outs

    def timed_a(name, k):
        b = on_card(data_a.batch_at(k))
        with scoped(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[name], m = fns[name](states[name], b)
            loss = float(m["loss"])
            torch.cuda.synchronize()
        if not np.isfinite(loss):
            raise AssertionError(f"(a) {name} step {k}: loss {loss}")
        return 1e3 * (time.perf_counter() - t0)

    step_ms = collections.defaultdict(list)
    for k, name in enumerate(("unsharded", "sharded", "sharded", "unsharded",
                              "unsharded", "sharded"), start=1):
        step_ms[name].append(timed_a(name, k))

    def dist_part(kernel, op, scope, fwd):
        """Collectives (NCCL kernels) and the work of DTensor's
        redistributes, forward or backward, against the rest."""
        if "nccl" in kernel.lower() or "redistribute" in (scope, fwd):
            return "collectives + redistribute"
        return "the rest"
    with use_mesh(mesh1):
        (states["sharded"], _), busy_a, n_ev_a, parts_a = device_busy(
            lambda: fns["sharded"](states["sharded"],
                                   on_card(data_a.batch_at(7))),
            part=dist_part, ranges={(DTensor, "redistribute"):
                                    "redistribute"}, once=True)
    coll_ms = (parts_a or {}).get("collectives + redistribute", 0.0)
    ms_u = float(np.mean(step_ms["unsharded"][1:]))
    ms_s = float(np.mean(step_ms["sharded"][1:]))
    log(f"  (a) step times in turns (unsharded, sharded, sharded, "
        f"unsharded, unsharded, sharded; the first of each a warm-up): "
        f"unsharded {ms_u:.1f} ms, sharded {ms_s:.1f} ms "
        f"({100 * (ms_s / ms_u - 1):+.1f}%), "
        f"{2 * seq / ms_s * 1e3:.0f} tokens/s sharded; one profiled sharded "
        f"step: device busy "
        + (f"{busy_a:.1f} ms over {n_ev_a} events, collectives and "
           f"redistributes {coll_ms:.2f} ms "
           f"({100 * coll_ms / busy_a:.2f}% of device time)"
           if busy_a else "not measured (no device events in the trace)")
        + f" [{smi}]")
    phase11 = {"step_ms": (ms_u, ms_s), "coll_ms": coll_ms,
               "busy_ms": busy_a}

    # the sharded state (params, m, v, step) through a checkpoint onto the
    # unsharded tree and back onto the mesh, bit for bit
    sharded_s = states.pop("sharded")
    del states
    torch.cuda.empty_cache()
    ck_dir = ROOT / "build" / "dist_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck = Checkpointer(str(ck_dir))
    t0 = time.perf_counter()
    ck.save(1, sharded_s)
    plain_s, _ = ck.restore(tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
        sharded_s))
    ck.save(2, plain_s)
    back_s, _ = ck.restore(sharded_s, step=2, shardings=dc.full_shardings(
        plan_a, specs_a))
    ck_ms = 1e3 * (time.perf_counter() - t0)
    n_ck = 0
    for a, b, c in zip(tree_leaves(sharded_s), tree_leaves(plain_s),
                       tree_leaves(back_s)):
        if isinstance(b, DTensor) or not isinstance(c, DTensor) or not (
                torch.equal(a.full_tensor(), b)
                and torch.equal(c.to_local(), a.to_local())):
            raise AssertionError("checkpoint: the sharded state did not "
                                 "come back bit for bit")
        n_ck += 1
    log(f"  (a) checkpoint of the sharded state, params, m, v and step "
        f"({n_ck} leaves, {state_bytes(plain_s) / 1e9:.2f} GB), restored "
        f"onto the unsharded tree and that one's back onto the mesh, bit "
        f"for bit ({ck_ms:.0f} ms for two saves and two restores)")
    shutil.rmtree(ck_dir, ignore_errors=True)
    del sharded_s, plain_s, back_s
    torch.cuda.empty_cache()

    # the sharded decode: 4 slots × 4096 positions after a 3000-token
    # prefill (plain, dense attention: 3000 is no multiple of the chunk)
    cfg_d = dataclasses.replace(cfg_a, remat_policy="none")
    gen_d = torch.Generator(device=dev).manual_seed(6)
    params_d = lm.compute_params(materialize(lm.param_specs(cfg_d), gen_d,
                                             device=dev), cfg_d)
    cache_d, tok_d, pos_d = dc.prefilled_cache(
        params_d, dataclasses.replace(cfg_d, attn_impl="dense"), LM_SLOTS,
        4096, 3000)
    plan_d = ShardingPlan(mesh=mesh1, fsdp=False, mode="decode")
    forms_d = {}
    runs_d = {}
    for name in ("unsharded", "sharded"):
        forms_d[name] = collections.Counter()
        kops._matmul_kernel = recorder(forms_d[name])
        try:
            c = tree_map(torch.clone, cache_d)
            if name == "sharded":
                runs_d[name] = dc.sharded_decode(
                    params_d, c, cfg_d, plan_d, lm.param_specs(cfg_d),
                    lm.cache_specs(cfg_d, LM_SLOTS, 4096), tok_d, pos_d, 2)
            else:
                runs_d[name] = dc.plain_decode(params_d, c, cfg_d, tok_d,
                                               pos_d, 2)
        finally:
            kops._matmul_kernel = matmul_ws
    d_bound = cfg_d.num_layers * 2.0 ** -7
    d_rel = max(dc.rel_l2(a, b) for a, b in zip(runs_d["sharded"][0],
                                                runs_d["unsharded"][0]))
    d_equal = all(torch.equal(a, b) for a, b in zip(
        runs_d["sharded"][0], runs_d["unsharded"][0]))
    cache_equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs_d["sharded"][1]),
        tree_leaves(runs_d["unsharded"][1])))
    want_d = {"stream": 2 * 3 * cfg_d.num_layers}
    if (d_rel > d_bound or not cache_equal or not all(
            bool(torch.isfinite(t).all()) for t in runs_d["sharded"][0])
            or not (dict(forms_d["sharded"]) == dict(forms_d["unsharded"])
                    == want_d)):
        raise AssertionError(f"(a) sharded decode: logits rel L2 {d_rel} "
                             f"(bound {d_bound}), cache equal {cache_equal},"
                             f" matmul_ws forms {forms_d}")
    log(f"  (a) decode under mode='decode' (cache_seq over model), "
        f"{LM_SLOTS} slots x 4096 positions after a 3000-token prefill, 2 "
        f"steps: logits {'bit-equal to' if d_equal else 'within'} the "
        f"unsharded decode's (rel L2 {d_rel:.2e}, bound {d_bound:.4g}), "
        f"caches bit-equal; matmul_ws {dict(forms_d['sharded'])} held to "
        f"matmul_ws_plain")
    del params_d, cache_d, runs_d
    torch.cuda.empty_cache()

    # (a) the MoE layer's sharded backward at full width: deepseek-moe-16b
    # (64 routed experts of 1408, 2 shared) at DS_TRAIN_LAYERS layers, 2 x
    # DS_TRAIN_SEQ tokens, the FSDP plan on pallas_ws: the routed experts'
    # einsums and the router on local shards, the shared experts on
    # matmul_ws, every call held to matmul_ws_plain
    cfg_m = dataclasses.replace(get_config(DS_ARCH),
                                num_layers=DS_TRAIN_LAYERS,
                                gemm_backend="pallas_ws")
    specs_m = ts.init_state_specs(cfg_m)
    plan_m = ShardingPlan(mesh=mesh1, fsdp=True, mode="train")
    data_m = SyntheticLM(DataConfig(vocab_size=cfg_m.vocab_size,
                                    seq_len=DS_TRAIN_SEQ, global_batch=2,
                                    seed=13))
    states_m = {"unsharded": draw_state(cfg_m, seed=13)}
    states_m["sharded"] = device_put(tree_map(torch.clone,
                                              states_m["unsharded"]),
                                     dc.full_shardings(plan_m, specs_m))
    fns_m = {"unsharded": ts.make_train_step(cfg_m, hp_a),
             "sharded": ts.make_train_step(cfg_m, hp_a,
                                           act_rules=plan_m.acts)}
    worst_a.update(plain=0.0, ws=0.0, lib=0.0)
    outs_m, forms_m = {}, {}
    batch_m = on_card(data_m.batch_at(0))
    torch.use_deterministic_algorithms(True)
    try:
        for name in ("unsharded", "sharded"):
            forms_m[name] = collections.Counter()
            kops._matmul_kernel = recorder(forms_m[name])
            try:
                with scoped(name):
                    outs_m[name], states_m[name] = dc.captured_step(
                        fns_m[name], states_m[name], batch_m)
            finally:
                kops._matmul_kernel = matmul_ws
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    # the shared experts' three GEMMs a layer: forward and the remat's
    # recompute in bf16 (wgmma), dx and dw in f32 (simt)
    n_shared = 3 * cfg_m.num_layers
    want_m = {"wgmma": 2 * n_shared, "simt": 2 * n_shared}
    if not (dict(forms_m["sharded"]) == dict(forms_m["unsharded"])
            == want_m):
        raise AssertionError(f"(a) MoE: matmul_ws calls by form {forms_m},"
                             f" expected {want_m} each")
    per_call_m = max(worst_a["ws"], worst_a["lib"])
    bound_m = 2 * 2 * n_shared * per_call_m
    differ_m = dc.outputs_equal(outs_m["sharded"], outs_m["unsharded"])
    held_m = None
    if differ_m:
        held_m = dc.hold_step(outs_m["sharded"], outs_m["unsharded"],
                              grad_rel=bound_m)
    m_m, n_grads_m = outs_m["sharded"][0], len(outs_m["sharded"][1])
    if not (np.isfinite(m_m["loss"]) and m_m["aux_loss"] > 0):
        raise AssertionError(f"(a) MoE step metrics {m_m}")
    del outs_m

    def timed_m(name, k):
        b = on_card(data_m.batch_at(k))
        with scoped(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states_m[name], mm = fns_m[name](states_m[name], b)
            loss = float(mm["loss"])
            torch.cuda.synchronize()
        if not np.isfinite(loss):
            raise AssertionError(f"(a) MoE {name} step {k}: loss {loss}")
        return 1e3 * (time.perf_counter() - t0)
    ms_m = collections.defaultdict(list)
    for k, name in enumerate(("unsharded", "sharded", "sharded",
                              "unsharded"), start=1):
        ms_m[name].append(timed_m(name, k))
    log(f"  (a) MoE sharded backward: {cfg_m.name} at full width (d_model "
        f"{cfg_m.d_model}, {cfg_m.moe.num_experts} routed experts of "
        f"{cfg_m.moe.expert_ff}, top {cfg_m.moe.top_k}, "
        f"{cfg_m.moe.num_shared} shared) with {cfg_m.num_layers} layers "
        f"({param_count(cfg_m) / 1e9:.3f} B params), 2 x {DS_TRAIN_SEQ} "
        f"tokens, FSDP plan, pallas_ws, one rank: the sharded step "
        + ("is bit-equal to" if not differ_m else
           f"differs at {differ_m[:8]} and is held ({held_m}) to")
        + f" the unsharded one ({n_grads_m} gradients, params, m, v and "
        f"metrics; loss {m_m['loss']:.6f}, aux "
        f"loss {m_m['aux_loss']:.6f}, grad norm {m_m['grad_norm']:.4f}); "
        f"the gradient bound a differing leaf is held to, 2 x "
        f"{2 * n_shared} x {per_call_m:.2e} = {bound_m:.2e}; matmul_ws "
        f"calls by form, each held to matmul_ws_plain: "
        f"{dict(forms_m['sharded'])} a step, as the shared experts' "
        f"{n_shared} GEMMs predict; step ms unsharded "
        f"{float(np.mean(ms_m['unsharded'])):.1f}, sharded "
        f"{float(np.mean(ms_m['sharded'])):.1f} (after one warm-up each: "
        f"{ms_m['unsharded'][0]:.1f} / {ms_m['sharded'][0]:.1f}) [{smi}]")
    phase11["moe_ms"] = (float(np.mean(ms_m["unsharded"])),
                         float(np.mean(ms_m["sharded"])))
    del states_m, fns_m
    torch.cuda.empty_cache()

    # (a) rwkv6-1.6b at full width and depth on local shards: the sharded
    # prefill (the wkv core on this rank's rows and heads) and 2 decode
    # steps against the unsharded ones
    cfg_r = get_config(RWKV_ARCH)
    params_r = lm.compute_params(materialize(
        lm.param_specs(cfg_r), torch.Generator(device=dev).manual_seed(14),
        device=dev), cfg_r)
    gen_r = torch.Generator(device="cpu").manual_seed(14)
    toks_r = torch.randint(0, cfg_r.vocab_size, (LM_SLOTS, RWKV_SHARD_SEQ),
                           generator=gen_r).to(dev)
    t0 = time.perf_counter()
    got_r, pcache_r = dc.family_prefill(params_r, cfg_r, ShardingPlan(
        mesh=mesh1, fsdp=False, mode="prefill"), {"tokens": toks_r})
    prefill_ms_r = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():
        want_r, cache_r = lm.prefill(params_r, {"tokens": toks_r}, cfg_r)
    pstate_eq_r = all(torch.equal(a, b.cpu()) for a, b in zip(
        tree_leaves(pcache_r), tree_leaves(cache_r)))
    tok_r, pos_r = toks_r[:, -1], torch.full((LM_SLOTS,), RWKV_SHARD_SEQ,
                                             device=dev)
    dec_r = dc.sharded_decode(
        params_r, tree_map(torch.clone, cache_r), cfg_r,
        ShardingPlan(mesh=mesh1, fsdp=False, mode="decode"),
        lm.param_specs(cfg_r), lm.cache_specs(cfg_r, LM_SLOTS,
                                              RWKV_SHARD_SEQ),
        tok_r, pos_r, 2)
    plain_r = dc.plain_decode(params_r, cache_r, cfg_r, tok_r, pos_r, 2)
    bound_r = cfg_r.num_layers * 2.0 ** -7
    rel_r = [dc.rel_l2(got_r, want_r.cpu())] + [
        dc.rel_l2(a, b) for a, b in zip(dec_r[0], plain_r[0])]
    eq_r = torch.equal(got_r, want_r.cpu()) and all(
        torch.equal(a, b) for a, b in zip(dec_r[0], plain_r[0]))
    cache_eq_r = pstate_eq_r and all(torch.equal(a, b) for a, b in zip(
        tree_leaves(dec_r[1]), tree_leaves(plain_r[1])))
    if max(rel_r) > bound_r or not cache_eq_r or not all(
            bool(torch.isfinite(t).all()) for t in [got_r, *dec_r[0]]):
        raise AssertionError(f"(a) rwkv6 sharded: logits rel L2 {rel_r} "
                             f"(bound {bound_r}), state equal {cache_eq_r}")
    log(f"  (a) {cfg_r.name} at full width and depth ({cfg_r.num_layers} "
        f"layers, {cfg_r.d_model // cfg_r.rwkv_head_size} heads of "
        f"{cfg_r.rwkv_head_size}), mode='prefill' then 'decode' on one "
        f"rank: the sharded prefill of {LM_SLOTS} x {RWKV_SHARD_SEQ} "
        f"tokens ({prefill_ms_r:.0f} ms, the wkv core on local rows and "
        f"heads) and 2 decode steps "
        f"{'bit-equal to' if eq_r else 'within'} the unsharded ones "
        f"(logits rel L2 {max(rel_r):.2e}, bound {bound_r:.4g}); the "
        f"state after the prefill and after them bit-equal")
    del params_r, cache_r, pcache_r, dec_r, plain_r
    torch.cuda.empty_cache()
    if flash_attention.launches:
        raise AssertionError("phase 11 launched flash_attention")
    log(f"  (a) matmul_ws launches: {matmul_ws.launches} (by form "
        f"{matmul_ws.path_launches})")
    stats["matmul_ws"]["launches"] += matmul_ws.launches
    credit_forms()
    dist.destroy_process_group()

    # (b) 4 ranks on the card
    world_b = 4
    n_cards = torch.cuda.device_count()
    backend_b = backend_for(dev, world_b)
    needs = sorted({c for v in dc.CARD_CHECKS.values() for c in v})
    probe = {c: {"ok": True, "error": ""} for c in needs}
    if backend_b == "gloo":
        probe = {c: probe_one(c, world_b, "gloo", "cuda") for c in needs}
    allowed = [k for k, v in dc.CARD_CHECKS.items()
               if all(probe[c]["ok"] for c in v)]
    waiting = [k for k in dc.CARD_CHECKS if k not in allowed]
    log(f"  (b) {world_b} ranks on {n_cards} card(s), backend {backend_b}"
        f"{' (the ranks share the card)' if n_cards < world_b else ''}; "
        f"probe of what the checks need beyond their own collectives: "
        + ", ".join(f"{c} {'ok' if r['ok'] else 'NO: ' + r['error']}"
                    for c, r in probe.items()))
    out_b, _ = dc.spawn_ranks(dc.card_scenarios, world_b, tuple(allowed),
                              LM_ARCH, 8, device=dev, timeout_s=900)
    ps, pp = out_b.get("compressed_psum"), out_b.get("pipeline_apply")
    if ps is None or not ps["equal"]:
        raise AssertionError(f"(b) compressed_psum: {ps}")
    if pp is None or not (pp["forward_equal"] and pp["grad_rel"] <= 1e-5):
        raise AssertionError(f"(b) pipeline_apply: {pp}")
    log(f"  (b) compressed_psum of a [3072, 8192] f32 leaf over 4 ranks: "
        f"bit-equal to the sum of the ranks' own int8 shards times the "
        f"largest scale (max |sum| {ps['max']:.4g})")
    log(f"  (b) pipeline_apply, 4 stages of one full-width {LM_ARCH} block "
        f"each (f32, xla), 8 microbatches of 512 tokens: output bit-equal "
        f"to the sequential stack's, gradients of all {pp['leaves']} stage "
        f"leaves within {pp['grad_rel']:.2e} relative L2 (bound 1e-5: the "
        f"8 microbatches' terms summed in another order); "
        f"{pp['ms']:.0f} ms forward + backward")
    st = out_b.get("sharded_train_step")
    sd = out_b.get("sharded_decode_step")
    if st is not None:
        log(f"  (b) sharded train step, 2 full-width layers on (data=2, "
            f"model=2), FSDP, f32 compute, 2 x 2048 tokens: {st['ms']:.0f} "
            f"ms; against rank 0's unsharded step: loss {st['loss']:.2e}, "
            f"gradients {st['grad_rel']:.2e} relative L2 (bound 2 × "
            f"{st['calls']} × {st['per_call']:.2e} = {st['bound']:.2e}, "
            f"the TF32 control's at least {st['ctl']:.2e}), params, m and "
            f"v within {st['state']:.2e} ({st['near_zero']} near-zero "
            f"param elements at 2·lr) [{smi}]")
    if sd is not None:
        log(f"  (b) sharded decode, 2 full-width layers, 4 slots x 4096 "
            f"after 3000 tokens: logits {sd['rel']:.2e} relative L2 of the "
            f"unsharded decode's (bound {sd['bound']:.4g})")
    if waiting:
        log("  (b) waiting for a machine with one card per rank, where "
            "NCCL carries DTensor's all-gather: " + ", ".join(waiting))
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")

    # -- 12. the roofline of the LM's steps; the dry run ---------------------
    log("phase 12: llama3.2-3b's steps counted on the card against the H100's "
        "published peaks (roofline.counts, roofline.analysis.H100), and "
        "the dry run (launch.dryrun)")
    t_phase = time.perf_counter()
    mem_note("phase 12's entry")
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch import dryrun
    from repro_torch.roofline import counts as rcounts
    from repro_torch.roofline.analysis import H100, terms
    from repro_torch.serving.serve_step import (make_decode_step,
                                                make_prefill_step)

    # (a) each step counted on the card (real tensors, full depth) and by
    # the dry run on fake tensors of the same one-card cell (mesh "one";
    # one and two layer groups, extrapolated to 28), on xla and pallas_ws
    ROOF_STEPS = {
        "prefill": (ShapeConfig("prefill_4096", seq, 1, "prefill"),
                    {"attn_impl": "flash"}, 1),
        "decode": (ShapeConfig("decode_4x4096", LM_MAX_SEQ, LM_SLOTS,
                               "decode"), {}, 1),
        # phase 10(c)'s step: 2 x 4096 tokens in two microbatches, remat
        # "minimal", 2048-position attention chunks, f32 state
        "train": (ShapeConfig("train_2x4096", seq, 2, "train"),
                  {"remat_policy": "minimal", "attn_impl": "chunked",
                   "attn_chunk": TRAIN_ATTN_CHUNK}, 2)}

    def predicted_forms(c, kind, m):
        """matmul_ws launches by form that a ``kind`` step of ``c`` makes
        on ``pallas_ws`` (``mm_path`` of each MLP GEMM; M = ``m`` rows):
        the bf16 forward; in a train step also its remat recompute and
        the f32 dx and dw of each, a microbatch each."""
        want = collections.Counter()
        for k, n in layer_gemms(c):
            want[mm_path(m, k, n, torch.bfloat16)] += c.num_layers
            if kind == "train":
                want[mm_path(m, k, n, torch.bfloat16)] += c.num_layers
                want[mm_path(m, n, k, torch.float32)] += c.num_layers
                want[mm_path(k, m, n, torch.float32)] += c.num_layers
        if kind == "train":
            want = collections.Counter({p: 2 * v for p, v in want.items()})
        return {p: want.get(p, 0) for p in PATHS}

    def real_step(kind, c, accum):
        """(step, args) of the ``kind`` step of ``c`` on the card, its
        inputs drawn from seed 12 (bf16 params for serving, phase 10's
        f32 state for training); the args hold every tensor, so
        deleting them frees the step's memory."""
        gen = torch.Generator(device=dev).manual_seed(12)

        def ints(high, shape, low=0):
            return torch.randint(low, high, shape, generator=gen,
                                 device=dev, dtype=torch.int32)
        if kind == "train":
            return ts.make_train_step(c, AdamWConfig(), accum_steps=accum), (
                draw_state(c, seed=12),
                {k: ints(c.vocab_size, (2, seq)) for k in ("tokens",
                                                          "labels")})
        params = materialize(lm.param_specs(c), gen, device=dev,
                             dtype_override="bfloat16")
        if kind == "prefill":
            return torch.no_grad()(make_prefill_step(c)), (
                params, {"tokens": ints(c.vocab_size, (1, seq))})
        return torch.no_grad()(make_decode_step(c)), (
            params, materialize(lm.cache_specs(c, LM_SLOTS, LM_MAX_SEQ),
                                gen, device=dev, dtype_override="bfloat16"),
            ints(c.vocab_size, (LM_SLOTS,)),
            ints(LM_MAX_SEQ, (LM_SLOTS,), low=3000))

    def median_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    roof, roof_extra, fake_s = {}, {}, 0.0
    reset_counts()
    roof_mm, roof_flash = 0, 0
    for kind, (shape, over, accum) in ROOF_STEPS.items():
        for backend in ("xla", "pallas_ws"):
            t0 = time.perf_counter()
            fake, _, _, _, _, c, _, _, _ = dryrun.count_cell(
                LM_ARCH, shape, "one", device=dev,
                overrides={**over, "gemm_backend": backend},
                accum_steps=accum)
            fake_s += time.perf_counter() - t0
            # the train step peaks at ~73 GB of the card's 80: what the
            # earlier phases left in the allocator's cache goes first
            gc.collect()
            torch.cuda.empty_cache()
            log(f"  {kind} {backend}: {torch.cuda.memory_allocated() / 1e9:.2f}"
                f" GB allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
                f"reserved before the step's inputs are drawn")
            step, args = real_step(kind, c, accum)
            before = dict(matmul_ws.path_launches)
            flash0 = flash_attention.launches
            _, card = rcounts.analyze(step, *args)
            torch.cuda.synchronize()
            forms = {p: matmul_ws.path_launches[p] - before[p]
                     for p in PATHS}
            flash_n = flash_attention.launches - flash0
            diff = {k: (v, fake.as_dict()[k])
                    for k, v in card.as_dict().items()
                    if v != fake.as_dict()[k]}
            if diff:
                raise AssertionError(f"{kind} {backend}: the card's count "
                                     f"differs from the dry run's: {diff}")
            want = (predicted_forms(c, kind, LM_SLOTS if kind == "decode"
                                    else seq)
                    if backend == "pallas_ws" else dict.fromkeys(PATHS, 0))
            n_ws = card.op_counts.get("repro_torch.matmul_ws", 0)
            want_flash = c.num_layers if kind == "prefill" else 0
            if forms != want or n_ws != sum(want.values()) \
                    or flash_n != want_flash:
                raise AssertionError(
                    f"{kind} {backend}: matmul_ws launches {forms} (counted "
                    f"ops {n_ws}), mm_path predicts {want}; flash_attention "
                    f"{flash_n}, expected {want_flash}")
            roof_mm += sum(forms.values())
            roof_flash += flash_n
            if kind == "train":
                ms = lm_runs[backend][0]          # phase 10(c)'s median
            else:
                ms = median_ms(lambda: step(*args), 3 if kind == "prefill"
                               else 20)
                runs = 4 if kind == "prefill" else 21   # warm-up + timed
                roof_mm += sum(want.values()) * runs
                roof_flash += want_flash * runs
            roof[kind, backend] = (card, ms)
            del args, step
            torch.cuda.empty_cache()
        # the same work on both backends, except that remat "minimal"
        # saves the dots on xla (aten mm / bmm) and recomputes the
        # matmul_ws GEMMs in the train step's backward, as the
        # reference's policy recomputes its pallas_call: their forward
        # FLOPs once more a microbatch
        a, b = roof[kind, "xla"][0], roof[kind, "pallas_ws"][0]
        m = seq * 2 // accum
        extra = (accum * c.num_layers * sum(2 * m * k * n for k, n in
                                            layer_gemms(c))
                 if kind == "train" else 0)
        if b.flops - a.flops != extra:
            raise AssertionError(f"{kind}: xla counts {a.flops} FLOPs, "
                                 f"pallas_ws {b.flops}, the recompute "
                                 f"{extra}")
        roof_extra[kind] = extra
    if matmul_ws.launches != roof_mm or flash_attention.launches != roof_flash:
        raise AssertionError(f"phase 12 launches: matmul_ws "
                             f"{matmul_ws.launches} (expected {roof_mm}), "
                             f"flash_attention {flash_attention.launches} "
                             f"(expected {roof_flash})")
    stats["matmul_ws"]["launches"] += matmul_ws.launches
    credit_forms()
    stats["flash_attention"]["launches"] += flash_attention.launches
    log(f"  [{smi}]; peaks: bf16 {H100['peak_flops']['bfloat16'] / 1e12:.0f}"
        f", f32 {H100['peak_flops']['float32'] / 1e12:.0f} TFLOP/s, HBM "
        f"{H100['hbm_bw'] / 1e12:.2f} TB/s (published, 700 W); each count "
        f"equal to the dry run's fake count of the same one-card cell "
        f"(one and two layer groups extrapolated to {lm_full.num_layers}; "
        f"{fake_s:.1f} s of host time for all six)")
    worst = 0.0
    for (kind, backend), (c, ms) in roof.items():
        where = " (phase 10(c)'s median)" if kind == "train" else ""
        t = terms(c, H100)
        bound = max(t.values())
        share = 1e3 * bound / ms
        worst = max(worst, share)
        by_dt = ", ".join(f"{dt} {f / 1e12:.4f}"
                          for dt, f in sorted(c.flops_by_dtype.items()))
        log(f"  {kind:7s} {backend:9s}: TFLOP {by_dt}; traffic "
            f"{c.traffic / 1e9:.3f} GB; terms compute {1e3 * t['compute']:.3f}"
            f" / memory {1e3 * t['memory']:.3f} / collective "
            f"{1e3 * t['collective']:.3f} ms; bound by "
            f"{max(t, key=t.get)}; measured {ms:.2f} ms{where}; bound / "
            f"measured {share:.4f}")
        if share > 1.05:
            raise AssertionError(f"{kind} {backend}: roofline share "
                                 f"{share:.3f} above 1.05: the counts or "
                                 f"the peaks are wrong")
    log(f"  FLOPs equal on both backends in the prefill and decode; the "
        f"train step's pallas_ws count is xla's plus the recomputed MLP "
        f"GEMMs, {roof_extra['train'] / 1e12:.4f} TFLOP (remat "
        f"\"minimal\" saves aten dots, recomputes matmul_ws)")
    log(f"  shares at most {worst:.4f} (gate 1.05); launches held: "
        f"matmul_ws {matmul_ws.launches}, flash_attention "
        f"{flash_attention.launches}")

    # (b) the launcher: one production cell on fake CUDA tensors over a
    # fake process group of 256 ranks, in a subprocess
    out_dir = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out_dir)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"dry run launcher: exit {run.returncode}: "
                             f"{run.stderr[-3000:]}")
    cell = json.loads((out_dir / "llama3p2_3b__decode_32k__single.json")
                      .read_text())
    shape = SHAPES["decode_32k"]
    c = dataclasses.replace(lm_full, param_dtype="bfloat16")
    plan = ShardingPlan(mesh=AbstractMesh((16, 16), ("data", "model")),
                        fsdp=False, mode="decode")

    def shard_bytes(specs, shardings, dtype=None):
        """One rank's bytes of ``specs`` laid out by ``shardings``: each
        sharded dim divided by its mesh axes' sizes."""
        sizes, total = {"data": 16, "model": 16}, [0]

        def one(s, sh):
            n = 1
            for i, d in enumerate(s.shape):
                e = sh.spec[i] if i < len(sh.spec) else None
                for a in (() if e is None else (e,) if isinstance(e, str)
                          else e):
                    d //= sizes[a]
                n *= d
            total[0] += n * torch_dtype(dtype or s.dtype).itemsize
        tree_map(one, specs, shardings)
        return total[0]
    pspecs = lm.param_specs(c)
    cspecs = lm.cache_specs(c, shape.global_batch, shape.seq_len)
    # the token and position vectors go whole to every rank
    want_args = (shard_bytes(pspecs, plan.param_shardings(pspecs),
                             "bfloat16")
                 + shard_bytes(cspecs, plan.cache_shardings(cspecs))
                 + 2 * shape.global_batch * 4)
    mem, rl = cell["memory_analysis"], cell["roofline"]
    if (cell["chips"] != 256 or mem["argument_bytes"] != want_args
            or rl["bottleneck"] not in ("compute", "memory", "collective")
            or not cell["device"].startswith("cuda")):
        raise AssertionError(f"dry run cell: chips {cell['chips']}, "
                             f"argument_bytes {mem['argument_bytes']} "
                             f"(the plan's shards {want_args}), bottleneck "
                             f"{rl['bottleneck']}, device {cell['device']}")
    log(f"  (b) python -m repro_torch.launch.dryrun --arch llama3.2-3b "
        f"--shape decode_32k --mesh single: {cli_s:.1f} s, fake "
        f"{cell['device']} tensors over 256 fake ranks; per rank argument "
        f"{mem['argument_bytes'] / 1e9:.3f} GB (the plan's local shards), "
        f"peak {mem['peak_bytes'] / 1e9:.3f} GB (extrapolated from "
        f"{cell['depth']['counted_groups']} groups), terms compute "
        f"{1e3 * rl['t_compute']:.4f} / memory {1e3 * rl['t_memory']:.4f} "
        f"/ collective {1e3 * rl['t_collective']:.4f} ms, bound by "
        f"{rl['bottleneck']}; collectives "
        f"{cell['collective_counts']}")

    # (b) the train_4k cells on single that the distribution of every
    # family repaired (the MoE layer's sharded backward, rwkv6 on local
    # shards, seamless's frontend on local shards), started in phase 1
    t0 = time.perf_counter()
    for arch, proc in train_cells.items():
        proc.wait(timeout=600)
        if proc.returncode != 0:
            err = (TRAIN_CELLS_DIR / f"{arch}.log").read_text()
            raise AssertionError(f"dry run {arch} train_4k single: exit "
                                 f"{proc.returncode}: {err[-3000:]}")
    wait_s = time.perf_counter() - t0
    cells_s = time.perf_counter() - t_cells
    for arch in REPAIRED_TRAIN_CELLS:
        cell = json.loads((TRAIN_CELLS_DIR
                           / f"{arch}__train_4k__single.json").read_text())
        mem, rl = cell["memory_analysis"], cell["roofline"]
        if (cell["chips"] != 256 or not cell["device"].startswith("cuda")
                or not cell["cost_analysis"]["flops"] > 0
                or not cell["collective_counts"]):
            raise AssertionError(f"dry run cell {arch} train_4k: {cell}")
        log(f"  (b) {arch} train_4k single: fake {cell['device']} tensors "
            f"over 256 fake ranks, host {cell['run_s']:.1f} s "
            f"({cell['depth']['counted_groups']} of "
            f"{cell['depth']['groups']} groups counted); per rank terms "
            f"compute {1e3 * rl['t_compute']:.1f} / memory "
            f"{1e3 * rl['t_memory']:.1f} / collective "
            f"{1e3 * rl['t_collective']:.1f} ms, bound by "
            f"{rl['bottleneck']}; peak {mem['peak_bytes'] / 1e9:.2f} GB "
            f"(fits 80 GB: {mem['fits_80GB']})")
    log(f"  (b) the train_4k cells side by side on the host: done within "
        f"{cells_s:.1f} s of their start in phase 1; phase 12 waited "
        f"{wait_s:.1f} s for them")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(TRAIN_CELLS_DIR, ignore_errors=True)

    # (c) the conv programs counted on the card: the int8 forwards of
    # vgg_imagenet, mobilenet_small and unet_small at 224, batch 8 (through
    # make_int8_program), and phase 8's QAT step of vgg_imagenet, each run
    # under CostCounter on real tensors and again on fake CUDA tensors of
    # the same shapes; the conv ops (repro_torch::conv2d_ws and
    # repro_torch::conv2d_ws_pipe) carry their own FLOP formula
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map as pytree_map

    def faked(mode, tree):
        """``tree`` with every tensor a fake tensor of ``mode`` (same
        shape, dtype and device)."""
        return pytree_map(lambda t: mode.from_tensor(t)
                          if isinstance(t, torch.Tensor) else t, tree)

    def fake_program(mode, q):
        return network.make_int8_program(dataclasses.replace(q, **{
            f.name: faked(mode, getattr(q, f.name))
            for f in dataclasses.fields(q) if f.name != "plan"}),
            ConvCoreConfig(int8=True))

    def events_ms(fn, n):
        """Median ms of ``n`` calls of ``fn``, each between two CUDA events,
        after one call of warm-up."""
        fn()
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    # a served network packs each tensor-core layer's weights once, on its
    # first call, though they reach the launch through the dispatcher
    cwm = sys.modules["repro_torch.kernels.conv2d_ws"]
    packs, pack0 = [], cwm._pack
    cwm._pack = lambda w: packs.append(tuple(w.shape)) or pack0(w)
    conv_runs = []
    for name in ("vgg_imagenet", "mobilenet_small", "unet_small"):
        plan = getattr(network, name)(
            **({} if name == "vgg_imagenet" else
               {"input_shape": (224, 224, 4)}))
        rng = np.random.default_rng(30)
        params = plan.init_params(rng, device=dev)
        calib = torch.from_numpy(rng.normal(size=(BATCH, *plan.input_shape))
                                 .astype(np.float32)).to(dev)
        q = network.quantize_network(plan, params, calib)
        x_ = torch.from_numpy(rng.normal(size=(BATCH, *plan.input_shape))
                              .astype(np.float32)).to(dev)
        conv_runs.append((f"{name} int8 forward", plan,
                          network.make_int8_program(q, ConvCoreConfig(
                              int8=True)), (x_,),
                          lambda mode, q=q: fake_program(mode, q)))
    qplan = network.vgg_imagenet()
    qx, qy = training.synthetic_digits(
        np.random.default_rng(1), BATCH, input_shape=qplan.input_shape,
        classes=1000, device=dev)
    qstep = training.make_train_step(qplan, training.TrainConfig(
        qat=True, per_channel=True))
    conv_runs.append(("vgg_imagenet QAT step", qplan, qstep, (
        training.init_train_state(qplan, np.random.default_rng(0),
                                  device=dev), qx, qy),
        lambda mode: qstep))
    reset_counts()
    log(f"  (c) [{smi}] the conv programs at 224, batch {BATCH}: counted on "
        f"the card and on fake CUDA tensors (equal), launches by path under "
        f"the counter, ms the median of CUDA events around a call:")
    for label, plan, fn, args, make_fake in conv_runs:
        before = {k: path_counts(wrappers[k]) for k in convs}
        mm0, pack_n = matmul_ws.launches, len(packs)
        _, card = rcounts.analyze(fn, *args)
        torch.cuda.synchronize()
        launched = {k: tuple(a - b for a, b in zip(path_counts(wrappers[k]),
                                                   before[k]))
                    for k in convs}
        mode = FakeTensorMode()
        fargs, ffn = faked(mode, args), make_fake(mode)
        with mode:
            _, fake = rcounts.analyze(ffn, *fargs)
        diff = {k: (v, fake.as_dict()[k]) for k, v in card.as_dict().items()
                if v != fake.as_dict()[k]}
        if diff:
            raise AssertionError(f"{label}: the card's count differs from "
                                 f"the count on fake tensors: {diff}")
        n_conv = sum(sp.kind in ("conv", "conv_transpose")
                     for sp in plan.layers)
        ops_ = {k: card.op_counts.get(f"repro_torch.{k}", 0) for k in convs}
        if (any(ops_[k] != launched[k][0] for k in convs)
                or card.op_counts.get("repro_torch.matmul_ws", 0)
                != matmul_ws.launches - mm0
                or ("QAT" not in label and sum(ops_.values()) != n_conv)):
            raise AssertionError(
                f"{label}: counted ops {dict(card.op_counts)}, launches "
                f"(all, {', '.join(CONV_PATHS)}) {launched}, matmul_ws "
                f"{matmul_ws.launches - mm0}, {n_conv} conv layers")
        ms = events_ms(lambda: fn(*args), 5)
        n_tc = sum(v[1] for v in launched.values())
        if "QAT" not in label and len(packs) - pack_n != n_tc:
            raise AssertionError(f"{label}: {len(packs) - pack_n} weight "
                                 f"packs over 7 calls, {n_tc} tensor-core "
                                 f"layers")
        t = terms(card, H100)
        share = 1e3 * max(t.values()) / ms
        path_split = {k: dict(zip(CONV_PATHS, v[1:]))
                      for k, v in launched.items() if v[0]}
        by_dt = ", ".join(f"{dt} {f / 1e12:.6f}"
                          for dt, f in sorted(card.flops_by_dtype.items()))
        log(f"    {label}: TFLOP {by_dt}; traffic {card.traffic / 1e9:.4f} "
            f"GB; terms compute {1e3 * t['compute']:.4f} / memory "
            f"{1e3 * t['memory']:.4f} / collective "
            f"{1e3 * t['collective']:.4f} ms, bound by {max(t, key=t.get)}; "
            f"measured {ms:.3f} ms; bound / measured {share:.4f}; ops "
            f"{dict(card.op_counts)}; conv launches by path {path_split}, "
            f"matmul_ws {matmul_ws.launches - mm0}; weight packs over 7 "
            f"calls {len(packs) - pack_n}")
        if share > 1.05:
            raise AssertionError(f"{label}: roofline share {share:.3f} above "
                                 f"1.05: the counts or the peaks are wrong")
    cwm._pack = pack0
    for k, fn in wrappers.items():
        stats[k]["launches"] += fn.launches
    for k in convs:
        stats[k]["simt"]["launches"] += wrappers[k].simt_launches
    credit_paths()
    credit_forms()
    del conv_runs, args, fargs

    # (d) the host time the torch.library ops add to a call: matmul_ws at
    # the decode step's MLP GEMMs, conv2d_ws at the §5.2 layer.  Each
    # window issues its calls back to back and is timed from the first
    # call to the last one's return: fewer launches than the stream's
    # queue holds, so the host never waits on the device and the time is
    # the host's.  The launches here are not the main path's: the counts
    # are put back afterwards.
    def interleaved_host_us(routes, calls, reps, windows=20):
        """Host us a call of each route over ``windows`` interleaved
        windows of ``reps`` × ``calls`` (argument tuples), after holding
        every route's result equal → ({route: per-window us}, the most us
        the stream drained after a window)."""
        for a in calls:
            outs = [f(*a) for f in routes.values()]
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise AssertionError(f"{list(routes)} differ at "
                                     f"{[tuple(t.shape) for t in a]}")
        host, drain, names = {r: [] for r in routes}, [], list(routes)
        for i in range(windows):
            for r in names[i % 3:] + names[:i % 3]:
                f = routes[r]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    for a in calls:
                        f(*a)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                drain.append(1e6 * (time.perf_counter() - t1))
                host[r].append(1e6 * (t1 - t0) / (reps * len(calls)))
        return {r: np.array(v) for r, v in host.items()}, max(drain)

    def spread(v):
        return (f"{np.median(v):.3f} ({v.min():.3f}-{v.max():.3f})")

    mwm = sys.modules["repro_torch.kernels.matmul_ws"]

    def before_op(x, w, bias=None):
        """``matmul_ws`` as it was before the op: the same checks, then
        the launch called directly."""
        mwm._dtype(x, w)
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor) or isinstance(w, DTensor):
            raise TypeError("matmul_ws takes plain tensors")
        if x.device.type == "cpu":
            return mwm.matmul_ws_plain(x, w, bias)
        if not x.is_cuda:
            raise ValueError(f"matmul_ws runs on a CUDA or CPU tensor, "
                             f"got {x.device}")
        return mwm._cuda_impl(x, w, bias)

    saved = {k: path_counts(wrappers[k]) for k in convs}, \
        matmul_ws.launches, dict(matmul_ws.path_launches)
    gen = torch.Generator(device=dev).manual_seed(12)
    gemms = [(torch.randn(LM_SLOTS, k, generator=gen, device=dev,
                          dtype=torch.bfloat16),
              torch.randn(k, n, generator=gen, device=dev,
                          dtype=torch.bfloat16) / k ** 0.5)
             for k, n in layer_gemms(lm_full)]
    reps, windows = 200, 20
    host, drained = interleaved_host_us(
        {"wrapper": matmul_ws, "op": mwm._OP, "before": before_op}, gemms,
        reps, windows)
    d_wrap = float(np.median(host["wrapper"] - host["before"]))
    d_op = float(np.median(host["op"] - host["before"]))
    n_dec = sum(predicted_forms(lm_full, "decode", LM_SLOTS).values())
    dec_ms = roof["decode", "pallas_ws"][1]
    shapes = ", ".join(f"[{LM_SLOTS},{k}]@[{k},{n}]"
                       for k, n in layer_gemms(lm_full))
    log(f"  (d) [{smi}] host us a matmul_ws call at the decode step's MLP "
        f"GEMMs ({shapes} bf16), {windows} interleaved windows of "
        f"{reps * len(gemms)} calls each, "
        f"median (min-max): wrapper {spread(host['wrapper'])}, op alone "
        f"{spread(host['op'])}, before the op {spread(host['before'])}; "
        f"median of the windows' differences: wrapper - before "
        f"{d_wrap:+.3f} us, op - before {d_op:+.3f} us a call; x {n_dec} "
        f"calls a pallas_ws decode step = {d_wrap * n_dec / 1e3:+.4f} ms "
        f"of its {dec_ms:.2f} ms; the stream drained at most "
        f"{drained:.0f} us after a window's last call")

    # conv2d_ws at the §5.2 layer (int8, int32 out, its ConvCore plan's
    # banks and tiles): the wrapper, the op alone (the padding resolved),
    # and the wrapper as it was before the op (the same checks, then the
    # launch set up and called directly)
    p52 = paper_workload()
    tp52 = ConvCore(ConvCoreConfig(int8=True)).plan(p52["x"], p52["w"])
    geo52 = dict(stride=1, padding="VALID", groups=1,
                 cin_banks=tp52.cin_banks, kout_banks=tp52.kout_banks,
                 h_tile=tp52.h_tile, w_tile=tp52.w_tile, dilation=1)

    def conv_wrapper(x, w, b):
        return conv2d_ws(x, w, b, **geo52)

    def conv_op(x, w, b):
        return cwm._CONV_OPS[False](
            x, w, b, None, None, 1, [0, 0, 0, 0], 1, 1, tp52.cin_banks,
            tp52.kout_banks, tp52.h_tile, tp52.w_tile, False, False)

    def conv_before(x, w, b):
        """``conv2d_ws`` as it was before the op (``run_conv`` launching
        directly)."""
        if x.device.type == "cpu":
            return conv2d_ws_plain(x, w, b, **geo52)
        if not x.is_cuda:
            raise ValueError(f"conv2d_ws runs on a CUDA or CPU tensor, got "
                             f"{x.device}")
        g, plan = cwm._launch_setup(
            tuple(x.shape), tuple(w.shape), cwm._check_operands(x, w), False,
            False, False, False, tuple(sorted(geo52.items())))
        out, path = cwm.launch_conv("conv2d_ws", False, x, w, b, None, g,
                                    plan, False, False)
        cwm.count_launch(conv2d_ws, path)
        return out

    c52 = [(rand_i8(*p52["x"]), rand_i8(*p52["w"]), rand_bias(p52["w"][3]))]
    creps, cwindows = 100, 20
    host, drained = interleaved_host_us(
        {"wrapper": conv_wrapper, "op": conv_op, "before": conv_before}, c52,
        creps, cwindows)
    d_wrap = float(np.median(host["wrapper"] - host["before"]))
    d_op = float(np.median(host["op"] - host["before"]))
    log(f"  (d) [{smi}] host us a conv2d_ws call at the §5.2 layer "
        f"(x{p52['x']} w{p52['w']} int8, int32 out, banks "
        f"{tp52.cin_banks} x {tp52.kout_banks}, tiles {tp52.h_tile} x "
        f"{tp52.w_tile}), {cwindows} interleaved windows of {creps} calls "
        f"each, median (min-max): wrapper {spread(host['wrapper'])}, op "
        f"alone {spread(host['op'])}, before the op "
        f"{spread(host['before'])}; median of the windows' differences: "
        f"wrapper - before {d_wrap:+.3f} us, op - before {d_op:+.3f} us a "
        f"call; the stream drained at most {drained:.0f} us after a "
        f"window's last call")
    for k in convs:
        fn = wrappers[k]
        fn.launches = saved[0][k][0]
        for p_, v in zip(CONV_PATHS, saved[0][k][1:]):
            setattr(fn, f"{p_}_launches", v)
    matmul_ws.launches, matmul_ws.path_launches = saved[1], saved[2]
    log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")

    # -- 13. the examples ----------------------------------------------------
    log("phase 13: the examples (repro_torch.examples), each main in process "
        "on the card")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mem_note("phase 13's entry")
    from repro_torch.examples import (conv_acceleration, quickstart,
                                      serve_batched, train_llama_tiny)
    ex_secs = {}

    def run_example(mod, argv):
        """``mod.main(argv)`` with its output logged indented, its
        launches read around it and added to the rows → (its figures,
        launches by kernel, conv launches by path)."""
        name = mod.__name__.rsplit(".", 1)[1]
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fig = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        seen = counts()
        paths = {k: by_path(wrappers[k]) for k in convs}
        forms = {k: v for k, v in matmul_ws.path_launches.items() if v}
        for k, v in seen.items():
            stats[k]["launches"] += v
        for k in convs:
            stats[k]["simt"]["launches"] += paths[k]["simt"]
        credit_paths()
        credit_forms()
        for line in buf.getvalue().splitlines():
            log(f"    | {line}")
        label = " ".join([name, *argv])
        log(f"  {label}: {secs:.1f} s; launches {seen}, conv launches by "
            f"path {paths}, matmul_ws forms {forms}")
        ex_secs[label] = secs
        return fig, seen, paths

    fig, seen, paths = run_example(conv_acceleration, [])
    paper, anchors = fig["paper"], perfmodel.paper_reference_numbers()
    if (paper["psums"] != 3_154_176
            or round(paper["gops_paper_1core"], 3) != 0.224
            or round(paper["gops_paper_20core"], 2) != 4.48
            or paper["gops_paper_1core"] != anchors["gops_1core"]
            or paper["gops_paper_20core"] != anchors["gops_20cores"]):
        raise AssertionError(f"conv_acceleration: the §5.2 anchors {paper}")
    if fig["lenet"]["multicore_max_abs"] != 0.0 \
            or not fig["resnet"]["lone_equal"]:
        raise AssertionError("conv_acceleration: the 4-core program or the "
                             "lone async request is not exact")
    errs = {"paper": paper["int8_rel_err"],
            **{k: fig[k]["int8_rel_err"]
               for k in ("lenet", "resnet", "mobilenet")}}
    over = {k: v for k, v in errs.items()
            if round(v, 4) > EXAMPLE_INT8_ERR[k]}
    if over:
        raise AssertionError(f"conv_acceleration: int8 errors {over} above "
                             f"the reference example's {EXAMPLE_INT8_ERR}")
    qat, h100 = fig["qat"], fig["h100"]
    if qat["loss_last"] >= qat["loss_first"] \
            or qat["int8_acc"] < qat["float_acc"] - 0.02:
        raise AssertionError(f"conv_acceleration: QAT {qat}")
    if fig["mobilenet"]["grouped_layers"] != 3 or h100["card_us"] is None:
        raise AssertionError(f"conv_acceleration: mobilenet_small "
                             f"{fig['mobilenet']}, the card time {h100}")
    conv_seen = {p_: sum(paths[k][p_] for k in convs) for p_ in
                 ("tc", "simt", "dw")}
    if not all(conv_seen.values()) or not seen["matmul_ws"]:
        raise AssertionError(f"conv_acceleration: launches {seen}, conv "
                             f"paths {paths}: a path of the example missed")
    log(f"  conv_acceleration: §5.2 anchors exact, int8 errors {errs} (the "
        f"reference example's levels {EXAMPLE_INT8_ERR}); the §5.2 int8 "
        f"layer {h100['card_us']:.2f} us a call on {h100['card']} against "
        f"its {h100['bound_us']:.3f} us bound, {h100['x_fpga']:.0f}x the "
        f"FPGA core; QAT loss {qat['loss_first']:.3f} -> "
        f"{qat['loss_last']:.4f}, int8 acc {qat['int8_acc']:.3f} "
        f"(float {qat['float_acc']:.3f})")

    for argv in ([], ["--w8"]):
        fig, seen, _ = run_example(serve_batched, argv)
        short = {u: len(o) for u, o in fig["outputs"].items()
                 if len(o) != fig["max_new"]}
        if fig["requests"] != 6 or short:
            raise AssertionError(f"serve_batched {argv}: {fig['requests']} "
                                 f"requests, short outputs {short}")
        if argv and not seen["matmul_ws"]:
            raise AssertionError("serve_batched --w8 launched no matmul_ws")
        log(f"  serve_batched {' '.join(argv) or '(float)'}: "
            f"{fig['tokens']} tokens in {fig['seconds']:.3f} s, "
            f"{fig['tokens_per_s']:.1f} tokens/s")

    fig, _, _ = run_example(quickstart, [])
    loss = fig["losses"]
    if len(loss) != 60 or not loss[-1] < loss[0]:
        raise AssertionError(f"quickstart: losses {loss[0]} -> {loss[-1]}")
    log(f"  quickstart: 60 steps, loss {loss[0]:.4f} -> {loss[-1]:.4f} in "
        f"{fig['train_s']:.2f} s; generated {fig['generated']}")

    ckpt = Path(tempfile.mkdtemp(prefix="train_llama_tiny_"))
    try:
        steps, fail = EXAMPLE_TRAIN_STEPS, EXAMPLE_TRAIN_FAIL
        fig, _, _ = run_example(train_llama_tiny, [
            "--preset", "100m", "--batch", "32", "--seq", "512", "--steps",
            str(steps), "--fail-at", str(fail), "--ckpt-dir", str(ckpt)])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resumed = fail // 10 * 10          # checkpoint_every = max(steps//5, 10)
    want = list(range(fail)) + list(range(resumed, steps))
    if fig["restarts"] != 1 or fig["history_steps"] != want \
            or not fig["loss_last"] < fig["loss_first"]:
        raise AssertionError(f"train_llama_tiny: {fig['restarts']} restarts, "
                             f"steps {fig['history_steps']}, loss "
                             f"{fig['loss_first']} -> {fig['loss_last']}")
    step_s = sorted(fig["step_s"][1:])
    med = step_s[len(step_s) // 2]
    log(f"  train_llama_tiny 100m ({fig['params']:,} params, 32 x 512 "
        f"tokens a step): one restart at step {fail}, resumed from the "
        f"step-{resumed} checkpoint; loss {fig['loss_first']:.4f} -> "
        f"{fig['loss_last']:.4f}; median step {1e3 * med:.1f} ms "
        f"({fig['tokens_per_step'] / med:,.0f} tokens/s; steps "
        f"{1e3 * step_s[0]:.1f}-{1e3 * step_s[-1]:.1f} ms), "
        f"{len(fig['straggler_events'])} straggler events, the run "
        f"{fig['run_s']:.1f} s with its checkpoints")
    spent = time.perf_counter() - t_phase
    log(f"  phase 13: {spent:.1f} s (budget {EXAMPLES_BUDGET_S} s"
        f"{'' if spent <= EXAMPLES_BUDGET_S else ', over it'}); "
        + ", ".join(f"{k} {v:.1f} s" for k, v in ex_secs.items()))

    # -- 14. results -----------------------------------------------------
    rows = []
    for name, (source, replaces) in KERNELS.items():
        st = stats[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=st["launches"], max_abs_err=st["max_abs_err"],
            ms=st["ms"], device_ms=st["device_ms"], plain_ms=st["plain_ms"],
            bound_ms=sum(st["bound"].values()),
            bound_by=max(st["bound"], key=st["bound"].get),
            library_ms=st["library_ms"]))
        if "f32" in st:     # the training path's f32 shapes, apart
            rows[-1].update(zip(("f32_ms", "f32_bound_ms", "f32_library_ms"),
                                st["f32"]))
        if "forms" in st:   # launches by form (the runs read by form)
            rows[-1]["form_launches"] = dict(st["forms"])
        if "int8" in st:    # w8 serving's long-M int8 GEMMs, apart
            rows[-1].update(st["int8"], int8_library_layouts=st[
                "int8_library_layouts"])
        if "conv1d" in st:  # recurrentgemma-9b's temporal conv, apart
            rows[-1].update(st["conv1d"])
        if "lm_bwd" in st:  # LM training's f32 backward GEMMs, apart
            rows[-1].update(st["lm_bwd"])
        if "simt" in st:    # the f32 simt path (phase 8's sums), apart
            sim = st["simt"]
            rows[-1].update(
                simt_launches=sim["launches"],
                simt_max_abs_err=sim["max_abs_err"],
                f32_plain_ms=sim["plain_ms"],
                f32_bound_by=max(sim["bound_by"], key=sim["bound_by"].get),
                **{f"f32_{k}": v for k, v in sim.items()
                   if k.startswith("dx_")})
        # the dw and nk paths (phase 3's sums), the scalar kernel's error
        for p_ in ("dw", "nk", "scalar"):
            if p_ in st:
                rows[-1].update({k if k.endswith("_launches") else
                                 f"{p_}_{k}": v for k, v in st[p_].items()})
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
