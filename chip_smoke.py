#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke]

Phases (any failure exits non-zero without printing the ok line).  Every
kernel's launch count is set to 0 just before each main path (serving,
MLP, ResNet-50, the custom-op MLP, BERT-base training, phase 10's
low-precision runs, phase 11's imperative MLP, phase 12's NMT
training, each ``translate`` and the bucketing fit, and phase 13's SSD-512
and Mask-RCNN training, phase 14's hybridized runs, phase 15's
generation serving, each part of phase 16, each training run of
phase 17, each model of phase 18, each part of phases 19 and 20,
phases 21 and 22, phase 23's traced round, phase 24 and its
Longformer fit, and each run of phase 25 in each rank) and read just
after;
a path must launch its kernel the expected number of times and the other
kernels not at all:

1. device check: a CUDA card must be present; prints the card's name and
   power limit; TF32 is switched off so every fp32 tolerance means fp32;
2. build: compiles every CUDA source of the port (one nvcc each, in
   parallel), prints the ptxas register/spill report (and, for the
   multi-SGD library, registers and spills for each of its 10 kernels:
   fp32, bf16 and fp16 in the plain and momentum forms, bf16 and fp16 on
   the mixed path with and without momentum; it fails on a spill) and a
   SASS census of each library (``cuobjdump -sass``; flash: tensor-core
   MMAs, async copies, ldmatrix, FFMA per kernel; multi-SGD: 16-byte
   global loads); fails if a flash kernel has no tensor-core MMA or no
   asynchronous copy, or a multi-SGD kernel lacks its register-staged
   16-byte loads (``sgd_words``);
3. kernels: calls each kernel's wrapper at the shapes its main path gives
   it and holds the result against the plain PyTorch version on the same
   inputs.  Flash attention (tensor cores: bf16, or 3xTF32 for fp32) at
   the BERT-base serving shapes, B=8, H=12, D=64, L=128 and 512, in fp32
   and bf16 (fp32 max-abs <= 1e-4; bf16 <= 2e-2 against the plain version
   in fp32), and a causal, a D=128 and a D=32 case; in fp16 (<= 4e-3)
   at B=8, L = 128, 256, 512 and D = 32, 64, 128 (H = 768 / D); the two
   multi-tensor SGD kernels on ResNet-50's 161 trainable shapes, in the
   Trainer's groups of 4 and as one group of 161, and on the MLP's 6
   shapes in its groups of 4, clip on and off, wd != 0, rescale != 1, plus
   odd sizes on misaligned pointers, and in bf16 and fp16 the same in
   every mode (plain, momentum, mixed with fp32 masters, with and without
   momentum): bit for bit (the kernels round as the plain versions do),
   each mixed weight its master rounded.  Times
   kernel, plain version and the library call (``scaled_dot_product_
   attention``; ``torch.optim.SGD(fused=True)``, in the weights' dtype
   where it computes the same function: not on the mixed path) with CUDA
   events, the unfused mixed route the port ran before (per tensor a
   gradient cast and a master copy around the fp32 kernel), the
   SGD kernels' device time also with torch.profiler (their back-to-back
   calls are bound by the host), each SGD launch's own device time in
   the Trainer's groups of 4 (binned by group size, < 64K, 64K-1M and
   > 1M elements, beside each bin's bound), and computes the bound
   (flash: at the tensor cores' TF32 or bf16 peak, or the memory rate);
4. serving: BERT-base (12 layers, 768 wide, 12 heads, FFN 3072, vocab
   30522, max length 512, weights from ``--seed``) served by
   ``ModelServer`` over length buckets 32..512 and batch buckets 1 and 8;
   requests submitted from threads; checks finite, correctly unpadded
   outputs, batching invariance against the direct forward on the card,
   one request against the same weights on the CPU (plain path), and that
   the flash kernel launched exactly 12 times per dispatched batch; a
   profile of one B=8, L=512 batch by kernel class, whose flash class
   must hold device time;
5. MLP training (BASELINE config #1 at full width): Dense 784-128 relu -
   64 relu - 10, batch 64, ``gluon.Trainer("sgd", lr 0.1)``, 20 steps on
   one seeded batch; the loss must fall and the plain-SGD kernel must
   launch exactly 2 times per step;
6. ResNet-50 v1 training (config #2 at full width and depth):
   ``Xavier("gaussian", "in", 2)`` weights from ``--seed``, hybridized,
   batch 128 of synthetic 3x224x224 fp32, ``Trainer("sgd", lr 0.1,
   momentum 0.9, wd 1e-4)``, 3 warm and 10 timed steps of
   ``autograd.record`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``autograd.backward`` -> ``trainer.step``.  Checks a finite loss,
   exactly 41 momentum-kernel launches per step, the aggregated update
   against the per-tensor one from the same weights and gradients
   (max-abs <= 1e-6), and one batch-2 step from the initial weights on
   the card against the same step on the CPU: loss within 1e-4, and every
   updated weight and running statistic, leaf by leaf, held against the
   same step in float64 on the CPU: the card's error, as a share of the
   leaf's change in that step (L2 norms), at most 4x the CPU fp32 run's
   share + 1e-3 (some leaves' fp32 step is itself far from float64, so
   one fixed tolerance would test their conditioning, not the card);
   prints
   images/s, step time, peak memory and a ``torch.profiler`` breakdown of
   one step;
7. rtc (kernels compiled at run time, the counterpart of the JAX
   package's Pallas ``rtc``): compiles the user modules below with NVRTC
   for ``sm_90a`` and records the compile ms; holds ``add_one`` (fp32)
   and ``twice`` (int32, exact) of the JAX package's rtc tests, ``axpy``
   reached through ``exports`` and a 100 KB dynamic-shared-memory kernel
   against their plain versions; the softmax output layer's forward and
   backward kernels at 100x10 (the MLP) and 4096x30522 (BERT-base's MLM
   logits) against theirs (max-abs <= 1e-6 on probabilities: fp32, the
   same expf per element, row sums in another order), timed beside the
   bound, the plain version and one library call each (``torch.softmax``;
   ``torch.scatter_add`` of -1 at each row's label); the host cost of one
   launch; and the refusals (wrong dtype, a CPU tensor, a CPU context,
   an unexported C++ name, a compile error carrying NVRTC's log), each
   raising ``MXNetError`` before any launch;
8. custom-op MLP (config #1 at full width, ``examples/train_mnist_mlp.py``
   with Adam): 2000 synthetic 784-feature samples from ``--seed`` (the
   example's ``--synthetic`` recipe at 784 features) plus 300 held out,
   batch 100, ``Trainer("adam", lr 2e-3)``, 2 epochs (40 steps), the
   output layer ``nd.Custom(logits, label, op_type="softmax_rtc")``
   under ``autograd.record``, ``autograd.backward``, ``metric.Accuracy``.
   A twin run from the same weights takes ``SoftmaxCrossEntropyLoss``
   (the same gradient).  Checks: the first step's gradients within 1e-6
   of the twin's, per-step losses within 1e-4 relative + 1e-6 (the
   custom head's loss is ``-log(p)`` of fp32 probabilities, which
   resolves a loss near 0 only to ~6e-8), exactly one forward and one
   backward rtc launch per step and no other kernel's, finite losses
   that fall, held-out accuracy above 0.5;
9. BERT-base pretraining (config #3 at full width and depth, as
   ``bench_bert_base`` runs it: ``dropout=0.0``, weights from ``--seed``,
   the MLM + NSP loss from the ``nd`` ops, ``Trainer("adam", lr 1e-4)``,
   batch 8 of sequence 256 with valid lengths in [128, 256] and 15 % of
   the valid positions masked): (a) fp32: one batch-2, sequence-128 Adam
   step from the initial weights on the card against the CPU in fp32 and
   float64, leaf by leaf (ResNet-50's ``leaf_check`` bounds) on the
   updated weights and on the gradients; 3 warm and 10 timed steps (step
   ms, sequences/s, tokens/s), one profiled step by class (GEMMs, flash
   forward, the flash backward's torch ops, LayerNorm, log-softmax,
   Adam, memcpy, other; idle share; Adam's kernels per parameter); (b)
   the same from the same weights under ``amp.init("bfloat16")``, 20
   steps: finite losses that fall, the first within 2e-2 (relative) of
   the fp32 run's, every parameter and Adam state still fp32; both: the
   flash kernel launched exactly 12 times per step (the backward is torch
   code and launches none), on fp32 q/k/v in (a) and bf16 in (b), and no
   other kernel; (c) the flash backward alone at B=8, H=12, L=256 and
   512, D=64, fp32 and bf16, ragged lengths: q/k/v gradients against
   torch autograd through the plain version in fp32 (max-abs <= the
   forward's tolerance x max(1, max|g|)), device ms of forward + backward
   beside the plain version's and ``scaled_dot_product_attention``'s
   (same key mask) and the bound, and the backward's peak memory beside
   one (B*H, L, L) fp32 matrix;
10. low precision, as the JAX package trains its two headline models:
   (a) ResNet-50 v1 of phase 6 (same weights and batch) under
   ``amp.init("bfloat16")``, 3 warm + 10 timed steps: finite losses
   that fall within the warm steps, the first 4 within 2e-2 of phase
   6's (the same weights and batch; the runs part ways later), every
   parameter and momentum fp32, exactly 41 momentum launches a step and
   only they in the ``trainer_step`` range; (b) the same after
   ``net.cast("bfloat16")`` with ``multi_precision``: after every step
   each weight its fp32 master rounded, bit for bit, 41 mixed-path
   launches a step and nothing else in the ``trainer_step`` range (no
   per-tensor cast or copy); both: step ms, images/s, device time by
   class (convolutions, BatchNorm, its statistics pass, casts, cuDNN's
   layout transposes, elementwise, the update) and
   idle share of one profiled step; (c) BERT-base pretraining of phase 9
   under ``amp.init("float16")`` with ``amp.init_trainer`` (dynamic loss
   scale from 2**16), 20 steps of ``scale_loss`` -> ``backward`` ->
   ``unscale`` -> ``step`` unless skipped: at least 15 applied steps
   with finite, falling losses, the first applied within 2e-2 of phase
   9's first fp32 loss, exactly 12 flash launches a step, all on fp16
   q/k/v, fp32 weights and Adam states; step ms, sequences/s, the loss
   scales and the skipped steps; the flash backward alone on fp16 inputs
   at L=256 and 512 (gradients within 2e-2 x max(1, max|g|)); (e) the
   MLP of phase 5 with bf16 weights: 2 plain-SGD launches a step on
   bf16 weights, a falling loss;
11. the imperative surface (config #1 at full width, 784-128-64-10,
   batch 64, written in ``nd`` ops as the verify recipe writes it):
   ``nd.array`` data and labels, the weights ``NDArray``s with
   ``attach_grad()``, ``autograd.record()`` over ``nd.FullyConnected``
   -> ``nd.Activation("relu")`` (twice) -> ``nd.FullyConnected`` ->
   ``nd.log_softmax`` -> ``nd.pick`` -> ``nd.mean``, ``L.backward()``,
   then outside ``record()`` one ``nd.multi_sgd_mom_update(w0, g0, m0,
   ..., lrs, wds, out=weights)`` a step (the momentum kernel, exactly 1
   launch a step and no other kernel's), 20 steps with finite, falling
   losses; the first step from the same weights on the CPU in fp32 and
   float64 (``leaf_check``); the gradients through ``nd.SoftmaxOutput(z,
   y, normalization="batch")`` within 1e-5 of those through log-softmax
   + pick + mean; ``examples/train_mnist_mlp.py``'s loop spelled against
   the port (``nd.array`` inputs, ``net(x)`` an ``NDArray``,
   ``L.backward()``, ``trainer.step``, ``metric.update``, the held-out
   forward through ``.asnumpy()``) for 10 Adam steps; prints both loops'
   step ms, the engine's waits and host reads a step, and the host
   microseconds of one ``nd.FullyConnected`` on NDArrays against
   ``F.linear`` on the same tensors;
12. config #4 (``BASELINE.json:10``, Sockeye's Transformer NMT with the
   Symbol bucketing executor): (a) ``transformer_nmt_base`` (6 + 6
   layers, 512 wide, FFN 2048, 8 heads, vocabulary 32000, max length
   128, the output tied to the embedding; weights from ``--seed``, fp32)
   trained as ``bench_nmt`` trains it (``bench.py:484-531``: Adam at lr
   1e-4 through ``gluon.Trainer``, B=16, one first step per bucket
   32/48/64, 2 warm and 8 timed passes over the buckets, each pass ending
   in a synchronise): exactly 12 flash launches a step (the encoder's
   self-attention and the decoder's cross-attention; its causal
   self-attention takes the masked softmax), no other kernel's, finite
   losses, the parameter count; one batch-2, length-16 step from the
   initial weights on the card against the CPU in fp32 and float64,
   ``leaf_check`` on the updated weights and on the gradients, the loss
   within 1e-4, the CPU runs taking the card's ReLU decisions
   (``Decisions``; float64's own may differ in at most 1e-4 of the
   units); tokens/s, step ms per bucket (CUDA events), one profiled
   step by class (GEMMs, flash forward, the flash backward's torch ops,
   LayerNorm, the decoder's masked softmax, log-softmax/cross-entropy
   over 32000, Adam, memcpy, other) and its idle share; (b)
   ``translate`` as ``examples/translate_nmt.py`` calls it, greedy on 8
   rows and beam 3 on 4, source length 32, ``max_len`` 35: exactly 6 +
   6 flash launches per decoder call, one host read per decoder call,
   the same result on a second run, and the card's every decoder call
   replayed on the CPU model from the same weights (teacher forcing):
   log-probabilities within 1e-4, each chosen token (greedy: the argmax;
   beam: the top 3) within 1e-4 of the CPU's best (3rd best); ms per
   output token; (c) the LSTM language model of
   ``examples/train_char_lm_bucketing.py`` at the upstream example's
   widths (Embedding(10000, 200), two LSTMCell(200), FullyConnected,
   SoftmaxOutput), ``BucketingModule.fit`` over ``BucketSentenceIter``
   (7680 sentences drawn from ``--seed``: lengths 2..60, Zipf-distributed
   tokens over 10,000 ids; batch 32, buckets 10..60), SGD lr 0.01, wd
   1e-5, ``Perplexity(invalid_label=0)``, one epoch: perplexity falls,
   every bucket's module on the master's parameter and gradient tensors,
   no kernel launches, one ``forward_backward`` + ``update`` on the card
   against the CPU (``leaf_check``), the checkpoint round trip bit for
   bit; samples/s, step ms per bucket, the host's share of a step; the
   flash kernel at the NMT shapes (B=16 H=8 L=64, cross Lq=48 Lk=64,
   decode Lq=1 Lk=64 and Lq=7 Lk=32, fp32: in phase 3, timed) and its
   backward at the cross shape;
13. config #5 (``BASELINE.json:10``, GluonCV's SSD and Mask-RCNN): (a)
   ``ssd_512_resnet50_v1(classes=20)`` as ``bench_ssd`` trains it
   (``bench.py:533-575``): ``initialize()`` leaves the extra stages' and
   the predictors' widths deferred, ``Trainer("sgd", lr 1e-3, momentum
   0.9)`` is built before the first forward, which settles them; batch
   8 of 512 x 512 fp32 images from ``--seed`` with ``bench_ssd``'s labels
   (4 rows an image, 2 real), 3 warm and 10 timed steps of
   ``autograd.record`` -> ``SSDMultiBoxLoss`` -> ``autograd.backward`` ->
   ``trainer.step``: step ms, images/s, one profiled step by class
   (convolutions, BatchNorm, ``MultiBoxTarget``, the loss, the update)
   and its idle share, peak memory, the trainable tensors, exactly one
   momentum launch per group of 4 of them a step and no other kernel's;
   (b) one batch-2 step at 512 x 512 from the initial weights on the
   card against the CPU in fp32 and float64 (``leaf_check`` on the
   updated parameters and on the gradients, the loss within 1e-4, or 1e-5
   relative above 10), the
   CPU runs taking the card's ReLU masks and ``MultiBoxTarget`` outputs
   (``Decisions``, ``TargetDecisions``; the decisions float64 would have
   taken otherwise at most 1e-4 of them); (c) ``MultiBoxDetection`` at
   its defaults on the trained net's softmax output at batch 8 (5,630
   anchors): ms a batch, ms in the NMS, its passes, the same kept set
   as the CPU's run of the op on the same inputs with scores and boxes
   within 1e-5, and as a plain greedy loop on the card; (d)
   ``mask_rcnn_resnet18_v1(classes=20)`` at its defaults (256 x 256,
   256 proposals before the NMS, 64 after, heads 256 wide, mask head 64)
   at batch 4, SGD lr 1e-3 momentum 0.9, boxes, classes and 14 x 14
   masks from ``--seed``, 3 warm and 10 timed steps: step ms, images/s,
   the device ms of ``Proposal``, ``ROIAlign``, the heads and the rest,
   the idle share, exact momentum launches; one batch-1 step by
   ``leaf_check``, the CPU runs taking the card's rois and ReLU masks;
   both models' updates: the momentum kernel in the Trainer's groups bit
   for bit against its plain version, its device ms beside the bound
   (20 B an element), the plain version's and fused
   ``torch.optim.SGD``'s;
14. ``hybridize()`` on CUDA graphs (``gluon/cached_op.py``): phases 4
   (``ModelServer``'s ``cached_graph``s), 5, 6, 10 and 13 (hybridized)
   already run on captured graphs and print each one's entries, graphs,
   replays and eager calls (one warm call per signature and mode, the
   deferred-shape calls, no other); their exact launch counts hold
   through replays (a capture counts nothing, each replay its
   launches), their batch-2 check steps replay after a warm call of the
   signature, and each phase frees its graphs before the next.  Then:
   (a) phase 12's NMT training, hybridized, from the same weights and
   batches, at 4 timed passes (phase 12 times 8): one recording entry a
   bucket, 12 flash launches a step, tokens/s, step ms per bucket, the
   idle share, device ms, the host's launches a step, capture ms and
   pool bytes a graph, the losses against phase 12's; phase 12's check
   step replayed from a graph, held by ``leaf_check``'s bounds against
   the float64 step and against the eager card step, and whether eager
   repeats bit for bit and the replay equals it; (b) phase 9's BERT-base
   pretraining, fp32 and bf16 AMP, hybridized, at 5 timed steps (phase 9
   times 10), beside phase 9's numbers, its check step replayed as in
   (a); (c) phase 4's 32 requests served from captured graphs, by eager
   dispatch, and from the graphs again: requests/s, p50/p99, the outputs
   against a direct forward and against eager dispatch (<= 1e-3); (d)
   Mask-RCNN, which reads the host in its forward (``reads_host``),
   hybridized: one warning, each step an eager call, counted, its losses
   within 1e-5 of phase 13's; (e) the flash kernel replayed from a
   captured graph against its eager call on the same inputs, bit for
   bit (B=8, L=512 and 256, fp32 and bf16, ragged lengths);
15. generation serving (``serving.GenerationServer`` over a paged KV
   cache, ``CausalLM``'s prefill and decode as captured graphs that
   update one pool in place): (a) ``causal_lm_small`` as ``bench.py``'s
   generation rows serve it (``bench.py:1122-1300``: 4 slots, KV blocks
   of 16, 128 blocks, prompt bucket 16, 48 new tokens), 64 requests of
   4-15 ids drawn from ``--seed`` submitted at once, in the
   ``interleave`` and ``step`` prefill modes, then again recording each
   request's logits rows (a digest of each) batched and alone
   (``slots=1``): tokens/s, TTFT p50/p99 ms, decode step p50/p99 ms;
   checks every run's tokens and logits bit for bit the alone run's, no
   KV block allocated or reserved after a run, the pool's ``data_ptr``
   unchanged and each decode replay copying out the logits alone, one
   decode graph and one prefill graph a server, and the alone run's
   every step teacher forced on the CPU (logits within 1e-4, each chosen
   token within 1e-4 of the CPU's best); (b) the same ``CausalLM`` at
   config #3's widths (vocabulary 30522, 12 layers, 768 wide, FFN 3072,
   12 heads, max length 512: 108.9 M parameters), 16 slots, 512 blocks
   of 16, prompt buckets 64/128/256, 128 new tokens at most: 64 requests
   of 16-256 prompt ids and 16-128 new tokens, interleaved; the first 8
   again alone and bit for bit, 2 teacher forced; one profiled decode
   step (device ms, idle share, the host's launches), capture ms and
   pool bytes a graph; (a) and (b) launch no kernel of the table (counts
   set to 0 before (a), read after (b)); (c) a ``ModelRegistry`` holding
   (a)'s server and a BERT-base ``ModelServer`` (phase 4's model, one
   length bucket) behind an ``HttpFrontend`` on a localhost port: 8
   concurrent SSE clients get the tokens of a direct ``submit_generate``,
   a client that hangs up mid-stream leaves no block allocated, ``predict``
   returns what ``infer`` does bit for bit (12 flash launches a forward,
   exact), ``/healthz``, ``/readyz`` and ``/v1/models`` answer 200;
16. the training surface around ``gluon.Trainer`` (fp32, TF32 off): (a)
   ResNet-50 v1 of phase 6 (same weights and batch) on MXNet's ImageNet
   recipe: ``sgd`` momentum 0.9, lr 0.05 (0.1 x 128 / 256), wd 1e-4 with
   ``wd_mult`` 0 on ``collect_params(".*gamma|.*beta|.*bias")``,
   ``MultiFactorScheduler(step=[6, 9], factor=0.1, warmup_steps=3)``, 12
   steps: each group's rate equals a CPU copy of the schedule's and its
   ``wds`` carry the 0 multipliers, 41 momentum launches a step; after
   step 6 ``save_parameters`` + ``save_states`` to a temporary
   directory, which a fresh net (another seed), Trainer and schedule
   load: every weight, momentum and count bit for bit the saving run's;
   steps 7-12 of both under deterministic cuDNN give equal losses and
   weights bit for bit (the checkpoint's bytes, save and load ms); (b)
   BERT-base of phase 9 (same weights and batch, B=8, S=256) pretrained
   with ``lamb`` (lr 1e-4, wd 0.01, 0 on LayerNorm and biases,
   ``PolyScheduler(max_update=13, pwr=1, warmup_steps=3)``) and
   ``gluon.utils.clip_global_norm(grads, 1.0)``, 13 steps (3 warm, 10
   timed): 12 flash launches a step, one host read a step (the clip's),
   the rates the schedule's, and phase 9's check step with this update
   (``leaf_check`` on the 158 leaves, loss within 1e-4); step ms,
   sequences/s, device ms and host launches beside phase 9's Adam; (c)
   every optimizer the JAX package registers (``rmsprop`` plain and
   centered, ``sgd`` with and without momentum; ``sgd``, ``nag``,
   ``adamw`` and ``lamb`` also with bf16 weights and
   ``multi_precision``), 5 Trainer steps with a ``CosineScheduler`` on
   BERT-base's FFN widths (768 x 3072 and back, biases) from gradients
   drawn from ``--seed``, held against the CPU run of the same (every
   fp32 weight and every state, the fp32 masters too, within 1e-5 x
   max(1, |w|)), each bf16 weight its fp32 master rounded, SGD's kernels launched once a step (the mixed
   path without momentum once a tensor), no other kernel, and no read
   back in LARS, LBSGD and LAMB (``set_sync_debug_mode("error")`` around
   their steps, no host read counted); SGLD by its noise's moments over
   4.7 M elements (mean 0 and std 1 within 5e-3);
17. the data pipeline: ResNet-50 v1 trained from a RecordIO file.  First
   line: what the machine offers for JPEG (PIL, ``jpeglib.h``, libjpeg
   in ``ldconfig``, the cores) and whether the port's native io core
   built with its decoder; 1,280 images made from ``--seed`` (shorter
   side 300-500, aspect 1.0-1.5, a 16x12 field upsampled plus noise)
   are packed under ``build/chip_smoke/`` as JPEG (quality 90) where the
   core decodes JPEG, else as ``RAWN``, and reused.  (a)
   ``ImageRecordIter(use_native=True)`` at MXNet's ``train_imagenet``
   settings (resize 256, random 224 crop and mirror, mean/std, shuffle,
   one thread per usable core): images/s over 2 epochs, the first
   batch's checksum and its bits equal to the same iterator's on one
   thread; (b) the iterator feeding ResNet-50 v1 at batch 128 through
   ``gluon.Trainer("sgd", momentum=0.9)`` (``split_and_load`` to the
   card), hybridized, in fp32 and under ``amp.init("bfloat16")``: step
   ms and images/s against the same model on one resident batch, the
   iterator's wait and the copy a step, the device idle share of a
   profiled step each way, 41 momentum launches a step (exact); the
   first step at batch 2 against the CPU fp32 and float64 steps
   (``leaf_check``, loss within 1e-4), bf16's first loss within 2e-2 of
   fp32's; (c) ``gluon.data.DataLoader`` over
   ``vision.ImageRecordDataset`` (``RandomResizedCrop(224)``, a flip,
   ``ToTensor``, ``Normalize``; ``num_workers`` the usable cores,
   ``pin_memory``, ``device_prefetch=2``) feeding the fp32 step: images/s
   over the epoch, the device stage's metrics, every batch's labels
   those of the sampler's ``.idx`` keys, batches on the card, host
   batches pinned, and a resume from ``state_dict()`` after 4 batches
   bit for bit the uninterrupted epoch (with a fixed resize: numpy's
   stream cannot be replayed across worker threads); (d) the loader of
   (c) alone at 1, 2, 4 and every usable thread, over two batches a
   worker, beside (a)'s native rates on one thread and on all; and one
   batch's copy to the idle card, pageable and pinned;
18. Gluon's model surface: (a) one constructor of each vision family
   through ``gluon.model_zoo.vision.get_model`` at 1000 classes
   (``alexnet``, ``vgg16``, ``resnet50_v2``, ``mobilenet_v2_1_0``,
   ``densenet121``, ``squeezenet1_1`` at 224 x 224, ``inception_v3`` at
   299 x 299), weights from ``--seed``, hybridized, batch 32 fp32,
   ``gluon.Trainer("sgd", lr 0.1, momentum 0.9, wd 1e-4)`` (lr 0.01 for
   VGG and SqueezeNet, 0.001 for AlexNet, which have no BatchNorm,
   ``ZOO_FAMILIES``): 3 warm and 5
   timed steps (step ms, images/s, the momentum kernel's launches a step,
   exact), one profiled step (device ms by class, idle share, host
   launches), two predict-mode forwards (the second replayed), the
   graphs' pool bytes; one batch-2 step from the initial weights eagerly on the
   card against the CPU in fp32 and float64 (``decision_leaf_check``;
   the CPU runs take the card's ReLU, ReLU6, max-pool and dropout
   decisions, ``ZooDecisions``) and the same step replayed from the
   captured graph bit for bit an eager card step (cuDNN's deterministic
   algorithms, generators reseeded); (b) MXNet's word language model
   (``example/gluon/word_language_model``: embedding 650, a 2-layer
   ``gluon.rnn.LSTM`` of 650 with dropout 0.5, the decoder tied to the
   embedding, vocabulary 33,278, bptt 35, batch 32, SGD at lr 20 with
   ``clip_global_norm`` at 0.25 a token), hybridized, the hidden state
   carried and detached across 3 warm and 10 timed windows of tokens
   from ``--seed`` (window ms, tokens/s, the plain SGD kernel's launches
   a window, exact; no cuDNN weight copy), one profiled window; the
   first window, dropout
   off, against the CPU in fp32 and float64 (``leaf_check``), and a
   window replayed from its graph, dropout on, bit for bit the eager
   card window;
19. the symbolic AMP and Module surface (``mx.sym`` graphs bound by
   ``Module``, ``contrib.amp.convert_model``, the registry's
   ``_contrib_flash_attention``): (a) a BERT-base-width encoder in
   ``mx.sym`` (12 layers of 768, 12 heads, FFN 3072 with GELU, residual
   LayerNorms, flash attention on (B*H, 512, 64) with per-sequence
   lengths, the head ``FullyConnected(2)`` -> ``softmax_cross_entropy``
   -> ``MakeLoss(normalization="batch")``), batch 8, through ``Module``
   (``forward_backward`` + SGD momentum ``update``, fp32): 2 warm and 5
   timed steps, 12 flash launches a forward and none in the backward,
   exact; one step of a 2-layer copy at batch 2 against the CPU in fp32
   and float64 (``leaf_check``); (b) its inference graph (hidden states
   and logits) converted by ``amp.convert_model(..., "bfloat16")`` and
   bound from the fp32 parameters: the cast nodes inserted, 12 bf16 flash
   launches, each output within 5e-2 (relative L2) of the fp32 graph's,
   the forward times; (c) GluonNLP's interleaved attention
   (``interleaved_matmul_selfatt_qk`` -> softmax -> ``..._valatt``) on a
   (512, 8, 3 x 768) projection against the flash route, max-abs <= 1e-4;
   (d) phase 12's LM converted in every bucket through a
   ``BucketingModule`` for inference: perplexity within 5e-2 (relative)
   of fp32's over one batch a bucket, and the converted checkpoint
   (``save_checkpoint(..., remove_amp_cast=True)``) loaded back as saved;
   (e) config #1's MLP under each of ``LinearRegressionOutput``,
   ``LogisticRegressionOutput``, ``MAERegressionOutput`` and
   ``SVMOutput`` through ``Module.fit`` (2 epochs of 640 samples) with a
   held-out ``score`` that must improve, and one step of each against the
   CPU (``leaf_check``, the CPU runs taking the card's ReLU decisions);
   (f) each of the 43 registry ops this slice adds on the card against
   its CPU run (exact where the op casts, indexes, orders or counts: ties
   in ``topk``/``sort``/``argsort`` and out-of-range ``gather_nd``
   indices included), and ``multi_all_finite`` over (a)'s gradients (1
   clean, 0 with one ``inf``, no host read before the caller's);
20. MXNet's export seam (fp32, TF32 off): (a) ResNet-50 v1 (config #2)
   at batch 128 trained 3 steps through ``gluon.Trainer("sgd", momentum
   0.9)``: 41 momentum-kernel launches a step, exact; one weight and one
   gradient read through ``Parameter.data()``/``grad()`` as ``NDArray``s
   on the card, bit for bit the parameters' tensors; ``export`` to
   ``<out>/export_phase/`` (every parameter under ``arg:``; the parameter
   files are removed when the phase ends); (b)
   ``SymbolBlock.imports`` on the card, its forward on a seeded batch of
   128 at 224 x 224 against the Gluon forward of (a) (eager); (c)
   ``ModelServer.from_exported`` serving 64 single-image requests over
   batch buckets 1, 8 and 32 twice, the second round timed (requests/s,
   p50/p99; the first replays each graph for the first time), every
   answer against the Gluon forward of its image; (d) ``model.load_checkpoint`` and a
   ``Module`` bound for inference on the same files against the Gluon
   forward; (b)-(d) within ``EXPORT_TOL`` of ``max(1, max |logit|)`` and
   launching none of the port's kernels; (e) config #1's MLP exported and
   served by ``from_exported`` (64 requests), its served logits through
   the ``softmax_rtc`` custom op on ``NDArray``s: one rtc launch, within
   ``SOFTMAX_TOL`` of the plain softmax;
21. the rest of the op files (``ops_tail``, ``ops_misc``, the draws of
   ``ops_random``, ``ops_linalg``, ``ops_spatial``; fp32 unless said, TF32
   off): (a) each of the slice's 113 deterministic ops (``SLICE_OPS``) on
   the card against its CPU run on the same inputs, the forward and the
   gradient of the outputs' sum where the op is differentiable, at the
   sizes that run them: a BERT-base activation (8 x 512 x 768) for the
   elementwise, special and shape ops, BERT-base's attention scores for
   the masked softmaxes, 64 SPD matrices of 256 x 256 for linalg (fp32 and
   float64; ``syevd`` on a spectrum 1, 2, ..., 256), ResNet-50's input
   (128 x 3 x 224 x 224) for the spatial ops
   (the CPU runs taking the card's sampler floors, ``SamplerDecisions``)
   and its stage-2 activation (128 x 256 x 56 x 56) for
   ``im2col``/``col2im``; exact where the op copies, tests, indexes, counts
   or creates, else within its family's ``SLICE_TOL``; prints the number
   of ops checked; (b) 2**22 draws of every ``_random_*``/``_sample_*``
   form (each parameter row of a ``_sample_*`` draw its own): mean and
   variance within 6 standard errors of the exact values, a reseed
   repeating every draw bit for bit, ``_shuffle`` a permutation,
   ``_sample_multinomial``'s frequencies its probabilities, and a normal,
   a gamma and a Poisson draw inside a hybridized block, fresh at each
   replay of its captured graph and repeated after a reseed; (c) a spatial
   transformer (Jaderberg et al. 2015: a ``Dense(6)`` over the pooled
   input, weight 0, bias the affine of scale 0.9 and rotation 10 degrees,
   then ``SpatialTransformer`` at 224 x 224; its rate 1e-4 of the base,
   as Jaderberg et al. set it) in front of ResNet-50 v1
   (config #2), batch 128: one batch-2 step from the initial weights on
   the card against the CPU in fp32 and float64 (``decision_leaf_check``,
   the CPU runs taking the card's ReLU, max-pool and sampler-floor
   decisions; the loc net's gradient held on its own), then 3 eager and 3
   hybridized steps of ``autograd.record`` -> ``backward`` ->
   ``Trainer("sgd", momentum 0.9)``: finite losses, the momentum kernel's
   launches exact (one per group of 4 trainable tensors a step); (d) a
   batched Gaussian-process likelihood as MXNet's ``linalg_*`` docs write
   it (16 problems of 1024 points in 8 dimensions, an RBF kernel plus
   noise, ``linalg_potrf`` -> ``linalg_trsm`` -> ``linalg_sumlogdiag``),
   20 Adam steps on its length scale, signal and noise through autograd,
   in float64 and fp32 on the card, held against the same fit in float64
   on the CPU: the card's float64 fit within 1e-12 (relative), its fp32
   fit within 2e-5; (a), (b) and (d) launch no kernel of the table;
22. control flow, the rest of Symbol/Module and of detection (fp32, TF32
   off): (a) ``ops_contrib``'s last ops (``CONTRIB_OPS``) on the card
   against their CPU runs, forward and gradient, at the sizes of their
   models (R-FCN's res5 and score maps at 600 x 1000 with 300 rois, Fast
   R-CNN's VGG-16 conv5_3 with 128 rois an image, FlowNetC's correlation
   of 441 displacements, SSD-512's matcher, compact bilinear pooling's
   count sketch, PSPNet's pyramid pooling, BERT-base's tables and
   activations; the sampling ops' CPU runs taking the card's floors), the
   peak memory of the sampling ops; ``_sample_unique_zipfian`` and
   ``rand_zipfian`` (8192 of 793,471 classes: distinct, a moment, a
   reseed bit for bit); ``_foreach``/``_while_loop``/``_cond`` in ``sym``
   and ``nd`` (a 1024-wide tanh RNN over 50 steps of batch 64 with a
   captured weight) against the CPU's fp32 and float64 runs
   (``leaf_check``); (b) a deformable R-FCN (Dai et al. 2017: ResNet-101
   to stride 16, res5 of ``gluon.contrib.cnn.DeformableConvolution``
   bottlenecks, position-sensitive ``DeformablePSROIPooling`` heads) at
   600 x 1000 with 300 rois, 128 sampled: a check step against the CPU
   in fp32 and float64 (``decision_leaf_check``), 3 eager and 3
   hybridized ``Trainer("sgd", momentum 0.9)`` steps, the momentum
   kernel's launches exact; (c) an RNN NMT at Sockeye 1.x's widths built
   from this slice's cells (a bidirectional ``FusedRNNCell`` encoder, an
   ``LSTMCell`` -> ``DropoutCell`` -> ``ResidualCell(LSTMCell)`` decoder
   with MLP attention under ``sym.contrib.foreach``, a ``_cond`` length
   mask) through ``BucketingModule`` (a check step, one Adam step in each
   of 5 buckets), as a ``SequentialModule`` (the same outputs and
   gradients), with a ``Monitor`` through ``fit`` against the CPU's, the
   fused encoder against ``unfuse()``, greedy translation by
   ``while_loop`` saved and loaded bit for bit, the name and attribute
   scopes; (d) ``mx.model.FeedForward`` fitting the MLP for 2 epochs,
   ``predict`` and ``score`` against the same run through ``Module``;
23. observability, the rest of serving and tuning (fp32, TF32 off):
   (a) BERT-base (phase 4's weights from ``--seed``, as a sentence-pair
   classifier: its NSP logits) at priority 2 with ``slo_ms`` and
   ``causal_lm_small`` at priority 1 behind ``ModelRegistry`` and
   ``HttpFrontend``; a round of 32 requests of lengths 16..512, each with
   a W3C ``traceparent``, under ``MXTPU_TRACE``: every response echoes
   the caller's trace id, every request's spans form the tree
   ``serving.request`` (under the caller's span) -> ``serving.assemble``
   (linking the batch's other requests) -> ``serving.dispatch`` ->
   ``serving.readback``, the Chrome trace dumps and parses, the flash
   kernel launches 12 times a forward; the same requests with tracing
   off give the same logits bit for bit, batch bucket for batch bucket;
   (b) requests/s and p50/p99 with tracing off, ``MXTPU_TRACE_SAMPLE=1``
   and ``=8``; (c) ``MXTPU_METRICS_PORT``'s Prometheus text scraped (its
   ``serving.requests_done`` the requests answered; the p99 bucket of
   ``serving.request_us`` carries an exemplar trace id the span ring
   holds), the JSONL writer's lines, ``/debug/stacks`` and
   ``/debug/profile`` over the front door (200 with
   ``MXTPU_DEBUG_ENDPOINTS``, the dispatch workers' sampled frames
   tagged by trace id at ``MXTPU_PROF_SAMPLE_HZ=100``; 404 without);
   (d) one dispatch held on a host event: ``Watchdog.tick(dt)`` flags
   ``serving.dispatch`` once and writes one postmortem (the held worker's
   stack, the four flight rings, the span ring, a snapshot), re-arms once
   released; a forced exception dumps the flight recorder with the served
   requests; (e) an overload round past BERT-base's SLO makes
   ``SloController`` shed the generation model (429) and double
   BERT-base's workers, quiet rounds un-shed it on the tick it is due;
   ``DecodeSlotController``
   ticks over rounds of the 16-slot generation at BERT-base's widths,
   each round's tokens bit for bit those at 16 fixed slots; (f)
   ``mx.profiler`` with ``profile_all=True`` around 3 eager BERT-base
   forwards and an ``nd`` MLP step: the op events, the card's kernels
   (the flash kernel 12 times a forward) and ``dumps()``'s rows, and what
   ``torch.profiler`` shows of one replayed forward (reported);
24. int8 and Longformer: (a) ResNet-50 v1 at 224 x 224, calibrated
   (``calib_mode="entropy"``, 2 batches of 4 seeded images), its 53
   convolutions and Dense swapped by ``quantize_net``, 32 requests served
   through ``ModelServer``'s captured graphs (against the eager int8
   forward); each quantized layer's int32 accumulator on the card's own
   int8 input bit for bit the CPU's; the card's int8 logits against a CPU
   int8 run given the card's roundings (``RoundDecisions``); the int8 and
   fp32 forwards timed at batch 32 and their logits' gap reported; (b)
   the sliding-window score and context ops, forward and gradients, at
   B=1, L=4096, 12 heads of 64 and w=256 against their direct-gather
   plain version, with the memory each keeps for its backward;
   Longformer-base (12 x 768, FFN 3072, 12 heads, w=256) with a
   Dense(50265) head trained 3 steps at B=1, L=4096 through
   ``Estimator.fit`` (``StoppingHandler``, ``CheckpointHandler``,
   ``LoggingHandler``), its SGD in the momentum kernel (launches counted),
   peak memory under 24 GB, its first step again bit for bit, the fp32
   encoder against float64 and the encoder served hybridized at B=4
   against eager;
25. data-parallel training across processes: two ranks of this script
   (``--rank-task phase25_rank``) started by the port's launcher
   (``mxnet_tpu_torch/tools/launch.py``) on this one card, so over gloo,
   each on ResNet-50 v1 at full width (224 x 224, 1000 classes, fp32,
   weights from ``--seed``), SGD momentum 0.9, wd 1e-4, global batch 128
   (64 a rank): (a) the JAX worker's kvstore invariants on CUDA tensors
   (``tests/test_dist.py:19-60``) and ``gluon.Trainer(kvstore=
   "dist_sync", update_on_kvstore=False)`` for 2 warm and 3 timed steps,
   the momentum kernel launching exactly 41 times a step on each rank,
   both ranks' trainable parameters bit for bit equal (SHA-1) after
   every step; a check step at global batch 4 (2 a rank) held by
   ``leaf_check`` against a CPU fp32 and a float64 step that runs each
   rank's half through its own model and sums the gradients, and the
   same check step with ``update_on_kvstore`` (the store's per-key
   updater) held to the same references;
   one with 2-bit compression whose pulled gradient is, bit for bit, the
   sum of each rank's CPU quantization; the all-reduce of the 25.56 M
   fp32 gradients timed alone (two ranks sharing one card: not a scaling
   number); (b) ``parallel.ShardedTrainer`` at dp = 2: ZeRO 0, 1 and 2,
   ``accum_steps=2`` and ``comm_bucket_mb=25``, each a check step at
   global batch 4 from the initial weights held by ``leaf_check``
   against a one-process CPU step on the whole batch (BatchNorm over the
   global batch; for accumulation, over each microbatch) and 1 warm and
   3 timed steps at 128, every parameter and running statistic bit for
   bit equal across the ranks after every step, the momentum kernel's
   launches exact (one call over every tensor or ZeRO slice a step),
   ZeRO 1's optimizer state about half of ZeRO 0's; (c) in this process,
   ``ShardedTrainer`` at dp = 1 at batch 128 (the JAX bench row's path),
   its step time beside phase 6's;
26. prints one JSON line of kernel measurements (flash: the fp32 and, as
   ``bf16_*``/``fp16_*``, the bf16 and fp16 B=8 L=512 cases, and every
   fp16 case; its training launches and its backward's times under
   ``train_launches`` and ``backward``; phase 12's launches and shapes
   under ``nmt_train_launches``, ``nmt_translate_launches`` and
   ``nmt_shapes``; the momentum kernel's phase-13 launches and updates
   under ``ssd_*`` and ``rcnn_*``; phase 16's launches under
   ``lamb_train_launches``, ``recipe_resume_launches`` and
   ``optimizer_zoo_launches`` (the mixed path without momentum's under
   ``optimizer_zoo_mixed_launches``), phase 17's under
   ``data_pipeline_launches``, phase 18's under ``vision_zoo_launches``
   and ``word_lm_launches``, phase 19's under
   ``symbolic_module_launches``, phase 20's under ``export_launches``,
   phase 21's under ``op_slice_launches``, phase 22's under
   ``control_flow_detection_launches``, phase 23's under
   ``observability_flash_launches``, phase 24's under
   ``longformer_launches``, phase 25's under ``dist_launches`` and
   ``sharded_launches``;
   the SGD kernels' bf16/fp16 entries, and the mixed path's own entry
   beside the unfused route's ``before_ms``), the card line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Writes the full report to ``<out>/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import http.client
import importlib.util
import json
import math
import os
import random
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from mxnet_tpu_torch import (autograd, gluon, load_reference_params, metric,
                             native, nd, operator, recordio, rtc)
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import io as mx_io
from mxnet_tpu_torch import callback as mx_callback
from mxnet_tpu_torch import model as mx_model
from mxnet_tpu_torch import module as mx_mod
from mxnet_tpu_torch import random as mx_random
from mxnet_tpu_torch import rnn as mx_rnn
from mxnet_tpu_torch import symbol as mx_sym
from mxnet_tpu_torch import engine as mx_engine
from mxnet_tpu_torch import init as mx_init
from mxnet_tpu_torch import lr_scheduler as mx_lr
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import as_device, cpu, gpu
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.data import DataLoader, vision
from mxnet_tpu_torch.gluon.data.vision import transforms
from mxnet_tpu_torch.gluon.model_zoo.rcnn import (RCNNLoss,
                                                  mask_rcnn_resnet18_v1)
from mxnet_tpu_torch.gluon.model_zoo.ssd import (SSDMultiBoxLoss,
                                                 ssd_512_resnet50_v1)
from mxnet_tpu_torch.gluon.model_zoo.transformer import (CausalLM,
                                                          LongformerEncoder,
                                                          bert_base,
                                                          causal_lm_small)
from mxnet_tpu_torch.gluon.contrib.estimator import (BatchBegin, BatchEnd,
                                                     CheckpointHandler,
                                                     Estimator,
                                                     LoggingHandler,
                                                     StoppingHandler)
from mxnet_tpu_torch.contrib.quantization import (QuantizedConv2D,
                                                  QuantizedDense,
                                                  quantize_net)
from mxnet_tpu_torch.ndarray.ops_sldwin import (direct_context,
                                                direct_score,
                                                sldwin_context,
                                                sldwin_score)
from mxnet_tpu_torch.gluon.model_zoo import vision as vision_zoo
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
from mxnet_tpu_torch.initializer import Xavier
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
from mxnet_tpu_torch.ndarray import ops_contrib, ops_optimizer, ops_spatial
from mxnet_tpu_torch.ndarray.register import get_op, invoke
from mxnet_tpu_torch.kernels.multi_sgd import (multi_mp_sgd,
                                               multi_mp_sgd_mom,
                                               multi_mp_sgd_mom_plain,
                                               multi_mp_sgd_plain, multi_sgd,
                                               multi_sgd_mom,
                                               multi_sgd_mom_plain,
                                               multi_sgd_plain, MAX_TENSORS)
from mxnet_tpu_torch import kvstore as mx_kv
from mxnet_tpu_torch import parallel as mx_par
from mxnet_tpu_torch.parallel import dist as mx_dist
from mxnet_tpu_torch import tuning
from mxnet_tpu_torch.observability import export as obs_export
from mxnet_tpu_torch.observability import flight as obs_flight
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.observability import sampler as obs_sampler
from mxnet_tpu_torch.observability import tracing
from mxnet_tpu_torch.observability import watchdog as obs_watchdog
from mxnet_tpu_torch.serving import (GenerationServer, HttpFrontend,
                                     ModelRegistry, ModelServer)
from mxnet_tpu_torch.serving.server import DECODE_ROWS, decode_rows, readback

# H100 SXM published peaks (dense): fp32 on the CUDA cores (the softmax
# kernels' unit); the tensor cores, where the flash kernel computes, in TF32
# (the fastest unit that carries an fp32-accurate product, as 3xTF32) and
# in bf16; HBM3 bandwidth
CUDA_CORE_FLOPS = 67e12
TENSOR_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12,
                torch.float16: 989e12}
PEAK_BYTES = 3.35e12
# the flash forward against its plain version in fp32: fp32; bf16 and
# fp16 output rounding (8 and 11 significant bits, and P rounded to the
# input type for the PV product)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
LENGTH_BUCKETS = (32, 64, 128, 256, 512)
BATCH_BUCKETS = (1, 8)
LAYERS, HEADS, HEAD_DIM, VOCAB = 12, 12, 64, 30522
N_REQUESTS = 32
FLASH_TPU = "mxnet_tpu/kernels/flash_attention.py:107"
FLASH_SRC = "mxnet_tpu_torch/kernels/csrc/flash_attention.cu"
SGD_TPU = "mxnet_tpu/kernels/multi_sgd.py:138"
SGD_MOM_TPU = "mxnet_tpu/kernels/multi_sgd.py:142"
SGD_SRC = "mxnet_tpu_torch/kernels/csrc/multi_sgd.cu"
SGD_TOL = 1e-6
AGG = 4                              # MXNET_OPTIMIZER_AGGREGATION_SIZE
MLP_SHAPES = [(128, 784), (128,), (64, 128), (64,), (10, 64), (10,)]
MLP_BATCH, MLP_STEPS = 64, 20
RESNET_BATCH, RESNET_WARM, RESNET_STEPS = 128, 3, 10
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CPU_CHECK_BATCH = 2
LEAF_K, LEAF_FLOOR = 4.0, 1e-3
RTC_TPU = "mxnet_tpu/rtc.py:50"
RTC_SRC = "chip_smoke.py"            # user kernels, compiled by rtc.py
# fp32 probabilities <= 1: kernel and plain version take the same expf of
# each element and differ only in the order of the row sums
SOFTMAX_TOL = 1e-6
SOFTMAX_SHAPES = [(100, 10), (4096, VOCAB)]   # the MLP; BERT-base's MLM
CUSTOM_SAMPLES, CUSTOM_HELD_OUT = 2000, 300
CUSTOM_BATCH, CUSTOM_EPOCHS, CUSTOM_LR = 100, 2, 2e-3
SMEM_FLOATS = 25600                   # 100 KB of dynamic shared memory
BERT_BATCH, BERT_SEQ = 8, 256         # bench_bert_base's shape
BERT_WARM, BERT_STEPS, BERT_AMP_STEPS = 3, 10, 20
BERT_OPT = {"learning_rate": 1e-4}
BERT_CHECK = (2, 128)                 # the leaf check's batch, sequence
BERT_AMP_LOSS_RTOL = 2e-2             # first AMP loss vs the fp32 one
MASK_ID = 103
# phase 10: low precision
LP_DTYPES = (torch.bfloat16, torch.float16)
SGD_MODES = ("sgd", "sgd_mom", "mp_sgd", "mp_sgd_mom")
RESNET_AMP_LOSS_RTOL = 2e-2           # first bf16 loss vs the fp32 one
RESNET_TRACKED = 4                    # bf16 steps held to the fp32 run's
BERT_FP16_STEPS, BERT_FP16_MIN_APPLIED = 20, 15
FP16_BACKWARD_TOL = 2e-2              # x max(1, max|g|)

# ----------------------------------------------------------------------
# User code of the rtc slice: CUDA sources compiled at run time by
# mxnet_tpu_torch.rtc (the counterpart of the TPU kernel path
# mxnet_tpu/rtc.py:50, PallasKernel._build, which compiles a user's Pallas
# kernel), each kernel beside its plain PyTorch version, and the softmax
# output layer as a custom operator (upstream MXNet's
# example/numpy-ops/custom_softmax_rtc.py, with one block per row so that
# it is right at any row width).

SOFTMAX_SRC = r"""
#define NEG_INF __int_as_float((int)0xff800000u)

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// Block-wide max / sum, returned to every thread; blockDim.x is a
// multiple of 32 and at most 1024.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = warp_max(lane < (blockDim.x >> 5) ? red[lane] : NEG_INF);
  __syncthreads();
  return v;
}
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = warp_sum(lane < (blockDim.x >> 5) ? red[lane] : 0.f);
  __syncthreads();
  return v;
}

// y = softmax(x) over each row of C; one block per row.  Bound by bytes:
// x is read from memory once (the second and third passes over a row
// hit L2) and y written once.  req: 1 write, 2 inplace, 3 add.
extern "C" __global__ void softmax_fwd(const float* __restrict__ x,
                                       float* __restrict__ y,
                                       const int C, const int req) {
  __shared__ float red[32];
  const float* xr = x + (size_t)blockIdx.x * C;
  float* yr = y + (size_t)blockIdx.x * C;
  float m = NEG_INF;
  for (int j = threadIdx.x; j < C; j += blockDim.x) m = fmaxf(m, xr[j]);
  m = block_max(m, red);
  float s = 0.f;
  for (int j = threadIdx.x; j < C; j += blockDim.x) s += expf(xr[j] - m);
  s = block_sum(s, red);
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const float p = expf(xr[j] - m) / s;
    if (req == 3) yr[j] += p; else yr[j] = p;
  }
}

// dx = y - onehot(label) for each row; the head gradient is not read
// (SoftmaxOutput's semantics).  Bound by bytes: y read, dx written.
extern "C" __global__ void softmax_bwd(const float* __restrict__ label,
                                       const float* __restrict__ y,
                                       float* __restrict__ dx,
                                       const int C, const int req) {
  const size_t row = blockIdx.x;
  const int l = (int)label[row];
  const float* yr = y + row * C;
  float* dr = dx + row * C;
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const float g = yr[j] - (j == l ? 1.f : 0.f);
    if (req == 3) dr[j] += g; else dr[j] = g;
  }
}
"""
SOFTMAX_FWD_SIG = "const float *x, float *y, const int C, const int req"
SOFTMAX_BWD_SIG = ("const float *label, const float *y, float *dx, "
                   "const int C, const int req")

# the JAX package's rtc tests' two kernels (tests/test_aux.py: add_one on
# fp32, twice on int32), written for the card; they write in place
ELEMENTWISE_SRC = r"""
extern "C" __global__ void add_one(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}
extern "C" __global__ void twice(const int* x, int* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2;
}
"""
# a C++ template, reached through exports=("axpy<float>", ...)
AXPY_SRC = r"""
template <typename T>
__global__ void axpy(const T* x, T* y, T alpha, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = alpha * x[i] + y[i];
}
"""
AXPY_EXPORTS = ("axpy<float>", "axpy<double>")
# reverses each block's n floats through dynamic shared memory (> 48 KB)
SMEM_SRC = r"""
extern "C" __global__ void smem_reverse(const float* x, float* y, int n) {
  extern __shared__ float buf[];
  const float* xb = x + (size_t)blockIdx.x * n;
  float* yb = y + (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = xb[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) yb[i] = buf[n - 1 - i];
}
"""
REQ_CODE = {"write": 1, "inplace": 2, "add": 3}


def softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``softmax_fwd``: exp(x - max) / sum, by row."""
    m = x.max(dim=1, keepdim=True).values
    e = torch.exp(x - m)
    return e / e.sum(dim=1, keepdim=True)


def softmax_bwd_plain(y: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The plain version of ``softmax_bwd``: y - onehot(label)."""
    return y - F.one_hot(label.long(), y.shape[1]).to(y.dtype)


def add_one_plain(x):
    return x + 1.0


def twice_plain(x):
    return x * 2


def axpy_plain(alpha, x, y):
    return alpha * x + y


def smem_reverse_plain(x, n):
    return x.view(-1, n).flip(1).reshape(x.shape)


def softmax_threads(c: int) -> int:
    """Threads per row: a multiple of 32, at most 1024."""
    return min(1024, max(32, -(-c // 32) * 32))


_RTC: dict = {}


def rtc_modules() -> dict:
    """The user modules, compiled once per process at first use."""
    if not _RTC:
        _RTC.update(softmax=rtc.CudaModule(SOFTMAX_SRC),
                    elementwise=rtc.CudaModule(ELEMENTWISE_SRC),
                    axpy=rtc.CudaModule(AXPY_SRC, exports=AXPY_EXPORTS),
                    smem=rtc.CudaModule(SMEM_SRC))
        sm = _RTC["softmax"]
        _RTC["softmax_fwd"] = sm.get_kernel("softmax_fwd", SOFTMAX_FWD_SIG)
        _RTC["softmax_bwd"] = sm.get_kernel("softmax_bwd", SOFTMAX_BWD_SIG)
    return _RTC


class SoftmaxRtc(operator.CustomOp):
    """Softmax output layer on MXNet's custom-op surface: ``in_data``,
    ``out_data`` and the gradients arrive as ``NDArray``s, which the rtc
    kernels take as they are on the card; on the CPU the plain versions
    run and ``assign`` writes their result."""

    def forward(self, is_train, req, in_data, out_data, aux):
        x, y = in_data[0], out_data[0]
        if req[0] == "null":
            return
        if x.context.device_type == "cpu":
            self.assign(y, req[0], softmax_plain(torch.as_tensor(
                x.asnumpy())))
            return
        n, c = x.shape
        rtc_modules()["softmax_fwd"].launch(
            [x, y, c, REQ_CODE[req[0]]], x.context, (n, 1, 1),
            (softmax_threads(c), 1, 1))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        label, y, dx = in_data[1], out_data[0], in_grad[0]
        if req[0] == "null":
            return
        if y.context.device_type == "cpu":
            self.assign(dx, req[0], softmax_bwd_plain(
                torch.as_tensor(y.asnumpy()),
                torch.as_tensor(label.asnumpy())))
            return
        n, c = y.shape
        rtc_modules()["softmax_bwd"].launch(
            [label, y, dx, c, REQ_CODE[req[0]]], y.context, (n, 1, 1),
            (softmax_threads(c), 1, 1))


@operator.register("softmax_rtc")
class SoftmaxRtcProp(operator.CustomOpProp):
    """``data`` (N, C) and ``label`` (N,) in, probabilities (N, C) out;
    the head gradient is not read (``need_top_grad=False``)."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return SoftmaxRtc()


def _short(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


COUNTED = (flash_attention, multi_sgd, multi_sgd_mom, multi_mp_sgd,
           multi_mp_sgd_mom)


def zero_counts() -> None:
    """Set every kernel's launch count to 0, just before a main path."""
    for wrapper in COUNTED:
        wrapper.launches = 0
    for dtype in flash_attention.launches_by_dtype:
        flash_attention.launches_by_dtype[dtype] = 0
    for name in ("softmax_fwd", "softmax_bwd"):
        if name in _RTC:
            _RTC[name].launches = 0
    rtc.launches = 0


def other_launches(*mine) -> int:
    """Launches of every kernel wrapper but ``mine`` (and of rtc), since
    the counts were last set to 0."""
    return sum(w.launches for w in COUNTED if w not in mine) + rtc.launches


def _is_kernel(event) -> bool:
    """A device-side record of torch.profiler that is a kernel or a copy,
    not the device span of a ``record_function`` range (the flash
    backward's, the trainer step's), which would count its kernels and
    its idle gaps a second time."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not event.is_user_annotation)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    three warm calls, by CUDA events."""
    for _ in range(3):
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


def flash_bound(vl_bh, lq, lk, d, dtype):
    """(bound_ms, bound_by, flops, bytes) of one flash-attention call, for
    the keys this run's lengths make live (min(ceil(vl), Lk) per row; the
    output depends on no later key, and a row with none is 0 whatever its
    q): 4 * Lq * keys * D operations at the tensor cores' rate for
    ``dtype``; out written once, and the q rows and K/V keys that are live
    read once."""
    bh = vl_bh.numel()
    keys_bh = torch.clamp(torch.ceil(vl_bh.float()), 0, lk)
    keys = keys_bh.sum().item()
    live_bh = int((keys_bh > 0).sum().item())
    flops = 4.0 * lq * keys * d
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = ((live_bh + bh) * lq + 2 * keys) * d * itemsize + bh * 4
    t_ops, t_bytes = flops / TENSOR_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def flash_inputs(gen, b, h, lq, lk, d):
    """q, k, v (fp32, on the CPU) and the (B,) lengths of one flash case,
    drawn from ``gen``: lengths in 1..Lk, the first 0 (a batch-pad row)."""
    q, k, v = (torch.randn(b * h, n, d, generator=gen)
               for n in (lq, lk, lk))
    vl = torch.randint(1, lk + 1, (b,), generator=gen).float()
    vl[0] = 0.0
    return q, k, v, vl


# (name, B, H, Lq, Lk, D, dtype, causal, timed iterations), in draw order
FLASH_CASES = [
    (f"bert_base B=8 L={lq} {_short(dtype)}", 8, HEADS, lq, lq, HEAD_DIM,
     dtype, False, 50)
    for lq in (128, 512) for dtype in (torch.float32, torch.bfloat16)] + [
    # the causal mask with Lq > Lk (dead rows), and the other head dims
    ("causal Lq=160 Lk=96", 2, HEADS, 160, 96, HEAD_DIM, torch.float32,
     True, 0),
    ("D=128 ragged", 2, 4, 200, 131, 128, torch.float32, False, 0),
    ("D=32 ragged bf16", 2, 4, 77, 77, 32, torch.bfloat16, True, 0)]
# the training phase's shape, drawn after FLASH_CASES, with the lengths of
# its batch (``bert_batch``: in [S/2, S]) in place of the drawn ones
TRAIN_FLASH_CASES = [
    (f"bert_train B={BERT_BATCH} L={BERT_SEQ} {_short(dtype)}", BERT_BATCH,
     HEADS, BERT_SEQ, BERT_SEQ, HEAD_DIM, dtype, False, 50)
    for dtype in (torch.float32, torch.bfloat16)]
# the fp16 forward (AMP's "float16" target) at B=8 and BERT-base's width
# (768 = H x D), drawn after TRAIN_FLASH_CASES
FP16_FLASH_CASES = [
    (f"fp16 B=8 L={lq} D={d}", 8, 768 // d, lq, lq, d, torch.float16,
     False, 20)
    for lq in (128, 256, 512) for d in (32, 64, 128)]


def check_flash(gen, name, b, h, lq, lk, d, dtype, causal, iters, vl=None):
    """One flash case: the kernel's output against the plain version's in
    fp32 (raises past ``TOL[dtype]``) and, with ``iters``, device and wall
    times beside the plain version's, SDPA's and the bound.  ``vl``, if
    given, replaces the (B,) lengths drawn from ``gen``."""
    dev = gpu(0)
    q, k, v, drawn = (t.to(dev) for t in flash_inputs(gen, b, h, lq, lk, d))
    vl = drawn if vl is None else vl.float().to(dev)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    vl_bh = vl.repeat_interleave(h)
    scale = 1.0 / math.sqrt(d)
    out = flash_attention(q, k, v, vl, causal, scale)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), vl_bh,
                                causal, scale)
    err = (out.float() - ref).abs().max().item()
    if not err <= TOL[dtype]:
        raise AssertionError(f"flash {name}: max-abs {err} > {TOL[dtype]}")
    row = {"case": name, "B": b, "H": h, "Lq": lq, "Lk": lk, "D": d,
           "dtype": _short(dtype), "causal": causal,
           "max_abs_err": err}
    if iters:
        key = torch.arange(lk, device=dev)[None, :] < vl[:, None]
        mask = key[:, None, None, :]
        if causal:
            mask = mask & torch.ones(lq, lk, dtype=torch.bool, device=dev) \
                .tril(lk - lq)
        q4, k4, v4 = (t.view(b, h, -1, d) for t in (q, k, v))
        bound_ms, bound_by, flops, nbytes = flash_bound(vl_bh, lq, lk, d,
                                                        dtype)

        def kernel():
            return flash_attention(q, k, v, vl, causal, scale)

        def plain():
            return flash_attention_plain(q, k, v, vl_bh, causal, scale)

        def library():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  scale=scale)

        library_kernels = {}
        row.update(
            ms=kernel_ms(kernel, iters, only="flash_fwd_kernel"),
            plain_ms=kernel_ms(plain, 5),
            library_ms=kernel_ms(library, iters, kernels=library_kernels),
            library_kernels=library_kernels,
            wall_ms=cuda_ms(kernel, iters), plain_wall_ms=cuda_ms(plain, 5),
            library_wall_ms=cuda_ms(library, iters),
            bound_ms=bound_ms, bound_by=bound_by, flops=flops,
            bytes=nbytes)
    return row


# config #4's shapes (phase 12), drawn after FP16_FLASH_CASES, every key
# valid (the NMT attentions that take the kernel carry no mask): training
# self- and cross-attention at B=16, H=8, D=64, and translate's decoder
# cross-attention, a prefix of Lq tokens against a source of Lk
NMT_FLASH_CASES = [
    ("nmt B=16 H=8 L=64", 16, 8, 64, 64, 64, torch.float32, False, 50),
    ("nmt cross Lq=48 Lk=64", 16, 8, 48, 64, 64, torch.float32, False, 50),
    ("nmt decode Lq=1 Lk=64", 8, 8, 1, 64, 64, torch.float32, False, 50),
    ("nmt decode Lq=7 Lk=32", 8, 8, 7, 32, 64, torch.float32, False, 50)]


def kernel_phase(seed: int):
    gen = torch.Generator().manual_seed(seed)
    rows = [check_flash(gen, *case) for case in FLASH_CASES]
    train_vl = torch.as_tensor(bert_batch(seed, BERT_BATCH, BERT_SEQ)[2])
    rows += [check_flash(gen, *case, vl=train_vl)
             for case in TRAIN_FLASH_CASES]
    rows += [check_flash(gen, *case) for case in FP16_FLASH_CASES]
    return rows + [check_flash(gen, *case, vl=torch.full((case[1],),
                                                         float(case[4])))
                   for case in NMT_FLASH_CASES]


# instruction families counted in the flash library's SASS
SASS_OPS = {"tensor_core_mma": ("HMMA", "HGMMA"),
            "async_copy": ("LDGSTS", "UTMALDG", "UBLKCP"),
            "ldmatrix": ("LDSM",), "ffma": ("FFMA",)}
# and in the multi-SGD library's: 16-byte global loads (a family may be a
# pattern of the whole mnemonic)
SGD_SASS_OPS = {"load_128": re.compile(r"LDG(\.\w+)*\.128(\.\w+)*")}
SGD_UNROLL = 4     # fp32 vectors a thread stages (csrc/multi_sgd.cu)
_SASS_FN = re.compile(r"\s*Function : (\S+)")
_SASS_OP = re.compile(                # address, predicate, mnemonic
    r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)"
    r"((?:\.[A-Z0-9_]+)*)")


def sass_census(text: str, families: dict = SASS_OPS) -> dict:
    """Counts of each family of ``families`` (default ``SASS_OPS``: opcodes,
    or a pattern of the whole mnemonic), per kernel (mangled name), in a
    ``cuobjdump -sass`` listing."""
    census, counts = {}, None
    for line in text.splitlines():
        fn = _SASS_FN.match(line)
        if fn:
            counts = census.setdefault(fn.group(1),
                                       {fam: 0 for fam in families})
            continue
        op = _SASS_OP.match(line)
        if op and counts is not None:
            for fam, ops in families.items():
                if (ops.fullmatch(op.group(1) + op.group(2))
                        if isinstance(ops, re.Pattern)
                        else op.group(1) in ops):
                    counts[fam] += 1
    return census


def cuobjdump() -> str:
    """The CUDA toolkit's ``cuobjdump``, else the copy in Triton's package."""
    cands = [os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                          "bin", "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    for cand in cands:
        if os.path.exists(cand):
            return cand
    raise AssertionError(f"cuobjdump not found at {cands}")


def library_sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library of ``csrc/<name>.cu``."""
    return subprocess.run([cuobjdump(), "-sass", str(_build._target(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


# mangled template arguments of the kernels' storage types
_MANGLED = {"f": "float32", "13__nv_bfloat16": "bfloat16",
            "6__half": "float16"}


def flash_sass() -> dict:
    """SASS census of each flash kernel instantiation in the built library;
    fails unless every one has tensor-core MMAs and asynchronous copies."""
    census = {}
    for fn, counts in sass_census(library_sass("flash_attention")).items():
        if "flash_fwd_kernel" not in fn:
            continue
        m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16|6__half)"
                      r"Li(\d+)E", fn)
        census[f"{_MANGLED[m.group(1)]} D={m.group(2)}" if m else fn] = \
            counts
    if not census or not all(c["tensor_core_mma"] and c["async_copy"]
                             for c in census.values()):
        raise AssertionError(f"flash kernel without tensor-core MMAs or "
                             f"asynchronous copies: {census}")
    return census


def sgd_words(dtype: str, mode: str) -> int:
    """16-byte words a vector of ``mode``'s kernel loads (w or its fp32
    master, g, and m with momentum), times the vectors each thread stages
    (``SGD_UNROLL`` fp32 vectors of 4, half as many of 8 in a 2-byte
    dtype): the kernel's staged 16-byte loads."""
    mixed = mode.startswith("mp")
    unroll = SGD_UNROLL if dtype == "float32" else SGD_UNROLL // 2
    master = 2 if mixed else 1            # an fp32 array of 8 elements
    words = 1 + master + (master if mode.endswith("mom") else 0)
    return unroll * words


def sgd_sass() -> dict:
    """SASS census of the multi-SGD kernels, one per storage type and
    mode (``float32 sgd``, ``bfloat16 mp_sgd_mom``, ...); fails unless
    there are all 10 and each holds the 16-byte loads it stages in
    registers (``sgd_words``)."""
    census = {}
    for fn, counts in sass_census(library_sass("multi_sgd"),
                                  SGD_SASS_OPS).items():
        m = re.search(r"multi_sgd_kernelI(f|13__nv_bfloat16|6__half)"
                      r"Li([0-3])E", fn)
        if m:
            census[f"{_MANGLED[m.group(1)]} "
                   f"{SGD_MODES[int(m.group(2))]}"] = counts
    want = {f"{dt} {mode}": sgd_words(dt, mode)
            for dt in ("float32", "bfloat16", "float16")
            for mode in SGD_MODES
            if dt != "float32" or not mode.startswith("mp")}
    if sorted(census) != sorted(want) or not all(
            census[k]["load_128"] >= n for k, n in want.items()):
        raise AssertionError(f"multi-SGD kernels without {want} staged "
                             f"16-byte loads: {census}")
    return census


_PTXAS_FN = re.compile(r"Function properties for (\S+)")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes per kernel (mangled name) from a
    ``-Xptxas -v`` log."""
    report, fn = {}, None
    for line in log.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            fn = m.group(1)
            report[fn] = {"registers": None, "spill_stores": 0,
                          "spill_loads": 0}
            continue
        if fn is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m:
            report[fn]["registers"] = int(m.group(1))
    return report


def bucket_lengths(rng, n_requests):
    """Request lengths in 16..512 drawn from ``rng``, cycling over the
    length buckets so every bucket is served."""
    lows = (16,) + tuple(b + 1 for b in LENGTH_BUCKETS[:-1])
    return [int(rng.integers(lows[i % 5], LENGTH_BUCKETS[i % 5] + 1))
            for i in range(n_requests)]


def profile_batch(net, dev, n_iters=3):
    """Where the time of a served B=8, L=512 batch goes: device time by
    kernel class (torch.profiler) over ``n_iters`` forward + readback
    calls of the cached graph, beside their host wall time."""
    from torch.profiler import ProfilerActivity, profile
    b, s = BATCH_BUCKETS[-1], LENGTH_BUCKETS[-1]
    arrays = (np.zeros((b, s), np.int32), np.zeros((b, s), np.int32),
              np.full((b,), s, np.float32))
    graph = net.cached_graph(*arrays)
    readback(graph.raw(*arrays))     # warm: the page-locked host buffers
    for _ in range(TRACE_ATTEMPTS):  # a replay's trace may lose records
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(n_iters):
                readback(graph.raw(*arrays))
            wall_ms = (time.monotonic() - t0) * 1e3 / n_iters
        classes = {"flash_attention": 0.0, "gemm": 0.0, "memcpy": 0.0,
                   "other": 0.0}
        for e in prof.key_averages():
            if not _is_kernel(e):
                continue
            name = e.key.lower()
            if "flash_fwd_kernel" in name:
                cls = "flash_attention"
            elif "memcpy" in name:
                cls = "memcpy"
            elif any(w in name for w in ("gemm", "cutlass", "xmma", "sm90")):
                cls = "gemm"
            else:
                cls = "other"
            classes[cls] += e.self_device_time_total / 1e3 / n_iters
        if classes["flash_attention"] > 0:
            break
    else:
        raise TraceLost(f"profile: no device time in flash_fwd_kernel in "
                        f"{TRACE_ATTEMPTS} traces ({classes})")
    busy = sum(classes.values())
    return {"batch": [b, s], "wall_ms": wall_ms, "device_ms": classes,
            "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms)}


def serve_phase(seed: int, n_requests: int, card: str):
    dev = gpu(0)
    net = bert_base(dropout=0.0)
    net.initialize(ctx=dev, seed=seed)
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, VOCAB, n).astype(np.int32),
             rng.integers(0, 2, n).astype(np.int32), np.float32(n))
            for n in bucket_lengths(rng, n_requests)]
    srv = ModelServer(net, max_batch=BATCH_BUCKETS[-1],
                      length_buckets=LENGTH_BUCKETS,
                      batch_buckets=BATCH_BUCKETS, queue_depth=4 * n_requests,
                      deadline_ms=0, workers=2, batch_window_us=5000)
    results, futs = {}, {}
    try:
        t0 = time.monotonic()
        srv.warmup(*[(np.zeros(n, np.int32), np.zeros(n, np.int32),
                      np.float32(n)) for n in LENGTH_BUCKETS])
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        srv.start()
        torch.cuda.reset_peak_memory_stats()
        b0 = srv.stats()["batches"]
        zero_counts()

        def client(tid, n_clients=4):
            mine = range(tid, n_requests, n_clients)
            for i in mine:
                futs[i] = srv.submit(*reqs[i])
            for i in mine:
                results[i] = futs[i].result(timeout=600)

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.monotonic() - t0
        launches = flash_attention.launches
        other = other_launches(flash_attention)
        batches = srv.stats()["batches"] - b0
        graphs = graph_summary(net)
        if any(t.is_alive() for t in threads) or len(results) != n_requests:
            raise AssertionError("requests did not complete")
    finally:
        srv.stop()
    stats = srv.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != LAYERS * batches or other:
        raise AssertionError(f"flash launches {launches} != {LAYERS} x "
                             f"{batches} batches, or {other} SGD/rtc "
                             f"launches")
    if (graphs["graphs"] != len(LENGTH_BUCKETS) * len(BATCH_BUCKETS)
            or graphs["replays"] != batches or graphs["warm_calls"]
            or graphs["deferred_calls"]):
        raise AssertionError(f"served {batches} batches from graphs "
                             f"{graphs}")
    buckets = set()
    for i, (toks, _, _) in enumerate(reqs):
        mlm, nsp = results[i]
        n = toks.shape[0]
        if mlm.shape != (n, VOCAB) or nsp.shape != (2,):
            raise AssertionError(f"request {i}: shapes {mlm.shape} "
                                 f"{nsp.shape}, want ({n}, {VOCAB}), (2,)")
        if not (np.isfinite(mlm).all() and np.isfinite(nsp).all()):
            raise AssertionError(f"request {i}: non-finite output")
        buckets.add(next(b for b in LENGTH_BUCKETS if b >= n))
    if buckets != set(LENGTH_BUCKETS):
        raise AssertionError(f"buckets served {sorted(buckets)}")

    def direct(model, i, device):
        with torch.inference_mode():
            out = model(*[torch.as_tensor(np.asarray(a)[None], device=device)
                          for a in reqs[i]])
        return [o[0].cpu().numpy() for o in out]

    def max_err(i, outs):
        return max(float(np.abs(a - b).max())
                   for a, b in zip(results[i], outs))

    invariance = {i: max_err(i, direct(net, i, dev)) for i in range(4)}
    breakdown = profile_batch(net, dev)
    free_graphs(net)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    cpu_net = bert_base(dropout=0.0)
    cpu_net.initialize(ctx=cpu(), seed=seed)
    shortest = min(range(n_requests), key=lambda i: reqs[i][0].shape[0])
    cpu_err = max_err(shortest, direct(cpu_net, shortest, cpu()))
    if max(invariance.values()) > 1e-3 or cpu_err > 1e-3:
        raise AssertionError(f"served vs direct max-abs {invariance}, "
                             f"vs CPU plain path {cpu_err} (limit 1e-3)")
    lat = np.array([(futs[i].t_done - futs[i].t_enqueue) * 1e3
                    for i in range(n_requests)])
    dispatch = registry().histogram("serving.dispatch_us")
    return {
        "card": card, "requests": n_requests, "batches": batches,
        "flash_launches": launches, "graph_stats": graphs,
        "warmup_s": warm_s, "wall_s": wall,
        "requests_per_s": n_requests / wall,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "dispatch_ms_p50_bucketed": dispatch.percentile(50) / 1e3,
        "dispatch_ms_p99_bucketed": dispatch.percentile(99) / 1e3,
        "peak_memory_gb": peak_gb, "stats": stats,
        "batching_invariance_max_abs": invariance,
        "cpu_plain_path_max_abs": cpu_err,
        "cpu_check_length": int(reqs[shortest][0].shape[0]),
        "profile": breakdown,
    }


def _groups(n, size):
    return [list(range(lo, min(lo + size, n))) for lo in range(0, n, size)]


def resnet50_trainable_shapes():
    return [p.shape for p in resnet50_v1().collect_params().values()
            if p.grad_req != "null"]


def sgd_bound(n_elems: int, momentum: bool):
    """(bound_ms, bytes) of one update over ``n_elems`` fp32 elements:
    sgd reads w, g and writes w (12 B/element), sgd_mom also reads and
    writes m (20 B/element); 4-6 flops per element are far below the
    card's 20 flops per byte, so bytes bound it."""
    nbytes = (20 if momentum else 12) * n_elems
    return nbytes / PEAK_BYTES * 1e3, nbytes


def _clone_at(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``t`` placed ``offset`` elements into a buffer of its
    own, as the original was (a plain clone would start aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


# the kernel of ``torch.cuda._sleep``, which opens each trace of device_ms
SENTINEL, SENTINEL_CYCLES = "spin_kernel", 1000
# traces of one timing before it gives up: on an H100, CUPTI loses records
# of a trace now and then, in a fresh process too and more often after
# graph replays; once a process loses them it may go on losing them (8
# lossy traces in a row ended a whole-script run), so ``kernel_ms`` then
# times by CUDA events instead
TRACE_ATTEMPTS = 4
# the timings whose every trace lost records, timed by CUDA events instead
EVENT_FALLBACKS = []


class TraceLost(AssertionError):
    """Every trace of a timing lost records (CUPTI), or held none."""


def device_ms(fn, iters: int, attempts: int = TRACE_ATTEMPTS, only: str = "",
              kernels: dict = None, lost: int = 0,
              per_call: int = 0) -> float:
    """Device time of one ``fn`` call: the summed time of the CUDA kernels
    it launches (torch.profiler; with ``only``, of those whose name holds
    it) over ``iters`` calls, after three warm calls.  Unlike ``cuda_ms``
    it leaves out the host's launch gaps.  A trace that lost records (no
    device time at all, or a kernel counted more than ``lost`` times short
    of a multiple of ``iters``) is taken again, up to ``attempts`` times,
    and then raises: 0 is never a measurement.  With ``lost`` (a call of
    many kernels, some from autograd's backward thread, where a trace of
    thousands of records can lose one), a kernel short of at most
    ``lost`` records has its time scaled up to its full count.  Each
    trace opens with a sentinel kernel (``SENTINEL``, left out of the
    sums), so that the record a trace may lose first is not one of
    ``fn``'s.  ``kernels``, if given, gets each kernel's launches per
    call.  With ``per_call`` (``only`` names one kernel that ``fn``
    launches exactly that often) the count is known, so a trace is taken
    if at least half the records arrived and none too many, and the time
    is their mean duration times the known count."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SENTINEL_CYCLES)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if _is_kernel(e) and SENTINEL not in e.key
                  and only in e.key]
        full = {e.key: per_call * iters if per_call
                else e.count + (-e.count) % iters for e in events}
        total = sum(e.self_device_time_total * full[e.key] / e.count
                    for e in events)
        short = lost if not per_call else per_call * iters // 2
        if total > 0 and all(0 <= full[e.key] - e.count <= short
                             for e in events) \
                and (not per_call or len(events) == 1):
            if kernels is not None:
                kernels.update({e.key[:80]: full[e.key] // iters
                                for e in events})
            return total / iters / 1e3
    seen = [(e.key[:60], e.count) for e in events]
    raise TraceLost(f"torch.profiler saw no device time, or partial "
                    f"records, in {attempts} traces of {iters} calls; "
                    f"the last: {seen}")


def kernel_ms(fn, iters: int, **kw) -> float:
    """``device_ms`` of ``fn``, or, where CUPTI lost records in each of
    its traces, the CUDA-event time of back-to-back calls (``cuda_ms``),
    which adds the host's launch gaps; such a fallback is noted in
    ``EVENT_FALLBACKS`` and on stderr, and ``kw["kernels"]`` then stays
    unfilled.  Correctness is checked elsewhere: a lossy profiler is no
    fault of the kernel timed."""
    try:
        return device_ms(fn, iters, **kw)
    except TraceLost as e:
        ms = cuda_ms(fn, iters)
        EVENT_FALLBACKS.append({"fn": getattr(fn, "__qualname__", repr(fn)),
                                "event_ms": ms, "trace": str(e)[:300]})
        print(f"chip_smoke: {EVENT_FALLBACKS[-1]['fn']}: {str(e)[:300]}; "
              f"timed by CUDA events instead: {ms} ms", file=sys.stderr,
              flush=True)
        return ms


def launch_ms(fn, n_launches: int, iters: int, only: str,
              attempts: int = TRACE_ATTEMPTS, each: list = None) -> list:
    """Device time of each of the ``n_launches`` kernel launches (those
    whose name holds ``only``) that one ``fn`` call makes, in launch order,
    averaged over ``iters`` calls after three warm calls: torch.profiler's
    kernel events, ordered by their start on the device.  Each trace
    opens with a small synchronised op (a trace can lose its first kernel
    record); a trace with another number of ``only`` events is taken
    again, up to ``attempts`` times, and then raises, or, given ``each``
    (callables making launch i alone), times each by CUDA events
    (``cuda_ms``), noted in ``EVENT_FALLBACKS``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    sentinel = torch.zeros(1, device=gpu(0))
    found = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sentinel.add_(1)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if _is_kernel(e)
                         and only in e.name),
                        key=lambda e: e.time_range.start)
        found = len(events)
        if found == n_launches * iters:
            per = [0.0] * n_launches
            for i, e in enumerate(events):
                per[i % n_launches] += e.time_range.elapsed_us()
            return [t / iters / 1e3 for t in per]
    lost = (f"torch.profiler saw {found} {only!r} launches in {iters} "
            f"calls, not {n_launches * iters}")
    if each is None:
        raise TraceLost(lost)
    ms = [cuda_ms(f, iters) for f in each]
    EVENT_FALLBACKS.append({"fn": f"launch_ms {only}", "event_ms": ms,
                            "trace": lost})
    print(f"chip_smoke: {lost}; timed by CUDA events instead",
          file=sys.stderr, flush=True)
    return ms


# group sizes (elements) that bin the per-launch table
LAUNCH_BINS = (("< 64K", 0, 1 << 16), ("64K-1M", 1 << 16, 1 << 20),
               ("> 1M", 1 << 20, math.inf))


def launch_bins(elements: list, ms: list, momentum: bool) -> list:
    """The per-launch table binned by group size: launches, elements,
    device ms and the bytes bound of each bin, and the bound's share of
    the device time."""
    rows = []
    for name, lo, hi in LAUNCH_BINS:
        pick = [i for i, n in enumerate(elements) if lo <= n < hi]
        n = sum(elements[i] for i in pick)
        t = sum(ms[i] for i in pick)
        bound = sgd_bound(n, momentum)[0]
        rows.append({"bin": name, "launches": len(pick), "elements": n,
                     "ms": t, "bound_ms": bound,
                     "bound_share": bound / t if t > 0 else None})
    return rows


def time_sgd(case: SgdCase, momentum: bool, iters: int):
    """Times of one update over the whole set at the Trainer's settings of
    the ResNet recipe (lr 0.1, wd 1e-4, momentum 0.9, rescale 1/128, no
    clip): the kernel in groups of 4 (the main path) and as one group, the
    plain version, and fused torch.optim.SGD.  ``ms``, ``plain_ms`` and
    ``library_ms`` are device time (``device_ms``); the ``*_wall_ms`` keys
    are CUDA-event time of back-to-back calls, which includes the host's
    launch overhead whenever the host is slower than the card."""
    w, m = case.state("sgd_mom")
    lrs, wds = [0.1] * len(w), [1e-4] * len(w)
    rescale = 1.0 / RESNET_BATCH
    groups = _groups(len(w), AGG)

    def kernel(gs):
        for idx in gs:
            sub = ([w[i] for i in idx], [case.g[i] for i in idx])
            if momentum:
                multi_sgd_mom(*sub, [m[i] for i in idx], lrs[:len(idx)],
                              wds[:len(idx)], 0.9, rescale)
            else:
                multi_sgd(*sub, lrs[:len(idx)], wds[:len(idx)], rescale)

    def plain():
        if momentum:
            multi_sgd_mom_plain(w, case.g, m, lrs, wds, 0.9, rescale)
        else:
            multi_sgd_plain(w, case.g, lrs, wds, rescale)

    params = [torch.nn.Parameter(t.clone()) for t in case.w]
    for p, g in zip(params, case.g):
        p.grad = g
    lib = torch.optim.SGD(params, lr=0.1, momentum=0.9 if momentum else 0.0,
                          weight_decay=1e-4, fused=True)
    one_group = [list(range(len(w)))]
    before = multi_sgd.launches + multi_sgd_mom.launches
    row = {"wall_ms": cuda_ms(lambda: kernel(groups), iters)}
    row["launches_per_update"] = (multi_sgd.launches + multi_sgd_mom.launches
                                  - before) / (iters + 3)
    elements = [sum(math.prod(case.shapes[i]) for i in idx) for idx in groups]
    per_launch = launch_ms(lambda: kernel(groups), len(groups), 5,
                           "multi_sgd_kernel",
                           each=[lambda g=g: kernel([g]) for g in groups])
    row.update(
        per_launch=[{"elements": n, "ms": t,
                     "bound_ms": sgd_bound(n, momentum)[0]}
                    for n, t in zip(elements, per_launch)],
        per_launch_bins=launch_bins(elements, per_launch, momentum),
        ms=kernel_ms(lambda: kernel(groups), 5, lost=1),
        one_group_ms=kernel_ms(lambda: kernel(one_group), 5, lost=1),
        one_group_wall_ms=cuda_ms(lambda: kernel(one_group), iters),
        plain_ms=kernel_ms(plain, 5, lost=1),
        plain_wall_ms=cuda_ms(plain, iters),
        library_ms=kernel_ms(lib.step, 5, lost=1),
        library_wall_ms=cuda_ms(lib.step, iters))
    bound_ms, nbytes = sgd_bound(case.n, momentum)
    row.update(bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
               elements=case.n, tensors=len(w))
    return row


def sgd_bytes(mode: str, itemsize: int) -> int:
    """Bytes per element that one update of ``mode`` must move, each input
    read once and each output written once: w and g of ``itemsize``
    bytes, m in it too (plain), or m and the master w32 in fp32 (mixed,
    where w is written and not read)."""
    if mode.startswith("mp"):
        return 2 * itemsize + 8 + (8 if mode.endswith("mom") else 0)
    return (5 if mode.endswith("mom") else 3) * itemsize


SGD_FNS = {"sgd": (multi_sgd, multi_sgd_plain),
           "sgd_mom": (multi_sgd_mom, multi_sgd_mom_plain),
           "mp_sgd": (multi_mp_sgd, multi_mp_sgd_plain),
           "mp_sgd_mom": (multi_mp_sgd_mom, multi_mp_sgd_mom_plain)}


class SgdCase:
    """Weights and gradients of ``shapes`` and ``dtype`` (fp32, bf16 or
    fp16) on the card, momenta in that dtype (``m``, plain) and in fp32
    (``m32``, mixed), fp32 masters a little off their weights (``w32``),
    per-tensor lr and wd, all drawn from ``gen``; ``offset`` > 0 places
    every tensor that many elements into its buffer (misaligned)."""

    def __init__(self, gen, shapes, dtype=torch.float32, offset=0):
        dev = gpu(0)

        def make(shape, scale, dt):
            n = math.prod(shape)
            buf = torch.randn(n + offset, device=dev, generator=gen) * scale
            return buf.to(dt)[offset:].view(shape)

        self.shapes, self.dtype, self.offset = shapes, dtype, offset
        self.w = [make(s, 1.0, dtype) for s in shapes]
        self.g = [make(s, 2.0, dtype) for s in shapes]
        self.m = [make(s, 0.1, dtype) for s in shapes]
        self.m32 = [make(s, 0.1, torch.float32) for s in shapes]
        self.w32 = [make(s, 1e-3, torch.float32).add_(w.float())
                    for s, w in zip(shapes, self.w)]
        k = len(shapes)
        self.lrs = (torch.rand(k, generator=torch.Generator().manual_seed(k))
                    * 0.2 + 0.01).tolist()
        self.wds = (torch.rand(k, generator=torch.Generator().manual_seed(
            k + 1)) * 1e-3).tolist()
        self.n = sum(math.prod(s) for s in shapes)

    def state(self, mode):
        """Copies (at the case's offset) of what ``mode`` updates: [w],
        [w, m], [w, w32] or [w, m32, w32]."""
        parts = {"sgd": (self.w,), "sgd_mom": (self.w, self.m),
                 "mp_sgd": (self.w, self.w32),
                 "mp_sgd_mom": (self.w, self.m32, self.w32)}[mode]
        return [[_clone_at(t, self.offset) for t in part] for part in parts]


def sgd_args(mode, state, g, lrs, wds, rescale, clip, momentum=0.9):
    """The arguments of ``mode``'s wrapper (and plain version) over
    ``state`` (``SgdCase.state``)."""
    mom = (momentum,) if mode.endswith("mom") else ()
    return (state[0], g, *state[1:], lrs, wds, *mom, rescale, clip)


def check_sgd(case: SgdCase, mode: str, group: int, clip: float,
              rescale: float) -> dict:
    """``mode``'s kernel in groups of ``group`` against its plain version
    over the whole set: bit for bit, one launch per 64 tensors of each
    group, and on the mixed path every weight its master rounded."""
    kernel, plain = SGD_FNS[mode]
    ks, ps = case.state(mode), case.state(mode)
    before = kernel.launches
    groups = _groups(len(case.shapes), group)
    for idx in groups:
        kernel(*sgd_args(mode, [[part[i] for i in idx] for part in ks],
                         [case.g[i] for i in idx],
                         [case.lrs[i] for i in idx],
                         [case.wds[i] for i in idx], rescale, clip))
    launches = kernel.launches - before
    plain(*sgd_args(mode, ps, case.g, case.lrs, case.wds, rescale, clip))
    torch.cuda.synchronize()
    pairs = [(a, b) for ka, pa in zip(ks, ps) for a, b in zip(ka, pa)]
    bits = {2: torch.int16, 4: torch.int32}
    bitwise = all(torch.equal(a.view(bits[a.element_size()]),
                              b.view(bits[b.element_size()]))
                  for a, b in pairs)
    rounded = (not mode.startswith("mp")) or all(
        torch.equal(w, w32.to(w.dtype)) for w, w32 in zip(ks[0], ks[-1]))
    return {"kernel": mode, "dtype": _short(case.dtype), "group": group,
            "clip": clip, "rescale": rescale, "launches": launches,
            "expected_launches": sum(-(-len(i) // 64) for i in groups),
            "bitwise": bitwise, "weights_are_rounded_masters": rounded,
            "max_abs_err": max((a.float() - b.float()).abs().max().item()
                               for a, b in pairs)}


def time_lp_sgd(case: SgdCase, mode: str, iters: int) -> dict:
    """Times of one update over the whole set in the Trainer's groups of
    4 at the ResNet recipe's settings (lr 0.1, wd 1e-4, momentum 0.9,
    rescale 1/128): the kernel (device ms and CUDA-event wall ms), its
    plain version, ``torch.optim.SGD(fused=True)`` on the same dtype
    (plain modes; the mixed update has no one PyTorch call) and the
    bound."""
    kernel, plain = SGD_FNS[mode]
    state = case.state(mode)
    rescale = 1.0 / RESNET_BATCH
    k = len(case.shapes)
    lrs, wds = [0.1] * k, [1e-4] * k
    groups = _groups(k, AGG)

    def run():
        for idx in groups:
            kernel(*sgd_args(mode, [[part[i] for i in idx]
                                    for part in state],
                             [case.g[i] for i in idx], lrs[:len(idx)],
                             wds[:len(idx)], rescale, -1.0))

    before = kernel.launches
    row = {"wall_ms": cuda_ms(run, iters)}
    row["launches_per_update"] = (kernel.launches - before) / (iters + 3)
    row.update(ms=kernel_ms(run, 5, lost=1),
               plain_ms=kernel_ms(lambda: plain(*sgd_args(
                   mode, state, case.g, lrs, wds, rescale, -1.0)), 3,
                   lost=1))
    row["library_ms"] = None
    if not mode.startswith("mp"):
        params = [torch.nn.Parameter(t.clone()) for t in case.w]
        for p, g in zip(params, case.g):
            p.grad = g
        lib = torch.optim.SGD(params, lr=0.1, weight_decay=1e-4, fused=True,
                              momentum=0.9 if mode.endswith("mom") else 0.0)
        row["library_ms"] = kernel_ms(lib.step, 5, lost=1)
    nbytes = sgd_bytes(mode, case.w[0].element_size()) * case.n
    row.update(bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
               bytes=nbytes, elements=case.n, tensors=k,
               dtype=_short(case.dtype))
    return row


def time_unfused_mixed(case: SgdCase, iters: int) -> dict:
    """The mixed momentum update as ``multi_mp_sgd_mom_update`` ran it
    before the kernel had a mixed path: per group, each gradient cast to
    fp32, the fp32 momentum kernel on the masters, then each master
    copied into its weight; timed as ``time_lp_sgd``."""
    w, m32, w32 = case.state("mp_sgd_mom")
    rescale = 1.0 / RESNET_BATCH
    groups = _groups(len(case.shapes), AGG)

    def run():
        for idx in groups:
            multi_sgd_mom([w32[i] for i in idx],
                          [case.g[i].float() for i in idx],
                          [m32[i] for i in idx], [0.1] * len(idx),
                          [1e-4] * len(idx), 0.9, rescale)
            for i in idx:
                w[i].copy_(w32[i])

    kernels = {}
    return {"ms": kernel_ms(run, 5, kernels=kernels, lost=1),
            "wall_ms": cuda_ms(run, iters),
            "launches_per_update": sum(kernels.values()),
            "bytes_per_element": 6 + 20 + 6}


def sgd_kernel_phase(seed: int):
    """The multi-tensor SGD kernels against their plain versions on
    ResNet-50's and the MLP's trainable shapes and on odd, misaligned ones:
    fp32 (both forms), and bf16/fp16 in every mode (plain, momentum,
    mixed, mixed with momentum), bit for bit; their times at ResNet-50's
    and the MLP's shapes, and the unfused mixed route's."""
    gen = torch.Generator(device=gpu(0)).manual_seed(seed)
    shapes = resnet50_trainable_shapes()
    odd_shapes = [(1,), (3,), (7, 5), (1023,), (4097,), (8191,), (8193,),
                  (3, 33333)] * 9
    cases, checks = {}, []
    for dt in (torch.float32, *LP_DTYPES):
        cases[dt] = (
            (SgdCase(gen, shapes, dt), "resnet50", (AGG, 161), RESNET_BATCH),
            (SgdCase(gen, MLP_SHAPES, dt), "mlp", (AGG,), MLP_BATCH),
            (SgdCase(gen, odd_shapes, dt), "odd x72", (AGG, 72),
             RESNET_BATCH),
            (SgdCase(gen, odd_shapes, dt, offset=1), "odd x72 misaligned",
             (AGG, 72), RESNET_BATCH))
        checks += [check_sgd(case, mode, group, clip, 1.0 / batch)
                   | {"case": name}
                   for mode in SGD_MODES
                   if dt != torch.float32 or not mode.startswith("mp")
                   for case, name, groups, batch in cases[dt]
                   for group in groups for clip in (-1.0, 0.5)]
    bad = [c for c in checks if not (
        c["bitwise"] and c["weights_are_rounded_masters"]
        and c["launches"] == c["expected_launches"])]
    resnet, mlp = cases[torch.float32][0][0], cases[torch.float32][1][0]
    lp = {dt: cases[dt][0][0] for dt in LP_DTYPES}
    times = {"multi_sgd_mlp": time_sgd(mlp, False, iters=200),
             "multi_sgd_resnet50": time_sgd(resnet, False, iters=20),
             "multi_sgd_mom_resnet50": time_sgd(resnet, True, iters=20),
             "multi_sgd_bf16_mlp": time_lp_sgd(
                 cases[torch.bfloat16][1][0], "sgd", 200),
             "multi_sgd_mom_bf16_resnet50": time_lp_sgd(
                 lp[torch.bfloat16], "sgd_mom", 20),
             "multi_sgd_mom_fp16_resnet50": time_lp_sgd(
                 lp[torch.float16], "sgd_mom", 20),
             "multi_mp_sgd_mom_resnet50": time_lp_sgd(
                 lp[torch.bfloat16], "mp_sgd_mom", 20),
             "unfused_mixed_resnet50": time_unfused_mixed(
                 lp[torch.bfloat16], 20)}
    return {"checks": checks, "failed": bad, "times": times}


def mlp_phase(seed: int, dtype: str = "float32"):
    """Config #1: the 784-128-64-10 MLP trained by plain SGD on one seeded
    batch, its Dense layers (and so its input) in ``dtype``; the
    plain-SGD kernel must launch exactly twice per step (6 parameters in
    groups of 4), on weights of ``dtype``."""
    dev = gpu(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu", in_units=784, dtype=dtype),
            nn.Dense(64, activation="relu", in_units=128, dtype=dtype),
            nn.Dense(10, in_units=64, dtype=dtype))
    net.initialize(ctx=dev, seed=seed)
    net.hybridize()
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((MLP_BATCH, 784),
                                            dtype=np.float32), device=dev)
    x = x.to(getattr(torch, dtype))
    y = torch.as_tensor(rng.integers(0, 10, MLP_BATCH).astype(np.float32),
                        device=dev)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    for _ in range(MLP_STEPS):
        with autograd.record():
            loss = lossfn(net(x), y)
        autograd.backward(loss)
        trainer.step(MLP_BATCH)
        losses.append(loss.detach().float().mean())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = multi_sgd.launches
    other = other_launches(multi_sgd)
    losses = [v.item() for v in losses]
    dtypes = {_short(p._tensor().dtype) for p in net.collect_params().values()}
    graphs = graph_summary(net)
    free_graphs(net)
    return {"steps": MLP_STEPS, "batch": MLP_BATCH, "dtype": dtype,
            "launches": launches, "other_kernel_launches": other,
            "losses": losses, "step_ms": wall / MLP_STEPS * 1e3,
            "graphs": graphs,
            "ok": launches == 2 * MLP_STEPS and other == 0
            and losses[-1] < losses[0] and dtypes == {dtype}
            and all(math.isfinite(v) for v in losses)
            and graphs["entries"] == graphs["graphs"] == 1
            and graphs["replays"] == MLP_STEPS - 1
            and graphs["warm_calls"] == 1
            and graphs["deferred_calls"] == 0}


# the profiler ranges of a ResNet training step: each takes the kernels
# that ran inside it on the device (``_spans``)
RESNET_RANGES = {"batchnorm_stats": "batchnorm_stats",
                 "trainer_step": "update"}


def _spans(prof, names) -> list:
    """(start, end, name) on the device's clock of every ``record_function``
    range of ``names``: the CUDA-typed user annotation that spans the
    kernels launched inside the range, from any launcher (a ctypes launch
    has no CPU op for ``kernels`` to hang from)."""
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.is_user_annotation and e.name in names]


def range_kernels(prof, name: str) -> list:
    """Names of the kernels that started on the device inside a
    ``record_function`` range ``name`` (``_spans``)."""
    spans = [(s, t) for s, t, _ in _spans(prof, {name})]
    return [e.name for e in prof.events() if _is_kernel(e)
            and any(s <= e.time_range.start <= t for s, t in spans)]


# phase 18's finer classes, by a word of the kernel's name, tried first
FINE_CLASSES = (("recurrent", ("rnn", "lstm", "gru_")),
                ("pool", ("pool",)), ("concat", ("catarray",)),
                ("dropout", ("dropout", "bernoulli")))


def _device_classes(prof, wall_ms, ranges=RESNET_RANGES, fine=False):
    """Device time of one profiled step by kernel class (convolutions and
    GEMMs, BatchNorm, casts, cuDNN's NCHW/NHWC transposes, elementwise,
    the update, memcpy, other; with ``fine`` also ``FINE_CLASSES``; the
    kernels that ran inside a range of ``ranges`` in the class of the
    narrowest such range), and its idle share of the step's wall
    time."""
    classes = {"conv_gemm": 0.0, "batchnorm": 0.0, "batchnorm_stats": 0.0,
               "casts": 0.0, "layout": 0.0, "elementwise": 0.0,
               "update": 0.0, "memcpy": 0.0, "other": 0.0}
    classes.update(dict.fromkeys(ranges.values(), 0.0))
    if fine:
        classes.update(dict.fromkeys((c for c, _ in FINE_CLASSES), 0.0))

    def by_name(name):
        name = name.lower()
        if "multi_sgd" in name:
            return "update"
        if "memcpy" in name or "memset" in name:
            return "memcpy"
        for cls, words in FINE_CLASSES if fine else ():
            if any(w in name for w in words):
                return cls
        if "nchwtonhwc" in name or "nhwctonchw" in name:
            return "layout"
        if any(w in name for w in ("conv", "gemm", "xmma", "cutlass",
                                   "sm90", "implicit", "winograd",
                                   "fft", "wgrad", "dgrad", "fprop")):
            return "conv_gemm"
        if any(w in name for w in ("bn_", "batch_norm", "batchnorm")):
            return "batchnorm"
        if "copy_kernel" in name:
            return "casts"
        if any(w in name for w in ("elementwise", "reduce", "softmax",
                                   "foreach")):
            return "elementwise"
        return "other"

    top = []
    for e in prof.key_averages():
        if not _is_kernel(e):
            continue
        ms = e.self_device_time_total / 1e3
        classes[by_name(e.key)] += ms
        top.append((ms, e.key[:90], e.count))
    spans = _spans(prof, ranges)
    for e in prof.events():
        if not _is_kernel(e):
            continue
        inside = [(end - start, name) for start, end, name in spans
                  if start <= e.time_range.start <= end]
        if inside:
            ms = e.time_range.elapsed_us() / 1e3
            classes[by_name(e.name)] -= ms
            classes[ranges[min(inside)[1]]] += ms
    busy = sum(classes.values())
    top.sort(reverse=True)
    return {"wall_ms": wall_ms, "device_ms": classes,
            "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "top_kernels": [{"ms": t, "name": n, "calls": c}
                            for t, n, c in top[:12]]}


def _snapshot(net):
    return {k: p._tensor().detach().clone()
            for k, p in net.collect_params().items()}


def _max_diff(a, b):
    """Max-abs difference of two snapshots of one architecture, parameter
    by parameter in order (instance prefixes may differ)."""
    return max((x.float().cpu() - y.float().cpu()).abs().max().item()
               for x, y in zip(a.values(), b.values()))


def one_step(model, x, y, lossfn):
    """One Trainer step of ``model`` at the ResNet recipe; returns the
    loss (float64, on the CPU) and the updated parameters."""
    tr = gluon.Trainer(model.collect_params(), "sgd", RESNET_OPT)
    with autograd.record():
        loss = lossfn(model(x), y)
    autograd.backward(loss)
    tr.step(x.shape[0])
    return loss.detach().cpu().double(), _snapshot(model)


def leaf_check(run, cpu32, cpu64, init):
    """Each leaf's error against the float64 step, as a share of the
    leaf's change in that step (L2 norms): ``run``'s share must be at most
    ``LEAF_K`` times the CPU fp32 run's + ``LEAF_FLOOR``.  A fault in one
    leaf's gradient or statistics shows as a share near 1 in that leaf;
    fp32 rounding gives ~1e-6 where the step is well conditioned and up to
    the CPU's own share where it is not.  Snapshots are of one
    architecture, matched parameter by parameter in order; names from
    ``init``."""
    rows = []
    for name, r, c, ref, w0 in zip(init, run.values(), cpu32.values(),
                                   cpu64.values(), init.values()):
        ref = ref.double().cpu()
        change = (ref - w0.double().cpu()).norm().item()
        share = [(t.double().cpu() - ref).norm().item() / change
                 if change > 0 else math.inf for t in (r, c)]
        rows.append({"leaf": name, "run": share[0], "cpu": share[1],
                     "limit": LEAF_K * share[1] + LEAF_FLOOR})
    bad = [r for r in rows if not r["run"] <= r["limit"]]
    cpu_shares = sorted(r["cpu"] for r in rows)
    return {
        "ok": not bad, "leaves": len(rows), "failed": bad,
        "tight": sum(r["limit"] <= 10 * LEAF_FLOOR for r in rows),
        "cpu_share_median": cpu_shares[len(rows) // 2],
        "worst_cpu": sorted(rows, key=lambda r: -r["cpu"])[:6],
        "worst_margin": sorted(rows, key=lambda r: r["limit"]
                               - r["run"])[:6]}


def resnet_phase(seed: int, card: str):
    """Config #2: ResNet-50 v1 at batch 128 through gluon.Trainer."""
    from torch.profiler import ProfilerActivity, profile
    dev = gpu(0)
    net = resnet50_v1(classes=1000)
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    net.hybridize()
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(RESNET_BATCH, 3, 224, 224, device=dev, generator=gen)
    y = torch.randint(0, 1000, (RESNET_BATCH,), device=dev,
                      generator=gen).float()
    params = net.collect_params()
    w_init = _snapshot(net)
    trainer = gluon.Trainer(params, "sgd", RESNET_OPT)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(tr, xb, yb):
        with autograd.record():
            loss = lossfn(net(xb), yb)
        autograd.backward(loss)
        tr.step(xb.shape[0])
        return loss.detach().mean()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = [step(trainer, x, y) for _ in range(RESNET_WARM)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses += [step(trainer, x, y) for _ in range(RESNET_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = multi_sgd_mom.launches
    other = other_launches(multi_sgd_mom)
    steps = RESNET_WARM + RESNET_STEPS
    losses = [v.item() for v in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainable = [p for p in params.values() if p.grad_req != "null"]
    groups = -(-len(trainable) // AGG)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.monotonic()
        step(trainer, x, y)
        torch.cuda.synchronize()
        prof_wall_ms = (time.monotonic() - t1) * 1e3
    breakdown = _device_classes(prof, prof_wall_ms)

    # the aggregated update against the per-tensor one, from the same
    # weights and gradients
    w0 = _snapshot(net)
    with autograd.record():
        loss = lossfn(net(x), y)
    autograd.backward(loss)
    grads = {p.name: p._grad_tensor().clone() for p in trainable}
    results = []
    for agg in (AGG, 0):
        with torch.no_grad():
            for k, p in params.items():
                p._tensor().copy_(w0[k])
        for p in trainable:
            p._grad_tensor().copy_(grads[p.name])
            p.fresh = False
        tr = gluon.Trainer(params, "sgd", RESNET_OPT)
        tr.optimizer.aggregate_num = agg
        tr.step(RESNET_BATCH)
        results.append(_snapshot(net))
    torch.cuda.synchronize()
    agg_vs_per_tensor = _max_diff(*results)
    graphs = graph_summary(net)

    # one step at batch 2 from the initial weights on the card (replayed
    # from its captured graph: a warm call of the signature first), on the
    # CPU in fp32 and on the CPU in float64 (the arbiter)
    arrays = {k: v.cpu().numpy() for k, v in w_init.items()}
    xb, yb = x[:CPU_CHECK_BATCH], y[:CPU_CHECK_BATCH]
    warm_call(lambda: lossfn(net(xb), yb))
    load_reference_params(net, arrays, ctx=dev)
    replays = net.graph_stats()["replays"]
    after = {"card": one_step(net, xb, yb, lossfn)}
    check_replayed = net.graph_stats()["replays"] - replays
    free_graphs(net)
    for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        model = resnet50_v1(classes=1000)
        load_reference_params(model, arrays, ctx=cpu())
        after[name] = one_step(model.to(dtype), xb.cpu().to(dtype),
                               yb.cpu(), lossfn)
    cpu_loss_err = (after["card"][0] - after["cpu"][0]).abs().max().item()
    cpu_weight_err = _max_diff(after["card"][1], after["cpu"][1])
    leaves = leaf_check(after["card"][1], after["cpu"][1],
                        after["cpu64"][1], w_init)
    ok = (launches == groups * steps and other == 0
          and all(math.isfinite(v) for v in losses)
          and agg_vs_per_tensor <= SGD_TOL and cpu_loss_err <= 1e-4
          and leaves["ok"] and check_replayed == 1
          and graphs["entries"] == graphs["graphs"] == 1
          and graphs["replays"] == steps + 1 and graphs["warm_calls"] == 1
          and graphs["deferred_calls"] == 0)
    return {
        "card": card, "batch": RESNET_BATCH, "warm_steps": RESNET_WARM,
        "timed_steps": RESNET_STEPS, "trainable_params": len(trainable),
        "launches": launches, "launches_per_step": launches / steps,
        "other_kernel_launches": other,
        "expected_launches_per_step": groups, "losses": losses,
        "images_per_s": RESNET_BATCH * RESNET_STEPS / wall,
        "step_ms": wall / RESNET_STEPS * 1e3, "peak_memory_gb": peak_gb,
        "profile": breakdown,
        "aggregated_vs_per_tensor_max_abs": agg_vs_per_tensor,
        "cpu_check_batch": CPU_CHECK_BATCH,
        "cpu_check_loss_abs_err": cpu_loss_err,
        "cpu_check_weight_max_abs": cpu_weight_err,
        "cpu_check_leaves": leaves, "graphs": graphs,
        "cpu_check_step_replayed": check_replayed, "ok": ok}


def softmax_bound(n: int, c: int, backward: bool):
    """(bound_ms, bound_by) of one softmax kernel at (n, c) fp32: forward
    reads x and writes y (8 B/element) and does ~7 fp32 operations per
    element (max, 2 subtractions, 2 exps, a sum, a division); backward
    reads y and the labels and writes dx, 1 operation per element."""
    elems = n * c
    nbytes = 8 * elems + (4 * n if backward else 0)
    flops = (1 if backward else 7) * elems
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / CUDA_CORE_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def _refused(fn) -> bool:
    """True when ``fn`` raises MXNetError and launches no rtc kernel."""
    before = rtc.launches
    try:
        fn()
    except MXNetError:
        return rtc.launches == before
    return False


def host_us_per_launch(fn, n: int) -> float:
    """Host time of one call of ``fn`` (a launch, not synchronised),
    averaged over ``n`` calls after a synchronised warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return host


def check_softmax(gen, n: int, c: int, iters: int):
    """Both softmax kernels at (n, c) against their plain versions, and
    their times (CUDA events) beside the bound, the plain version and one
    library call each: ``torch.softmax`` for the forward, and for the
    backward ``torch.scatter_add(y, 1, index, -1)``, which computes
    y - onehot(label) from the (n, 1) label index and a column of -1 made
    beforehand."""
    dev = gpu(0)
    k = rtc_modules()
    x = torch.randn(n, c, device=dev, generator=gen) * 3.0
    label = torch.randint(0, c, (n,), device=dev, generator=gen).float()
    y = torch.empty_like(x)
    dx = torch.empty_like(x)
    grid, block = (n, 1, 1), (softmax_threads(c), 1, 1)

    def fwd():
        k["softmax_fwd"].launch([x, y, c, 1], dev, grid, block)

    def bwd():
        k["softmax_bwd"].launch([label, y, dx, c, 1], dev, grid, block)

    index = label.long().view(n, 1)
    minus_ones = torch.full((n, 1), -1.0, device=dev)

    def bwd_library():
        return torch.scatter_add(y, 1, index, minus_ones)

    fwd()
    bwd()
    torch.cuda.synchronize()
    y_ref = softmax_plain(x)
    fwd_err = (y - y_ref).abs().max().item()
    bwd_err = (dx - softmax_bwd_plain(y, label)).abs().max().item()
    rows = {}
    for name, err, fn, plain, lib, backward in (
            ("softmax_fwd", fwd_err, fwd, lambda: softmax_plain(x),
             lambda: torch.softmax(x, dim=1), False),
            ("softmax_bwd", bwd_err, bwd,
             lambda: softmax_bwd_plain(y, label), bwd_library, True)):
        bound_ms, bound_by = softmax_bound(n, c, backward)
        rows[name] = {
            "shape": [n, c], "max_abs_err": err,
            "library_max_abs_err": (lib() - plain()).abs().max().item(),
            "ms": cuda_ms(fn, iters), "plain_ms": cuda_ms(plain, iters),
            "library_ms": cuda_ms(lib, iters),
            "bound_ms": bound_ms, "bound_by": bound_by}
    return rows


def rtc_phase(seed: int):
    """The rtc path: compile the user modules (NVRTC, sm_90a), hold every
    kernel against its plain version, time the softmax kernels at the
    MLP's and BERT-base's MLM shapes, measure the host cost of a launch,
    launch with 100 KB of dynamic shared memory, and check the
    refusals."""
    dev = gpu(0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.monotonic()
    mods = rtc_modules()
    compile_s = time.monotonic() - t0
    compile_ms = {name: mods[name].compile_ms
                  for name in ("softmax", "elementwise", "axpy", "smem")}
    checks = {}

    # the JAX rtc tests' kernels, at their shapes
    xf = torch.arange(8, dtype=torch.float32, device=dev).reshape(2, 4)
    yf = torch.empty_like(xf)
    add_one = mods["elementwise"].get_kernel(
        "add_one", "const float *x, float *y, int n")
    add_one.launch([xf, yf, xf.numel()], dev, (1, 1, 1), (256, 1, 1))
    xi = torch.arange(6, dtype=torch.int32, device=dev).reshape(2, 3)
    yi = torch.empty_like(xi)
    twice = mods["elementwise"].get_kernel(
        "twice", "const int *x, int *y, int n")
    twice.launch([xi, yi, xi.numel()], dev, (1, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    checks["add_one"] = (yf - add_one_plain(xf)).abs().max().item()
    checks["twice_exact"] = bool(torch.equal(yi, twice_plain(xi))
                                 and yi.dtype == torch.int32)

    # a C++ template through exports; alpha * x + y may contract to an FMA
    # (one rounding fewer than the plain version): fp32 1e-6
    n = 1 << 20
    for dtype, name in ((torch.float32, "axpy<float>"),
                        (torch.float64, "axpy<double>")):
        ctype = "float" if dtype == torch.float32 else "double"
        k = mods["axpy"].get_kernel(
            name, f"const {ctype} *x, {ctype} *y, {ctype} alpha, int n")
        x = torch.randn(n, device=dev, generator=gen).to(dtype)
        y = torch.randn(n, device=dev, generator=gen).to(dtype)
        ref = axpy_plain(0.5, x, y)
        k.launch([x, y, 0.5, n], dev, (n // 256, 1, 1), (256, 1, 1))
        torch.cuda.synchronize()
        checks[name] = (y - ref).abs().max().item()

    # 100 KB of dynamic shared memory (needs cuFuncSetAttribute)
    smem = mods["smem"].get_kernel("smem_reverse",
                                   "const float *x, float *y, int n")
    xs = torch.randn(8 * SMEM_FLOATS, device=dev, generator=gen)
    ys = torch.empty_like(xs)
    smem.launch([xs, ys, SMEM_FLOATS], dev, (8, 1, 1), (1024, 1, 1),
                shared_mem=4 * SMEM_FLOATS)
    torch.cuda.synchronize()
    checks["smem_reverse_100KB_exact"] = bool(
        torch.equal(ys, smem_reverse_plain(xs, SMEM_FLOATS)))

    softmax = {f"{n}x{c}": check_softmax(gen, n, c, 200 if n < 1000 else 20)
               for n, c in SOFTMAX_SHAPES}
    checks["softmax_max_abs"] = max(r["max_abs_err"] for rows in
                                    softmax.values() for r in rows.values())

    # host cost of one launch, beside PR 2's ctypes SGD wrapper at the
    # MLP's shapes (one group of 4 tensors)
    sgd_w = [torch.zeros(s, device=dev) for s in MLP_SHAPES[:AGG]]
    sgd_g = [torch.zeros_like(w) for w in sgd_w]
    sx = torch.zeros(100, 10, device=dev)
    sy = torch.empty_like(sx)
    host = {
        "add_one": host_us_per_launch(lambda: add_one.launch(
            [xf, yf, xf.numel()], dev, (1, 1, 1), (256, 1, 1)), 2000),
        "softmax_fwd_100x10": host_us_per_launch(
            lambda: mods["softmax_fwd"].launch(
                [sx, sy, 10, 1], dev, (100, 1, 1), (32, 1, 1)), 2000),
        "multi_sgd_mlp_group": host_us_per_launch(lambda: multi_sgd(
            sgd_w, sgd_g, [0.0] * AGG, [0.0] * AGG), 2000)}

    # refusals: each raises MXNetError before any launch
    bad_src = 'extern "C" __global__ void broken(float* y) { y[0] = nope; }'
    log = ""
    try:
        rtc.CudaModule(bad_src)
    except MXNetError as e:
        log = str(e)
    refusals = {
        "wrong_dtype": _refused(lambda: add_one.launch(
            [xf.double(), yf, 8], dev, (1, 1, 1), (256, 1, 1))),
        "cpu_tensor": _refused(lambda: add_one.launch(
            [xf.cpu(), yf, 8], dev, (1, 1, 1), (256, 1, 1))),
        "cpu_ctx": _refused(lambda: add_one.launch(
            [xf, yf, 8], cpu(), (1, 1, 1), (256, 1, 1))),
        "unexported_cpp_name": _refused(lambda: mods["axpy"].get_kernel(
            "axpy", "const float *x, float *y, float alpha, int n")),
        "compile_error_log": "nope" in log and "error" in log}
    ok = (checks["add_one"] == 0.0 and checks["twice_exact"]
          and checks["axpy<float>"] <= 1e-6
          and checks["axpy<double>"] <= 1e-12
          and checks["smem_reverse_100KB_exact"]
          and checks["softmax_max_abs"] <= SOFTMAX_TOL
          and all(refusals.values()))
    return {"compile_ms": compile_ms, "compile_s_total": compile_s,
            "checks": checks, "softmax": softmax,
            "host_us_per_launch": host, "refusals": refusals,
            "compile_error_log": log[-400:], "ok": ok}


def synthetic_mnist(seed: int):
    """The ``--synthetic`` recipe of ``examples/train_mnist_mlp.py`` at
    784 features: class centres ``rand(10, 784)``, 0.1 noise, shifted by
    -0.5; ``CUSTOM_SAMPLES`` to train on and ``CUSTOM_HELD_OUT`` held
    out."""
    rng = np.random.RandomState(seed)
    total = CUSTOM_SAMPLES + CUSTOM_HELD_OUT
    temp = rng.rand(10, 784).astype(np.float32)
    y = rng.randint(0, 10, total)
    x = temp[y] + 0.1 * rng.randn(total, 784).astype(np.float32)
    x -= 0.5
    n = CUSTOM_SAMPLES
    return (x[:n], y[:n].astype(np.float32)), (x[n:], y[n:])


def mlp_net(dev, arrays=None, seed=0):
    """Config #1's MLP: Xavier() weights from ``seed``, or ``arrays``."""
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(128, activation="relu", in_units=784),
                nn.Dense(64, activation="relu", in_units=128),
                nn.Dense(10, in_units=64))
    if arrays is None:
        net.initialize(Xavier(), ctx=dev, seed=seed)
    else:
        load_reference_params(net, arrays, ctx=dev)
    return net


def custom_mlp_phase(seed: int):
    """Config #1's MLP trained with Adam, its softmax output layer the
    rtc ``softmax_rtc`` custom op, beside a twin run from the same weights
    with ``SoftmaxCrossEntropyLoss`` (the same gradient, softmax - onehot
    per sample)."""
    dev = gpu(0)
    (xtr, ytr), (xte, yte) = synthetic_mnist(seed)
    xs = torch.as_tensor(xtr, device=dev)
    ys = torch.as_tensor(ytr, device=dev)
    batches = [(xs[i:i + CUSTOM_BATCH], ys[i:i + CUSTOM_BATCH])
               for i in range(0, CUSTOM_SAMPLES, CUSTOM_BATCH)]
    steps = CUSTOM_EPOCHS * len(batches)
    init = {k: v.cpu().numpy()
            for k, v in _snapshot(mlp_net(dev, seed=seed)).items()}

    def grads(net):
        return [p._grad_tensor().detach().clone()
                for p in net.collect_params().values()]

    def run(custom: bool):
        net = mlp_net(dev, init)
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": CUSTOM_LR})
        lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
        acc = metric.Accuracy()
        losses, first = [], None
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(CUSTOM_EPOCHS):
            for x, y in batches:
                with autograd.record():
                    logits = net(x)
                    if custom:
                        out = nd.Custom(logits, y, op_type="softmax_rtc")
                    else:
                        out = lossfn(logits, y)
                autograd.backward(out)
                if first is None:
                    first = grads(net)
                trainer.step(CUSTOM_BATCH)
                with torch.no_grad():
                    if custom:
                        pick = out.gather(1, y.long()[:, None])
                        losses.append(-pick.log().mean())
                        acc.update([y], [out])
                    else:
                        losses.append(out.mean())
                        acc.update([y], [logits])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        with torch.no_grad():
            pred = net(torch.as_tensor(xte, device=dev)).argmax(1).cpu()
        held_out = float((pred.numpy() == yte).mean())
        return {"losses": [v.item() for v in losses], "first_grads": first,
                "train_accuracy": acc.get()[1], "held_out_accuracy": held_out,
                "step_ms": wall / steps * 1e3, "net": net,
                "trainer": trainer}

    def profile_step(net, trainer):
        """Device time of one custom-op step by kernel class, and its idle
        share of the step's wall time (torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile
        x, y = batches[0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with autograd.record():
                out = nd.Custom(net(x), y, op_type="softmax_rtc")
            autograd.backward(out)
            trainer.step(CUSTOM_BATCH)
            metric.Accuracy().update([y], [out])
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        classes = {"rtc_softmax": 0.0, "gemm": 0.0, "memcpy": 0.0,
                   "other": 0.0}
        for e in prof.key_averages():
            if not _is_kernel(e):
                continue
            name = e.key.lower()
            cls = ("rtc_softmax" if "softmax_fwd" in name
                   or "softmax_bwd" in name else
                   "memcpy" if "memcpy" in name or "memset" in name else
                   "gemm" if any(w in name for w in ("gemm", "cutlass",
                                                     "xmma", "sm90"))
                   else "other")
            classes[cls] += e.self_device_time_total / 1e3
        busy = sum(classes.values())
        return {"wall_ms": wall_ms, "device_ms": classes,
                "device_busy_ms": busy,
                "device_idle_share": max(0.0, 1.0 - busy / wall_ms)}

    zero_counts()
    custom = run(True)
    launches = {"softmax_fwd": _RTC["softmax_fwd"].launches,
                "softmax_bwd": _RTC["softmax_bwd"].launches}
    other = sum(w.launches for w in COUNTED)
    breakdown = profile_step(custom["net"], custom["trainer"])
    twin = run(False)
    grad_err = max((a - b).abs().max().item() for a, b in
                   zip(custom["first_grads"], twin["first_grads"]))
    # per-step losses within 1e-4 relative + 1e-6: -log(p) of an fp32
    # probability near 1 resolves only to ~6e-8, and the losses fall to
    # ~1e-5.  Adam turns a rounding-sized difference of a gradient near 0
    # into a step of +-lr (m / sqrt(v) ~ +-1), so the weights after the
    # first step are not held to 1e-6: the gradients of the first step are
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(custom["losses"], twin["losses"]))
    loss_ok = all(abs(a - b) <= 1e-4 * abs(b) + 1e-6 for a, b in
                  zip(custom["losses"], twin["losses"]))
    losses = custom["losses"]
    ok = (grad_err <= 1e-6 and loss_ok
          and launches == {"softmax_fwd": steps, "softmax_bwd": steps}
          and other == 0 and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0]
          and custom["held_out_accuracy"] > 0.5)
    for r in (custom, twin):
        for key in ("first_grads", "net", "trainer"):
            del r[key]
    return {"steps": steps, "batch": CUSTOM_BATCH, "launches": launches,
            "profile": breakdown,
            "other_kernel_launches": other,
            "first_step_grad_max_abs_vs_twin": grad_err,
            "loss_max_rel_vs_twin": loss_rel, "custom": custom,
            "twin": twin, "ok": ok}


# ----------------------------------------------------------------------
# BERT-base pretraining (config #3) through gluon.Trainer("adam"), in fp32
# and under contrib.amp's bf16 casts: bench_bert_base's recipe (bench.py
# :392-478) on one card.

def bert_batch(seed: int, batch: int, seq: int, vocab: int = VOCAB):
    """``bench_bert_base``'s synthetic batch (bench.py:453-463) from
    ``seed``: token ids, valid lengths in [seq/2, seq], 15 % of the valid
    positions masked (and position 0 of every row), no second segment.
    Returns numpy ``(inputs, segments, valid_lengths, labels, weights,
    nsp_labels)``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (batch, seq))
    valid_lens = rng.integers(seq // 2, seq + 1, (batch,))
    valid = np.arange(seq)[None, :] < valid_lens[:, None]
    mask_pos = (rng.random((batch, seq)) < 0.15) & valid
    mask_pos[:, 0] = True                # >= 1 masked position per row
    inputs = np.where(mask_pos, MASK_ID, tokens)
    segs = np.zeros((batch, seq), np.int64)
    nsp_y = rng.integers(0, 2, (batch,))
    return (inputs, segs, valid_lens.astype(np.float32), tokens,
            mask_pos.astype(np.float32), nsp_y)


def mlm_nsp_loss(mlm, nsp, labels, weights, nsp_y, F=nd):
    """The reference's pretraining loss (bench.py:440-449) from the ``nd``
    ops of ``F``: masked-LM cross-entropy over the weighted positions plus
    the NSP head's cross-entropy."""
    logp = F.log_softmax(mlm, axis=-1)
    ce = -F.pick(logp, labels, axis=-1)                  # (B, S)
    mlm_l = F.sum(ce * weights) / F.sum(weights)
    nsp_logp = F.log_softmax(nsp, axis=-1)
    return mlm_l - F.mean(F.pick(nsp_logp, nsp_y, axis=-1))


def bert_train_step(net, trainer, batch):
    """``autograd.record`` -> MLM + NSP loss -> ``autograd.backward`` ->
    ``trainer.step(1)`` (the loss is already a mean); returns the loss.
    The update runs in a profiler range named ``trainer_step``."""
    inputs, segs, vl, labels, weights, nsp_y = batch
    with autograd.record():
        mlm, nsp = net(inputs, segs, vl)
        loss = mlm_nsp_loss(mlm, nsp, labels, weights, nsp_y)
    autograd.backward(loss)
    with torch.profiler.record_function("trainer_step"):
        trainer.step(1)
    return loss.detach()


def bert_check_step(model, batch):
    """One Adam step of ``model`` from its current weights: the loss
    (float64, on the CPU), the gradients and the updated weights."""
    tr = gluon.Trainer(model.collect_params(), "adam", BERT_OPT)
    inputs, segs, vl, labels, weights, nsp_y = batch
    with autograd.record():
        loss = mlm_nsp_loss(*model(inputs, segs, vl), labels, weights, nsp_y)
    autograd.backward(loss)
    grads = {k: p._grad_tensor().detach().clone()
             for k, p in model.collect_params().items()}
    tr.step(1)
    return loss.detach().cpu().double(), grads, _snapshot(model)


# kernel classes of a BERT training step; the two profiler ranges
# (the flash backward's torch ops, the Adam update) take every kernel
# launched inside them, the rest go by kernel name
BERT_RANGES = {"flash_attention_backward": "flash_backward",
               "trainer_step": "adam"}


def _bert_kernel_class(name: str) -> str:
    name = name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_forward"
    if "memcpy" in name or "memset" in name:
        return "memcpy"
    if any(w in name for w in ("gemm", "cutlass", "xmma", "sm90", "nvjet",
                               "cublas")):
        return "gemm"
    if "layer_norm" in name or "layernorm" in name:
        return "layernorm"
    if "softmax" in name:
        return "log_softmax"
    return "other"


def _range_of(event):
    while event is not None:
        if event.name in BERT_RANGES:
            return BERT_RANGES[event.name]
        event = event.cpu_parent
    return None


BERT_CLASSES = ("gemm", "flash_forward", "flash_backward", "layernorm",
                "log_softmax", "adam", "memcpy", "other")


# the CUDA runtime and driver calls by which the host starts device work
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"}
GRAPH_LAUNCH = "cudaGraphLaunch"


def host_launches(prof) -> dict:
    """The launches the host issued in a profiled window: kernel, copy
    and memset launches, and CUDA-graph launches (each of which starts
    all of its graph's kernels); and the device ms of the multi-tensor
    kernels (``torch._foreach_copy_``'s: a replay's outputs and gradients
    copied out of the graph's buffers; the port's Adam and SGD launch
    none of these)."""
    names = [e.name for e in prof.events()]
    return {"host_launches": sum(n in LAUNCH_CALLS for n in names),
            "host_graph_launches": names.count(GRAPH_LAUNCH),
            "foreach_copy_ms": sum(
                e.self_device_time_total for e in prof.key_averages()
                if _is_kernel(e) and "multi_tensor_apply" in e.key) / 1e3}


def bert_step_classes(prof, wall_ms: float, n_params: int,
                      classify=_bert_kernel_class,
                      names=BERT_CLASSES) -> dict:
    """Device time of one profiled training step by class (GEMMs, flash
    forward, the flash backward's torch ops, LayerNorm, the log-softmax,
    Adam's elementwise kernels, memcpy, other), its idle share of the
    step's wall time, the Adam kernels per parameter, and how long each
    range spans on the device's timeline (its kernels and the gaps
    between them).  A kernel is put in a range's class through the CPU
    op that launched it."""
    classes = dict.fromkeys(names, 0.0)
    top, spans = [], {}
    for e in prof.key_averages():
        if _is_kernel(e):
            ms = e.self_device_time_total / 1e3
            classes[classify(e.key)] += ms
            top.append((ms, e.count, e.key[:100]))
        elif e.key in BERT_RANGES and e.is_user_annotation:
            spans[BERT_RANGES[e.key]] = e.self_device_time_total / 1e3
    ranged = {"flash_backward": 0, "adam": 0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        cls = _range_of(e)
        if cls is None:
            continue
        for k in e.kernels:
            ms = k.duration / 1e3
            classes[classify(k.name)] -= ms
            classes[cls] += ms
            ranged[cls] += 1
    busy = sum(classes.values())
    return {"wall_ms": wall_ms, "device_ms": classes,
            "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            **host_launches(prof),
            "kernels_in_ranges": ranged,
            "range_spans_ms": spans,
            "adam_kernels_per_param": ranged["adam"] / n_params,
            "top_kernels": [{"ms": ms, "calls": n, "name": name}
                            for ms, n, name in sorted(top, reverse=True)[:15]]}


def bert_run(net, batch, n_steps: int, timed: int = None) -> dict:
    """``n_steps`` Adam steps of ``net`` on one batch (``BERT_WARM`` warm,
    then ``timed`` (``BERT_STEPS``) timed, then the rest), the flash launches of
    them all, one profiled step after them, and the dtypes of every
    parameter and Adam state at the end."""
    from torch.profiler import ProfilerActivity, profile
    timed = BERT_STEPS if timed is None else timed
    params = net.collect_params()
    trainer = gluon.Trainer(params, "adam", BERT_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = [bert_train_step(net, trainer, batch)
              for _ in range(BERT_WARM)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses += [bert_train_step(net, trainer, batch)
               for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    losses += [bert_train_step(net, trainer, batch)
               for _ in range(n_steps - len(losses))]
    torch.cuda.synchronize()
    launches = flash_attention.launches
    by_dtype = {k.replace("torch.", ""): n
                for k, n in flash_attention.launches_by_dtype.items()}
    other = other_launches(flash_attention)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.monotonic()
        bert_train_step(net, trainer, batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.monotonic() - t1) * 1e3
    states = [t for st in trainer._states.values() for t in st]
    seqs = batch[0].shape[0]
    tokens = batch[0].numel()
    return {
        "steps": n_steps, "timed_steps": timed,
        "losses": [v.item() for v in losses],
        "step_ms": wall / timed * 1e3,
        "sequences_per_s": seqs * timed / wall,
        "tokens_per_s": tokens * timed / wall,
        "real_tokens_per_s": batch[2].sum().item() * timed / wall,
        "flash_launches": launches, "flash_launches_by_dtype": by_dtype,
        "other_kernel_launches": other, "peak_memory_gb": peak_gb,
        "profile": bert_step_classes(prof, prof_wall_ms, len(params)),
        "param_dtypes": sorted({_short(p._tensor().dtype)
                                for p in params.values()}),
        "adam_state_dtypes": sorted({_short(t.dtype) for t in states}),
        "adam_states": len(states)}


def bert_leaf_check(net, seed: int, keep: dict = None,
                    step=bert_check_step) -> dict:
    """One Adam step (or ``step``'s, phase 16's LAMB) at batch 2,
    sequence 128 from ``net``'s weights on
    the card, on the CPU in fp32 and on the CPU in float64 (the arbiter),
    held leaf by leaf (``leaf_check``, ResNet-50's bounds): the updated
    weights, and the gradients themselves (Adam's first step moves each
    weight by about ``lr * sign(g)``, which hides the size of a gradient's
    error).  ``keep`` takes the three steps and the card's batch for
    phase 14's replayed step."""
    w_init = _snapshot(net)
    arrays = {k: v.cpu().numpy() for k, v in w_init.items()}
    batch = bert_batch(seed + 1, *BERT_CHECK)
    card_batch = [torch.as_tensor(a, device=gpu(0)) for a in batch]
    after = {"card": step(net, card_batch)}
    for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        model = bert_base(dropout=0.0)
        load_reference_params(model, arrays, ctx=cpu())
        after[name] = step(model.to(dtype),
                           [torch.as_tensor(a) for a in batch])
        del model
    zeros = {k: torch.zeros_like(v) for k, v in w_init.items()}
    loss_err = (after["card"][0] - after["cpu"][0]).abs().item()
    weights = leaf_check(after["card"][2], after["cpu"][2],
                         after["cpu64"][2], w_init)
    grads = leaf_check(after["card"][1], after["cpu"][1],
                       after["cpu64"][1], zeros)
    load_reference_params(net, arrays, ctx=gpu(0))
    if keep is not None:
        keep.update(after=after, w_init=w_init, batch=card_batch)
    return {"batch": list(BERT_CHECK), "loss_abs_err_vs_cpu": loss_err,
            "loss_card": after["card"][0].item(),
            "loss_cpu64": after["cpu64"][0].item(),
            "weights": weights, "grads": grads,
            "ok": loss_err <= 1e-4 and weights["ok"] and grads["ok"]}


def flash_backward_bound(vl_bh, lq, lk, d, dtype):
    """(bound_ms, bound_by) of one flash-attention forward + backward:
    the six products of the two directions (S = QKᵀ, O = PV; dV = PᵀdO,
    dP = dO Vᵀ, dQ = dS K, dK = dSᵀQ), 12 * Lq * keys * D operations over
    the live keys, at the tensor cores' rate for ``dtype``; q, k, v and dO
    read once, O, dQ, dK, dV written once."""
    bh = vl_bh.numel()
    keys = torch.clamp(torch.ceil(vl_bh.float()), 0, lk).sum().item()
    flops = 12.0 * lq * keys * d
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * bh * (lq + lk) * d * itemsize + bh * 4
    t_ops, t_bytes = flops / TENSOR_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_flash_backward(gen, b, h, length, d, dtype, iters,
                         grad_tol=None, lk=None, lost=1):
    """The backward alone at (B, H, L, D) (queries ``length``, keys ``lk``,
    default ``length``): the kernel's output against the
    plain version's (max-abs <= TOL[dtype]) and q/k/v gradients through
    the kernel's Function against torch autograd through the plain version
    in fp32 on the same values (max-abs <= ``grad_tol``, default
    TOL[dtype], x max(1, max|g|)),
    device ms of forward + backward against the plain version's and
    ``scaled_dot_product_attention``'s with the same key mask, and the
    backward's peak memory beside one (B*H, Lq, Lk) fp32 matrix.  ``lost``
    is ``device_ms``'s allowance of lost records for the kernel's and the
    plain version's timings (at Lq=48, Lk=64 a trace of 20 forwards lost
    2 of its 20 kernel records, one of 3 plain forward + backward calls 2
    of an elementwise kernel's 24).  The forward alone launches the
    kernel once a call, so its timing needs no allowance: it takes the
    records that arrive (``device_ms``'s ``per_call``)."""
    dev = gpu(0)
    bh = b * h
    lk = lk or length
    q, k, v, dout = (torch.randn(bh, n, d, generator=gen).to(dev, dtype)
                     for n in (length, lk, lk, length))
    vl = torch.randint(lk // 2, lk + 1, (b,), generator=gen) \
        .float().to(dev)
    vl_bh = vl.repeat_interleave(h)
    scale = 1.0 / math.sqrt(d)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = flash_attention(q, k, v, vl)
    grads = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    ref_out = flash_attention_plain(*ref_leaves, vl_bh, False, scale)
    ref = torch.autograd.grad(ref_out, ref_leaves, dout.float())
    fwd_err = (out.detach().float() - ref_out.detach()).abs().max().item()
    err = max((g.float() - r).abs().max().item()
              for g, r in zip(grads, ref))
    ref_max = max(r.abs().max().item() for r in ref)
    tol = (grad_tol or TOL[dtype]) * max(1.0, ref_max)
    del out, ref_out

    out = flash_attention(q, k, v, vl)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out

    mask = (torch.arange(lk, device=dev)[None, :]
            < vl[:, None])[:, None, None, :]
    sdpa_leaves = [t.detach().view(b, h, -1, d).requires_grad_()
                   for t in (q, k, v)]
    dout4 = dout.view(b, h, length, d)

    def ours():
        return torch.autograd.grad(flash_attention(q, k, v, vl), leaves,
                                   dout)

    def plain():
        return torch.autograd.grad(
            flash_attention_plain(*ref_leaves, vl_bh, False, scale),
            ref_leaves, dout.float())

    def library():
        return torch.autograd.grad(F.scaled_dot_product_attention(
            *sdpa_leaves, attn_mask=mask, scale=scale), sdpa_leaves, dout4)

    def forward():
        with torch.no_grad():
            return flash_attention(q, k, v, vl)

    bound_ms, bound_by = flash_backward_bound(vl_bh, length, lk, d, dtype)
    launches = {"ours": {}, "library": {}}
    fwd_bwd_ms = kernel_ms(ours, iters, kernels=launches["ours"],
                           lost=lost)
    # on an H100, traces taken after phases that replayed CUDA graphs
    # lost 2 of these 20 records (bf16, L=512) and 4 (fp32, Lq=48)
    fwd_ms = kernel_ms(forward, iters, only="flash_fwd_kernel", per_call=1)
    return {
        "case": f"B={b} H={h} L={length} D={d} {_short(dtype)}"
                if lk == length else
                f"B={b} H={h} Lq={length} Lk={lk} D={d} {_short(dtype)}",
        "max_abs_err": err, "tolerance": tol, "ref_max_abs": ref_max,
        "forward_max_abs_err": fwd_err, "forward_tolerance": TOL[dtype],
        "ok": err <= tol and fwd_err <= TOL[dtype],
        "fwd_bwd_ms": fwd_bwd_ms, "fwd_ms": fwd_ms,
        "bwd_ms": fwd_bwd_ms - fwd_ms,
        "plain_fwd_bwd_ms": kernel_ms(plain, 3, lost=lost),
        # SDPA's cuDNN backward: a trace of 20 fp16 calls read one
        # elementwise kernel 2 records short in 3 traces running
        "library_fwd_bwd_ms": kernel_ms(library, iters,
                                        kernels=launches["library"],
                                        lost=2),
        "launches_per_call": launches,
        "wall_fwd_bwd_ms": cuda_ms(ours, iters),
        "library_wall_fwd_bwd_ms": cuda_ms(library, iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bwd_peak_memory_mb": peak / 1e6,
        "full_matrix_mb": bh * length * lk * 4 / 1e6}


def bert_train_phase(seed: int, card: str) -> dict:
    """Config #3: BERT-base (12 layers, 768 wide, 12 heads, FFN 3072,
    vocab 30522, ``dropout=0.0``, weights from ``seed``) pretrained with
    the MLM + NSP loss through ``gluon.Trainer("adam", lr 1e-4)`` at batch
    8, sequence 256: (a) fp32 with the leaf check, (b) under
    ``amp.init("bfloat16")`` from the same weights, (c) the flash backward
    alone."""
    dev = gpu(0)
    batch = [torch.as_tensor(a, device=dev)
             for a in bert_batch(seed, BERT_BATCH, BERT_SEQ)]
    runs = {}
    try:
        for mode in ("fp32", "amp_bf16"):
            if mode == "amp_bf16":
                amp.init("bfloat16")
            net = bert_base(dropout=0.0)
            net.initialize(ctx=dev, seed=seed)
            check = bert_leaf_check(net, seed, CHECK_STEPS.setdefault(
                "bert", {})) if mode == "fp32" else None
            runs[mode] = bert_run(net, batch, BERT_WARM + BERT_STEPS
                                  if mode == "fp32" else BERT_AMP_STEPS)
            runs[mode]["leaf_check"] = check
            print(f"bert-base training {mode} on {card}:",
                  json.dumps(runs[mode]), flush=True)
            del net
            torch.cuda.empty_cache()
    finally:
        amp.disable()
    gen = torch.Generator().manual_seed(seed)
    backward = []
    for length in (256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            backward.append(check_flash_backward(gen, 8, HEADS, length,
                                                 HEAD_DIM, dtype, 20))
            print("flash backward", json.dumps(backward[-1]), flush=True)
    fp32, bf16 = runs["fp32"], runs["amp_bf16"]
    per_step = LAYERS                       # the backward launches none
    first_rel = abs(bf16["losses"][0] - fp32["losses"][0]) \
        / abs(fp32["losses"][0])
    checks = {
        "leaf_check": fp32["leaf_check"]["ok"],
        "fp32_launches": fp32["flash_launches"] == per_step * fp32["steps"]
        and fp32["flash_launches_by_dtype"]["float32"]
        == fp32["flash_launches"],
        "amp_launches_bf16": bf16["flash_launches"]
        == per_step * bf16["steps"]
        and bf16["flash_launches_by_dtype"]["bfloat16"]
        == bf16["flash_launches"],
        "no_other_kernel": fp32["other_kernel_launches"] == 0
        and bf16["other_kernel_launches"] == 0,
        "finite_losses": all(math.isfinite(v) for r in (fp32, bf16)
                             for v in r["losses"]),
        "amp_loss_falls": bf16["losses"][-1] < bf16["losses"][0],
        "amp_first_loss_vs_fp32": first_rel <= BERT_AMP_LOSS_RTOL,
        "fp32_weights_and_states": all(
            r["param_dtypes"] == ["float32"]
            and r["adam_state_dtypes"] == ["float32"]
            for r in (fp32, bf16)),
        "flash_backward": all(r["ok"] for r in backward)}
    return {"card": card, "batch": BERT_BATCH, "seq": BERT_SEQ,
            "lr": BERT_OPT["learning_rate"], "fp32": fp32, "amp_bf16": bf16,
            "amp_first_loss_rel_vs_fp32": first_rel,
            "flash_launches_per_step": per_step, "backward": backward,
            "checks": checks, "ok": all(checks.values())}


# ----------------------------------------------------------------------
# Phase 10: low precision as the JAX package runs it.  ResNet-50 v1 in
# bf16 (amp.init, and Block.cast with fp32 masters through the mixed-path
# kernel), BERT-base under amp.init("float16") with dynamic loss scaling
# (the flash kernel's fp16 path), the MLP with bf16 weights (the plain SGD
# kernel in bf16).

def masters_mismatched(trainer) -> list:
    """Names of the parameters whose weight is not its fp32 master
    rounded to the weight's dtype, bit for bit (multi-precision states:
    ``(momentum, master)``)."""
    bits = {torch.bfloat16: torch.int16, torch.float16: torch.int16}
    bad = []
    for i, p in enumerate(trainer._params):
        w, w32 = p._tensor(), trainer._states[i][1]
        if not torch.equal(w.view(bits[w.dtype]),
                           w32.to(w.dtype).view(bits[w.dtype])):
            bad.append(p.name)
    return bad


def update_range_check(prof, kernel: str, expected: int) -> dict:
    """The kernels launched inside the ``trainer_step`` range: exactly
    ``expected`` launches of ``kernel`` and nothing else (a per-tensor
    cast or copy there fails it)."""
    names = range_kernels(prof, "trainer_step")
    ours = sum(kernel in n for n in names)
    others = sorted({n[:90] for n in names if kernel not in n})
    return {"kernel_launches": ours, "expected": expected,
            "other_kernels": others,
            "ok": ours == expected and not others}


def resnet_lp_run(seed: int, recipe: str, fp32_losses: list) -> dict:
    """ResNet-50 v1 at batch 128 from phase 6's weights and batch, SGD lr
    0.1, momentum 0.9, wd 1e-4 through ``gluon.Trainer``, 3 warm and 10
    timed steps, in one of the JAX package's two bf16 recipes: ``amp``,
    ``amp.init("bfloat16")`` (fp32 weights, the momentum kernel in fp32),
    or ``cast``, ``net.cast("bfloat16")`` and a bf16 batch with
    ``multi_precision`` (fp32 masters, the mixed-path kernel).  Each step
    ends in a synchronise (the step time is the mean of the timed steps'
    own times); after each ``cast`` step every weight must be its master
    rounded.  The losses are held against phase 6's fp32 run
    (``fp32_losses``, the same weights and batch): the first within
    ``RESNET_AMP_LOSS_RTOL``, the first ``RESNET_TRACKED`` within it too,
    and the loss must fall below the first within the warm steps.  (At
    lr 0.1 on one batch the loss of every recipe, fp32 included, climbs
    again from step 4 and the runs part ways there: whether the 13th loss
    ends below the first is chance.)  One profiled step gives the device
    time by class and the kernels of the ``trainer_step`` range."""
    from torch.profiler import ProfilerActivity, profile
    dev = gpu(0)
    if recipe == "amp":
        amp.init("bfloat16")
    try:
        net = resnet50_v1(classes=1000)
        net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
        net.hybridize()
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(RESNET_BATCH, 3, 224, 224, device=dev, generator=gen)
        y = torch.randint(0, 1000, (RESNET_BATCH,), device=dev,
                          generator=gen).float()
        opt = dict(RESNET_OPT)
        if recipe == "cast":
            net.cast("bfloat16")
            x = x.bfloat16()
            opt["multi_precision"] = True
        params = net.collect_params()
        trainer = gluon.Trainer(params, "sgd", opt)
        lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
        counter = multi_mp_sgd_mom if recipe == "cast" else multi_sgd_mom
        groups = -(-len(trainer._params) // AGG)

        def step():
            with autograd.record():
                loss = lossfn(net(x), y)
            autograd.backward(loss)
            with torch.profiler.record_function("trainer_step"):
                trainer.step(x.shape[0])
            return loss.detach().float().mean()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses, times, mismatched = [], [], []
        for _ in range(RESNET_WARM + RESNET_STEPS):
            t0 = time.monotonic()
            losses.append(step())
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            if recipe == "cast":
                mismatched.append(masters_mismatched(trainer))
        steps = RESNET_WARM + RESNET_STEPS
        launches, other = counter.launches, other_launches(counter)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.monotonic()
            step()
            torch.cuda.synchronize()
            prof_wall_ms = (time.monotonic() - t1) * 1e3
        update = update_range_check(prof, "multi_sgd_kernel", groups)
        states = [t for st in trainer._states.values()
                  for t in (st if isinstance(st, tuple) else (st,))]
        param_dtypes = sorted({_short(p._tensor().dtype)
                               for p in params.values()})
        graphs = graph_summary(net)
        free_graphs(net)
    finally:
        amp.disable()
    losses = [v.item() for v in losses]
    step_s = sum(times[RESNET_WARM:]) / RESNET_STEPS
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, fp32_losses)]
    first_rel = rel[0]
    checks = {
        "finite_losses": all(math.isfinite(v) for v in losses),
        "losses_fall": min(losses[1:RESNET_WARM + 1]) < losses[0],
        "tracks_fp32": max(rel[:RESNET_TRACKED]) <= RESNET_AMP_LOSS_RTOL,
        "launches": launches == groups * steps and other == 0,
        "graphs": graphs["entries"] == graphs["graphs"] == 1
        and graphs["replays"] == steps and graphs["warm_calls"] == 1
        and graphs["deferred_calls"] == 0,
        "update_range": update["ok"],
        "state_dtypes": {_short(t.dtype) for t in states} == {"float32"}}
    checks["first_loss_vs_fp32"] = first_rel <= RESNET_AMP_LOSS_RTOL
    if recipe == "amp":
        checks["param_dtypes"] = param_dtypes == ["float32"]
    else:
        checks["weights_are_rounded_masters"] = not any(mismatched)
        checks["param_dtypes"] = param_dtypes == ["bfloat16"]
    del net, trainer
    torch.cuda.empty_cache()
    return {"recipe": recipe, "batch": RESNET_BATCH, "steps": steps,
            "timed_steps": RESNET_STEPS, "losses": losses,
            "first_loss_rel_vs_fp32": first_rel,
            "loss_rel_vs_fp32": rel, "step_ms": step_s * 1e3,
            "images_per_s": RESNET_BATCH / step_s,
            "peak_memory_gb": peak_gb, "kernel": counter.__name__,
            "launches": launches, "launches_per_step": launches / steps,
            "expected_launches_per_step": groups,
            "other_kernel_launches": other, "update_range": update,
            "mismatched_masters_per_step": [len(m) for m in mismatched],
            "param_dtypes": param_dtypes, "graphs": graphs,
            "profile": _device_classes(prof, prof_wall_ms),
            "checks": checks, "ok": all(checks.values())}


def bert_fp16_run(seed: int, fp32_first_loss: float) -> dict:
    """BERT-base pretraining (phase 9's weights, batch and recipe) under
    ``amp.init("float16")`` for ``BERT_FP16_STEPS`` steps, with
    ``amp.init_trainer``'s ``DynamicLossScaler`` (2**16):
    ``amp.scale_loss`` -> ``autograd.backward`` -> ``amp.unscale``, which
    skips a step whose gradients overflowed and halves the scale, else
    ``trainer.step(1)``.  Times steps ``BERT_WARM`` to ``BERT_WARM +
    BERT_STEPS``; profiles one more step."""
    from torch.profiler import ProfilerActivity, profile
    dev = gpu(0)
    batch = [torch.as_tensor(a, device=dev)
             for a in bert_batch(seed, BERT_BATCH, BERT_SEQ)]
    inputs, segs, vl, labels, weights, nsp_y = batch
    amp.init("float16")
    try:
        net = bert_base(dropout=0.0)
        net.initialize(ctx=dev, seed=seed)
        params = net.collect_params()
        trainer = amp.init_trainer(gluon.Trainer(params, "adam", BERT_OPT))
        first_scale = trainer._amp_loss_scaler.loss_scale

        def step():
            with autograd.record():
                loss = mlm_nsp_loss(*net(inputs, segs, vl), labels, weights,
                                    nsp_y)
            with amp.scale_loss(loss, trainer) as scaled:
                autograd.backward(scaled)
            skip = amp.unscale(trainer)
            if not skip:
                with torch.profiler.record_function("trainer_step"):
                    trainer.step(1)
            return loss.detach(), skip

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses, skipped, scales, t0, wall = [], [], [], 0.0, 0.0
        for i in range(BERT_FP16_STEPS):
            if i == BERT_WARM:
                torch.cuda.synchronize()
                t0 = time.monotonic()
            scales.append(trainer._amp_loss_scaler.loss_scale)
            loss, skip = step()
            losses.append(loss)
            skipped.append(skip)
            if i == BERT_WARM + BERT_STEPS - 1:
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = flash_attention.launches
        by_dtype = {k.replace("torch.", ""): n
                    for k, n in flash_attention.launches_by_dtype.items()}
        other = other_launches(flash_attention)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.monotonic()
            step()
            torch.cuda.synchronize()
            prof_wall_ms = (time.monotonic() - t1) * 1e3
        states = [t for st in trainer._states.values() for t in st]
        param_dtypes = sorted({_short(p._tensor().dtype)
                               for p in params.values()})
    finally:
        amp.disable()
    losses = [v.item() for v in losses]
    applied = [v for v, s in zip(losses, skipped) if not s]
    first_rel = abs(applied[0] - fp32_first_loss) / abs(fp32_first_loss) \
        if applied else math.inf
    checks = {
        "applied_steps": len(applied) >= BERT_FP16_MIN_APPLIED,
        "finite_applied_losses": all(math.isfinite(v) for v in applied),
        "applied_losses_fall": len(applied) > 1 and applied[-1] < applied[0],
        "first_applied_loss_vs_fp32": first_rel <= BERT_AMP_LOSS_RTOL,
        "flash_launches_fp16": launches == LAYERS * BERT_FP16_STEPS
        and by_dtype["float16"] == launches,
        "no_other_kernel": other == 0,
        "initial_scale": first_scale == 2.0 ** 16,
        "fp32_weights_and_states": param_dtypes == ["float32"]
        and {_short(t.dtype) for t in states} == {"float32"}}
    del net, trainer
    torch.cuda.empty_cache()
    return {"steps": BERT_FP16_STEPS, "losses": losses,
            "skipped_steps": [i for i, s in enumerate(skipped) if s],
            "loss_scales": scales, "applied_steps": len(applied),
            "first_applied_loss_rel_vs_fp32": first_rel,
            "step_ms": wall / BERT_STEPS * 1e3,
            "sequences_per_s": BERT_BATCH * BERT_STEPS / wall,
            "flash_launches": launches, "flash_launches_by_dtype": by_dtype,
            "other_kernel_launches": other, "peak_memory_gb": peak_gb,
            "profile": bert_step_classes(prof, prof_wall_ms, len(params)),
            "param_dtypes": param_dtypes, "checks": checks,
            "ok": all(checks.values())}


def low_precision_phase(seed: int, card: str, resnet: dict,
                        bert: dict) -> dict:
    """Phase 10: (a) ResNet-50 under ``amp.init("bfloat16")``, (b) after
    ``cast("bfloat16")`` with ``multi_precision``, both against phase 6's
    first fp32 loss; (c) BERT-base under ``amp.init("float16")`` against
    phase 9's, and the flash backward alone on fp16 inputs; (e) the MLP
    with bf16 weights (the plain SGD kernel in bf16)."""
    runs = {}
    for recipe in ("amp", "cast"):
        runs[f"resnet50_{recipe}"] = resnet_lp_run(seed, recipe,
                                                   resnet["losses"])
        print(f"resnet50 {recipe} bf16 on {card}:",
              json.dumps(runs[f"resnet50_{recipe}"]), flush=True)
    runs["bert_fp16"] = bert_fp16_run(seed, bert["fp32"]["losses"][0])
    print(f"bert-base fp16 amp on {card}:", json.dumps(runs["bert_fp16"]),
          flush=True)
    gen = torch.Generator().manual_seed(seed + 10)
    backward = [check_flash_backward(gen, 8, HEADS, length, HEAD_DIM,
                                     torch.float16, 20, FP16_BACKWARD_TOL)
                for length in (256, 512)]
    for r in backward:
        print("flash backward", json.dumps(r), flush=True)
    runs["mlp_bf16"] = mlp_phase(seed, "bfloat16")
    print(f"mlp bf16 on {card}:", json.dumps(runs["mlp_bf16"]), flush=True)
    checks = {name: r["ok"] for name, r in runs.items()}
    checks["flash_backward_fp16"] = all(r["ok"] for r in backward)
    return {"card": card, **runs, "backward": backward, "checks": checks,
            "ok": all(checks.values())}


# ----------------------------------------------------------------------
# Phase 11: config #1 written in nd ops on NDArrays (the imperative
# surface), as the verify recipe writes it, and the Gluon loop of
# examples/train_mnist_mlp.py spelled against the port.

IMPERATIVE_STEPS, IMPERATIVE_LR, IMPERATIVE_WD = 20, 0.1, 1e-4
IMPERATIVE_GLUON_STEPS = 10
FC_HOST_CALLS = 500                    # calls timed for the host cost
SOFTMAX_OUTPUT_TOL = 1e-5


def imperative_init(seed: int):
    """The MLP's weights (He normal) and zero biases, and one batch of 64,
    drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    arrays = [(rng.standard_normal(s) * math.sqrt(2.0 / s[1])).astype(
        np.float32) if len(s) == 2 else np.zeros(s, np.float32)
        for s in MLP_SHAPES]
    x = rng.standard_normal((MLP_BATCH, 784), dtype=np.float32)
    y = rng.integers(0, 10, MLP_BATCH).astype(np.float32)
    return arrays, x, y


def imperative_logits(x, params):
    w0, b0, w1, b1, w2, b2 = params
    h = nd.Activation(nd.FullyConnected(x, w0, b0, num_hidden=128),
                      act_type="relu")
    h = nd.Activation(nd.FullyConnected(h, w1, b1, num_hidden=64),
                      act_type="relu")
    return nd.FullyConnected(h, w2, b2, num_hidden=10)


def imperative_loss(x, y, params):
    return -nd.mean(nd.pick(nd.log_softmax(imperative_logits(x, params)), y,
                            axis=-1))


class ImperativeMLP:
    """The MLP's state as NDArrays on ``ctx``: weights with
    ``attach_grad()``, zero momenta, the batch and the ``lrs``/``wds``
    arrays of the multi-tensor update."""

    def __init__(self, seed: int, ctx, dtype: str = "float32"):
        arrays, x, y = imperative_init(seed)
        with ctx:
            self.params = [nd.array(a, dtype=dtype) for a in arrays]
            for p in self.params:
                p.attach_grad()
            self.moms = [nd.zeros(a.shape, dtype=dtype) for a in arrays]
            self.x = nd.array(x, dtype=dtype)
            self.y = nd.array(y)
            self.lrs = nd.array(np.full(len(arrays), IMPERATIVE_LR))
            self.wds = nd.array([IMPERATIVE_WD if a.ndim == 2 else 0.0
                                 for a in arrays])

    def step(self):
        """Record the loss, backward, and one ``multi_sgd_mom_update`` over
        the 6 parameters into the weights (``out=``)."""
        with autograd.record():
            loss = imperative_loss(self.x, self.y, self.params)
        loss.backward()
        self.update()
        return loss

    def update(self):
        nd.multi_sgd_mom_update(
            *[t for p, m in zip(self.params, self.moms)
              for t in (p, p.grad, m)],
            self.lrs, self.wds, momentum=0.9,
            num_weights=len(self.params), out=self.params)

    def snapshot(self):
        return {f"param{i}": p._data.detach().clone()
                for i, p in enumerate(self.params)}


def imperative_breakdown(mlp: ImperativeMLP, n: int = 10) -> dict:
    """Where an imperative step's time goes: the host time of its three
    parts (the recorded forward and the backward are the host's enqueue;
    the update includes the two host reads of ``lrs``/``wds``, each of
    which waits for the device), mean over ``n`` steps without a
    synchronise inside; then one profiled step: device ms by kernel class
    and the idle share of its wall time."""
    from torch.profiler import ProfilerActivity, profile
    parts = {"forward": 0.0, "backward": 0.0, "update": 0.0}
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for _ in range(n):
        t0 = time.perf_counter()
        with autograd.record():
            loss = imperative_loss(mlp.x, mlp.y, mlp.params)
        t1 = time.perf_counter()
        loss.backward()
        t2 = time.perf_counter()
        mlp.update()
        t3 = time.perf_counter()
        parts["forward"] += (t1 - t0) * 1e3 / n
        parts["backward"] += (t2 - t1) * 1e3 / n
        parts["update"] += (t3 - t2) * 1e3 / n
    torch.cuda.synchronize()
    wall_all = (time.perf_counter() - t_all) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mlp.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    classes = {"gemm": 0.0, "update": 0.0, "memcpy": 0.0, "other": 0.0}
    kernels = 0
    for e in prof.key_averages():
        if not _is_kernel(e):
            continue
        name = e.key.lower()
        cls = ("update" if "multi_sgd" in name else
               "memcpy" if "memcpy" in name or "memset" in name else
               "gemm" if any(w in name for w in ("gemm", "cutlass", "xmma",
                                                 "sm90")) else "other")
        classes[cls] += e.self_device_time_total / 1e3
        kernels += e.count
    busy = sum(classes.values())
    return {"host_ms": parts, "step_ms": wall_all,
            "profiled_wall_ms": wall_ms, "device_ms": classes,
            "device_busy_ms": busy, "device_records": kernels,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms)}


def softmax_output_check(seed: int):
    """One batch's gradients through ``nd.SoftmaxOutput(z, y,
    normalization="batch")`` against those through log-softmax + pick +
    mean, on the card."""
    grads = []
    for head in ("softmax_output", "log_softmax"):
        mlp = ImperativeMLP(seed, gpu(0))
        with autograd.record():
            if head == "softmax_output":
                out = nd.SoftmaxOutput(imperative_logits(mlp.x, mlp.params),
                                       mlp.y, normalization="batch")
            else:
                out = imperative_loss(mlp.x, mlp.y, mlp.params)
        out.backward()
        grads.append([p.grad._data.clone() for p in mlp.params])
    return max((a - b).abs().max().item() for a, b in zip(*grads))


def host_us(fn, n: int) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls (the card's
    queue absorbs the launches; synchronised before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def imperative_gluon_loop(seed: int):
    """``examples/train_mnist_mlp.py``'s loop against the port (shapes
    given: deferred shape inference is not ported): ``nd.array`` inputs on
    the default context, ``net(x)`` an NDArray, ``L.backward()``,
    ``trainer.step``, ``metric.update`` and the held-out forward through
    ``.asnumpy()``, inside ``with gpu(0):`` (the default context, as
    the example leaves it)."""
    with gpu(0):
        return _imperative_gluon_loop(seed)


def _imperative_gluon_loop(seed: int):
    (xtr, ytr), (xte, yte) = synthetic_mnist(seed)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(128, activation="relu", in_units=784),
                nn.Dense(64, activation="relu", in_units=128),
                nn.Dense(10, in_units=64))
    net.initialize(mx_init.Xavier(), seed=seed)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": CUSTOM_LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    losses, types = [], set()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in range(IMPERATIVE_GLUON_STEPS):
        lo = i * CUSTOM_BATCH
        x = nd.array(xtr[lo:lo + CUSTOM_BATCH])
        y = nd.array(ytr[lo:lo + CUSTOM_BATCH])
        with autograd.record():
            out = net(x)
            L = loss_fn(out, y)
        L.backward()
        trainer.step(x.shape[0])
        acc.update([y], [out])
        losses.append(L.mean())
        types.add((type(out).__name__, type(L).__name__))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    held = float(np.mean(np.argmax(net(nd.array(xte)).asnumpy(), 1) == yte))
    losses = [v.asscalar() for v in losses]
    return {"steps": IMPERATIVE_GLUON_STEPS, "batch": CUSTOM_BATCH,
            "losses": losses, "train_accuracy": acc.get()[1],
            "held_out_accuracy": held,
            "step_ms": wall / IMPERATIVE_GLUON_STEPS * 1e3,
            "types": sorted(types),
            "ok": types == {("NDArray", "NDArray")}
            and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0] and 0.0 <= held <= 1.0}


def imperative_phase(seed: int):
    """Config #1 at full width (784-128-64-10, batch 64) through
    NDArrays and the nd registry: 20 steps of record -> FullyConnected /
    Activation / log_softmax / pick / mean -> ``L.backward()`` -> one
    ``nd.multi_sgd_mom_update`` (the momentum kernel, one launch a step
    for the 6 tensors); the first step against the CPU in fp32 and
    float64 (``leaf_check``); SoftmaxOutput's gradients against the
    log-softmax path; the Gluon loop of the example; the host cost of one
    op through the registry; the engine's waits and host reads a step."""
    import torch.nn.functional as F_

    eng = mx_engine.engine()
    # one step from the initial weights: the card against the CPU
    steps = {}
    for name, ctx, dtype in (("run", gpu(0), "float32"),
                             ("cpu32", cpu(), "float32"),
                             ("cpu64", cpu(), "float64")):
        mlp = ImperativeMLP(seed, ctx, dtype)
        if name == "run":
            init = mlp.snapshot()
        first_loss = mlp.step().asscalar()
        steps[name] = (first_loss, mlp.snapshot())
    leaf = leaf_check(steps["run"][1], steps["cpu32"][1], steps["cpu64"][1],
                      init)
    loss_err = abs(steps["run"][0] - steps["cpu64"][0])

    # the main path: 20 steps, counts set to 0 just before
    mlp = ImperativeMLP(seed, gpu(0))
    torch.cuda.synchronize()
    eng.reset_stats()
    zero_counts()
    t0 = time.monotonic()
    losses = [mlp.step() for _ in range(IMPERATIVE_STEPS)]
    nd.waitall()
    wall = time.monotonic() - t0
    launches = multi_sgd_mom.launches
    other = other_launches(multi_sgd_mom)
    stats = eng.stats()
    losses = [v.asscalar() for v in losses]

    breakdown = imperative_breakdown(mlp)
    so_err = softmax_output_check(seed)
    zero_counts()
    gluon_loop = imperative_gluon_loop(seed)
    gluon_other = other_launches()

    # the registry's host cost for one op on NDArrays, against F.linear on
    # the same tensors
    x, w, b = mlp.x, mlp.params[0], mlp.params[1]
    with torch.no_grad():
        fc_us = host_us(lambda: nd.FullyConnected(x, w, b, num_hidden=128),
                        FC_HOST_CALLS)
        linear_us = host_us(lambda: F_.linear(x._data, w._data, b._data),
                            FC_HOST_CALLS)
    ok = (launches == IMPERATIVE_STEPS and other == 0 and leaf["ok"]
          and loss_err <= 1e-4 and so_err <= SOFTMAX_OUTPUT_TOL
          and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0] and gluon_loop["ok"]
          and gluon_other == 0)
    return {"steps": IMPERATIVE_STEPS, "batch": MLP_BATCH,
            "launches": launches, "launches_per_step":
                launches / IMPERATIVE_STEPS,
            "other_kernel_launches": other, "losses": losses,
            "step_ms": wall / IMPERATIVE_STEPS * 1e3,
            "waits_per_step": (stats["waits"] - 1) / IMPERATIVE_STEPS,
            "waitall_after_loop": 1,
            "host_reads_per_step": stats["host_reads"] / IMPERATIVE_STEPS,
            "leaf_check": {"loss_abs_err_vs_cpu64": loss_err,
                           **{k: leaf[k] for k in (
                               "ok", "leaves", "failed", "cpu_share_median",
                               "worst_margin")}},
            "softmax_output_grad_max_abs_vs_log_softmax": so_err,
            "breakdown": breakdown,
            "gluon_loop": gluon_loop,
            "gluon_other_kernel_launches": gluon_other,
            "host_us": {"nd_fully_connected": fc_us, "f_linear": linear_us,
                        "registry_overhead": fc_us - linear_us},
            "ok": ok}


# ----------------------------------------------------------------------
# Phase 12: config #4 (BASELINE.json:10, Sockeye's Transformer NMT and
# the Symbol bucketing executor).  (a) transformer_nmt_base trained
# through gluon.Trainer as bench_nmt runs it (bench.py:484-531), (b)
# ``translate`` as examples/translate_nmt.py calls it, (c) the LSTM
# language model of examples/train_char_lm_bucketing.py through
# BucketingModule.fit, at the widths of the upstream example its
# docstring names (example/rnn/bucketing/lstm_bucketing.py).

NMT_VOCAB, NMT_MAXLEN, NMT_LAYERS, NMT_HEADS = 32000, 128, 6, 8
NMT_BATCH, NMT_BUCKETS = 16, (32, 48, 64)
NMT_WARM, NMT_PASSES = 2, 8
NMT_OPT = {"learning_rate": 1e-4}
NMT_CHECK = (2, 16)                   # the leaf check's batch, sequence
NMT_CLASSES = ("gemm", "flash_forward", "flash_backward", "layernorm",
               "masked_softmax", "log_softmax_ce", "adam", "memcpy",
               "other")
TRANSLATE_SRC, TRANSLATE_TOL = 32, 1e-4
TRANSLATE_RUNS = (("greedy", 8, 1), ("beam", 4, 3))   # rows, beam size
BOS, EOS = 1, 2
LM_VOCAB, LM_EMB, LM_HIDDEN, LM_LAYERS = 10000, 200, 200, 2
LM_BATCH, LM_BUCKETS = 32, (10, 20, 30, 40, 50, 60)
LM_OPT = {"learning_rate": 0.01, "wd": 1e-5}
LM_SENTENCES = 7680                   # ~240 batches of 32
LM_WINDOW = 20                        # batches per perplexity reading
LM_TIMED = 5                          # timed steps per bucket


def nmt_data(seed: int, batch: int, buckets, vocab: int) -> dict:
    """``bench_nmt``'s batches (bench.py:506-512) from ``seed``: per
    bucket length, source, target and label ids in [1, vocab), float32
    (the bench's ``nd.array``), on the CPU."""
    rng = np.random.default_rng(seed)
    return {s: tuple(torch.as_tensor(rng.integers(1, vocab, (batch, s)),
                                     dtype=torch.float32)
                     for _ in range(3)) for s in buckets}


def nmt_loss(net, src, tgt, lab):
    """``bench_nmt``'s loss: the mean over the batch of
    ``SoftmaxCrossEntropyLoss`` of the logits."""
    return nd.mean(gluon.loss.SoftmaxCrossEntropyLoss()(net(src, tgt), lab))


def nmt_step(net, trainer, src, tgt, lab):
    """One ``bench_nmt`` step: record, the loss, ``autograd.backward``,
    ``trainer.step(batch)`` (in a ``trainer_step`` profiler range);
    returns the loss."""
    with autograd.record():
        loss = nmt_loss(net, src, tgt, lab)
    autograd.backward(loss)
    with torch.profiler.record_function("trainer_step"):
        trainer.step(src.shape[0])
    return loss.detach()


def _nmt_kernel_class(name: str) -> str:
    low = name.lower()
    if "logsoftmax" in low or "gather" in low or "nll" in low:
        return "log_softmax_ce"
    if "softmax" in low:
        return "masked_softmax"
    return _bert_kernel_class(name)


def nmt_param_count(net) -> int:
    return sum(math.prod(p.shape) for p in net.collect_params().values())


def nmt_check_step(model, batch):
    """One Adam step of ``model`` from its weights at the bench's recipe:
    the loss (float64, on the CPU), the gradients, the updated weights."""
    tr = gluon.Trainer(model.collect_params(), "adam", NMT_OPT)
    src, tgt, lab = batch
    with autograd.record():
        loss = nmt_loss(model, src, tgt, lab)
    autograd.backward(loss)
    grads = {k: p._grad_tensor().detach().clone()
             for k, p in model.collect_params().items()}
    tr.step(src.shape[0])
    return loss.detach().cpu().double(), grads, _snapshot(model)


class Decisions(torch.overrides.TorchFunctionMode):
    """While open, every ReLU of the forward (``F.relu``, ``torch.relu``,
    ``Tensor.relu``) records which units it passes, one mask a call in
    call order, or, given ``masks``, passes those units and no others
    (``z * mask``: the same piecewise-linear function, its gradient the
    mask) and counts the units where its own decision (``z > 0``) differs
    (``flips``).

    A unit whose pre-activation sits within rounding of 0 can fall either
    way in two fp32 runs, and one such unit moves every gradient upstream
    of it (one of the NMT base model's 786,432 at its check's shape put
    ten leaves 1.4e-3 to 5.3e-3 of their norm from float64 on an H100,
    where the CPU fp32 run sat at 1e-6).  Holding the CPU runs to the
    card's decisions keeps a leaf check about the arithmetic; ``flips``
    reports how many decisions were the card's own."""

    RELUS = (F.relu, torch.relu, torch.Tensor.relu)

    def __init__(self, masks=None):
        super().__init__()
        self._forced = masks
        self.masks = []
        self.flips = self.units = self._calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self.RELUS:
            return func(*args, **kwargs)
        z = args[0]
        own = z > 0
        self.units += own.numel()
        if self._forced is None:
            self.masks.append(own)
            return func(*args, **kwargs)
        mask = self._forced[self._calls].to(z.device)
        self._calls += 1
        self.flips += int((own != mask).sum())
        return z * mask.to(z.dtype)


def nmt_leaf_check(net, seed: int, build, keep: dict = None) -> dict:
    """One Adam step at batch 2, length 16 from ``net``'s weights on the
    card, on the CPU in fp32 and in float64, held leaf by leaf
    (``leaf_check``) on the updated weights and on the gradients; the
    card's loss within 1e-4 of the CPU's.  The CPU runs take the card's
    ReLU decisions (``Decisions``); the units where float64 would
    have decided otherwise must be at most 1e-4 of them.  ``net``'s
    weights are put back after.  ``keep`` takes the three steps and the
    card's batch for phase 14's replayed step."""
    w_init = _snapshot(net)
    arrays = {k: v.cpu().numpy() for k, v in w_init.items()}
    batch = nmt_data(seed + 1, NMT_CHECK[0], (NMT_CHECK[1],),
                     NMT_VOCAB)[NMT_CHECK[1]]
    with Decisions() as card:
        after = {"card": nmt_check_step(net,
                                        [t.to(gpu(0)) for t in batch])}
    flips = {}
    for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        model = build()
        load_reference_params(model, arrays, ctx=cpu())
        with Decisions(card.masks) as forced:
            after[name] = nmt_check_step(model.to(dtype),
                                         [t.to(dtype) for t in batch])
        flips[name] = forced.flips
        del model
    zeros = {k: torch.zeros_like(v) for k, v in w_init.items()}
    loss_err = (after["card"][0] - after["cpu"][0]).abs().item()
    weights = leaf_check(after["card"][2], after["cpu"][2],
                         after["cpu64"][2], w_init)
    grads = leaf_check(after["card"][1], after["cpu"][1],
                       after["cpu64"][1], zeros)
    load_reference_params(net, arrays, ctx=gpu(0))
    if keep is not None:
        keep.update(after=after, w_init=w_init,
                    batch=[t.to(gpu(0)) for t in batch])
    return {"batch": list(NMT_CHECK), "loss_abs_err_vs_cpu": loss_err,
            "loss_card": after["card"][0].item(),
            "loss_cpu64": after["cpu64"][0].item(),
            "relu_units": card.units, "relu_flips": flips,
            "weights": weights, "grads": grads,
            "ok": loss_err <= 1e-4 and weights["ok"] and grads["ok"]
            and flips["cpu64"] <= 1e-4 * card.units}


def nmt_train_run(net, seed: int, passes: int = None) -> dict:
    """The bench's schedule: one first step per bucket, ``NMT_WARM`` warm
    passes, then ``passes`` (``NMT_PASSES``) timed passes over the buckets, each
    ending in a synchronise (each step's device-clock span taken by CUDA
    events); the flash launches of every step; one profiled step at the
    longest bucket."""
    from torch.profiler import ProfilerActivity, profile
    passes = NMT_PASSES if passes is None else passes
    dev = gpu(0)
    data = {s: [t.to(dev) for t in b] for s, b in
            nmt_data(seed, NMT_BATCH, NMT_BUCKETS, NMT_VOCAB).items()}
    params = net.collect_params()
    trainer = gluon.Trainer(params, "adam", NMT_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    first = [nmt_step(net, trainer, *data[s]) for s in NMT_BUCKETS]
    for _ in range(NMT_WARM):
        for s in NMT_BUCKETS:
            nmt_step(net, trainer, *data[s])
    torch.cuda.synchronize()
    spans = {s: [] for s in NMT_BUCKETS}
    losses = []
    t0 = time.monotonic()
    for _ in range(passes):
        marks = []
        for s in NMT_BUCKETS:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            losses.append(nmt_step(net, trainer, *data[s]))
            e1.record()
            marks.append((s, e0, e1))
        torch.cuda.synchronize()
        for s, e0, e1 in marks:
            spans[s].append(e0.elapsed_time(e1))
    wall = time.monotonic() - t0
    steps = len(NMT_BUCKETS) * (1 + NMT_WARM + passes)
    launches = flash_attention.launches
    other = other_launches(flash_attention)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.monotonic()
        nmt_step(net, trainer, *data[NMT_BUCKETS[-1]])
        torch.cuda.synchronize()
        prof_wall_ms = (time.monotonic() - t1) * 1e3
    tokens = passes * NMT_BATCH * sum(NMT_BUCKETS)
    return {
        "steps": steps, "timed_passes": passes,
        "first_losses": [v.item() for v in first],
        "losses": [v.item() for v in losses],
        "tokens_per_s": tokens / wall,
        "pass_ms": wall / passes * 1e3,
        "step_ms": {str(s): sum(v) / len(v) for s, v in spans.items()},
        "flash_launches": launches, "flash_launches_per_step":
            launches / steps,
        "other_kernel_launches": other, "peak_memory_gb": peak_gb,
        "profile": bert_step_classes(prof, prof_wall_ms, len(params),
                                     _nmt_kernel_class, NMT_CLASSES)}


class DecoderCalls:
    """Counts (and with ``record``, keeps) ``net``'s decoder calls of one
    ``translate`` while open: each call's prefix on the host, the source
    row its memory starts at, and the log-probabilities the card read
    back."""

    def __init__(self, net, record: bool = False):
        self._net = net
        self._record = record
        self.calls = 0
        self.records = []

    def __enter__(self):
        step = type(self._net)._step_logp

        def counted(tgt, mem, src_mask):
            logp = step(self._net, tgt, mem, src_mask)
            self.calls += 1
            if self._record:
                row = mem.storage_offset() // (mem.shape[1] * mem.shape[2])
                self.records.append((tgt.detach().cpu(), row,
                                     mem.shape[0], logp))
            return logp
        self._net._step_logp = counted
        return self

    def __exit__(self, *exc):
        del self._net._step_logp


def translate_flash_launches(layers: int, decoder_calls: int) -> int:
    """The flash launches of one ``translate``: the encoder's
    self-attention once, the decoder's cross-attention once a call (its
    causal self-attention takes the masked softmax)."""
    return layers * (1 + decoder_calls)


def teacher_forcing(cpu_net, src, records, beam: int, tol: float) -> dict:
    """Replays the card's decoder calls on ``cpu_net`` (the same weights
    on the CPU): each call's prefix against the CPU encoder's memory of
    the same source rows, the last position's log-probabilities against
    the card's (max-abs), and the tokens the card chose (greedy: its
    argmax; beam: its top ``beam``) each within ``tol`` of the CPU's best
    (greedy) or ``beam``-th best."""
    with torch.no_grad():
        mem = cpu_net.encode(torch.as_tensor(src, dtype=torch.float32))
        err, worst_choice, bad = 0.0, 0.0, 0
        for tgt, row, rows, logp_card in records:
            m = mem[row:row + rows]
            dec = cpu_net.decoder(
                cpu_net.word_embed(tgt) * math.sqrt(cpu_net._units), m)
            logp = torch.log_softmax(cpu_net.out_proj(dec[:, -1]),
                                     dim=-1).numpy()
            err = max(err, float(np.abs(logp - logp_card).max()))
            chosen = np.argsort(logp_card, axis=-1)[:, -beam:]
            kth = np.sort(logp, axis=-1)[:, -beam][:, None]
            short = kth - np.take_along_axis(logp, chosen, axis=-1)
            worst_choice = max(worst_choice, float(short.max()))
            bad += int((short > tol).sum())
    return {"calls": len(records), "logp_max_abs_err": err,
            "choice_max_shortfall": worst_choice, "bad_choices": bad,
            "ok": err <= tol and bad == 0}


def translate_run(net, cpu_net, seed: int) -> dict:
    """``translate`` as examples/translate_nmt.py calls it, greedy on 8
    rows and beam 3 on 4, ``max_len`` = source length + 3: a timed run
    (the flash launches exact, the host reads one per decoder call), a
    recorded run that must decode the same, and its teacher-forcing
    replay on the CPU."""
    eng = mx_engine.engine()
    rng = np.random.default_rng(seed + 2)
    src = rng.integers(3, NMT_VOCAB, (TRANSLATE_RUNS[0][1], TRANSLATE_SRC))
    max_len = TRANSLATE_SRC + 3
    net.translate(nd.array(src[:1], ctx=gpu(0)), BOS, EOS, max_len=2)
    out = {}
    for mode, rows, beam in TRANSLATE_RUNS:
        x = nd.array(src[:rows], ctx=gpu(0))
        torch.cuda.synchronize()
        eng.reset_stats()
        zero_counts()
        with DecoderCalls(net) as calls:
            t0 = time.monotonic()
            toks, scores = net.translate(x, BOS, EOS, max_len=max_len,
                                         beam_size=beam)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        launches = flash_attention.launches
        other = other_launches(flash_attention)
        reads = eng.stats()["host_reads"]
        with DecoderCalls(net, record=True) as rec:
            again = net.translate(x, BOS, EOS, max_len=max_len,
                                  beam_size=beam)
        n_tokens = max(1, sum(len(t) for t in toks))
        tf = teacher_forcing(cpu_net, src[:rows], rec.records, beam,
                             TRANSLATE_TOL)
        expected = translate_flash_launches(NMT_LAYERS, calls.calls)
        out[mode] = {
            "rows": rows, "beam": beam, "max_len": max_len,
            "decoder_calls": calls.calls, "flash_launches": launches,
            "flash_launches_expected": expected,
            "other_kernel_launches": other, "host_reads": reads,
            "output_tokens": n_tokens, "wall_ms": wall * 1e3,
            "ms_per_token": wall * 1e3 / n_tokens,
            "ms_per_decoder_call": wall * 1e3 / calls.calls,
            "scores": scores, "same_on_rerun": again == (toks, scores),
            "teacher_forcing": tf,
            "ok": launches == expected and other == 0
            and reads == calls.calls and again == (toks, scores)
            and tf["ok"] and all(math.isfinite(v) for v in scores)}
    return out


def nmt_phase(seed: int, card: str) -> dict:
    """Config #4's model: ``transformer_nmt_base(vocab 32000, max_length
    128)`` (6 + 6 layers, 512 wide, FFN 2048, 8 heads, the output tied to
    the embedding), weights from ``seed``, fp32 with TF32 off: the leaf
    check, ``bench_nmt``'s training run, then ``translate``."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        transformer_nmt_base

    def build():
        return transformer_nmt_base(vocab_size=NMT_VOCAB,
                                    max_length=NMT_MAXLEN)
    net = build()
    net.initialize(ctx=gpu(0), seed=seed)
    n_params = nmt_param_count(net)
    check = nmt_leaf_check(net, seed, build,
                           CHECK_STEPS.setdefault("nmt", {}))
    arrays = {k: v.cpu().numpy() for k, v in _snapshot(net).items()}
    train = nmt_train_run(net, seed)
    print(f"nmt training on {card}:", json.dumps(train), flush=True)
    # translate from the initial weights, on the card and on the CPU
    load_reference_params(net, arrays, ctx=gpu(0))
    cpu_net = build()
    load_reference_params(cpu_net, arrays, ctx=cpu())
    trans = translate_run(net, cpu_net, seed)
    del net, cpu_net
    torch.cuda.empty_cache()
    steps = train["steps"]
    checks = {
        "leaf_check": check["ok"],
        "flash_launches": train["flash_launches"]
        == 2 * NMT_LAYERS * steps,
        "no_other_kernel": train["other_kernel_launches"] == 0,
        "finite_losses": all(math.isfinite(v) for v in
                             train["first_losses"] + train["losses"]),
        "param_count": n_params == NMT_VOCAB * 512 + 2 * NMT_MAXLEN * 512
        + NMT_LAYERS * (3152384 + 4204032),
        "translate_greedy": trans["greedy"]["ok"],
        "translate_beam": trans["beam"]["ok"]}
    return {"card": card, "params": n_params, "batch": NMT_BATCH,
            "buckets": list(NMT_BUCKETS), "leaf_check": check,
            "train": train, "translate": trans, "checks": checks,
            "ok": all(checks.values())}


def lm_sentences(seed: int, n: int) -> list:
    """``n`` id sentences from ``seed``: lengths uniform in [2, 60] (the
    buckets' span), tokens from a Zipf law (exponent 1.1) over ids 1 ..
    9999 of a 10,000-word vocabulary (PTB's size; id 0 pads)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, LM_BUCKETS[-1] + 1, n)
    p = 1.0 / np.arange(1, LM_VOCAB) ** 1.1
    tokens = rng.choice(np.arange(1, LM_VOCAB), size=int(lengths.sum()),
                        p=p / p.sum())
    return [t.tolist() for t in np.split(tokens, np.cumsum(lengths)[:-1])]


def lm_sym_gen(seq_len):
    """examples/train_char_lm_bucketing.py's ``sym_gen`` at the upstream
    widths: Embedding(10000, 200), two LSTMCell(200) unrolled to the
    bucket's length, FullyConnected to the vocabulary, SoftmaxOutput."""
    data, label = mx_sym.var("data"), mx_sym.var("softmax_label")
    embed = mx_sym.Embedding(data, input_dim=LM_VOCAB, output_dim=LM_EMB,
                             name="embed")
    stack = mx_rnn.SequentialRNNCell()
    for i in range(LM_LAYERS):
        stack.add(mx_rnn.LSTMCell(LM_HIDDEN, prefix=f"lstm_l{i}_"))
    outputs, _ = stack.unroll(seq_len, embed, layout="NTC",
                              merge_outputs=True)
    pred = mx_sym.reshape(outputs, shape=(-1, LM_HIDDEN))
    pred = mx_sym.FullyConnected(pred, num_hidden=LM_VOCAB, name="pred")
    label = mx_sym.reshape(label, shape=(-1,))
    pred = mx_sym.SoftmaxOutput(pred, label, name="softmax")
    return pred, ("data",), ("softmax_label",)


def lm_iter(seed: int, n: int):
    random.seed(seed)
    np.random.seed(seed)
    return mx_rnn.BucketSentenceIter(lm_sentences(seed, n), LM_BATCH,
                                     buckets=list(LM_BUCKETS),
                                     invalid_label=0)


def unshared_parameters(bmod) -> list:
    """(bucket, name) of every parameter or gradient array of a bucket's
    module that is not the master module's tensor."""
    master = bmod.buckets[bmod.default_bucket_key]
    bad = []
    for key, m in bmod.buckets.items():
        for n in master._param_names:
            for mine, theirs in ((m._arg_params[n], master._arg_params[n]),
                                 (m._grad_params[n],
                                  master._grad_params[n])):
                if mine._data.data_ptr() != theirs._data.data_ptr():
                    bad.append((key, n))
    return bad


def module_to(mod, dtype) -> None:
    """Every array of a Module's executor, or of every bucket's of a
    BucketingModule (the buckets share theirs, so each moves once), in
    ``dtype``."""
    seen = set()
    for m in getattr(mod, "buckets", {None: mod}).values():
        exe = m._exec_group.execs[0]
        for arr in exe.arg_arrays + exe.grad_arrays + exe.aux_arrays:
            if arr is not None and id(arr) not in seen:
                seen.add(id(arr))
                arr._data = arr._data.to(dtype)


def lm_module(ctx, key: int):
    bmod = mx_mod.BucketingModule(lm_sym_gen, default_bucket_key=key,
                                  context=ctx)
    shape = (LM_BATCH, key)
    bmod.bind([("data", shape)], [("softmax_label", shape)])
    return bmod


def lm_check_step(ctx, dtype, arg_params, batch):
    """One ``forward_backward`` + ``update`` of a fresh module on ``ctx``
    in ``dtype`` from ``arg_params``: (gradients, updated weights), by
    parameter name, on the CPU."""
    bmod = lm_module(ctx, batch.bucket_key)
    bmod.init_params(arg_params=arg_params)
    module_to(bmod, dtype)
    bmod.init_optimizer(optimizer="sgd", optimizer_params=dict(LM_OPT))
    bmod.forward_backward(batch)
    m = bmod.buckets[batch.bucket_key]
    grads = {n: g._data.detach().cpu().clone()
             for n, g in m._grad_params.items()}
    bmod.update()
    return grads, {n: a._data.detach().cpu().clone()
                   for n, a in m._arg_params.items()}


def lm_leaf_check(seed: int) -> dict:
    """One SGD step at the longest bucket from the same initial weights on
    the card, on the CPU in fp32 and in float64, held leaf by leaf
    (``leaf_check``) on the gradients and the updated weights."""
    mx_random.seed(seed)
    init = lm_module(gpu(0), LM_BUCKETS[-1])
    init.init_params()
    arg, _ = init.get_params()
    batch = next(b for b in lm_iter(seed + 1, 1500)
                 if b.bucket_key == LM_BUCKETS[-1])
    runs = {name: lm_check_step(ctx, dtype, arg, batch)
            for name, ctx, dtype in (("card", gpu(0), torch.float32),
                                     ("cpu", cpu(), torch.float32),
                                     ("cpu64", cpu(), torch.float64))}
    w0 = {n: arg[n]._data for n in runs["card"][1]}
    zeros = {n: torch.zeros_like(t) for n, t in w0.items()}
    grads = leaf_check(runs["card"][0], runs["cpu"][0], runs["cpu64"][0],
                       zeros)
    weights = leaf_check(runs["card"][1], runs["cpu"][1], runs["cpu64"][1],
                         w0)
    return {"bucket": LM_BUCKETS[-1], "grads": grads, "weights": weights,
            "ok": grads["ok"] and weights["ok"]}


def device_busy_ms(prof) -> float:
    return sum(e.self_device_time_total for e in prof.key_averages()
               if _is_kernel(e)) / 1e3


def lm_phase(seed: int, card: str, out_dir: Path) -> dict:
    """Config #4's executor: ``BucketingModule.fit`` of the LSTM language
    model over ``BucketSentenceIter`` (batch 32, buckets 10..60), SGD at
    lr 0.01, wd 1e-5, ``Perplexity(invalid_label=0)`` as the example
    passes it; the buckets' parameter sharing, the leaf check, the
    checkpoint round trip, step ms per bucket and the host's share of a
    step; the trained parameters under ``"trained"`` (``arg``, ``aux``),
    which phase 19 converts."""
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    it = lm_iter(seed, LM_SENTENCES)
    mx_random.seed(seed)
    bmod = mx_mod.BucketingModule(lm_sym_gen,
                                  default_bucket_key=it.default_bucket_key,
                                  context=gpu(0))
    metric_ = metric.Perplexity(invalid_label=0)
    readings, speed = [], mx_callback.Speedometer(LM_BATCH, LM_WINDOW)

    def read(param):
        if param.nbatch and param.nbatch % LM_WINDOW == 0:
            readings.append(param.eval_metric.get()[1])
    n_batches = len(it.idx)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    bmod.fit(it, num_epoch=1, eval_metric=metric_, optimizer="sgd",
             optimizer_params=dict(LM_OPT),
             batch_end_callback=[read, speed])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = other_launches()
    unshared = unshared_parameters(bmod)
    # step ms per bucket, and one profiled step at the longest
    it.reset()
    by_key = {}
    for b in it:
        by_key.setdefault(b.bucket_key, b)
    step_ms, graph_ops = {}, {}
    for key, b in sorted(by_key.items()):
        bmod.forward_backward(b)
        bmod.update()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for _ in range(LM_TIMED):
            bmod.forward_backward(b)
            bmod.update()
        torch.cuda.synchronize()
        step_ms[str(key)] = (time.monotonic() - t1) / LM_TIMED * 1e3
        graph_ops[str(key)] = bmod.buckets[key]._exec_group.execs[0] \
            ._run(True).steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.monotonic()
        bmod.forward_backward(by_key[LM_BUCKETS[-1]])
        bmod.update()
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t1) * 1e3
    busy = device_busy_ms(prof)
    # the checkpoint round trip
    prefix = str(out_dir / "lm_bucketing")
    bmod.save_checkpoint(prefix, 1)
    arg, aux = bmod.get_params()
    sym, arg2, aux2 = mx_model.load_checkpoint(prefix, 1, ctx=cpu())
    master = bmod.buckets[bmod.default_bucket_key]
    round_trip = sym.tojson() == master.symbol.tojson() \
        and arg.keys() == arg2.keys() and aux.keys() == aux2.keys() \
        and all(torch.equal(arg[k]._data, arg2[k]._data) for k in arg)
    for path in (f"{prefix}-symbol.json", f"{prefix}-0001.params"):
        os.remove(path)
    leaf = lm_leaf_check(seed)
    n_params = sum(a.size for a in arg.values())
    checks = {
        "perplexity_falls": len(readings) >= 2
        and readings[-1] < readings[0],
        "finite": all(math.isfinite(v) for v in readings),
        "buckets_bound": sorted(bmod.buckets) == list(LM_BUCKETS),
        "parameters_shared": not unshared,
        "no_kernel_launches": launches == 0,
        "leaf_check": leaf["ok"], "checkpoint_round_trip": round_trip}
    return {
        "card": card, "batches": n_batches, "discarded": it.ndiscard,
        "params": n_params, "perplexity_windows": readings,
        "samples_per_s": n_batches * LM_BATCH / wall,
        "fit_wall_s": wall, "speedometer_samples_per_s": speed.speeds,
        "step_ms": step_ms, "graph_ops_per_forward": graph_ops,
        "profiled_step_ms": prof_wall, "device_busy_ms": busy,
        "host_share": max(0.0, 1.0 - busy / prof_wall),
        "unshared": unshared[:10], "leaf_check": {
            part: {k: leaf[part][k] for k in ("ok", "leaves", "failed",
                                               "cpu_share_median",
                                               "worst_margin")}
            for part in ("grads", "weights")},
        "checks": checks, "ok": all(checks.values()),
        "trained": {"arg": arg, "aux": aux}}


# ----------------------------------------------------------------------
# Phase 13: config #5 (``BASELINE.json:10``, GluonCV's SSD and Mask-RCNN)
SSD_BATCH, SSD_SIZE, SSD_WARM, SSD_STEPS = 8, 512, 3, 10   # bench_ssd
SSD_OPT = {"learning_rate": 1e-3, "momentum": 0.9}
SSD_CHECK = 2                          # the leaf check's batch
SSD_ANCHORS = 5630                     # 32²·4 + 16²·4 + (8² + 4² + 2² + 1)·6
DET_TOL = 1e-5
DET_ITERS = 5
RCNN_BATCH, RCNN_WARM, RCNN_STEPS = 4, 3, 10
RCNN_OPT = {"learning_rate": 1e-3, "momentum": 0.9}
RCNN_IMG, RCNN_CLASSES, RCNN_GT = 256, 20, 3
RCNN_CHECK = 1
#: share of the discrete decisions (ReLU units, anchors' class targets)
#: that a CPU run may have decided otherwise than the card
DECISION_FLIPS = 1e-4
UPDATE_LOST = 4                         # records a kernel, of 5 calls
UPDATE_ATTEMPTS = 6                     # traces of an update's timing
SSD_RANGES = {"batchnorm_stats": "batchnorm_stats",
              "multibox_target": "multibox_target", "ssd_loss": "loss",
              "trainer_step": "update"}
RCNN_RANGES = {"batchnorm_stats": "batchnorm_stats",
               "proposal": "proposal", "roi_align": "roi_align",
               "rcnn_heads": "heads", "rcnn_loss": "loss",
               "trainer_step": "update"}


def ssd_batch(seed: int, batch: int):
    """``bench_ssd``'s batch: ``SSD_SIZE`` images from ``seed``, 4 label
    rows an image, 2 of them real boxes, the rest padding (class -1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 3, SSD_SIZE, SSD_SIZE),
                            dtype=np.float32)
    labels = np.full((batch, 4, 5), -1, np.float32)
    for i in range(batch):
        labels[i, 0] = [i % 20, 0.1, 0.1, 0.6, 0.6]
        labels[i, 1] = [(i + 3) % 20, 0.5, 0.5, 0.9, 0.9]
    return torch.as_tensor(x), torch.as_tensor(labels)


def ranged(fn, name: str):
    """``fn`` called inside a profiler range ``name``."""
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


class RangedSSDLoss(SSDMultiBoxLoss):
    """``SSDMultiBoxLoss`` in the range ``ssd_loss``, its
    ``MultiBoxTarget`` in ``multibox_target``."""

    def targets(self, *args):
        with torch.profiler.record_function("multibox_target"):
            return super().targets(*args)

    def forward(self, *args):
        with torch.profiler.record_function("ssd_loss"):
            return super().forward(*args)


class TargetDecisions:
    """While open, ``lossfn``'s ``MultiBoxTarget`` outputs are recorded
    (``saved``), or, given ``forced``, replaced by them; ``flips`` counts
    the anchors whose class target (match or mined negative) the run
    would have set otherwise, of ``anchors``."""

    def __init__(self, lossfn, forced=None):
        self._lossfn, self._forced = lossfn, forced
        self.saved, self.flips, self.anchors = None, 0, 0

    def __enter__(self):
        own = self._lossfn.targets

        def targets(*args):
            out = own(*args)
            if self._forced is None:
                self.saved = [t.detach().clone() for t in out]
                return out
            forced = [f.to(t.device, t.dtype)
                      for f, t in zip(self._forced, out)]
            self.flips += int((forced[2] != out[2]).sum())
            self.anchors += out[2].numel()
            return forced
        self._lossfn.targets = targets
        return self

    def __exit__(self, *exc):
        del self._lossfn.targets


def check_step(model, run, opt):
    """One SGD step of ``model`` from its weights: ``run()`` gives the
    loss under ``autograd.record()``.  Returns the loss (float64, on the
    CPU), the gradients of the trainable leaves and the updated
    parameters."""
    params = model.collect_params()
    tr = gluon.Trainer(params, "sgd", opt)
    with autograd.record():
        loss = run()
    autograd.backward(loss)
    grads = {k: p._grad_tensor().detach().clone() for k, p in params.items()
             if p.grad_req != "null"}
    tr.step(1)
    return loss.detach().cpu().double(), grads, _snapshot(model)


def decision_leaf_check(after, w_init, flips, units) -> dict:
    """``leaf_check`` on the updated parameters and on the gradients of
    three ``check_step`` runs (card, CPU fp32, CPU float64), the card's
    loss within 1e-4 of the CPU's, or 1e-5 of it where it is larger than
    10 (SSD's multibox loss at the first step is ~100, a sum over 11,260
    anchors: 8.4e-5 apart on an H100), and the decisions float64 would
    have taken otherwise at most ``DECISION_FLIPS`` of them."""
    zeros = {k: torch.zeros_like(w_init[k]) for k in after["card"][1]}
    loss_err = (after["card"][0] - after["cpu"][0]).abs().item()
    loss_tol = max(1e-4, 1e-5 * abs(after["cpu"][0].item()))
    weights = leaf_check(after["card"][2], after["cpu"][2],
                         after["cpu64"][2], w_init)
    grads = leaf_check(after["card"][1], after["cpu"][1],
                       after["cpu64"][1], zeros)
    flips_ok = all(flips["cpu64"][k] <= DECISION_FLIPS * max(units[k], 1)
                   for k in units)
    return {"loss_abs_err_vs_cpu": loss_err,
            "loss_card": after["card"][0].item(),
            "loss_cpu64": after["cpu64"][0].item(),
            "decisions": units, "flips": flips, "weights": weights,
            "grads": grads,
            "ok": loss_err <= loss_tol and weights["ok"] and grads["ok"]
            and flips_ok}


def ssd_leaf_check(net, arrays, seed: int) -> dict:
    """One batch-2 step at 512 x 512 from the initial weights
    (``arrays``) on the card, on the CPU in fp32 and in float64, held by
    ``decision_leaf_check``; the CPU runs take the card's ReLU masks and
    ``MultiBoxTarget`` outputs (matches and mined negatives), recorded in
    the signature's warm call.  A hybridized ``net`` replays the card's
    step from its captured graph, which is also held against the eager
    step on the card (``vs_eager``: ``leaf_check`` with that step as the
    comparator)."""
    x, labels = ssd_batch(seed + 1, SSD_CHECK)
    w_init = _snapshot(net)
    lossfn = SSDMultiBoxLoss()
    dx, dl = x.to(gpu(0)), labels.to(gpu(0))
    with Decisions() as relus, TargetDecisions(lossfn) as targets:
        warm_call(lambda: lossfn(*net(dx), dl))
    load_reference_params(net, arrays, ctx=gpu(0))
    replays = net.graph_stats()["replays"]
    after = {"card": check_step(net, lambda: lossfn(*net(dx), dl),
                                SSD_OPT)}
    replayed = net.graph_stats()["replays"] - replays
    flips = {}
    for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        model = ssd_512_resnet50_v1(classes=20)
        load_reference_params(model, arrays, ctx=cpu())
        model.to(dtype)
        with Decisions(relus.masks) as r, \
                TargetDecisions(lossfn, targets.saved) as t:
            xc, lc = x.to(dtype), labels.to(dtype)
            after[name] = check_step(
                model, lambda: lossfn(*model(xc), lc), SSD_OPT)
        flips[name] = {"relu_units": r.flips, "anchors": t.flips}
        units = {"relu_units": r.units, "anchors": t.anchors}
        del model
    hybridized = net._active
    free_graphs(net)
    net.hybridize(False)
    load_reference_params(net, arrays, ctx=gpu(0))
    eager = check_step(net, lambda: lossfn(*net(dx), dl), SSD_OPT)
    zeros = {k: torch.zeros_like(w_init[k]) for k in eager[1]}
    vs_eager = {"weights": leaf_check(after["card"][2], eager[2],
                                      after["cpu64"][2], w_init),
                "grads": leaf_check(after["card"][1], eager[1],
                                    after["cpu64"][1], zeros)}
    res = {"batch": SSD_CHECK, **decision_leaf_check(after, w_init, flips,
                                                     units)}
    want = 1 if hybridized and dx.device.type == "cuda" else 0
    res.update(replayed=replayed, vs_eager=vs_eager,
               replay_bitwise_eager=_bitwise(
                   [after["card"][0], *after["card"][1].values()],
                   [eager[0], *eager[1].values()]))
    res["ok"] = (res["ok"] and replayed == want
                 and all(r["ok"] for r in vs_eager.values()))
    return res


def sgd_update_row(shapes, seed: int, opt: dict, batch: int,
                   update_ms: float) -> dict:
    """The momentum kernel over ``shapes`` in the Trainer's groups of 4 at
    ``opt``: bit for bit against its plain version; ``update_ms``, the
    device time of the main path's update (the ``trainer_step`` range of
    its profiled step), beside the bound and the plain version's and
    fused ``torch.optim.SGD``'s device times on the same update.  Late in
    the whole script on an H100, ``device_ms`` traces of these updates
    lost a few of their thousands of records in every take (4-10 of the
    kernel's 260): the kernel's time is read off the step's trace, and
    the other two are kept with up to ``UPDATE_LOST`` records a kernel
    missing, scaled to whole calls; one run lost every record of
    Mask-RCNN's fused-SGD timing in 3 traces running, so each is taken
    up to ``UPDATE_ATTEMPTS`` times."""
    case = SgdCase(torch.Generator(device=gpu(0)).manual_seed(seed), shapes)
    rescale = 1.0 / batch
    check = check_sgd(case, "sgd_mom", AGG, -1.0, rescale)
    w, m = case.state("sgd_mom")
    lrs, wds = [opt["learning_rate"]] * len(w), [0.0] * len(w)
    params = [torch.nn.Parameter(t.clone()) for t in case.w]
    for p, g in zip(params, case.g):
        p.grad = g
    lib = torch.optim.SGD(params, lr=opt["learning_rate"],
                          momentum=opt["momentum"], fused=True)
    bound_ms, nbytes = sgd_bound(case.n, True)
    return {"check": check, "ms": update_ms,
            "plain_ms": kernel_ms(lambda: multi_sgd_mom_plain(
                w, case.g, m, lrs, wds, opt["momentum"], rescale), 5,
                attempts=UPDATE_ATTEMPTS, lost=UPDATE_LOST),
            "library_ms": kernel_ms(lib.step, 5, attempts=UPDATE_ATTEMPTS,
                                    lost=UPDATE_LOST),
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
            "elements": case.n, "tensors": len(w),
            "launches_per_update": -(-len(w) // AGG)}


def train_run(step, images: int, warm: int, steps: int, ranges) -> dict:
    """``warm`` then ``steps`` timed calls of ``step`` (one training step
    of ``images`` images, returning its loss), the momentum launches of
    them all, and one profiled step by class (``_device_classes`` with
    ``ranges``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, other = multi_sgd_mom.launches, other_launches(multi_sgd_mom)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.monotonic()
        step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.monotonic() - t1) * 1e3
    return {"steps": warm + steps, "losses": [v.item() for v in losses],
            "step_ms": wall / steps * 1e3,
            "images_per_s": images * steps / wall,
            "launches": launches, "other_kernel_launches": other,
            "peak_memory_gb": peak_gb,
            "profile": _device_classes(prof, prof_wall_ms, ranges)}


def ssd_train_run(net, trainer, lossfn, x, labels) -> dict:
    """``bench_ssd``'s steps: ``autograd.record`` -> ``net`` -> the
    multibox loss -> ``autograd.backward`` -> ``trainer.step``."""
    def step():
        with autograd.record():
            loss = lossfn(*net(x), labels)
        autograd.backward(loss)
        with torch.profiler.record_function("trainer_step"):
            trainer.step(x.shape[0])
        return loss.detach()
    return train_run(step, x.shape[0], SSD_WARM, SSD_STEPS, SSD_RANGES)


def greedy_loop_keep(det, thresh: float) -> torch.Tensor:
    """The kept set of ``box_nms`` over ``det`` (B, N, 6) [id, score,
    corners] (valid: score > 0; only boxes of one id suppress each
    other) by the plain greedy walk, one candidate at a time over the
    batch, each IoU row computed on its own."""
    scores, ids, boxes = det[..., 1], det[..., 0], det[..., 2:6]
    valid = scores > 0
    order = ops_contrib._desc_order(torch.where(
        valid, scores, torch.full_like(scores, -math.inf)))
    cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    cid = torch.gather(ids, 1, order)
    keep = torch.gather(valid, 1, order)
    later = torch.arange(cand.shape[1], device=det.device)
    for i in range(cand.shape[1]):
        iou = ops_contrib._iou_corner(cand[:, i:i + 1], cand)
        kill = (iou > thresh) & (cid == cid[:, i:i + 1]) & keep[:, i:i + 1]
        keep &= ~(kill & (later > i))
    return torch.zeros_like(valid).scatter(1, order, keep)


def ssd_detect(net, x) -> dict:
    """``MultiBoxDetection`` at its defaults on the trained net's softmax
    output at batch 8: ms per batch, ms in the NMS, the NMS's passes; the
    card's output against the CPU's run of the op on the same inputs (the
    same kept set by index, scores and boxes within ``DET_TOL``), and its
    kept set against a plain greedy loop on the card."""
    detect = nd.contrib.MultiBoxDetection
    with autograd.predict_mode(), torch.no_grad():
        anchors, cls, box = net(x)
    prob = torch.softmax(cls, dim=-1).transpose(1, 2).contiguous()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(DET_ITERS):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.monotonic() - t0) / DET_ITERS * 1e3

    ops_contrib.nms_stats.reset()
    out, det_ms = timed(lambda: detect(prob, box, anchors))
    passes = {"run": ops_contrib.nms_stats.last,
              "settled": ops_contrib.nms_stats.settled}
    # the detections before the NMS (no pair of boxes overlaps by more
    # than IoU 2), then the NMS alone on them
    pre = detect(prob, box, anchors, nms_threshold=2.0)
    _, nms_ms = timed(lambda: nd.contrib.box_nms(
        pre, overlap_thresh=0.5, coord_start=2, score_index=1, id_index=0))
    host = detect(prob.cpu(), box.cpu(), anchors.cpu())
    kept, kept_cpu = out[..., 1] > 0, host[..., 1] > 0
    greedy = greedy_loop_keep(pre, 0.5)
    torch.cuda.synchronize()
    err = (out.cpu() - host).abs().max().item()
    res = {"batch": x.shape[0], "anchors": anchors.shape[1],
           "candidates": int((pre[..., 1] > 0).sum()) // x.shape[0],
           "kept_per_image": kept.sum(dim=1).tolist(),
           "ms_per_batch": det_ms, "nms_ms": nms_ms, "nms_passes": passes,
           "max_abs_err_vs_cpu": err,
           "same_kept_set_as_cpu": bool(torch.equal(kept.cpu(), kept_cpu)),
           "same_kept_set_as_greedy_loop": bool(torch.equal(kept, greedy))}
    res["ok"] = (res["same_kept_set_as_cpu"] and err <= DET_TOL
                 and res["same_kept_set_as_greedy_loop"]
                 and passes["run"] < res["anchors"])
    return res


def ssd_phase(seed: int, card: str) -> dict:
    """(a) SSD-512 training as ``bench_ssd``, (b) its leaf check, (c)
    ``MultiBoxDetection`` on the trained net."""
    dev = gpu(0)
    net = ssd_512_resnet50_v1(classes=20)
    net.initialize(ctx=dev, seed=seed)
    net.hybridize()
    params = net.collect_params()
    deferred = sum(not p.shape_known() for p in params.values())
    trainer = gluon.Trainer(params, "sgd", SSD_OPT)     # before any forward
    x, labels = (t.to(dev) for t in ssd_batch(seed, SSD_BATCH))
    with autograd.predict_mode(), torch.no_grad():
        net(x[:1])                       # settles the deferred shapes
    arrays = {k: v.cpu().numpy() for k, v in _snapshot(net).items()}
    trainable = [p for p in params.values() if p.grad_req != "null"]
    train = ssd_train_run(net, trainer, RangedSSDLoss(), x, labels)
    print(f"ssd-512 training on {card}:", json.dumps(train), flush=True)
    detection = ssd_detect(net, x)
    print(f"ssd-512 detection on {card}:", json.dumps(detection),
          flush=True)
    graphs = graph_summary(net)
    free_graphs(net)
    load_reference_params(net, arrays, ctx=dev)
    check = ssd_leaf_check(net, arrays, seed)
    update = sgd_update_row([p.shape for p in trainable], seed, SSD_OPT,
                            SSD_BATCH, train["profile"]["device_ms"]["update"])
    del net, trainer
    torch.cuda.empty_cache()
    groups = -(-len(trainable) // AGG)
    checks = {
        "deferred_then_settled": deferred > 0 and all(
            p.shape_known() for p in params.values()),
        "anchors": detection["anchors"] == SSD_ANCHORS,
        "momentum_launches": train["launches"] == groups * train["steps"],
        "no_other_kernel": train["other_kernel_launches"] == 0,
        "finite_losses": all(math.isfinite(v) for v in train["losses"]),
        "leaf_check": check["ok"], "detection": detection["ok"],
        # the warm calls: the first training step, the first detection
        "graphs": graphs["warm_calls"] == (2 if dev.type == "cuda" else 0)
        and graphs["deferred_calls"] == 1
        and graphs["replays"] == (train["steps"] if dev.type == "cuda"
                                  else 0),
        "update_bitwise": update["check"]["bitwise"]
        and update["check"]["launches"]
        == update["check"]["expected_launches"]}
    return {"card": card, "batch": SSD_BATCH, "size": SSD_SIZE,
            "deferred_params": deferred, "trainable_params": len(trainable),
            "expected_launches_per_step": groups, "graphs": graphs,
            "train": train,
            "detection": detection, "leaf_check": check, "update": update,
            "checks": checks, "ok": all(checks.values())}


def rcnn_batch(seed: int, batch: int):
    """Images, ``RCNN_GT`` boxes (corners in pixels, 1/8 to 5/8 of the
    image wide and high), classes and 14 x 14 binary masks an image,
    from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 3, RCNN_IMG, RCNN_IMG),
                            dtype=np.float32)
    wh = rng.uniform(RCNN_IMG / 8, RCNN_IMG * 5 / 8, (batch, RCNN_GT, 2))
    lo = rng.uniform(0, 1, (batch, RCNN_GT, 2)) * (RCNN_IMG - wh)
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    classes = rng.integers(0, RCNN_CLASSES, (batch, RCNN_GT)).astype(
        np.float32)
    masks = (rng.random((batch, RCNN_GT, 14, 14)) > 0.5).astype(np.float32)
    return [torch.as_tensor(a) for a in (x, boxes, classes, masks)]


class RoiDecisions:
    """While open, ``net``'s proposals are recorded (``rois``) or, given
    ``forced``, replaced by those."""

    def __init__(self, net, forced=None):
        self._net, self._forced, self.rois = net, forced, None

    def __enter__(self):
        own = self._net.proposals

        def proposals(score, loc):
            if self._forced is not None:
                return self._forced.to(score.device, score.dtype)
            self.rois = own(score, loc)
            return self.rois
        self._net.proposals = proposals
        return self

    def __exit__(self, *exc):
        del self._net.proposals


def rcnn_leaf_check(net, arrays, seed: int) -> dict:
    """One batch-1 step from ``arrays`` on the card, on the CPU in fp32
    and in float64 (``decision_leaf_check``); the CPU runs take the
    card's rois and ReLU masks."""
    batch = rcnn_batch(seed + 1, RCNN_CHECK)
    w_init = _snapshot(net)
    lossfn = RCNNLoss.for_net(net)
    with Decisions() as relus, RoiDecisions(net) as rois:
        dev = [t.to(gpu(0)) for t in batch]
        after = {"card": check_step(
            net, lambda: lossfn(net(dev[0]), *dev[1:]), RCNN_OPT)}
    flips, units = {}, {}
    for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        model = mask_rcnn_resnet18_v1(classes=RCNN_CLASSES)
        load_reference_params(model, arrays, ctx=cpu())
        model.to(dtype)
        with Decisions(relus.masks) as r, RoiDecisions(model, rois.rois):
            host = [t.to(dtype) for t in batch]
            after[name] = check_step(
                model, lambda: lossfn(model(host[0]), *host[1:]), RCNN_OPT)
        flips[name], units = {"relu_units": r.flips}, {"relu_units": r.units}
        del model
    return {"batch": RCNN_CHECK, **decision_leaf_check(after, w_init, flips,
                                                       units)}


def rcnn_phase(seed: int, card: str) -> dict:
    """(d) ``mask_rcnn_resnet18_v1(classes=20)`` at its defaults trained
    at batch 4 by SGD with momentum, and its leaf check."""
    dev = gpu(0)
    net = mask_rcnn_resnet18_v1(classes=RCNN_CLASSES)
    net.initialize(ctx=dev, seed=seed)
    params = net.collect_params()
    deferred = sum(not p.shape_known() for p in params.values())
    trainer = gluon.Trainer(params, "sgd", RCNN_OPT)    # before any forward
    x, boxes, classes, masks = (t.to(dev) for t in
                                rcnn_batch(seed, RCNN_BATCH))
    with autograd.predict_mode(), torch.no_grad():
        net(x[:1])                       # settles the deferred shapes
    arrays = {k: v.cpu().numpy() for k, v in _snapshot(net).items()}
    trainable = [p for p in params.values() if p.grad_req != "null"]
    lossfn = RCNNLoss.for_net(net)
    roi_align = net._roi_align
    net.proposals = ranged(net.proposals, "proposal")
    net._roi_align = ranged(roi_align, "roi_align")
    for head in (net.head, net.cls_pred, net.box_pred, net.mask_head):
        head.forward = ranged(head.forward, "rcnn_heads")

    def step():
        with autograd.record():
            out = net(x)
            with torch.profiler.record_function("rcnn_loss"):
                loss = lossfn(out, boxes, classes, masks)
        autograd.backward(loss)
        with torch.profiler.record_function("trainer_step"):
            trainer.step(x.shape[0])
        return loss.detach()

    train = train_run(step, RCNN_BATCH, RCNN_WARM, RCNN_STEPS, RCNN_RANGES)
    del net.proposals
    net._roi_align = roi_align
    for head in (net.head, net.cls_pred, net.box_pred, net.mask_head):
        del head.forward
    print(f"mask-rcnn training on {card}:", json.dumps(train), flush=True)
    load_reference_params(net, arrays, ctx=dev)
    check = rcnn_leaf_check(net, arrays, seed)
    update = sgd_update_row([p.shape for p in trainable], seed + 1,
                            RCNN_OPT, RCNN_BATCH,
                            train["profile"]["device_ms"]["update"])
    del net, trainer
    torch.cuda.empty_cache()
    groups = -(-len(trainable) // AGG)
    checks = {
        "deferred_then_settled": deferred > 0 and all(
            p.shape_known() for p in params.values()),
        "momentum_launches": train["launches"] == groups * train["steps"],
        "no_other_kernel": train["other_kernel_launches"] == 0,
        "finite_losses": all(math.isfinite(v) for v in train["losses"]),
        "leaf_check": check["ok"],
        "update_bitwise": update["check"]["bitwise"]
        and update["check"]["launches"]
        == update["check"]["expected_launches"]}
    return {"card": card, "batch": RCNN_BATCH, "img_size": RCNN_IMG,
            "deferred_params": deferred, "trainable_params": len(trainable),
            "expected_launches_per_step": groups, "train": train,
            "leaf_check": check, "update": update, "checks": checks,
            "ok": all(checks.values())}


def detection_phase(seed: int, card: str) -> dict:
    """Phase 13: config #5, SSD-512 then Mask-RCNN."""
    ssd_res = ssd_phase(seed, card)
    rcnn_res = rcnn_phase(seed, card)
    return {"ssd": ssd_res, "rcnn": rcnn_res,
            "ok": ssd_res["ok"] and rcnn_res["ok"]}


# ----------------------------------------------------------------------
# Phase 14: hybridize() on CUDA graphs (gluon/cached_op.py).  Phases 5, 6,
# 10 and 13 hybridize and so run on captured graphs; this phase trains the
# NMT and BERT-base hybridized beside their eager runs of phases 12 and 9,
# serves BERT-base from captured graphs beside eager dispatch, and runs
# the host-reading Mask-RCNN hybridized.

HYB_NMT_PASSES = 4           # timed passes (phase 12 times bench_nmt's 8)
HYB_BERT_STEPS = 5           # timed steps (phase 9 times 10)
HYB_RCNN_STEPS = 2
CHECK_STEPS: dict = {}       # phases 9 and 12's check steps, for phase 14


def graph_summary(net) -> dict:
    """``graph_stats()`` of a hybridized block in short: entries, graphs,
    replays, the eager calls of its entries on the card (the warm call of
    each mode, and the calls while a shape was unknown: a phase holds
    both to exact counts, so a call that ran eagerly where it should have
    replayed fails it), a host-reading block's eager calls, and each
    graph's mode, replays, capture ms and pool bytes."""
    st = net.graph_stats()
    return {"entries": st["entries"], "graphs": st["graphs"],
            "replays": st["replays"], "warm_calls": st["warm_calls"],
            "deferred_calls": st["deferred_calls"],
            "host_reading_eager_calls": st["eager_calls"],
            "by_graph": [g for e in st["by_entry"] for g in e["graphs"]]}


def free_graphs(net) -> None:
    """Drop ``net``'s cached graphs (their memory pools go with the last
    reference: the entries and the block refer to each other, hence the
    collection), then return the cached memory."""
    net._cached_graph.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def warm_call(run) -> None:
    """A signature's first, eager call on the card (forward and
    backward, no update), so that the next call of it replays."""
    with autograd.record():
        loss = run()
    autograd.backward(loss)


def _bitwise(a, b) -> bool:
    return all(torch.equal(x.reshape(-1).view(torch.uint8).cpu(),
                           y.reshape(-1).view(torch.uint8).cpu())
               for x, y in zip(a, b))


def replay_leaf_check(net, arrays, step, kept: dict) -> dict:
    """The check step of phase 9 or 12 (``kept``: its batch and its card,
    CPU fp32 and CPU float64 runs from ``arrays``) replayed from a
    captured graph of hybridized ``net``: after a warm call of the
    signature the weights are put back, so the next step captures the
    entry anew and replays it.  Held by ``leaf_check``'s bounds against
    the float64 step (the CPU fp32 run the comparator) and against the
    eager card step (that run the comparator), weights and gradients;
    the loss within 1e-4 of the CPU's.  Also whether the eager card step
    is bit for bit reproducible (run again here) and whether the replay
    is bit for bit the eager step."""
    dev = gpu(0)
    after, batch, w_init = kept["after"], kept["batch"], kept["w_init"]
    net.hybridize(False)
    load_reference_params(net, arrays, ctx=dev)
    again = step(net, batch)
    net.hybridize()
    load_reference_params(net, arrays, ctx=dev)
    step(net, batch)                                 # warm
    load_reference_params(net, arrays, ctx=dev)
    before = net.graph_stats()["replays"]
    replay = step(net, batch)
    replayed = net.graph_stats()["replays"] - before
    load_reference_params(net, arrays, ctx=dev)
    zeros = {k: torch.zeros_like(v) for k, v in w_init.items()}
    card = after["card"]
    res = {"replayed": replayed,
           "eager_bitwise_run_to_run": _bitwise(
               [card[0]] + list(card[1].values()) + list(card[2].values()),
               [again[0]] + list(again[1].values())
               + list(again[2].values())),
           "replay_bitwise_eager": _bitwise(
               [card[0]] + list(card[1].values()) + list(card[2].values()),
               [replay[0]] + list(replay[1].values())
               + list(replay[2].values())),
           "loss_abs_err_vs_cpu":
               (replay[0] - after["cpu"][0]).abs().item(),
           "vs_float64": {
               "weights": leaf_check(replay[2], after["cpu"][2],
                                     after["cpu64"][2], w_init),
               "grads": leaf_check(replay[1], after["cpu"][1],
                                   after["cpu64"][1], zeros)},
           "vs_eager": {
               "weights": leaf_check(replay[2], card[2], after["cpu64"][2],
                                     w_init),
               "grads": leaf_check(replay[1], card[1], after["cpu64"][1],
                                   zeros)}}
    res["ok"] = (replayed == 1 and res["loss_abs_err_vs_cpu"] <= 1e-4
                 and all(r["ok"] for part in ("vs_float64", "vs_eager")
                         for r in res[part].values()))
    return res


def _leaf_brief(check: dict) -> dict:
    return {k: check[k] for k in ("replayed", "eager_bitwise_run_to_run",
                                  "replay_bitwise_eager",
                                  "loss_abs_err_vs_cpu", "ok")} | {
        f"{part}_{leaves}": {k: check[part][leaves][k] for k in (
            "ok", "leaves", "failed", "worst_margin")}
        for part in ("vs_float64", "vs_eager")
        for leaves in ("weights", "grads")}


def nmt_graph_run(seed: int, card: str, eager: dict) -> dict:
    """(a) phase 12's training run (``bench_nmt``'s schedule at
    ``HYB_NMT_PASSES`` timed passes) hybridized, from the same weights and
    batches: one recording entry per bucket; the losses against phase
    12's eager run of the same steps; and phase 12's check step replayed
    (``replay_leaf_check``)."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        transformer_nmt_base
    net = transformer_nmt_base(vocab_size=NMT_VOCAB, max_length=NMT_MAXLEN)
    net.initialize(ctx=gpu(0), seed=seed)
    arrays = {k: v.cpu().numpy() for k, v in _snapshot(net).items()}
    net.hybridize()
    train = nmt_train_run(net, seed, HYB_NMT_PASSES)
    graphs = graph_summary(net)
    free_graphs(net)
    check = replay_leaf_check(net, arrays, nmt_check_step,
                              CHECK_STEPS["nmt"])
    free_graphs(net)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    ours = train["first_losses"] + train["losses"]
    theirs = (eager["first_losses"] + eager["losses"])[:len(ours)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ours, theirs))
    checks = {
        "one_entry_per_bucket": graphs["entries"] == len(NMT_BUCKETS)
        and graphs["graphs"] == len(NMT_BUCKETS),
        "replays": graphs["replays"] == train["steps"] + 1
        - len(NMT_BUCKETS),
        "eager_calls": graphs["deferred_calls"] == 0
        and graphs["warm_calls"] == len(NMT_BUCKETS),
        "flash_launches": train["flash_launches"]
        == 2 * NMT_LAYERS * train["steps"],
        "no_other_kernel": train["other_kernel_launches"] == 0,
        "finite_losses": all(math.isfinite(v) for v in ours),
        "losses_vs_eager": rel <= 1e-4,
        "leaf_check": check["ok"]}
    return {"card": card, "train": train, "graphs": graphs,
            "eager_step_ms": eager["step_ms"],
            "eager_tokens_per_s": eager["tokens_per_s"],
            "losses_bitwise_eager": ours == theirs,
            "losses_max_rel_vs_eager": rel, "leaf_check": check,
            "checks": checks, "ok": all(checks.values())}


def bert_graph_run(seed: int, card: str, eager: dict) -> dict:
    """(b) phase 9's BERT-base pretraining hybridized, from the same
    weights and batch, in fp32 and under ``amp.init("bfloat16")``, at
    ``HYB_BERT_STEPS`` timed steps; phase 9's check step replayed."""
    dev = gpu(0)
    batch = [torch.as_tensor(a, device=dev)
             for a in bert_batch(seed, BERT_BATCH, BERT_SEQ)]
    runs, check = {}, None
    try:
        for mode in ("fp32", "amp_bf16"):
            if mode == "amp_bf16":
                amp.init("bfloat16")
            net = bert_base(dropout=0.0)
            net.initialize(ctx=dev, seed=seed)
            arrays = {k: v.cpu().numpy() for k, v in _snapshot(net).items()}
            net.hybridize()
            runs[mode] = bert_run(net, batch, BERT_WARM + HYB_BERT_STEPS,
                                  HYB_BERT_STEPS)
            runs[mode]["graphs"] = graph_summary(net)
            print(f"bert-base hybridized {mode} on {card}:",
                  json.dumps(runs[mode]), flush=True)
            free_graphs(net)
            if mode == "fp32":
                check = replay_leaf_check(net, arrays, bert_check_step,
                                          CHECK_STEPS["bert"])
                free_graphs(net)
            del net
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        amp.disable()
    steps = BERT_WARM + HYB_BERT_STEPS
    checks = {"leaf_check": check["ok"]}
    for mode, r in runs.items():
        g = r["graphs"]
        n = len(r["losses"])
        want = eager[mode]["losses"][:n]
        checks[f"{mode}_graphs"] = (g["entries"] == 1 and g["graphs"] == 1
                                    and g["replays"] == steps
                                    and g["warm_calls"] == 1
                                    and g["deferred_calls"] == 0)
        checks[f"{mode}_launches"] = (
            r["flash_launches"] == LAYERS * steps
            and r["flash_launches_by_dtype"][
                "float32" if mode == "fp32" else "bfloat16"]
            == r["flash_launches"] and r["other_kernel_launches"] == 0)
        checks[f"{mode}_losses_vs_eager"] = max(
            abs(a - b) / abs(b) for a, b in zip(r["losses"], want)) \
            <= (1e-4 if mode == "fp32" else BERT_AMP_LOSS_RTOL)
        r["losses_bitwise_eager"] = r["losses"] == want
    return {"card": card, "timed_steps": HYB_BERT_STEPS, "runs": runs,
            "eager": {mode: {k: eager[mode][k] for k in (
                "step_ms", "sequences_per_s", "tokens_per_s")} | {
                k: eager[mode]["profile"][k] for k in (
                    "device_idle_share", "device_busy_ms", "host_launches",
                    "host_graph_launches")}
                for mode in runs},
            "leaf_check": check, "checks": checks,
            "ok": all(checks.values())}


class EagerServer(ModelServer):
    """``ModelServer`` whose dispatch runs the block's forward eagerly on
    each batch (the port's ``raw`` before it captured graphs): the
    yardstick of (c)."""

    def _build_graph(self, block, key, batch):
        dev = block.device()

        def raw(*arrays):
            with torch.inference_mode(), autograd.predict_mode():
                out = block(*[torch.as_tensor(np.asarray(a), device=dev)
                              for a in arrays])
            return tuple(out)
        raw(*[np.zeros((batch,) + tuple(shape), dtype=dt)
              for shape, dt in key])
        return raw


def serve_round(srv, reqs) -> dict:
    """Each of ``reqs`` (one request's inputs, a tuple) through the
    started ``srv``, submitted from 4 threads: wall time, requests/s,
    p50/p99 latency (enqueue to result), the batches dispatched and the
    results in order."""
    results, futs = {}, {}
    b0 = srv.stats()["batches"]           # the registry is process-wide

    def client(tid, n_clients=4):
        mine = range(tid, len(reqs), n_clients)
        for i in mine:
            futs[i] = srv.submit(*reqs[i])
        for i in mine:
            results[i] = futs[i].result(timeout=600)

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    if len(results) != len(reqs):
        raise AssertionError("requests did not complete")
    lat = np.array([(futs[i].t_done - futs[i].t_enqueue) * 1e3
                    for i in range(len(reqs))])
    return {"wall_s": wall, "requests_per_s": len(reqs) / wall,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "batches": srv.stats()["batches"] - b0,
            "results": [results[i] for i in range(len(reqs))]}


def serve_requests(net, reqs, server_cls) -> dict:
    """``reqs`` through a ``server_cls`` over ``net`` with phase 4's
    buckets and workers (``serve_round``): wall time, requests/s,
    p50/p99 latency, the results, the flash launches and the server's
    stats."""
    srv = server_cls(net, max_batch=BATCH_BUCKETS[-1],
                     length_buckets=LENGTH_BUCKETS,
                     batch_buckets=BATCH_BUCKETS,
                     queue_depth=4 * len(reqs), deadline_ms=0, workers=2,
                     batch_window_us=5000)
    try:
        t0 = time.monotonic()
        srv.warmup(*[(np.zeros(n, np.int32), np.zeros(n, np.int32),
                      np.float32(n)) for n in LENGTH_BUCKETS])
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        srv.start()
        zero_counts()
        run = serve_round(srv, reqs)
        launches = flash_attention.launches
    finally:
        srv.stop()
    return {"warmup_s": warm_s, **run, "flash_launches": launches,
            "stats": srv.stats()}


def serve_graph_run(seed: int, card: str) -> dict:
    """(c) phase 4's 32 requests served from captured ``cached_graph``s
    and, in the same call, by eager dispatch (``EagerServer``), then from
    the graphs again: requests/s and p50/p99 of each; the served outputs
    against a direct forward (<= 1e-3) and the graphs' outputs against
    eager dispatch's."""
    dev = gpu(0)
    net = bert_base(dropout=0.0)
    net.initialize(ctx=dev, seed=seed)
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, VOCAB, n).astype(np.int32),
             rng.integers(0, 2, n).astype(np.int32), np.float32(n))
            for n in bucket_lengths(rng, N_REQUESTS)]
    runs = {"graphs": serve_requests(net, reqs, ModelServer)}
    graphs = graph_summary(net)
    runs["eager"] = serve_requests(net, reqs, EagerServer)
    runs["graphs_again"] = serve_requests(net, reqs, ModelServer)
    with torch.inference_mode():
        direct = [net(*[torch.as_tensor(np.asarray(a)[None], device=dev)
                        for a in reqs[i]]) for i in range(4)]
    err = max(float(np.abs(a - b[0].cpu().numpy()).max())
              for i in range(4)
              for a, b in zip(runs["graphs"]["results"][i], direct[i]))
    vs_eager = max(float(np.abs(a - b).max())
                   for i in range(len(reqs))
                   for a, b in zip(runs["graphs"]["results"][i],
                                   runs["eager"]["results"][i]))
    free_graphs(net)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    for r in runs.values():
        del r["results"]
    batches = runs["graphs"]["batches"]
    checks = {
        "executables": runs["graphs"]["stats"]["executables"]
        == len(LENGTH_BUCKETS) * len(BATCH_BUCKETS),
        "replays": graphs["replays"] == batches
        and graphs["deferred_calls"] == 0
        and graphs["warm_calls"] == 0,
        "flash_launches": all(
            r["flash_launches"] == LAYERS * r["batches"]
            for r in runs.values()),
        "vs_direct": err <= 1e-3, "vs_eager_dispatch": vs_eager <= 1e-3}
    return {"card": card, "requests": N_REQUESTS, "runs": runs,
            "graphs": graphs, "max_abs_vs_direct": err,
            "max_abs_vs_eager_dispatch": vs_eager, "checks": checks,
            "ok": all(checks.values())}


def rcnn_graph_run(seed: int, card: str, eager_losses: list) -> dict:
    """(d) phase 13's Mask-RCNN, hybridized: it reads the host in its
    forward (``reads_host``), so ``hybridize()`` warns once and each step
    runs eagerly, counted; its first ``HYB_RCNN_STEPS`` losses against
    phase 13's eager run from the same weights and batch."""
    import warnings
    dev = gpu(0)
    net = mask_rcnn_resnet18_v1(classes=RCNN_CLASSES)
    net.initialize(ctx=dev, seed=seed)
    trainer = gluon.Trainer(net.collect_params(), "sgd", RCNN_OPT)
    x, boxes, classes, masks = (t.to(dev) for t in
                                rcnn_batch(seed, RCNN_BATCH))
    with autograd.predict_mode(), torch.no_grad():
        net(x[:1])                       # settles the deferred shapes
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        net.hybridize()
        net.hybridize()
    warned = sum("reads the host" in str(w.message) for w in caught)
    lossfn = RCNNLoss.for_net(net)
    losses = []
    for _ in range(HYB_RCNN_STEPS):
        with autograd.record():
            loss = lossfn(net(x), boxes, classes, masks)
        autograd.backward(loss)
        trainer.step(x.shape[0])
        losses.append(loss.item())
    eager_calls = net.eager_calls
    entries = net.graph_stats()["entries"]
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, eager_losses)]
    checks = {"warned_once": warned == 1,
              "eager_calls_counted": eager_calls == HYB_RCNN_STEPS
              and entries == 0,
              "losses_vs_eager": max(rel) <= 1e-5}
    return {"card": card, "steps": HYB_RCNN_STEPS, "losses": losses,
            "eager_losses": eager_losses[:HYB_RCNN_STEPS],
            "losses_rel_vs_eager": rel,
            "first_loss_bitwise_eager": losses[0] == eager_losses[0],
            "warnings": warned,
            "eager_calls": eager_calls, "checks": checks,
            "ok": all(checks.values())}


class FlashBlock(gluon.HybridBlock):
    """One flash-attention call as a block, so that ``hybridize()``
    captures it."""

    def forward(self, q, k, v, vl):
        return flash_attention(q, k, v, vl)


def flash_replay_check(seed: int) -> dict:
    """The flash kernel replayed from a captured graph against its eager
    call on the same inputs, bit for bit, at the BERT-base serving shape
    (B=8, L=512) and the training shape (L=256), fp32 and bf16, with
    ragged lengths: 3 calls (warm, capture + replay, replay) each, the
    launches counted once a call."""
    dev = gpu(0)
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for length in (512, 256):
        q, k, v, vl = flash_inputs(gen, 8, HEADS, length, length, HEAD_DIM)
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dev, dtype) for t in (q, k, v)] + [vl.to(dev)]
            want = flash_attention(*args)
            block = FlashBlock()
            block.hybridize()
            zero_counts()
            with torch.no_grad():
                outs = [block(*args) for _ in range(3)]
            torch.cuda.synchronize()
            rows.append({
                "case": f"B=8 H={HEADS} L={length} {_short(dtype)}",
                "bitwise": all(_bitwise([o], [want]) for o in outs),
                "replays": block.graph_stats()["replays"],
                "launches": flash_attention.launches})
            free_graphs(block)
    return {"cases": rows, "ok": all(r["bitwise"] and r["replays"] == 2
                                     and r["launches"] == 3 for r in rows)}


def graph_phase(seed: int, card: str, nmt: dict, bert: dict,
                rcnn: dict) -> dict:
    """Phase 14: (a) the NMT, (b) BERT-base pretraining, (c) BERT-base
    served, (d) Mask-RCNN, hybridized; (e) the flash kernel under
    replay against its eager call, bit for bit."""
    res = {"nmt": nmt_graph_run(seed, card, nmt["train"])}
    print(f"nmt hybridized on {card}:", json.dumps(res["nmt"]), flush=True)
    res["bert"] = bert_graph_run(seed, card, bert)
    res["serving"] = serve_graph_run(seed, card)
    print(f"serving from graphs on {card}:", json.dumps(res["serving"]),
          flush=True)
    res["rcnn"] = rcnn_graph_run(seed, card, rcnn["train"]["losses"])
    res["flash"] = flash_replay_check(seed)
    print(f"flash under replay on {card}:", json.dumps(res["flash"]),
          flush=True)
    res["ok"] = all(r["ok"] for r in res.values())
    return res


# ---- phase 15: generation serving ---------------------------------------
# causal_lm_small served as bench.py's generation rows serve it
# (bench.py:1122-1300), the same CausalLM at config #3's widths, and the
# front door (ModelRegistry behind HttpFrontend) on localhost.

GEN_SMALL = {"slots": 4, "kv_block": 16, "kv_blocks": 128,
             "prompt_buckets": (16,), "max_new_tokens": 48}
GEN_SMALL_REQUESTS = 64
GEN_SMALL_PROMPT = (4, 15)            # prompt lengths; ids in 1..249
GEN_BASE_MODEL = {"vocab_size": VOCAB, "num_layers": LAYERS, "units": 768,
                  "hidden_size": 3072, "num_heads": HEADS,
                  "max_length": 512}  # BERT-base's widths (bench.py:392)
GEN_BASE = {"slots": 16, "kv_block": 16, "kv_blocks": 512,
            "prompt_buckets": (64, 128, 256), "max_new_tokens": 128}
GEN_BASE_REQUESTS = 64
GEN_BASE_PROMPT = (16, 256)
GEN_BASE_NEW = (16, 128)
GEN_BASE_BITWISE = 8                  # requests decoded again alone
GEN_BASE_FORCED = 2                   # of them, teacher forced on the CPU
GEN_TOL = 1e-4
HTTP_CLIENTS = 8
HTTP_NEW_TOKENS = 24
BERT_PREDICT_LEN = 8


class PhaseServer(GenerationServer):
    """``GenerationServer`` that times each decode iteration (inputs in,
    replay, readback and the bookkeeping around them) and, for the
    requests in ``track`` (by submission order), keeps a digest of every
    logits row its prefill and decode steps read back, and the rows
    themselves for those in ``keep``: the batched-against-alone and
    teacher-forcing checks.  A recorded step copies its logits to the
    host once more; timed runs track nothing."""

    def __init__(self, block, track=(), keep=(), **kw):
        super().__init__(block, **kw)
        self.track, self.keep = set(track), set(keep)
        self.digests = {r: [] for r in self.track}
        self.rows = {r: [] for r in self.keep}
        self.step_s = []

    def _prefill(self, entry, req, bucket):
        if self.track:
            entry = (_Recorder(entry[0], self, [req]), entry[1])
        super()._prefill(entry, req, bucket)

    def _decode_graph(self, replays):
        graph, stages = super()._decode_graph(replays)
        if self.track:
            graph = _Recorder(graph, self, None)
        return graph, stages

    def _decode_step(self):
        self.replay = 0
        t0 = time.perf_counter()
        super()._decode_step()
        self.step_s.append(time.perf_counter() - t0)


class _Recorder:
    """A graph whose ``raw`` also records each tracked request's logits row
    (row i belongs to ``reqs[i]``; with ``reqs`` None, a decode step's
    next replay, whose rows are the next ``DECODE_ROWS`` slots)."""

    def __init__(self, graph, srv, reqs):
        self.graph, self.srv, self.reqs = graph, srv, reqs

    def raw(self, *args):
        logits, pool = self.graph.raw(*args)
        reqs = self.reqs
        if reqs is None:
            first = self.srv.replay * DECODE_ROWS
            self.srv.replay += 1
            reqs = self.srv._running[first:first + DECODE_ROWS]
        host = logits[:len(reqs)].cpu().numpy()
        for row, r in zip(host, reqs):
            if r is not None and r.rid in self.srv.track:
                self.srv.digests[r.rid].append(
                    hashlib.sha1(row.tobytes()).hexdigest())
                if r.rid in self.srv.keep:
                    self.srv.rows[r.rid].append(row.copy())
        return logits, pool


def gen_requests(seed: int, n: int, prompt, new=None):
    """``n`` prompts (lengths in ``prompt``, ids in 1..249) and their
    ``max_new_tokens`` (in ``new``, or None), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 250, int(rng.integers(prompt[0],
                                                     prompt[1] + 1)))
               .astype(np.int32) for _ in range(n)]
    caps = [None] * n if new is None else \
        [int(c) for c in rng.integers(new[0], new[1] + 1, n)]
    return prompts, caps


def _pct(values, q):
    return float(np.percentile(values, q)) if len(values) else 0.0


def gen_serve(net, prompts, caps, server_kw: dict, mode: str,
              track=(), keep=()) -> dict:
    """Every request submitted at once to a warmed ``PhaseServer`` in
    prefill mode ``mode``: wall time, tokens/s, TTFT and decode-step
    p50/p99 ms, the tokens, the logits digests and rows recorded, the
    server's stats and graphs, whether the pool moved."""
    os.environ["MXTPU_SERVING_PREFILL_MODE"] = mode
    srv = PhaseServer(net, track=track, keep=keep, queue_depth=4096,
                      deadline_ms=0, **server_kw)
    ptr = srv.pool.data_ptr()
    try:
        srv.start()
        t0 = time.monotonic()
        srv.warmup()
        warm_s = time.monotonic() - t0
        srv.step_s.clear()
        t0 = time.monotonic()
        reqs = [srv.submit_generate(p, max_new_tokens=c)
                for p, c in zip(prompts, caps)]
        tokens = [list(r.result(timeout=600)) for r in reqs]
        wall = time.monotonic() - t0
        graphs = srv.graph_stats()      # stop() drops the graphs
    finally:
        srv.stop()
        os.environ.pop("MXTPU_SERVING_PREFILL_MODE", None)
    n_tokens = sum(len(t) for t in tokens)
    ttft = [(r.t_first - r.t_enqueue) * 1e3 for r in reqs]
    step = [s * 1e3 for s in srv.step_s]
    return {"mode": mode, "slots": srv.decode_slots,
            "requests": len(reqs), "tokens_generated": n_tokens,
            "warmup_s": warm_s, "wall_s": wall,
            "tokens_per_s": n_tokens / wall,
            "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p99": _pct(ttft, 99),
            "decode_step_ms_p50": _pct(step, 50),
            "decode_step_ms_p99": _pct(step, 99),
            "decode_steps": len(step), "stats": srv.stats(),
            "graphs": graphs,
            "pool_moved": srv.pool.data_ptr() != ptr,
            "tokens": tokens, "digests": srv.digests, "rows": srv.rows}


def teacher_forced(cpu_net, prompts, tokens, rows: dict, tol: float) -> dict:
    """The card's served logits of each request in ``rows`` replayed on
    ``cpu_net`` (the same weights on the CPU) by teacher forcing: one full
    causal forward over the prompt and the generated tokens but the last;
    every step's logits against the card's (max-abs), and each token the
    card chose within ``tol`` of the CPU's best logit at that step."""
    err, shortfall, steps = 0.0, 0.0, 0
    with torch.no_grad():
        for rid, card_rows in rows.items():
            seq = np.concatenate([prompts[rid],
                                  np.asarray(tokens[rid][:-1], np.int32)])
            logits = cpu_net(torch.as_tensor(seq[None]))[0].numpy()
            cpu_rows = logits[len(prompts[rid]) - 1:]
            card = np.stack(card_rows)
            if card.shape != cpu_rows.shape:
                raise AssertionError(f"request {rid}: {card.shape} card "
                                     f"rows, {cpu_rows.shape} forced")
            err = max(err, float(np.abs(card - cpu_rows).max()))
            chosen = np.asarray(tokens[rid])
            if not np.array_equal(chosen, card.argmax(-1)):
                raise AssertionError(f"request {rid}: tokens are not the "
                                     f"argmax of the rows read back")
            best = cpu_rows.max(-1)
            shortfall = max(shortfall, float(
                (best - cpu_rows[np.arange(len(chosen)), chosen]).max()))
            steps += len(chosen)
    return {"requests": len(rows), "steps": steps,
            "logits_max_abs_err": err, "choice_max_shortfall": shortfall,
            "ok": err <= tol and shortfall <= tol}


def gen_checks(runs: dict, forced: dict, logits_bytes: int,
               on_card: bool) -> dict:
    """A phase-15 cell's checks from its runs: ``runs["alone"]`` (slots=1)
    against every other run, tokens and logits digests, for the requests
    it holds; no KV block allocated or reserved after any run; the pool
    never moved; each decode replay copied out the logits alone
    (``logits_bytes``, at the decode rows); on the card, one decode graph
    and a prefill graph per bucket captured and replayed in each run; the
    teacher forcing."""
    alone = runs["alone"]
    ids = range(len(alone["tokens"]))
    checks = {
        "batched_equals_alone_tokens": all(
            r["tokens"][i] == alone["tokens"][i]
            for r in runs.values() for i in ids),
        "batched_equals_alone_logits": all(
            r["digests"][i] == alone["digests"][i]
            for r in runs.values() if r["digests"] for i in ids)
        and sum(bool(r["digests"]) for r in runs.values()) >= 2,
        "no_block_leaked": all(
            r["stats"]["kv_blocks_used"] == 0
            and r["stats"]["kv_blocks_reserved"] == 0
            for r in runs.values()),
        "pool_in_place": all(not r["pool_moved"] for r in runs.values())
        and all(g["copy_bytes"] == logits_bytes
                for r in runs.values()
                for d in r["graphs"]["decode"].values()
                for g in d["graphs"]),
        "teacher_forcing": forced["ok"]}
    if on_card:
        checks["graphs_replayed"] = all(
            len(r["graphs"]["decode"]) == 1
            and all(len(e["graphs"]) == 1 and e["graphs"][0]["replays"] > 0
                    and e["warm_calls"] == 1
                    for e in r["graphs"]["decode"].values())
            and all(len(e["graphs"]) == 1
                    for e in r["graphs"]["prefill"].values())
            for r in runs.values())
    return checks


def _gen_brief(run: dict) -> dict:
    """A run without its tokens, digests and rows, for the report."""
    return {k: v for k, v in run.items()
            if k not in ("tokens", "digests", "rows")}


def _graph_costs(run: dict) -> dict:
    """Capture ms, pool bytes and bytes copied out of each graph of a
    run."""
    return {f"{kind}_{key}": {k: e["graphs"][0][k] for k in
                              ("capture_ms", "pool_bytes", "copy_bytes",
                               "replays")}
            for kind in ("prefill", "decode")
            for key, e in run["graphs"][kind].items() if e["graphs"]}


GEN_CLASSES = ("gemm", "kv_gather_scatter", "copy", "softmax",
               "layernorm", "other")


def _gen_kernel_class(name: str) -> str:
    name = name.lower()
    if any(w in name for w in ("gemm", "cutlass", "xmma", "sm90_",
                               "gemv", "splitk")):
        return "gemm"
    if "index" in name or "gather" in name or "scatter" in name:
        return "kv_gather_scatter"
    if "copy" in name or "memcpy" in name:
        return "copy"
    if "softmax" in name:
        return "softmax"
    if "layer_norm" in name or "layernorm" in name:
        return "layernorm"
    return "other"


def profile_decode_step(srv_net, server_kw: dict, n_iters: int = 5) -> dict:
    """One decode step of a warmed server's graph under torch.profiler:
    the step's inputs copied in, the replay, the logits read back (the
    shapes, and so the work, are the step's at any occupancy).  Device ms
    (in all and by kernel class), kernels a step, idle share of the
    step's wall time, and the host's launches a step."""
    from torch.profiler import ProfilerActivity, profile
    srv = GenerationServer(srv_net, deadline_ms=0, **server_kw)
    graph, (stage,) = srv._decode_graph(1)

    def step():
        logits, _ = graph.raw(*stage.push(), srv.pool)
        readback([logits])
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n_iters):
            step()
        wall_ms = (time.monotonic() - t0) * 1e3 / n_iters
    busy = device_busy_ms(prof) / n_iters
    launches = host_launches(prof)
    classes = dict.fromkeys(GEN_CLASSES, 0.0)
    kernels = 0
    for e in prof.key_averages():
        if _is_kernel(e):
            classes[_gen_kernel_class(e.key)] += \
                e.self_device_time_total / 1e3 / n_iters
            kernels += e.count
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_ms": classes, "kernels": kernels / n_iters,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "host_launches": launches["host_launches"] / n_iters,
            "host_graph_launches":
                launches["host_graph_launches"] / n_iters}


def _cpu_twin(net, make):
    """``make()`` on the CPU with ``net``'s weights."""
    twin = make()
    load_reference_params(twin, {k: p._tensor().detach().cpu().numpy()
                                 for k, p in net.collect_params().items()},
                          ctx=cpu())
    return twin


def gen_small_cell(seed: int, dev) -> dict:
    """(a) ``causal_lm_small`` as ``bench.py``'s generation rows serve it:
    64 requests at once, both prefill modes timed, then recorded batched
    and alone (slots=1); the alone run's logits teacher forced on the
    CPU."""
    net = causal_lm_small()
    net.initialize(ctx=dev, seed=seed)
    net.hybridize()
    prompts, caps = gen_requests(seed + 15, GEN_SMALL_REQUESTS,
                                 GEN_SMALL_PROMPT)
    every = range(len(prompts))
    runs = {mode: gen_serve(net, prompts, caps, GEN_SMALL, mode)
            for mode in ("interleave", "step")}
    runs["recorded"] = gen_serve(net, prompts, caps, GEN_SMALL,
                                 "interleave", track=every)
    runs["alone"] = gen_serve(net, prompts, caps,
                              {**GEN_SMALL, "slots": 1}, "interleave",
                              track=every, keep=every)
    cpu_net = _cpu_twin(net, causal_lm_small)
    forced = teacher_forced(cpu_net, prompts, runs["alone"]["tokens"],
                            runs["alone"]["rows"], GEN_TOL)
    logits_bytes = decode_rows(GEN_SMALL["slots"]) * 257 * 4
    checks = gen_checks(runs, forced, logits_bytes, dev.type == "cuda")
    free_graphs(net)
    return {"model": "causal_lm_small", "server": GEN_SMALL,
            "runs": {k: _gen_brief(r) for k, r in runs.items()},
            "graph_costs": _graph_costs(runs["interleave"]),
            "teacher_forcing": forced, "checks": checks,
            "ok": all(checks.values()), "net": net}


def gen_base_cell(seed: int, dev) -> dict:
    """(b) the same ``CausalLM`` at config #3's widths: 64 requests of
    16-256 prompt ids and 16-128 new tokens at once, interleaved; then
    recorded batched, the first 8 alone, 2 of them teacher forced."""
    net = CausalLM(**GEN_BASE_MODEL)
    net.initialize(ctx=dev, seed=seed)
    net.hybridize()
    n_params = sum(p._tensor().numel() for p in net.collect_params().values())
    prompts, caps = gen_requests(seed + 16, GEN_BASE_REQUESTS,
                                 GEN_BASE_PROMPT, GEN_BASE_NEW)
    few = range(GEN_BASE_BITWISE)
    runs = {"interleave": gen_serve(net, prompts, caps, GEN_BASE,
                                    "interleave")}
    runs["recorded"] = gen_serve(net, prompts, caps, GEN_BASE,
                                 "interleave", track=few)
    runs["alone"] = gen_serve(net, prompts[:len(few)], caps[:len(few)],
                              {**GEN_BASE, "slots": 1}, "interleave",
                              track=few, keep=range(GEN_BASE_FORCED))
    profile = profile_decode_step(net, GEN_BASE) \
        if dev.type == "cuda" else {}
    cpu_net = _cpu_twin(net, lambda: CausalLM(**GEN_BASE_MODEL))
    forced = teacher_forced(cpu_net, prompts, runs["alone"]["tokens"],
                            runs["alone"]["rows"], GEN_TOL)
    del cpu_net
    logits_bytes = decode_rows(GEN_BASE["slots"]) * VOCAB * 4
    checks = gen_checks(runs, forced, logits_bytes, dev.type == "cuda")
    free_graphs(net)
    del net
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the least a decode step must read: every weight once and each
    # row's key/value window (the gather reads it from the pool)
    window = 2 * LAYERS * decode_rows(GEN_BASE["slots"]) * GEN_BASE[
        "kv_block"] * -(-(GEN_BASE["prompt_buckets"][-1] + GEN_BASE[
            "max_new_tokens"]) // GEN_BASE["kv_block"]) * GEN_BASE_MODEL[
        "units"] * 4
    return {"model": GEN_BASE_MODEL, "parameters": n_params,
            "server": GEN_BASE,
            "decode_step_bytes": {"weights": 4 * n_params,
                                  "kv_window": window},
            "decode_step_bound_ms": (4 * n_params + window)
            / PEAK_BYTES * 1e3,
            "kv_pool_bytes": 2 * LAYERS * GEN_BASE["kv_blocks"]
            * GEN_BASE["kv_block"] * GEN_BASE_MODEL["units"] * 4,
            "runs": {k: _gen_brief(r) for k, r in runs.items()},
            "graph_costs": _graph_costs(runs["interleave"]),
            "decode_profile": profile, "teacher_forcing": forced,
            "checks": checks, "ok": all(checks.values())}


def sse_generate(port: int, name: str, prompt, drop_after: int = 0,
                 **kw) -> list:
    """One generation streamed over a raw socket: the ``(event, payload)``
    pairs, or, with ``drop_after``, the tokens seen before the client
    hangs up after that many."""
    body = json.dumps(dict(prompt=[int(t) for t in prompt], **kw))
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    buf = b""
    try:
        s.sendall((f"POST /v1/models/{name}/generate HTTP/1.1\r\nHost: t"
                   f"\r\nContent-Type: application/json\r\nContent-Length:"
                   f" {len(body)}\r\n\r\n{body}").encode())
        while True:
            if drop_after and buf.count(b"data:") >= drop_after:
                break
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    finally:
        s.close()
    out = []
    for part in buf.partition(b"\r\n\r\n")[2].decode().split("\n\n"):
        event, data = "message", None
        for line in part.strip().splitlines():
            if line.startswith("event:"):
                event = line.partition(":")[2].strip()
            elif line.startswith("data:"):
                data = json.loads(line.partition(":")[2])
        if data is not None:
            out.append((event, data))
    return out


def http_json(port: int, method: str, path: str, obj=None, headers=None,
              raw: bool = False):
    """One request on a connection of its own: ``(status, the JSON
    body)``, or with ``raw`` ``(status, the response's headers, the
    body's bytes)``."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        c.request(method, path, body=None if obj is None else
                  json.dumps(obj), headers=headers or {})
        r = c.getresponse()
        body = r.read()
        return (r.status, r.headers, body) if raw else \
            (r.status, json.loads(body))
    finally:
        c.close()


def frontdoor_cell(seed: int, dev, lm) -> dict:
    """(c) a ``ModelRegistry`` holding (a)'s ``GenerationServer`` (over
    its model) and BERT-base's ``ModelServer`` (phase 4's model and
    weights, one length bucket) behind an ``HttpFrontend`` on an
    ephemeral localhost port: 8 concurrent SSE clients against direct
    ``submit_generate``, a client that hangs up mid-stream, ``predict``
    against ``infer``, and the GET routes.  BERT-base's flash launches
    are counted here: 12 a forward."""
    reg = ModelRegistry()
    gen = GenerationServer(lm, deadline_ms=0, **GEN_SMALL)
    reg.load("causal_lm_small", gen, priority=1, warm=True)
    bert = bert_base(dropout=0.0)
    bert.initialize(ctx=dev, seed=seed)
    n = BERT_PREDICT_LEN
    ms = ModelServer(bert, max_batch=1, length_buckets=(32,),
                     batch_buckets=(1,), deadline_ms=0, workers=1,
                     batch_window_us=0)
    reg.load("bert_base", ms, priority=1, warm=[(
        np.zeros(n, np.int32), np.zeros(n, np.int32), np.float32(n))])
    fe = HttpFrontend(reg, port=0, addr="127.0.0.1").start()
    prompts, _ = gen_requests(seed + 17, HTTP_CLIENTS, GEN_SMALL_PROMPT)
    try:
        gets = {path: http_json(fe.port, "GET", path)[0]
                for path in ("/healthz", "/readyz", "/v1/models")}
        direct = [gen.generate(p, timeout=120,
                               max_new_tokens=HTTP_NEW_TOKENS)
                  for p in prompts]
        streams = {}

        def client(i):
            streams[i] = sse_generate(fe.port, "causal_lm_small",
                                      prompts[i],
                                      max_new_tokens=HTTP_NEW_TOKENS)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(HTTP_CLIENTS)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        sse_s = time.monotonic() - t0
        sse_tokens = {i: [d["token"] for e, d in ev if e == "message"]
                      for i, ev in streams.items()}
        done = {i: [d["tokens"] for e, d in ev if e == "done"]
                for i, ev in streams.items()}
        sse_ok = len(streams) == HTTP_CLIENTS and all(
            sse_tokens[i] == direct[i] and done[i] == [direct[i]]
            for i in range(HTTP_CLIENTS))
        dropped = sse_generate(fe.port, "causal_lm_small", prompts[0],
                               drop_after=2, max_new_tokens=GEN_SMALL[
                                   "max_new_tokens"])
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                gen.stats()["kv_blocks_used"]
                or gen.stats()["kv_blocks_reserved"]):
            time.sleep(0.02)
        after_drop = gen.stats()
        rng = np.random.default_rng(seed + 18)
        x = (rng.integers(0, VOCAB, n).astype(np.int32),
             rng.integers(0, 2, n).astype(np.int32), np.float32(n))
        zero_counts()
        b0 = ms.stats()["batches"]
        status, body = http_json(
            fe.port, "POST", "/v1/models/bert_base/predict",
            {"inputs": [x[0].tolist(), x[1].tolist(), float(x[2])],
             "dtypes": ["int32", "int32", "float32"]})
        want = ms.infer(*x, timeout=120)
        batches = ms.stats()["batches"] - b0
        flash = flash_attention.launches
        other = other_launches(flash_attention)
        predict_ok = status == 200 and all(
            np.array_equal(np.asarray(o, np.float32), w)
            for o, w in zip(body["outputs"], want))
    finally:
        fe.stop(drain=True)
    free_graphs(bert)
    del bert
    checks = {
        "get_routes": gets == {"/healthz": 200, "/readyz": 200,
                               "/v1/models": 200},
        "sse_equals_direct": sse_ok,
        "disconnect_releases": 0 < len(dropped) < GEN_SMALL[
            "max_new_tokens"] and after_drop["kv_blocks_used"] == 0
        and after_drop["kv_blocks_reserved"] == 0,
        "predict_equals_infer": predict_ok,
        "bert_flash_launches": flash == LAYERS * batches and batches == 2
        and other == 0}
    return {"clients": HTTP_CLIENTS, "sse_s": sse_s, "gets": gets,
            "dropped_after_tokens": len(dropped),
            "kv_after_drop": {k: after_drop[k] for k in (
                "kv_blocks_used", "kv_blocks_reserved")},
            "bert_predict_batches": batches, "bert_flash_launches": flash,
            "checks": checks, "ok": all(checks.values())}


def generation_phase(seed: int, card: str) -> dict:
    """Phase 15: (a), (b) and (c) above.  The counts are set to 0 just
    before (a) and read just after (b): the generation path launches no
    kernel of the table.  (c) counts BERT-base's flash launches on its
    own."""
    dev = gpu(0)
    zero_counts()
    small = gen_small_cell(seed, dev)
    base = gen_base_cell(seed, dev)
    launches = {w.__name__: w.launches for w in COUNTED}
    launches["rtc"] = rtc.launches
    lm = small.pop("net")
    front = frontdoor_cell(seed, dev, lm)
    free_graphs(lm)
    checks = {"no_kernel_launches": sum(launches.values()) == 0}
    return {"card": card, "small": small, "base": base, "frontdoor": front,
            "generation_launches": launches, "checks": checks,
            "ok": all(checks.values()) and small["ok"] and base["ok"]
            and front["ok"]}


# ---- phase 16: the training surface around gluon.Trainer ---------------
# ResNet-50 on MXNet's ImageNet recipe with a checkpoint and a resume,
# BERT-base pretrained with LAMB as GluonNLP does, and every optimizer of
# the JAX package on BERT-base's Dense widths, each against a CPU run.

SURFACE_NO_WD = ".*gamma|.*beta|.*bias"      # the recipes' wd_mult = 0
# MXNet's ImageNet recipe at batch 128: lr 0.1 x 128 / 256
SURFACE_RESNET_OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
SURFACE_RESNET_SCHED = {"step": [6, 9], "factor": 0.1, "warmup_steps": 3,
                        "warmup_mode": "linear"}
SURFACE_RESNET_STEPS, SURFACE_RESUME_AT = 12, 6
SURFACE_BERT_OPT = {"learning_rate": 1e-4, "wd": 0.01}
SURFACE_BERT_SCHED = {"max_update": 13, "pwr": 1, "warmup_steps": 3}
SURFACE_BERT_WARM, SURFACE_BERT_TIMED = 3, 10
SURFACE_CLIP = 1.0
ZOO_STEPS, ZOO_BATCH, ZOO_WD = 5, 8, 1e-4
# a warmup step, then the cosine's first half: every rate above 0
ZOO_SCHED = {"max_update": 2 * ZOO_STEPS, "warmup_steps": 2}
ZOO_TOL = 1e-5                          # x max(1, |w|)
SGLD_MOMENT_TOL, SGLD_ELEMENTS = 5e-3, 1 << 20
# every optimizer the JAX package registers (rmsprop plain and centered,
# sgd with and without momentum), each at a rate of its own scale
ZOO = [("sgd", {"learning_rate": 0.1}),
       ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
       ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
       ("adam", {"learning_rate": 1e-3}),
       ("adagrad", {"learning_rate": 0.05}),
       ("rmsprop", {"learning_rate": 1e-3}),
       ("rmsprop", {"learning_rate": 1e-3, "centered": True}),
       ("ftrl", {"learning_rate": 0.1}),
       ("signum", {"learning_rate": 0.01, "wd_lh": 1e-4}),
       ("adadelta", {"learning_rate": 1.0}),
       ("adamw", {"learning_rate": 1e-3}),
       ("lars", {"learning_rate": 0.1}),
       ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9,
                  "warmup_strategy": "lars"}),
       ("ftml", {"learning_rate": 0.0025}),
       ("lamb", {"learning_rate": 1e-3}),
       ("adamax", {"learning_rate": 2e-3}),
       ("nadam", {"learning_rate": 1e-3}),
       ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9})]
ZOO_MP = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
          ("sgd", {"learning_rate": 0.1}),
          ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
          ("adamw", {"learning_rate": 1e-3}),
          ("lamb", {"learning_rate": 1e-3})]
ZOO_NO_READS = ("lars", "lbsgd", "lamb")
# the kernel each fp32 / bf16 SGD configuration launches per step
ZOO_KERNELS = {("sgd", False, False): (multi_sgd, 1),
               ("sgd", True, False): (multi_sgd_mom, 1),
               ("sgd", True, True): (multi_mp_sgd_mom, 1),
               ("sgd", False, True): (multi_mp_sgd, 4)}


def _flat(state) -> list:
    if state is None:
        return []
    if isinstance(state, tuple):
        return [t for s in state for t in _flat(s)]
    return [state]


def schedule_rates(cls, kw: dict, base_lr: float, counts) -> list:
    """The rates of a fresh CPU copy of a schedule, called at ``counts``
    in order."""
    sched = cls(base_lr=base_lr, **kw)
    return [sched(n) for n in counts]


class UpdateSpy:
    """While open, records the ``lrs`` and ``wds`` of every
    ``multi_sgd_mom_update`` call (the Trainer's groups)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._orig = ops_optimizer.multi_sgd_mom_update

        def spy(*data, **kwargs):
            self.calls.append((list(data[-2]), list(data[-1])))
            return self._orig(*data, **kwargs)
        ops_optimizer.multi_sgd_mom_update = spy
        return self

    def __exit__(self, *exc):
        ops_optimizer.multi_sgd_mom_update = self._orig


def resume_mismatches(net_a, tr_a, net_b, tr_b) -> list:
    """What differs, bit for bit, between two runs: the parameters (every
    one, BatchNorm's statistics included), each parameter's optimizer
    state and the update counts."""
    bad = [k for (k, a), b in zip(net_a.collect_params().items(),
                                  net_b.collect_params().values())
           if not torch.equal(a._tensor(), b._tensor())]
    for i, p in enumerate(tr_a._params):
        sa, sb = _flat(tr_a._states.get(i)), _flat(tr_b._states.get(i))
        if len(sa) != len(sb) or not all(torch.equal(u, v)
                                         for u, v in zip(sa, sb)):
            bad.append(f"state {p.name}")
    oa, ob = tr_a.optimizer, tr_b.optimizer
    if (oa.num_update, oa._index_update_count) != \
            (ob.num_update, ob._index_update_count):
        bad.append("num_update")
    return bad


def resnet_surface_trainer(net):
    """``sgd`` on the recipe: momentum 0.9, wd 1e-4 but 0 on BatchNorm
    and the biases, a multi-factor schedule with a linear warmup."""
    net.collect_params(SURFACE_NO_WD).setattr("wd_mult", 0.0)
    sched = mx_lr.MultiFactorScheduler(
        base_lr=SURFACE_RESNET_OPT["learning_rate"], **SURFACE_RESNET_SCHED)
    return gluon.Trainer(net.collect_params(), "sgd",
                         dict(SURFACE_RESNET_OPT, lr_scheduler=sched))


def resnet_surface_run(seed: int, card: str) -> dict:
    """(a) ResNet-50 v1 at batch 128 from phase 6's weights and batch,
    12 steps; after step 6 a checkpoint, which a fresh net (another
    seed), Trainer and schedule load and go on from; steps 7-12 of both
    runs under deterministic cuDNN."""
    dev = gpu(0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(RESNET_BATCH, 3, 224, 224, device=dev, generator=gen)
    y = torch.randint(0, 1000, (RESNET_BATCH,), device=dev,
                      generator=gen).float()
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()

    def make(net_seed):
        net = resnet50_v1(classes=1000)
        net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=net_seed)
        return net, resnet_surface_trainer(net)

    def step(net, tr):
        with autograd.record():
            loss = lossfn(net(x), y)
        autograd.backward(loss)
        tr.step(RESNET_BATCH)
        return loss.detach().mean()

    net_a, tr_a = make(seed)
    names = [p.name for p in tr_a._params]
    want_wd = [0.0 if re.match(SURFACE_NO_WD, n) else
               SURFACE_RESNET_OPT["wd"] for n in names]
    torch.cuda.synchronize()
    zero_counts()
    spy_a, spy_b = UpdateSpy(), UpdateSpy()
    t0 = time.monotonic()
    with spy_a:
        losses_a = [step(net_a, tr_a) for _ in range(SURFACE_RESUME_AT)]
    torch.cuda.synchronize()
    first_wall = time.monotonic() - t0
    with tempfile.TemporaryDirectory() as tmp:
        params_file, states_file = (os.path.join(tmp, f) for f in
                                    ("resnet50.params", "resnet50.states"))
        t0 = time.monotonic()
        net_a.save_parameters(params_file)
        tr_a.save_states(states_file)
        save_ms = (time.monotonic() - t0) * 1e3
        sizes = {"params": os.path.getsize(params_file),
                 "states": os.path.getsize(states_file)}
        net_b, tr_b = make(seed + 1)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        net_b.load_parameters(params_file)
        tr_b.load_states(states_file)
        torch.cuda.synchronize()
        load_ms = (time.monotonic() - t0) * 1e3
    at_resume = resume_mismatches(net_a, tr_a, net_b, tr_b)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        rest = SURFACE_RESNET_STEPS - SURFACE_RESUME_AT
        with spy_a:
            losses_a += [step(net_a, tr_a) for _ in range(rest)]
        with spy_b:
            losses_b = [step(net_b, tr_b) for _ in range(rest)]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    launches = multi_sgd_mom.launches
    other = other_launches(multi_sgd_mom)
    at_end = resume_mismatches(net_a, tr_a, net_b, tr_b)
    groups = -(-len(names) // AGG)
    steps = SURFACE_RESNET_STEPS + len(losses_b)
    rates = schedule_rates(mx_lr.MultiFactorScheduler, SURFACE_RESNET_SCHED,
                           SURFACE_RESNET_OPT["learning_rate"],
                           range(1, SURFACE_RESNET_STEPS + 1))

    def step_rates(spy):
        per = [spy.calls[i:i + groups] for i in range(0, len(spy.calls),
                                                      groups)]
        return ([sorted({lr for c in s for lr in c[0]}) for s in per],
                [[wd for c in s for wd in c[1]] for s in per])
    lrs_a, wds_a = step_rates(spy_a)
    lrs_b, wds_b = step_rates(spy_b)
    checks = {
        "momentum_launches": launches == groups * steps and other == 0,
        "rates_follow_the_schedule":
            lrs_a == [[r] for r in rates]
            and lrs_b == [[r] for r in rates[SURFACE_RESUME_AT:]],
        "no_decay_multipliers": all(w == want_wd for w in wds_a + wds_b),
        "resume_bitwise": not at_resume,
        "losses_bitwise": all(torch.equal(a, b) for a, b in zip(
            losses_a[SURFACE_RESUME_AT:], losses_b)),
        "final_bitwise": not at_end,
        "finite_losses": all(math.isfinite(v.item()) for v in losses_a)}
    return {"card": card, "batch": RESNET_BATCH,
            "steps": SURFACE_RESNET_STEPS, "resumed_at": SURFACE_RESUME_AT,
            "launches": launches, "launches_per_step": launches / steps,
            "expected_launches_per_step": groups,
            "rates": rates, "no_decay_params": want_wd.count(0.0),
            "losses": [v.item() for v in losses_a],
            "resumed_losses": [v.item() for v in losses_b],
            "first_steps_ms": first_wall / SURFACE_RESUME_AT * 1e3,
            "checkpoint_bytes": sizes, "save_ms": save_ms,
            "load_ms": load_ms, "mismatched_at_resume": at_resume[:10],
            "mismatched_at_end": at_end[:10], "checks": checks,
            "ok": all(checks.values())}


def lamb_trainer(net):
    """``lamb`` as GluonNLP pretrains BERT: wd 0.01 but 0 on LayerNorm and
    the biases, a linear warmup and a linear (power 1) decay."""
    net.collect_params(SURFACE_NO_WD).setattr("wd_mult", 0.0)
    sched = mx_lr.PolyScheduler(base_lr=SURFACE_BERT_OPT["learning_rate"],
                                **SURFACE_BERT_SCHED)
    return gluon.Trainer(net.collect_params(), "lamb",
                         dict(SURFACE_BERT_OPT, lr_scheduler=sched))


def lamb_step(net, trainer, batch):
    """``autograd.record`` -> MLM + NSP loss -> ``autograd.backward`` ->
    ``gluon.utils.clip_global_norm`` of the gradients -> ``trainer.step``
    (in a ``trainer_step`` profiler range); returns the loss and the
    gradients' norm before the clip."""
    inputs, segs, vl, labels, weights, nsp_y = batch
    with autograd.record():
        loss = mlm_nsp_loss(*net(inputs, segs, vl), labels, weights, nsp_y)
    autograd.backward(loss)
    norm = gluon.utils.clip_global_norm(
        [p._grad_tensor() for p in trainer._params], SURFACE_CLIP)
    with torch.profiler.record_function("trainer_step"):
        trainer.step(1)
    return loss.detach(), norm


def lamb_check_step(model, batch):
    """Phase 9's check step with phase 16's LAMB update: the loss, the
    gradients (before the clip) and the updated weights."""
    tr = lamb_trainer(model)
    inputs, segs, vl, labels, weights, nsp_y = batch
    with autograd.record():
        loss = mlm_nsp_loss(*model(inputs, segs, vl), labels, weights, nsp_y)
    autograd.backward(loss)
    grads = {k: p._grad_tensor().detach().clone()
             for k, p in model.collect_params().items()}
    gluon.utils.clip_global_norm([p._grad_tensor() for p in tr._params],
                                 SURFACE_CLIP)
    tr.step(1)
    return loss.detach().cpu().double(), grads, _snapshot(model)


def bert_lamb_run(seed: int, card: str, adam: dict) -> dict:
    """(b) BERT-base pretraining at B=8, S=256 from phase 9's weights and
    batch with ``lamb``, the gradients clipped to a global norm of 1:
    13 steps (3 warm, 10 timed), one profiled step, the check step, and
    phase 9's Adam numbers (``adam``) beside."""
    from torch.profiler import ProfilerActivity, profile
    dev = gpu(0)
    batch = [torch.as_tensor(a, device=dev)
             for a in bert_batch(seed, BERT_BATCH, BERT_SEQ)]
    net = bert_base(dropout=0.0)
    net.initialize(ctx=dev, seed=seed)
    check = bert_leaf_check(net, seed, step=lamb_check_step)
    trainer = lamb_trainer(net)
    eng = mx_engine.engine()
    n_steps = SURFACE_BERT_WARM + SURFACE_BERT_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, norms, reads, rates = [], [], [], []
    for i in range(n_steps):
        if i == SURFACE_BERT_WARM:
            torch.cuda.synchronize()
            t0 = time.monotonic()
        before = eng.host_reads
        loss, norm = lamb_step(net, trainer, batch)
        reads.append(eng.host_reads - before)
        losses.append(loss)
        norms.append(norm)
        rates.append(trainer.learning_rate)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = flash_attention.launches
    other = other_launches(flash_attention)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.monotonic()
        lamb_step(net, trainer, batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.monotonic() - t1) * 1e3
    breakdown = bert_step_classes(prof, prof_wall_ms, len(trainer._params))
    breakdown["device_ms"]["lamb"] = breakdown["device_ms"].pop("adam")
    want_rates = schedule_rates(mx_lr.PolyScheduler, SURFACE_BERT_SCHED,
                                SURFACE_BERT_OPT["learning_rate"],
                                range(1, n_steps + 1))
    losses = [v.item() for v in losses]
    timed = SURFACE_BERT_TIMED
    checks = {
        "leaf_check": check["ok"],
        "flash_launches": launches == LAYERS * n_steps and other == 0,
        "one_host_read_a_step": reads == [1] * n_steps,
        "rates_follow_the_schedule": rates == want_rates,
        "finite_losses": all(math.isfinite(v) for v in losses + norms)}
    del net, trainer
    torch.cuda.empty_cache()
    return {
        "card": card, "batch": BERT_BATCH, "seq": BERT_SEQ,
        "steps": n_steps, "timed_steps": timed, "losses": losses,
        "grad_norms": norms, "rates": rates,
        "host_reads_per_step": reads, "flash_launches": launches,
        "flash_launches_per_step": launches / n_steps,
        "other_kernel_launches": other,
        "step_ms": wall / timed * 1e3,
        "sequences_per_s": BERT_BATCH * timed / wall,
        "peak_memory_gb": peak_gb, "profile": breakdown,
        "adam": {k: adam[k] for k in ("step_ms", "sequences_per_s")}
        | {k: adam["profile"][k] for k in (
            "device_busy_ms", "device_idle_share", "host_launches")},
        "leaf_check": check, "checks": checks, "ok": all(checks.values())}


ZOO_WIDTHS = (768, 3072)                 # BERT-base's units and FFN


def zoo_net(dev, seed: int, dtype=None):
    """Two Dense layers at BERT-base's FFN widths (768 -> 3072 -> 768,
    with biases): 4.7 M parameters."""
    units, hidden = ZOO_WIDTHS
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(hidden, in_units=units),
                nn.Dense(units, in_units=hidden))
    net.initialize(ctx=dev, seed=seed)
    if dtype is not None:
        net.cast(dtype)
    return net


def zoo_steps(net, name: str, kw: dict, grads, check_reads: bool = False):
    """``ZOO_STEPS`` Trainer steps of ``name`` with a cosine schedule, each
    from the gradients of ``grads`` (one list a step, on the net's
    device); with ``check_reads`` each step runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (a read back raises).
    Returns the Trainer, the rates and each step's weights before it."""
    sched = mx_lr.CosineScheduler(base_lr=kw["learning_rate"],
                                  **ZOO_SCHED)
    tr = gluon.Trainer(net.collect_params(), name,
                       dict(kw, wd=ZOO_WD, lr_scheduler=sched))
    rates, before = [], []
    for step_grads in grads:
        for p, g in zip(tr._params, step_grads):
            p._grad_tensor().copy_(g)
            p.fresh = False
        before.append([p._tensor().detach().clone() for p in tr._params])
        if check_reads:
            torch.cuda.set_sync_debug_mode("error")
        try:
            tr.step(ZOO_BATCH)
        finally:
            if check_reads:
                torch.cuda.set_sync_debug_mode("default")
        rates.append(tr.learning_rate)
    return tr, rates, before


def zoo_error(card_tr, cpu_tr) -> float:
    """The largest ``|card - cpu| / max(1, |cpu|)`` over every fp32
    weight and every state of two Trainers' runs (a bf16 weight is held
    by its fp32 master, a state: rounding masters that differ in their
    last bit can give weights a bf16 ulp apart)."""
    worst = 0.0
    for i, (p, q) in enumerate(zip(card_tr._params, cpu_tr._params)):
        pairs = list(zip(_flat(card_tr._states.get(i)),
                         _flat(cpu_tr._states.get(i))))
        if p._tensor().dtype == torch.float32:
            pairs.insert(0, (p._tensor(), q._tensor()))
        for a, b in pairs:
            a, b = a.detach().float().cpu(), b.detach().float()
            worst = max(worst, ((a - b).abs()
                                / b.abs().clamp(min=1.0)).max().item())
    return worst


def sgld_moments(before, after, grads, rates) -> list:
    """SGLD's noise at each step, ``(w' - w + lr / 2 * (g * rescale + wd
    * w)) / sqrt(lr)`` over every element (``before``/``after``: the
    weights around each step): its mean and std."""
    out = []
    for w0s, w1s, gs, lr in zip(before, after, grads, rates):
        noise = torch.cat([((w1 - w0 + lr / 2 * (
            g / ZOO_BATCH + ZOO_WD * w0)) / math.sqrt(lr)).reshape(-1)
            for w0, w1, g in zip(w0s, w1s, gs)])
        out.append({"elements": noise.numel(),
                    "mean": noise.mean().item(), "std": noise.std().item()})
    return out


def optimizer_zoo_run(seed: int, card: str) -> dict:
    """(c) Every optimizer the JAX package registers, 5 Trainer steps with
    a cosine schedule on the Dense stack, on the card and on the CPU from
    the same weights and gradients: every weight and state within
    ``ZOO_TOL`` x max(1, |w|); SGLD by its noise's moments; the
    multi-precision runs' bf16 weights their fp32 masters rounded; the
    SGD kernels' launches; no read back in LARS, LBSGD and LAMB."""
    dev = gpu(0)
    gen = torch.Generator().manual_seed(seed + 16)
    shapes = [p.shape for p in zoo_net(cpu(), seed).collect_params()
              .values()]
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(ZOO_STEPS)]
    # the fp32 runs' gradients and the bf16 runs', on the CPU and the card
    cpu_grads = {False: grads, True: [[g.bfloat16() for g in step]
                                      for step in grads]}
    card_grads = {mp: [[g.to(dev) for g in step] for step in gs]
                  for mp, gs in cpu_grads.items()}
    eng = mx_engine.engine()
    rows = []
    for mp, configs in ((False, ZOO), (True, ZOO_MP)):
        dtype = torch.bfloat16 if mp else None
        for name, kw in configs:
            kw = dict(kw, multi_precision=True) if mp else kw
            torch.cuda.synchronize()
            zero_counts()
            reads = eng.host_reads
            card_tr, rates, _ = zoo_steps(
                zoo_net(dev, seed, dtype), name, kw, card_grads[mp],
                name in ZOO_NO_READS)
            torch.cuda.synchronize()
            reads = eng.host_reads - reads
            counts = {w.__name__: w.launches for w in COUNTED}
            cpu_tr, cpu_rates, _ = zoo_steps(
                zoo_net(cpu(), seed, dtype), name, kw, cpu_grads[mp])
            err = zoo_error(card_tr, cpu_tr)
            key = (name, kw.get("momentum", 0.0) != 0.0, mp)
            kernel, per_step = ZOO_KERNELS.get(key, (None, 0))
            want = {w.__name__: (per_step * ZOO_STEPS if w is kernel else 0)
                    for w in COUNTED}
            row = {"optimizer": name, "options": {
                k: v for k, v in kw.items() if k != "learning_rate"},
                "learning_rate": kw["learning_rate"],
                "multi_precision": mp, "max_rel_err": err,
                "launches": counts, "host_reads": reads,
                "rates_follow_the_schedule": rates == cpu_rates,
                "ok": err <= ZOO_TOL and counts == want
                and rates == cpu_rates
                and (name not in ZOO_NO_READS or reads == 0)}
            if mp:
                row["masters_mismatched"] = masters_mismatched(card_tr)
                row["ok"] = row["ok"] and not row["masters_mismatched"]
            rows.append(row)
            del card_tr, cpu_tr
    zero_counts()
    sgld_tr, rates, before = zoo_steps(zoo_net(dev, seed), "sgld",
                                       {"learning_rate": 0.01},
                                       card_grads[False])
    after = before[1:] + [[p._tensor().detach() for p in sgld_tr._params]]
    sgld = sgld_moments(before, after, card_grads[False], rates)
    sgld_ok = all(abs(m["mean"]) <= SGLD_MOMENT_TOL
                  and abs(m["std"] - 1) <= SGLD_MOMENT_TOL
                  and m["elements"] >= SGLD_ELEMENTS for m in sgld) \
        and other_launches() == 0
    return {"card": card, "steps": ZOO_STEPS, "parameters": sum(
        math.prod(s) for s in shapes), "rows": rows,
        "sgld": {"moments": sgld, "ok": sgld_ok},
        "optimizers": sorted({r["optimizer"] for r in rows} | {"sgld"}),
        "ok": all(r["ok"] for r in rows) and sgld_ok}


def surface_phase(seed: int, card: str, bert: dict) -> dict:
    """Phase 16: (a) ResNet-50's recipe with a resume, (b) BERT-base with
    LAMB beside phase 9's Adam, (c) every optimizer; each part's counts
    set to 0 just before it and read just after."""
    runs = {"resnet": resnet_surface_run(seed, card)}
    torch.cuda.empty_cache()
    runs["bert"] = bert_lamb_run(seed, card, bert["fp32"])
    runs["zoo"] = optimizer_zoo_run(seed, card)
    return {**runs, "ok": all(r["ok"] for r in runs.values())}


# ---- phase 17: the data pipeline ------------------------------------------

DATA_IMAGES = 1280                       # 10 batches of 128
DATA_SHORT = (300, 500)                  # shorter side, as ImageNet's
DATA_ASPECT = (1.0, 1.5)
DATA_FIELD = (12, 16)                    # the seeded field, upsampled
DATA_NOISE = 8.0
DATA_QUALITY = 90
DATA_RESIZE = 256
DATA_CROP = 224
DATA_MEAN = (123.68, 116.779, 103.939)   # MXNet's train_imagenet recipe
DATA_STD = (58.393, 57.12, 57.375)
DATA_EPOCHS = 2                          # (a)'s timed epochs
DATA_WARM = 2                            # steps before the timed ones
DATA_RESUME_AT = 4                       # batches before the state_dict
DATA_SCALING_ROUNDS = 2                  # (d): batches each worker builds
DATA_COPY_REPS = 3                       # timed copies of one batch
DATA_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def jpeg_probe() -> dict:
    """What the machine offers for JPEG: PIL, libjpeg's header and
    libraries, the cores; and whether the port's io core built with its
    JPEG decoder (``native.has_jpeg``)."""
    def run(cmd, stdin=None):
        try:
            r = subprocess.run(cmd, input=stdin, capture_output=True,
                               text=True, timeout=60)
            return r.returncode, r.stdout
        except (OSError, subprocess.SubprocessError) as e:
            return -1, str(e)
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    t0 = time.monotonic()
    core_jpeg = native.has_jpeg()
    return {
        "pil": pil,
        "jpeglib_h": run(["g++", "-E", "-x", "c++", "-"],
                         "#include <jpeglib.h>\n")[0] == 0,
        "ldconfig_jpeg": [ln.split("=>")[-1].strip() for ln in
                          run(["ldconfig", "-p"])[1].splitlines()
                          if "jpeg" in ln.lower()],
        "nproc": os.cpu_count(), "usable_cores": len(os.sched_getaffinity(0)),
        "io_core_jpeg": core_jpeg,
        "io_core_build_s": time.monotonic() - t0}


def phase17_image(seed: int, i: int) -> np.ndarray:
    """Image ``i`` of the phase: shorter side in ``DATA_SHORT``, aspect in
    ``DATA_ASPECT`` (landscape or portrait), a seeded 16x12 RGB field
    upsampled bilinearly plus noise of std ``DATA_NOISE``: smooth enough
    to compress as photographs do."""
    g = torch.Generator().manual_seed(seed * 1_000_003 + i)
    short = int(torch.randint(DATA_SHORT[0], DATA_SHORT[1] + 1, (1,),
                              generator=g))
    aspect = DATA_ASPECT[0] + (DATA_ASPECT[1] - DATA_ASPECT[0]) * float(
        torch.rand((), generator=g))
    long = int(round(short * aspect))
    h, w = (short, long) if float(torch.rand((), generator=g)) < 0.5 \
        else (long, short)
    field = torch.rand(1, 3, *DATA_FIELD, generator=g) * 255
    img = F.interpolate(field, size=(h, w), mode="bilinear",
                        align_corners=False)[0].permute(1, 2, 0)
    img = img + torch.randn(h, w, 3, generator=g) * DATA_NOISE
    return img.clamp_(0, 255).round_().to(torch.uint8).numpy()


def phase17_records(seed: int, out_dir: Path, jpeg: bool, n: int) -> dict:
    """``n`` records (label ``i % 1000``) in ``phase17_<seed>_<payload>``
    ``.rec``/``.idx`` under ``out_dir``, reused when present: JPEG at
    quality ``DATA_QUALITY`` through ``recordio.pack_img``, else the
    ``RAWN`` payload ``pack_img`` writes without PIL, both framed by
    ``MXIndexedRecordIO.write_idx`` as ``tools.im2rec.pack`` frames them.
    Images are made and encoded one after another on the calling thread
    (torch's own threads inside each op): a pool of threads running torch
    ops while ``torch.set_num_threads`` changed left oneMKL's threaded LU
    (``torch.linalg.inv`` on the CPU, phase 21) hanging later in the same
    process (torch 2.11.0+cu128)."""
    payload = "jpeg" if jpeg else "rawn"
    rec = out_dir / f"phase17_{seed}_{payload}_{n}.rec"
    idx = rec.with_suffix(".idx")
    t0 = time.monotonic()
    made = not (rec.exists() and idx.exists())
    if made:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp_rec, tmp_idx = (p.with_suffix(p.suffix + ".tmp")
                            for p in (rec, idx))
        writer = recordio.MXIndexedRecordIO(str(tmp_idx), str(tmp_rec), "w")
        for i in range(n):
            header = recordio.IRHeader(0, float(i % 1000), i, 0)
            img = phase17_image(seed, i)
            writer.write_idx(i, recordio.pack_img(
                header, img, quality=DATA_QUALITY) if jpeg else
                recordio.pack(header, recordio._raw_payload(img)))
        writer.close()
        os.replace(tmp_idx, idx)
        os.replace(tmp_rec, rec)
    return {"rec": rec, "idx": idx, "payload": payload, "images": n,
            "made": made, "make_s": time.monotonic() - t0,
            "mean_record_bytes": rec.stat().st_size / n}


def record_iter(data: dict, threads: int, seed: int, batch: int):
    """``mx.io.ImageRecordIter`` of MXNet's ImageNet recipe over the
    phase's records."""
    return mx_io.ImageRecordIter(
        str(data["rec"]), (3, DATA_CROP, DATA_CROP), batch,
        path_imgidx=str(data["idx"]),
        shuffle=True, rand_crop=True, rand_mirror=True, resize=DATA_RESIZE,
        mean_r=DATA_MEAN[0], mean_g=DATA_MEAN[1], mean_b=DATA_MEAN[2],
        std_r=DATA_STD[0], std_g=DATA_STD[1], std_b=DATA_STD[2],
        preprocess_threads=threads, seed=seed, use_native=True)


def iter_rate(make, epochs: int = 1) -> dict:
    """Images/s of an ``ImageRecordIter`` over ``epochs`` epochs with
    nothing consuming it, its first batch (data, labels), and whether it
    ran on the native core."""
    it = make()
    first, n = None, 0
    t0 = time.monotonic()
    for _ in range(epochs):
        for b in it:
            if first is None:
                first = (b.data[0].asnumpy(), b.label[0].asnumpy())
            n += b.data[0].shape[0]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {"images": n, "s": wall, "images_per_s": n / wall,
            "first": first,
            "native": getattr(it, "_native", None) is not None}


def copy_ms(x: np.ndarray, dev) -> dict:
    """Host ms of one batch's copy to the card with nothing else queued:
    as (b) copies it (``split_and_load`` of a host ``NDArray``, from
    pageable memory) and from pinned memory (``non_blocking``), the
    median of ``DATA_COPY_REPS`` copies each."""
    host = nd.array(x, ctx=cpu())

    def median_ms(copy):
        times = []
        for _ in range(DATA_COPY_REPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            copy()
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    out = {"bytes": x.nbytes, "pageable_ms": median_ms(
        lambda: gluon.utils.split_and_load(host, [dev]))}
    if as_device(dev).type == "cuda":
        pinned = torch.from_numpy(x).pin_memory()
        out["pinned_ms"] = median_ms(
            lambda: pinned.to(as_device(dev), non_blocking=True))
    else:
        out["pinned_ms"] = None
    return out


def batch_digest(a: np.ndarray) -> dict:
    return {"sum": float(a.astype(np.float64).sum()),
            "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest()[:16]}


def fed_run(net, trainer, lossfn, source, steps: int, warm: int = 0,
            profile_step: bool = False) -> dict:
    """``warm`` + ``steps`` Trainer steps of ``net`` on the (x, y) pairs
    that ``source`` yields, ``x``/``y`` on the card.  Times the wait in
    ``next(source)`` per timed step (for a host iterator it includes the
    copy to the card), the timed steps' wall time and the whole run's
    (``all_s``, warm steps included), and with ``profile_step`` one more
    profiled step's device classes."""
    from torch.profiler import ProfilerActivity, profile

    def step():
        t0 = time.monotonic()
        x, y = next(source)
        waited = time.monotonic() - t0
        with autograd.record():
            loss = lossfn(net(x), y)
        autograd.backward(loss)
        with torch.profiler.record_function("trainer_step"):
            trainer.step(x.shape[0])
        loss = getattr(loss, "_data", loss)      # NDArray in, NDArray out
        return loss.detach().float().mean(), waited

    losses, waits = [], []
    start = time.monotonic()
    for _ in range(warm):
        losses.append(step()[0])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        loss, waited = step()
        losses.append(loss)
        waits.append(waited)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    out = {"steps": warm + steps, "timed_steps": steps,
           "all_s": time.monotonic() - start,
           "next_wait_ms": [w * 1e3 for w in waits]}
    if steps:
        out.update(step_ms=wall / steps * 1e3,
                   images_per_s=RESNET_BATCH * steps / wall,
                   next_wait_ms_per_step=sum(waits) / steps * 1e3)
    if profile_step:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.monotonic()
            loss, _ = step()
            losses.append(loss)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t1) * 1e3
        out["profile"] = _device_classes(prof, wall_ms)
        out["steps"] += 1
    out["losses"] = [v.item() for v in losses]
    return out


def from_record_iter(it, dev, waits: list):
    """(x, y) on the card from a host iterator, copied as MXNet's recipe
    copies (``gluon.utils.split_and_load``: from pageable memory, so the
    copy waits for the step before it).  Appends the time each
    ``next(it)`` blocked (the iterator's own wait) to ``waits``."""
    src = iter(it)
    while True:
        t0 = time.monotonic()
        try:
            b = next(src)
        except StopIteration:
            return
        waits.append(time.monotonic() - t0)
        yield (gluon.utils.split_and_load(b.data[0], [dev])[0],
               gluon.utils.split_and_load(b.label[0], [dev])[0])


def resident(x, y, n: int):
    for _ in range(n):
        yield x, y


def phase17_net(seed: int, dev):
    net = resnet50_v1(classes=1000)
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    net.hybridize()
    return net


def record_train(data: dict, seed: int, threads: int, dev,
                 bf16: bool = False) -> dict:
    """(b): ResNet-50 v1 at batch 128 fed by ``ImageRecordIter`` through
    ``gluon.Trainer("sgd", momentum=0.9)``: one epoch (``DATA_WARM`` warm
    steps, the rest timed), one profiled step on the next epoch's first
    batch left resident and one on its second batch from the iterator,
    then as many steps as the epoch on the resident batch.  Fp32, or with
    ``bf16`` under ``amp.init("bfloat16")`` (which the caller turns off).
    The net and its trainer come back for phase (c)."""
    if bf16:
        amp.init("bfloat16")
    net = phase17_net(seed, dev)
    w_init = _snapshot(net)
    trainer = gluon.Trainer(net.collect_params(), "sgd", RESNET_OPT)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    groups = -(-len(trainer._params) // AGG)
    it = record_iter(data, threads, seed, RESNET_BATCH)
    n_batches = data["images"] // RESNET_BATCH
    waits = []
    zero_counts()
    run = fed_run(net, trainer, lossfn, from_record_iter(it, dev, waits),
                  n_batches - DATA_WARM, DATA_WARM)
    timed = waits[DATA_WARM:]
    run["iter_wait_ms_per_step"] = sum(timed) / len(timed) * 1e3
    run["copy_and_wait_ms_per_step"] = run["next_wait_ms_per_step"] - \
        run["iter_wait_ms_per_step"]
    src = from_record_iter(it, dev, [])
    x, y = next(src)
    res_prof = fed_run(net, trainer, lossfn, resident(x, y, 1), 0,
                       profile_step=True)
    fed_prof = fed_run(net, trainer, lossfn, src, 0, profile_step=True)
    src.close()
    res = fed_run(net, trainer, lossfn, resident(x, y, n_batches),
                  n_batches - DATA_WARM, DATA_WARM)
    steps = run["steps"] + res_prof["steps"] + fed_prof["steps"] + \
        res["steps"]
    return {"run": run, "resident": res, "profile": fed_prof["profile"],
            "resident_profile": res_prof["profile"],
            "launches": multi_sgd_mom.launches, "steps": steps,
            "launches_per_step": multi_sgd_mom.launches / steps,
            "expected_launches_per_step": groups,
            "other_kernel_launches": other_launches(multi_sgd_mom),
            "graphs": graph_summary(net), "w_init": w_init,
            "net": net, "trainer": trainer}


def phase17_leaf_check(w_init: dict, x: np.ndarray, y: np.ndarray,
                       dev) -> dict:
    """The first step on the card at batch ``CPU_CHECK_BATCH`` of the
    loader's first batch, from the run's initial weights, against the
    same step on the CPU in fp32 and in float64 (``leaf_check``)."""
    arrays = {k: v.cpu().numpy() for k, v in w_init.items()}
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    xb = torch.as_tensor(x[:CPU_CHECK_BATCH])
    yb = torch.as_tensor(y[:CPU_CHECK_BATCH])
    after = {}
    for name, ctx, dtype in (("card", dev, torch.float32),
                             ("cpu", cpu(), torch.float32),
                             ("cpu64", cpu(), torch.float64)):
        model = resnet50_v1(classes=1000)
        load_reference_params(model, arrays, ctx=ctx)
        d = as_device(ctx)
        after[name] = one_step(model.to(dtype), xb.to(d, dtype),
                               yb.to(d), lossfn)
    loss_err = {k: (after["card"][0] - after[k][0]).abs().max().item()
                for k in ("cpu", "cpu64")}
    leaves = leaf_check(after["card"][1], after["cpu"][1],
                        after["cpu64"][1], w_init)
    return {"batch": CPU_CHECK_BATCH, "loss_abs_err": loss_err,
            "leaves": {k: leaves[k] for k in (
                "ok", "leaves", "failed", "cpu_share_median",
                "worst_margin")},
            "ok": loss_err["cpu"] <= 1e-4 and leaves["ok"]}


def loader_dataset(data: dict, train: bool):
    """``vision.ImageRecordDataset`` over the phase's records with the
    recipe's transforms: ``RandomResizedCrop(224)`` and a random flip
    (``train``), or a fixed resize to 224x224 (the resume check: the
    random transforms draw from numpy's global stream in whichever worker
    thread runs them, so no run replays them), then ``ToTensor`` and
    ``Normalize``."""
    mean = [m / 255 for m in DATA_MEAN]
    std = [s / 255 for s in DATA_STD]
    head = [transforms.RandomResizedCrop(DATA_CROP),
            transforms.RandomFlipLeftRight()] if train else \
        [transforms.Resize((DATA_CROP, DATA_CROP))]
    return vision.ImageRecordDataset(str(data["rec"])).transform_first(
        transforms.Compose(head + [transforms.ToTensor(),
                                   transforms.Normalize(mean, std)]))


def phase17_loader(data: dict, threads: int, train: bool = True,
                   device_prefetch: int = 2, sampler=None):
    return DataLoader(loader_dataset(data, train), batch_size=RESNET_BATCH,
                      shuffle=sampler is None, sampler=sampler,
                      num_workers=threads, pin_memory=True,
                      device_prefetch=device_prefetch)


def loader_scaling(data: dict, threads: int, seed: int) -> dict:
    """(d) at one thread count: the loader of (c) with nothing consuming
    it over ``DATA_SCALING_ROUNDS`` x ``threads`` batches, so that every
    worker builds ``DATA_SCALING_ROUNDS`` batches (a worker builds a whole
    batch); the sampler draws their records from the file, with repeats
    where they outnumber its images.  Images/s from the first ``next()``
    to the last batch (the pool's start-up included), a worker's mean ms
    to build one batch (``loader.batch_build_us``), and the rate of
    ``threads`` workers that each take that long (start-up excluded; the
    in-flight window keeps every worker busy)."""
    n = DATA_SCALING_ROUNDS * threads
    order = np.random.RandomState(seed).randint(
        0, data["images"], n * RESNET_BATCH)
    build = registry().histogram("loader.batch_build_us")
    before = (build.count, build.total)
    loader = phase17_loader(data, threads, sampler=order.tolist())
    t0 = time.monotonic()
    batches = sum(1 for _ in loader)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    build_ms = (build.total - before[1]) / max(1, build.count - before[0]) \
        / 1e3
    return {"batches": batches, "expected_batches": n,
            "images_per_s": batches * RESNET_BATCH / wall,
            "build_ms_per_batch": build_ms,
            "workers_images_per_s": threads * RESNET_BATCH / build_ms * 1e3}


def loader_train(data: dict, seed: int, threads: int, net, trainer) -> dict:
    """(c): the fp32 step of (b) fed by ``DataLoader`` over
    ``ImageRecordDataset`` (pinned batches, the device stage at depth 2),
    one epoch; every batch's labels against the ``.idx`` order the
    sampler drew; the resume check; and a pinned-batch check."""
    reg = registry()
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    before = {k: reg.histogram(k).count for k in (
        "loader.device_put_us", "loader.consume_wait_us")}
    loader = phase17_loader(data, threads)
    np.random.seed(seed)
    order = np.random.RandomState(seed).permutation(data["images"])
    labels = []

    def src():
        for xb, yb in loader:
            labels.append(yb._data)
            yield xb, yb

    zero_counts()
    n_batches = data["images"] // RESNET_BATCH
    run = fed_run(net, trainer, lossfn, src(), n_batches - 1, 1)
    # the whole epoch, its first batch's build included: the prefetch
    # window (num_workers + 2 num_workers batches) holds the whole epoch,
    # so the timed steps alone can ride on batches built before them
    run["epoch_images_per_s"] = data["images"] / run["all_s"]
    launches = multi_sgd_mom.launches
    other = other_launches(multi_sgd_mom)
    snap = reg.snapshot()
    expected = (order % 1000).astype(np.float32).reshape(n_batches, -1)
    labels_ok = len(labels) == n_batches and all(
        np.array_equal(a.cpu().numpy(), b) for a, b in zip(labels, expected))
    stage = {"device_put_us_p50": snap["loader.device_put_us"]["p50"],
             "device_put_calls": snap["loader.device_put_us"]["count"]
             - before["loader.device_put_us"],
             "device_buffer_depth": snap["loader.device_buffer_depth"],
             "prefetch_depth": snap["loader.prefetch_depth"],
             "prefetch_capacity": snap["loader.prefetch_capacity"],
             "consume_wait_us_p50": snap["loader.consume_wait_us"]["p50"]}

    # resume: state after DATA_RESUME_AT batches, restored into a fresh
    # loader, the rest of the epoch bit for bit
    np.random.seed(seed)
    full, state = [], None
    first = phase17_loader(data, threads, train=False)
    on_card = True
    for k, (xb, yb) in enumerate(first):
        on_card &= xb._data.is_cuda and yb._data.is_cuda
        full.append((xb._data.cpu(), yb._data.cpu()))
        if k + 1 == DATA_RESUME_AT:
            state = first.state_dict()
    np.random.seed(seed)
    again = phase17_loader(data, threads, train=False)
    again.load_state_dict(state)
    rest = [(xb._data.cpu(), yb._data.cpu()) for xb, yb in again]
    resume_ok = len(rest) == len(full) - DATA_RESUME_AT and all(
        _bitwise(a, b) for a, b in zip(rest, full[DATA_RESUME_AT:]))
    host = iter(phase17_loader(data, 1, train=False, device_prefetch=0))
    pinned_ok = all(t._data.is_pinned() for t in next(host))
    host.close()
    return {"run": run, "launches": launches,
            "other_kernel_launches": other, "stage": stage,
            "labels_match_idx": labels_ok, "pinned": pinned_ok,
            "on_card": on_card, "resume_state": state,
            "resume_bitwise": resume_ok, "batches": len(labels)}


def data_phase(seed: int, card: str, out_dir: Path) -> dict:
    """Phase 17: ResNet-50 v1 trained from a RecordIO file on the card."""
    start = time.monotonic()
    parts, last = {}, [start]

    def lap(name):
        now = time.monotonic()
        parts[name] = now - last[0]
        last[0] = now

    dev = gpu(0)
    probe = jpeg_probe()
    cores = probe["usable_cores"]
    jpeg = probe["io_core_jpeg"] and probe["pil"] is not None
    data = phase17_records(seed, out_dir, jpeg, DATA_IMAGES)
    lap("probe_and_records")
    print(f"data pipeline probe on {card}: {json.dumps(probe)}; records "
          f"{data['payload']} ("
          + ("JPEG at quality 90" if jpeg else
             "RAWN: the io core has no JPEG decoder here")
          + f"), {data['images']} images, mean record "
          f"{data['mean_record_bytes']:.0f} bytes, made in "
          f"{data['make_s']:.1f} s, preprocess threads {cores}",
          flush=True)
    threads = (1, 2, 4, cores) if cores > 4 else (1, 2, 4)

    # (a) the iterator alone, two epochs, and one epoch again on one
    # thread; a batch's copy to the idle card, pageable and pinned
    a = iter_rate(lambda: record_iter(data, cores, seed, RESNET_BATCH),
                  DATA_EPOCHS)
    one = iter_rate(lambda: record_iter(data, 1, seed, RESNET_BATCH))
    a_bitwise = all(np.array_equal(u.view(np.uint32), v.view(np.uint32))
                    for u, v in zip(a["first"], one["first"]))
    copy = copy_ms(a["first"][0], dev)
    lap("a")

    # (b) fp32 from the iterator against a resident batch, the first step
    # against the CPU, then (c) the DataLoader on the same net, then (b)
    # in bf16
    fp32 = record_train(data, seed, cores, dev)
    lap("b_fp32")
    check = phase17_leaf_check(fp32.pop("w_init"), *a["first"], dev)
    lap("leaf_check")
    net, trainer = fp32.pop("net"), fp32.pop("trainer")
    with dev:                    # the device stage copies to the context
        c = loader_train(data, seed, cores, net, trainer)
    free_graphs(net)
    del net, trainer
    lap("c")
    try:
        bf16 = record_train(data, seed, cores, dev, bf16=True)
        free_graphs(bf16.pop("net"))
        del bf16["trainer"], bf16["w_init"]
    finally:
        amp.disable()
    lap("b_bf16")

    # (d) the DataLoader alone at 1, 2, 4 and every usable thread; the
    # native iterator's rates are (a)'s, on one thread and on all
    with dev:
        scaling = {"dataloader": {t: loader_scaling(data, t, seed)
                                  for t in threads},
                   "record_iter_native": {
                       "threads": [1, cores],
                       "images_per_s": [one["images_per_s"],
                                        a["images_per_s"]]}}
    lap("d")
    rel = abs(bf16["run"]["losses"][0] - fp32["run"]["losses"][0]) / \
        abs(fp32["run"]["losses"][0])
    checks = {
        "native_core": a["native"] and one["native"],
        "first_batch_bitwise_one_thread": a_bitwise,
        "launches_fp32": fp32["launches"] == fp32[
            "expected_launches_per_step"] * fp32["steps"]
        and fp32["other_kernel_launches"] == 0,
        "launches_bf16": bf16["launches"] == bf16[
            "expected_launches_per_step"] * bf16["steps"]
        and bf16["other_kernel_launches"] == 0,
        "launches_dataloader": c["launches"] == fp32[
            "expected_launches_per_step"] * c["run"]["steps"]
        and c["other_kernel_launches"] == 0,
        "finite_losses": all(math.isfinite(v) for r in (
            fp32["run"], bf16["run"], c["run"]) for v in r["losses"]),
        "bf16_first_loss_vs_fp32": rel <= RESNET_AMP_LOSS_RTOL,
        "leaf_check": check["ok"],
        "dataloader_labels_match_idx": c["labels_match_idx"],
        "dataloader_pinned": c["pinned"],
        "dataloader_on_card": c["on_card"],
        "dataloader_resume_bitwise": c["resume_bitwise"],
        "dataloader_scaling_batches": all(
            r["batches"] == r["expected_batches"]
            for r in scaling["dataloader"].values()),
        "graphs": fp32["graphs"]["entries"] == 1
        and fp32["graphs"]["deferred_calls"] == 0}
    for r in (a, one):
        r["first"] = batch_digest(r.pop("first")[0])
    return {"card": card, "probe": probe, "payload": data["payload"],
            "images": data["images"],
            "mean_record_bytes": data["mean_record_bytes"],
            "make_s": data["make_s"], "threads": cores,
            "record_iter": {**a, "one_thread_first": one["first"],
                            "one_thread_images_per_s": one["images_per_s"]},
            "copy": copy,
            "fp32": fp32, "bf16": bf16, "leaf_check": check,
            "bf16_first_loss_rel_vs_fp32": rel, "dataloader": c,
            "scaling": scaling,
            "launches": fp32["launches"] + bf16["launches"] + c["launches"],
            "seconds": time.monotonic() - start, "part_seconds": parts,
            "checks": checks, "ok": all(checks.values())}


# ---------------------------------------------------------------------------
# Phase 18: Gluon's model surface, the vision zoo and a word language model

# (model, input side, learning rate): 0.1 with momentum 0.9 and wd 1e-4
# (MXNet's train_imagenet recipe) for the families with BatchNorm; less for
# those without, which diverge at 0.1 from these weights and this data
# (AlexNet's and SqueezeNet 1.1's losses reach NaN by the fourth step at
# batch 32, on the CPU): 0.01, as their published recipes train them, and
# 0.001 for AlexNet, whose loss also went from 40 to NaN in 8 steps at 0.01
# on an H100
ZOO_FAMILIES = (("alexnet", 224, 0.001), ("vgg16", 224, 0.01),
                ("resnet50_v2", 224, 0.1), ("mobilenet_v2_1_0", 224, 0.1),
                ("densenet121", 224, 0.1), ("squeezenet1_1", 224, 0.01),
                ("inception_v3", 299, 0.1))
ZOO_BATCH = 32
ZOO_WARM = 3          # the warm (eager) step, the capturing step, one more
ZOO_TIMED = 5
ZOO_CHECK = 2         # the leaf check's batch
WORD_LM = {"vocab": 33278, "emb": 650, "hidden": 650, "layers": 2,
           "dropout": 0.5, "bptt": 35, "batch": 32}
WORD_LM_OPT = {"learning_rate": 20.0}
WORD_LM_CLIP = 0.25
WORD_LM_WARM = 3
WORD_LM_TIMED = 10
CUDNN_COPY_WARNING = "contiguous chunk of memory"


class ZooDecisions(Decisions):
    """``Decisions``, and also the decisions of the rest of the vision
    zoo: the ReLU6 clamps (``torch.clamp(z, 0, hi)``, recorded as the
    units it passes and the units it caps), the max pools' arg-max (the
    CPU runs gather the card's windows' winners) and the dropout masks
    (``F.dropout`` in training mode, drawn here from a CPU generator
    seeded with ``seed`` and handed to the CPU runs)."""

    POOLS = (F.max_pool1d, F.max_pool2d, F.max_pool3d)

    def __init__(self, masks=None, seed=0):
        super().__init__(masks)
        self._gen = torch.Generator().manual_seed(seed)

    def _take(self):
        mask = self._forced[self._calls]
        self._calls += 1
        return mask

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.POOLS:
            out, idx = func(*args, **{**kwargs, "return_indices": True})
            self.units += idx.numel()
            if self._forced is None:
                self.masks.append(idx)
                return out
            want = self._take().to(idx.device)
            self.flips += int((idx != want).sum())
            return args[0].flatten(2).gather(2, want.flatten(2)) \
                .view(out.shape)
        if func is torch.clamp and len(args) == 3 and args[1] == 0 \
                and args[2] is not None:
            z, hi = args[0], args[2]
            own = ((z > 0) & (z < hi), z >= hi)
            self.units += z.numel()
            if self._forced is None:
                self.masks.append(own)
                return func(*args, **kwargs)
            mid, top = (m.to(z.device) for m in self._take())
            self.flips += int(((own[0] != mid) | (own[1] != top)).sum())
            return z * mid.to(z.dtype) + hi * top.to(z.dtype)
        if func is F.dropout:
            x = args[0]
            p = args[1] if len(args) > 1 else kwargs.get("p", 0.5)
            training = args[2] if len(args) > 2 else \
                kwargs.get("training", True)
            if not training or p == 0:
                return func(*args, **kwargs)
            if self._forced is None:
                mask = torch.rand(x.shape, generator=self._gen) >= p
                self.masks.append(mask)
            else:
                mask = self._take()
            return x * mask.to(x.device, x.dtype) / (1 - p)
        return super().__torch_function__(func, types, args, kwargs)


def profiled(step) -> dict:
    """One ``step()`` under torch.profiler: device ms by class
    (``_device_classes`` with the finer classes), the idle share of its
    wall time, the top kernels, and the host's kernel and graph
    launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    res = _device_classes(prof, wall_ms, fine=True)
    launches = host_launches(prof)
    res["host_launches"] = launches["host_launches"]
    res["host_graph_launches"] = launches["host_graph_launches"]
    return res


def zoo_check(net, name: str, w_init: dict, xb, yb, lossfn,
              seed: int, opt: dict) -> dict:
    """One SGD step (``opt``) at batch ``ZOO_CHECK`` from the
    initial weights: eagerly on the card recording its decisions
    (``ZooDecisions``), and on the CPU in fp32 and float64 taking them,
    held by ``decision_leaf_check``; then the same step replayed from the
    hybridized net's captured graph (after a warm call of the signature)
    against an eager card step, bit for bit (loss, gradients, weights),
    with cuDNN's deterministic algorithms and every generator reseeded
    before each step."""
    dev = gpu(0)
    arrays = {k: v.cpu().numpy() for k, v in w_init.items()}

    def run(model, x, y):
        return lambda: lossfn(model(x), y).mean()

    def card_step(reset=True):
        if reset:
            load_reference_params(net, arrays, ctx=dev)
        torch.manual_seed(seed)
        mx_random.seed(seed)
        return check_step(net, run(net, xb, yb), opt)

    torch.backends.cudnn.deterministic = True
    try:
        net.hybridize(False)
        load_reference_params(net, arrays, ctx=dev)
        with ZooDecisions(seed=seed) as card:
            after = {"card": check_step(net, run(net, xb, yb), opt)}
        eager = card_step()
        net.hybridize()
        card_step()                                    # warm
        before = net.graph_stats()["replays"]
        replay = card_step()
        replayed = net.graph_stats()["replays"] - before
        free_graphs(net)
    finally:
        torch.backends.cudnn.deterministic = False
    flips = {}
    for nm, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        model = vision_zoo.get_model(name, classes=1000)
        load_reference_params(model, arrays, ctx=cpu())
        with ZooDecisions(card.masks) as forced:
            after[nm] = check_step(
                model.to(dtype), run(model, xb.cpu().to(dtype), yb.cpu()),
                opt)
        flips[nm] = {"decisions": forced.flips}
        del model
    res = decision_leaf_check(after, w_init, flips,
                              {"decisions": card.units})
    flat = [[t[0]] + list(t[1].values()) + list(t[2].values())
            for t in (eager, replay)]
    res.update(replayed=replayed, replay_bitwise_eager=_bitwise(*flat))
    res["ok"] = res["ok"] and replayed == 1 and res["replay_bitwise_eager"]
    return res


def zoo_model_run(name: str, size: int, lr: float, seed: int,
                  card: str) -> dict:
    """(a) one vision family at ImageNet width (1000 classes), batch
    ``ZOO_BATCH`` fp32, hybridized, through ``gluon.Trainer("sgd", lr,
    momentum 0.9, wd 1e-4)``: ``ZOO_WARM`` then ``ZOO_TIMED`` timed steps, the
    momentum kernel's exact launches, two predict-mode forwards, and
    ``zoo_check``."""
    dev = gpu(0)
    net = vision_zoo.get_model(name, classes=1000)
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    net.hybridize()
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(ZOO_BATCH, 3, size, size, device=dev, generator=gen)
    y = torch.randint(0, 1000, (ZOO_BATCH,), device=dev,
                      generator=gen).float()
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.predict_mode(), torch.no_grad():
        net(x[:ZOO_CHECK])                   # settles the deferred shapes
    w_init = _snapshot(net)
    params = net.collect_params()
    trainable = [p for p in params.values() if p.grad_req != "null"]
    opt = dict(RESNET_OPT, learning_rate=lr)
    trainer = gluon.Trainer(params, "sgd", opt)
    groups = -(-len(trainable) // AGG)

    def step():
        with autograd.record():
            loss = lossfn(net(x), y)
        autograd.backward(loss)
        trainer.step(ZOO_BATCH)
        return loss.detach().mean()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = [step() for _ in range(ZOO_WARM)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses += [step() for _ in range(ZOO_TIMED)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = multi_sgd_mom.launches
    other = other_launches(multi_sgd_mom)
    steps = ZOO_WARM + ZOO_TIMED
    profile = profiled(step)
    steps += 1
    train_graphs = graph_summary(net)
    with autograd.predict_mode(), torch.no_grad():
        probs = [net(x) for _ in range(2)]
    torch.cuda.synchronize()
    graphs = graph_summary(net)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    free_graphs(net)
    losses = [v.item() for v in losses]
    check = zoo_check(net, name, w_init, x[:ZOO_CHECK], y[:ZOO_CHECK],
                      lossfn, seed, opt)
    train = [g for g in graphs["by_graph"] if g["mode"] == "train"]
    infer = [g for g in graphs["by_graph"] if g["mode"] == "infer"]
    checks = {
        "launches_exact": launches == groups * (steps - 1) and other == 0,
        "finite_losses": all(math.isfinite(v) for v in losses),
        "one_train_graph": len(train) == 1 and
        train[0]["replays"] == steps - 1,
        "predict_shape": tuple(probs[0].shape) == (ZOO_BATCH, 1000)
        and all(bool(torch.isfinite(p).all()) for p in probs),
        "predict_replayed": len(infer) == 1 and infer[0]["replays"] == 1,
        "predict_replay_bitwise_warm": _bitwise([probs[0]], [probs[1]]),
        "leaf_check": check["ok"]}
    res = {
        "model": name, "input": size, "batch": ZOO_BATCH,
        "learning_rate": lr,
        "parameters": sum(p._tensor().numel() for p in trainable),
        "trainable_tensors": len(trainable),
        "step_ms": wall / ZOO_TIMED * 1e3,
        "images_per_s": ZOO_BATCH * ZOO_TIMED / wall,
        "launches": launches,
        "launches_per_step": launches / (steps - 1),
        "expected_launches_per_step": groups,
        "other_kernel_launches": other, "losses": losses,
        "peak_memory_gb": peak_gb, "profile": profile,
        "pool_bytes": {"train": [g["pool_bytes"] for g in train],
                       "infer": [g["pool_bytes"] for g in infer]},
        "capture_ms": [g["capture_ms"] for g in graphs["by_graph"]],
        "graphs": train_graphs | {"after_predict": graphs["entries"]},
        "check": {k: check[k] for k in (
            "loss_abs_err_vs_cpu", "decisions", "flips", "replayed",
            "replay_bitwise_eager", "ok")} | {
            part: {k: check[part][k] for k in (
                "ok", "leaves", "failed", "cpu_share_median",
                "worst_margin")} for part in ("weights", "grads")},
        "checks": checks}
    res["ok"] = all(checks.values())
    del net, trainer, probs
    gc.collect()
    torch.cuda.empty_cache()
    return res


class WordLM(gluon.HybridBlock):
    """MXNet's ``example/gluon/word_language_model`` model: an embedding
    (uniform in +-0.1), dropout, a multi-layer ``gluon.rnn.LSTM`` with
    dropout between layers, dropout, and a decoder tied to the embedding
    (``params=``) unless ``tie`` is False."""

    def __init__(self, vocab, emb, hidden, layers, dropout, tie=True,
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden = hidden
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(
                vocab, emb, weight_initializer=mx_init.Uniform(0.1))
            self.rnn = gluon.rnn.LSTM(hidden, layers, dropout=dropout,
                                      input_size=emb)
            self.decoder = nn.Dense(
                vocab, in_units=hidden,
                params=self.encoder.params if tie else None)

    def forward(self, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        return self.decoder(output.reshape(-1, self._hidden)), hidden

    def begin_state(self, *args, **kwargs):
        return self.rnn.begin_state(*args, **kwargs)


def word_lm_window(net, trainer, x, y, hidden, lossfn, train=True):
    """One truncated-BPTT window of the example's loop: the hidden state
    detached, the summed token losses back-propagated, the gradients
    clipped to ``WORD_LM_CLIP`` per token (``clip_global_norm``), one SGD
    step over the window's tokens.  Returns the mean loss, the new hidden
    state, and the gradients before the step."""
    hidden = [h.detach() for h in hidden]
    with autograd.record(train_mode=train):
        out, hidden = net(x, hidden)
        loss = lossfn(out, y.reshape(-1))
    autograd.backward(loss)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    tokens = x.numel()
    gluon.utils.clip_global_norm([p._grad_tensor() for p in params],
                                 WORD_LM_CLIP * tokens)
    grads = {p.name: p._grad_tensor().detach().clone() for p in params}
    trainer.step(tokens)
    return loss.detach().mean(), hidden, grads


def word_lm_data(seed: int, windows: int, dev):
    cfg = WORD_LM
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg["vocab"],
                        (windows * cfg["bptt"] + 1, cfg["batch"]),
                        generator=gen).to(dev)
    return [(ids[i * cfg["bptt"]:(i + 1) * cfg["bptt"]],
             ids[i * cfg["bptt"] + 1:(i + 1) * cfg["bptt"] + 1].float())
            for i in range(windows)]


def word_lm_build(dropout=None):
    cfg = WORD_LM
    return WordLM(cfg["vocab"], cfg["emb"], cfg["hidden"], cfg["layers"],
                  cfg["dropout"] if dropout is None else dropout)


def word_lm_run(seed: int, card: str) -> dict:
    """(b) the word language model at the example's widths, hybridized:
    ``WORD_LM_WARM`` then ``WORD_LM_TIMED`` timed windows with the hidden
    state carried across them; the plain SGD kernel's exact launches; no
    copy of the weights by cuDNN; the first window (dropout off) against
    the CPU in fp32 and float64 (``leaf_check``); and a window replayed
    from the captured graph, dropout on, bit for bit its eager card
    window, every generator reseeded before each."""
    dev = gpu(0)
    cfg = WORD_LM
    net = word_lm_build()
    net.initialize(Xavier(), ctx=dev, seed=seed)
    net.hybridize()
    w_init = _snapshot(net)
    arrays = {k: v.cpu().numpy() for k, v in w_init.items()}
    params = net.collect_params()
    trainable = [p for p in params.values() if p.grad_req != "null"]
    trainer = gluon.Trainer(params, "sgd", WORD_LM_OPT)
    groups = -(-len(trainable) // AGG)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    windows = word_lm_data(seed, WORD_LM_WARM + WORD_LM_TIMED, dev)
    hidden = [h._data for h in net.begin_state(cfg["batch"], ctx=dev)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        zero_counts()
        for i, (x, y) in enumerate(windows):
            if i == WORD_LM_WARM:
                torch.cuda.synchronize()
                t0 = time.monotonic()
            loss, hidden, _ = word_lm_window(net, trainer, x, y, hidden,
                                             lossfn)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches, other = multi_sgd.launches, other_launches(multi_sgd)
    copies = [str(w.message) for w in caught
              if CUDNN_COPY_WARNING in str(w.message)]
    x, y = windows[-1]
    profile = profiled(lambda: word_lm_window(net, trainer, x, y, hidden,
                                              lossfn))
    graphs = graph_summary(net)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    free_graphs(net)
    losses = [v.item() for v in losses]

    # the first window, dropout off, on the card (eager) and on the CPU
    x0, y0 = windows[0]
    h0 = [torch.zeros_like(h) for h in hidden]
    after = {}
    net.hybridize(False)
    for nm, model, dtype in (("card", net, torch.float32),
                             ("cpu", None, torch.float32),
                             ("cpu64", None, torch.float64)):
        d = dev if model is not None else cpu()
        if model is None:
            model = word_lm_build()
        load_reference_params(model, arrays, ctx=d)
        model.to(dtype)
        tr = gluon.Trainer(model.collect_params(), "sgd", WORD_LM_OPT)
        loss, _, grads = word_lm_window(
            model, tr, x0.to(d), y0.to(d), [h.to(d, dtype) for h in h0],
            lossfn, train=False)
        after[nm] = (loss.cpu().double(), grads, _snapshot(model))
    zeros = {k: torch.zeros_like(v) for k, v in after["card"][1].items()}
    loss_err = (after["card"][0] - after["cpu"][0]).abs().item()
    weights = leaf_check(after["card"][2], after["cpu"][2],
                         after["cpu64"][2], w_init)
    grads = leaf_check(after["card"][1], after["cpu"][1],
                       after["cpu64"][1], zeros)

    # a replayed window, dropout on, against the eager one
    def card_window():
        load_reference_params(net, arrays, ctx=dev)
        torch.manual_seed(seed)
        mx_random.seed(seed)
        tr = gluon.Trainer(net.collect_params(), "sgd", WORD_LM_OPT)
        loss, new_h, g = word_lm_window(net, tr, x0, y0, h0, lossfn)
        return [loss] + list(new_h) + list(g.values()) + \
            list(_snapshot(net).values())

    torch.backends.cudnn.deterministic = True
    try:
        eager = card_window()
        net.hybridize()
        card_window()                                  # warm
        before = net.graph_stats()["replays"]
        replay = card_window()
        replayed = net.graph_stats()["replays"] - before
        free_graphs(net)
    finally:
        torch.backends.cudnn.deterministic = False
    flat = net.rnn._flat
    checks = {
        "launches_exact": launches == groups * len(windows) and other == 0,
        "finite_losses": all(math.isfinite(v) for v in losses),
        "no_cudnn_weight_copy": not copies and len(flat) == cfg["layers"],
        "tied": net.decoder.weight is net.encoder.weight,
        "one_train_graph": graphs["graphs"] == 1 and
        graphs["replays"] == len(windows),
        "first_window_vs_cpu": loss_err <= 1e-4 and weights["ok"]
        and grads["ok"],
        "replayed": replayed == 1,
        "replay_bitwise_eager": _bitwise(eager, replay)}
    tokens = cfg["bptt"] * cfg["batch"]
    res = {"config": cfg, "optimizer": WORD_LM_OPT, "clip": WORD_LM_CLIP,
           "parameters": sum(p._tensor().numel() for p in trainable),
           "trainable_tensors": len(trainable),
           "window_ms": wall / WORD_LM_TIMED * 1e3,
           "tokens_per_s": tokens * WORD_LM_TIMED / wall,
           "launches": launches, "launches_per_window": launches /
           len(windows), "expected_launches_per_window": groups,
           "other_kernel_launches": other, "losses": losses,
           "cudnn_weight_copies": len(copies), "peak_memory_gb": peak_gb,
           "graphs": graphs, "profile": profile,
           "first_window": {"loss_abs_err_vs_cpu": loss_err,
                            "weights": {k: weights[k] for k in (
                                "ok", "leaves", "failed",
                                "cpu_share_median", "worst_margin")},
                            "grads": {k: grads[k] for k in (
                                "ok", "leaves", "failed",
                                "cpu_share_median", "worst_margin")}},
           "checks": checks}
    res["ok"] = all(checks.values())
    del net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return res


def model_surface_phase(seed: int, card: str) -> dict:
    """Phase 18: every vision family of the zoo (``ZOO_FAMILIES``) and the
    word language model, each with its counts zeroed just before it."""
    start = time.monotonic()
    zoo, seconds = {}, {}
    for name, size, lr in ZOO_FAMILIES:
        t0 = time.monotonic()
        zoo[name] = zoo_model_run(name, size, lr, seed, card)
        seconds[name] = time.monotonic() - t0
    t0 = time.monotonic()
    lm = word_lm_run(seed, card)
    seconds["word_lm"] = time.monotonic() - t0
    return {"zoo": zoo, "word_lm": lm,
            "zoo_launches": sum(r["launches"] for r in zoo.values()),
            "seconds": time.monotonic() - start, "part_seconds": seconds,
            "ok": all(r["ok"] for r in zoo.values()) and lm["ok"]}


# ----------------------------------------------------------------------
# Phase 19: the symbolic AMP and Module surface: ``mx.sym`` graphs bound
# by ``Module``, ``contrib.amp.convert_model`` with its cast ops, the
# registry's ``_contrib_flash_attention``, the Module-era loss heads and
# the registry ops that ported modules name.  The symbol builders take
# the ``sym`` namespace, so the CPU tests build the same graph in the
# JAX package.
SYM_UNITS, SYM_HEADS, SYM_FFN = 768, 12, 3072      # BERT-base's widths
SYM_SEQ, SYM_BATCH, SYM_LAYERS = 512, 8, 12
SYM_CHECK_LAYERS, SYM_CHECK_BATCH = 2, 2           # the leaf check's copy
SYM_OPT = {"learning_rate": 1e-3, "momentum": 0.9}
SYM_WARM, SYM_TIMED = 2, 5
# The bf16 bounds sit about 3 to 10 times above the card's readings
# (PERF.md, PR 16: 5.2e-3, 1.7e-3 and 9.2e-5; the LM's logits 6.7e-3 in
# the CPU rehearsal's toy LM); bf16 rounds at 2^-8.
SYM_BF16_TOL = 1.5e-2        # relative L2 of the bf16-converted outputs
SYM_ROUTE_TOL = 1e-4         # interleaved route vs the flash route, fp32
LM_BF16_RTOL = 1e-3          # converted LM's perplexity vs fp32's
LM_LOGIT_TOL = 1e-2          # converted LM's centred logits, relative L2
HEAD_OPS = ("LinearRegressionOutput", "LogisticRegressionOutput",
            "MAERegressionOutput", "SVMOutput")
HEAD_OPT = {"learning_rate": 0.002, "momentum": 0.9}
HEAD_SAMPLES, HEAD_HELD_OUT, HEAD_BATCH, HEAD_EPOCHS = 640, 128, 64, 2
OP_TOL = 1e-5                # card vs CPU, x max(1, max|CPU|), fp32


def sym_encoder(sym, layers: int, units: int = None, heads: int = None,
                ffn: int = None, head: str = "loss"):
    """A BERT-style encoder in ``sym`` over inputs ``data`` (B, L, units)
    and ``valid_len`` (B,): per layer an interleaved-free q/k/v projection,
    ``_contrib_flash_attention`` on (B * heads, L, units / heads) with the
    per-sequence lengths, the output projection, residual ``LayerNorm``s
    and a GELU FFN (``LeakyReLU(act_type="gelu")``, in both registries).
    ``head``: ``"loss"`` (the first token's ``FullyConnected(2)`` ->
    ``softmax_cross_entropy`` against ``label`` -> ``MakeLoss(
    normalization="batch")``), ``"infer"`` (the last hidden states and
    the two logits, grouped).  Widths default to ``SYM_UNITS``,
    ``SYM_HEADS`` and ``SYM_FFN``."""
    units, heads, ffn = units or SYM_UNITS, heads or SYM_HEADS, \
        ffn or SYM_FFN
    x, vl = sym.var("data"), sym.var("valid_len")
    d = units // heads
    for i in range(layers):
        p = f"enc{i}_"
        qkv = sym.FullyConnected(x, num_hidden=3 * units, flatten=False,
                                 name=p + "qkv")
        qkv = sym.transpose(sym.reshape(qkv, shape=(0, 0, 3 * heads, d),
                                        name=p + "qkv_heads"),
                            axes=(0, 2, 1, 3), name=p + "qkv_t")
        q, k, v = (sym.reshape(t, shape=(-3, 0, 0), name=p + part)
                   for part, t in zip("qkv", sym.split(
                       qkv, num_outputs=3, axis=1, name=p + "split")))
        att = sym._contrib_flash_attention(q, k, v, vl, name=p + "flash")
        att = sym.reshape(sym.transpose(
            sym.reshape(att, shape=(-4, -1, heads, 0, 0), name=p + "att_b"),
            axes=(0, 2, 1, 3), name=p + "att_t"), shape=(0, 0, -3),
            name=p + "att")
        att = sym.FullyConnected(att, num_hidden=units, flatten=False,
                                 name=p + "proj")
        x = sym.LayerNorm(sym.broadcast_add(x, att, name=p + "res1"),
                          axis=-1, name=p + "ln1")
        h = sym.FullyConnected(x, num_hidden=ffn, flatten=False,
                               name=p + "ffn1")
        h = sym.LeakyReLU(h, act_type="gelu", name=p + "gelu")
        h = sym.FullyConnected(h, num_hidden=units, flatten=False,
                               name=p + "ffn2")
        x = sym.LayerNorm(sym.broadcast_add(x, h, name=p + "res2"),
                          axis=-1, name=p + "ln2")
    cls = sym.slice_axis(x, axis=1, begin=0, end=1, name="first")
    logits = sym.FullyConnected(cls, num_hidden=2, name="cls")
    if head == "infer":
        return sym.Group([x, logits])
    ce = sym.softmax_cross_entropy(logits, sym.var("label"), name="ce")
    return sym.MakeLoss(ce, normalization="batch", name="loss")


def sym_attention_routes(sym, heads: int = None):
    """Two graphs of one self-attention over GluonNLP's interleaved
    projection ``qkv`` (L, B, heads * 3 * D), every key valid: GluonNLP's
    ``interleaved_matmul_selfatt_qk`` -> ``softmax`` ->
    ``interleaved_matmul_selfatt_valatt``, and the same heads cut out and
    put through ``_contrib_flash_attention``; both give (L, B, heads * D).
    ``heads`` defaults to ``SYM_HEADS``."""
    heads = heads or SYM_HEADS
    qkv = sym.var("qkv")
    att = sym.softmax(sym._contrib_interleaved_matmul_selfatt_qk(
        qkv, heads=heads, name="qk"), axis=-1, name="att")
    gluonnlp = sym._contrib_interleaved_matmul_selfatt_valatt(
        qkv, att, heads=heads, name="valatt")
    parts = sym.reshape(sym.transpose(
        sym.reshape(qkv, shape=(0, 0, heads, 3, -1), name="heads"),
        axes=(1, 2, 3, 0, 4), name="heads_t"), shape=(-3, 0, 0, 0),
        name="parts")
    q, k, v = sym.split(parts, num_outputs=3, axis=1, squeeze_axis=True,
                        name="split")
    out = sym._contrib_flash_attention(q, k, v, name="flash")
    flash = sym.reshape(sym.transpose(
        sym.reshape(out, shape=(-4, -1, heads, 0, 0), name="out_b"),
        axes=(2, 0, 1, 3), name="out_t"), shape=(0, 0, -3), name="out")
    return gluonnlp, flash


def sym_mlp(sym, head: str):
    """Config #1's MLP (784-128 relu-64 relu-10) under one of the
    Module-era output layers, its label the variable ``label``."""
    x = sym.var("data")
    for i, n in enumerate((128, 64)):
        x = sym.Activation(sym.FullyConnected(x, num_hidden=n,
                                              name=f"fc{i + 1}"),
                           act_type="relu", name=f"relu{i + 1}")
    x = sym.FullyConnected(x, num_hidden=10, name="fc3")
    return getattr(sym, head)(x, sym.var("label"), name="head")


def encoder_batch(seed: int, batch: int, seq: int, units: int) -> tuple:
    """([features (B, L, units) ~ N(0, 1), lengths in [L / 2, L]],
    [labels 0/1]) as numpy arrays from ``seed``."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((batch, seq, units)).astype(np.float32)
    vl = g.integers(seq // 2, seq + 1, batch).astype(np.float32)
    y = g.integers(0, 2, batch).astype(np.float32)
    return [x, vl], [y]


def data_batch(arrays: tuple, ctx, dtype=None):
    """A ``DataBatch`` of (data, label) numpy lists on ``ctx``."""
    data, label = arrays
    return mx_io.DataBatch(
        data=[nd.array(a, ctx=ctx, dtype=dtype) for a in data],
        label=[nd.array(a, ctx=ctx, dtype=dtype) for a in label])


def encoder_module(symbol, ctx, batch: int, seq: int, units: int,
                   for_training: bool = True):
    mod = mx_mod.Module(symbol, data_names=("data", "valid_len"),
                        label_names=("label",) if for_training else (),
                        context=ctx)
    mod.bind(data_shapes=[("data", (batch, seq, units)),
                          ("valid_len", (batch,))],
             label_shapes=[("label", (batch,))] if for_training else None,
             for_training=for_training)
    return mod


def module_step(make, ctx, dtype, arg_params, arrays, opt,
                mode=None) -> tuple:
    """One ``forward_backward`` + ``update`` (SGD) of a fresh Module
    (``make(ctx)``) on ``ctx`` in ``dtype`` from ``arg_params``, the
    forward and backward under ``mode`` (a ``Decisions``; the binding's
    shape inference stays outside it): its outputs, gradients and updated
    weights, by name, on the CPU."""
    mod = make(ctx)
    mod.init_params(arg_params=arg_params)
    module_to(mod, dtype)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
    batch = data_batch(arrays, ctx, dtype)
    with mode if mode is not None else contextlib.nullcontext():
        mod.forward_backward(batch)
    outs = [o._data.detach().cpu().clone() for o in mod.get_outputs()]
    grads = {n: g._data.detach().cpu().clone()
             for n, g in mod._grad_params.items()}
    mod.update()
    return outs, grads, {n: a._data.detach().cpu().clone()
                         for n, a in mod._arg_params.items()}


def _brief(check: dict) -> dict:
    return {k: check[k] for k in ("ok", "leaves", "failed",
                                  "cpu_share_median", "worst_margin")}


def held_step(make, arg_params, arrays, opt, relu: bool = False,
              decisions=None) -> dict:
    """The same Module step on the card and on the CPU in fp32 and in
    float64, held leaf by leaf (``leaf_check``) on the gradients and the
    updated weights, the card's outputs within 1e-4 (x max(1, max|out|))
    of the CPU's.  With ``relu`` the CPU runs take the card's ReLU
    decisions (``Decisions``), or those of the ``decisions`` class,
    float64's own at most ``DECISION_FLIPS`` of them."""
    kind = decisions or Decisions
    held = relu or decisions is not None
    card = kind()
    runs = {"card": module_step(make, gpu(0), torch.float32, arg_params,
                                arrays, opt, card if held else None)}
    flips = {}
    for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        forced = kind(card.masks)
        runs[name] = module_step(make, cpu(), dtype, arg_params, arrays,
                                 opt, forced if held else None)
        flips[name] = forced.flips
    w0 = {n: arg_params[n]._data.detach().cpu() for n in runs["card"][1]}
    zeros = {n: torch.zeros_like(t) for n, t in w0.items()}
    grads = leaf_check(runs["card"][1], runs["cpu"][1], runs["cpu64"][1],
                       zeros)
    weights = leaf_check(runs["card"][2], runs["cpu"][2], runs["cpu64"][2],
                         w0)
    scale = max(1.0, max(o.abs().max().item() for o in runs["cpu"][0]))
    out_err = max((a - b).abs().max().item()
                  for a, b in zip(runs["card"][0], runs["cpu"][0]))
    return {"output_abs_err_vs_cpu": out_err, "relu_units": card.units,
            "relu_flips": flips, "grads": _brief(grads),
            "weights": _brief(weights),
            "ok": grads["ok"] and weights["ok"] and out_err <= 1e-4 * scale
            and flips["cpu64"] <= DECISION_FLIPS * max(card.units, 1)}


SYM_RANGES = {"flash_attention_backward": "flash_backward"}


def profiled_module_step(mod, batch) -> dict:
    """One more ``forward_backward`` + ``update`` under torch.profiler:
    device ms by class (the flash backward's torch ops by their range;
    the flash forward kernel under ``other``), the idle share of the
    step's wall time, and the host's kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    return _device_classes(prof, wall, SYM_RANGES) | {
        "host_launches": host_launches(prof)}


def encoder_train_run(seed: int) -> dict:
    """(a): the 12-layer encoder through ``Module`` (``bind`` ->
    ``init_params`` (N(0, 0.02)) -> ``init_optimizer("sgd", momentum)``
    -> ``forward_backward`` + ``update``), fp32, ``SYM_WARM`` warm and
    ``SYM_TIMED`` timed steps; then the leaf check of one step of a
    ``SYM_CHECK_LAYERS``-layer copy at the same widths.  Returns the
    trained module too (for (b) and (f))."""
    mx_random.seed(seed)
    mod = encoder_module(sym_encoder(mx_sym, SYM_LAYERS), gpu(0),
                         SYM_BATCH, SYM_SEQ, SYM_UNITS)
    mod.init_params(initializer=mx_init.Normal(0.02))
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SYM_OPT))
    batch = data_batch(encoder_batch(seed, SYM_BATCH, SYM_SEQ, SYM_UNITS),
                       gpu(0))
    torch.cuda.synchronize()
    zero_counts()
    losses, fwd_launches = [], []
    for step in range(SYM_WARM + SYM_TIMED):
        if step == SYM_WARM:
            torch.cuda.synchronize()
            t0 = time.monotonic()
        before = flash_attention.launches
        mod.forward(batch, is_train=True)
        fwd_launches.append(flash_attention.launches - before)
        mod.backward()
        mod.update()
        losses.append(mod.get_outputs()[0])
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / SYM_TIMED * 1e3
    launches = flash_attention.launches
    by_dtype = dict(flash_attention.launches_by_dtype)
    sgd = {w.__name__: w.launches for w in COUNTED if w is not
           flash_attention}
    other = other_launches(flash_attention)
    profile = profiled_module_step(mod, batch)
    losses = [float(o.asscalar()) for o in losses]
    steps = SYM_WARM + SYM_TIMED
    # the leaf check's copy: the first layers' widths, batch 2
    mx_random.seed(seed + 1)
    small = encoder_module(sym_encoder(mx_sym, SYM_CHECK_LAYERS), gpu(0),
                           SYM_CHECK_BATCH, SYM_SEQ, SYM_UNITS)
    small.init_params(initializer=mx_init.Normal(0.02))
    arg, _ = small.get_params()
    check = held_step(
        lambda ctx: encoder_module(sym_encoder(mx_sym, SYM_CHECK_LAYERS),
                                   ctx, SYM_CHECK_BATCH, SYM_SEQ,
                                   SYM_UNITS),
        arg, encoder_batch(seed + 2, SYM_CHECK_BATCH, SYM_SEQ, SYM_UNITS),
        SYM_OPT)
    checks = {"finite": all(math.isfinite(v) for v in losses),
              "flash_12_per_forward": fwd_launches == [SYM_LAYERS] * steps,
              "no_flash_in_backward": launches == SYM_LAYERS * steps,
              "flash_fp32": by_dtype[str(torch.float32)] == launches,
              "no_other_kernel": other == 0, "leaf_check": check["ok"]}
    return {"layers": SYM_LAYERS, "batch": SYM_BATCH, "seq": SYM_SEQ,
            "params": sum(a.size for a in mod.get_params()[0].values()),
            "step_ms": step_ms, "steps": steps, "losses": losses,
            "profile": profile,
            "flash_launches": launches, "flash_launches_per_forward":
                fwd_launches, "sgd_kernel_launches": sgd,
            "other_kernel_launches": other, "check": check,
            "checks": checks, "ok": all(checks.values()), "module": mod}


def _forward_ms(mod, batch, n: int) -> float:
    mod.forward(batch, is_train=False)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        mod.forward(batch, is_train=False)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / n * 1e3


def amp_encoder_run(seed: int, trained) -> dict:
    """(b): the trained encoder's inference graph (hidden states and
    logits) converted by ``amp.convert_model(..., "bfloat16")`` and bound
    for inference from the fp32 parameters, against the fp32 graph's
    forward: the inserted cast nodes, the flash launches by dtype, the
    relative L2 difference of each output, the forward times."""
    arg, aux = trained.get_params()
    infer = sym_encoder(mx_sym, SYM_LAYERS, head="infer")
    conv, carg, caux = amp.convert_model(infer, arg, aux, "bfloat16")
    ops = [n.op for n in conv._topo()]
    batch = data_batch(encoder_batch(seed + 3, SYM_BATCH, SYM_SEQ,
                                     SYM_UNITS), gpu(0))
    runs = {}
    for name, symbol, params in (("fp32", infer, arg), ("bf16", conv, carg)):
        mod = encoder_module(symbol, gpu(0), SYM_BATCH, SYM_SEQ, SYM_UNITS,
                             for_training=False)
        mod.init_params(arg_params=params, aux_params=aux)
        torch.cuda.synchronize()
        zero_counts()
        mod.forward(batch, is_train=False)
        outs = [o._data.float() for o in mod.get_outputs()]
        torch.cuda.synchronize()
        runs[name] = {"outs": outs, "launches": flash_attention.launches,
                      "by_dtype": dict(flash_attention.launches_by_dtype),
                      "other": other_launches(flash_attention),
                      "forward_ms": _forward_ms(mod, batch, 5),
                      "dtypes": [str(o.dtype) for o in mod.get_outputs()]}
        del mod
    rel = [((a - b).norm() / b.norm()).item() for a, b in
           zip(runs["bf16"]["outs"], runs["fp32"]["outs"])]
    checks = {
        "bf16_flash": runs["bf16"]["by_dtype"][str(torch.bfloat16)]
        == SYM_LAYERS == runs["bf16"]["launches"],
        "fp32_flash": runs["fp32"]["by_dtype"][str(torch.float32)]
        == SYM_LAYERS == runs["fp32"]["launches"],
        "no_other_kernel": runs["bf16"]["other"] == runs["fp32"]["other"]
        == 0,
        "params_fp32": all(v.dtype == np.float32 for v in carg.values()),
        "within_bound": all(r <= SYM_BF16_TOL for r in rel),
        "finite": all(bool(torch.isfinite(o).all())
                      for o in runs["bf16"]["outs"])}
    return {"amp_cast_nodes": ops.count("amp_cast"),
            "amp_multicast_nodes": ops.count("amp_multicast"),
            "nodes": len(ops), "rel_l2_vs_fp32": rel,
            "bound": SYM_BF16_TOL,
            "output_dtypes": runs["bf16"]["dtypes"],
            "flash_launches_by_dtype": {n: r["by_dtype"]
                                        for n, r in runs.items()},
            "forward_ms": {n: r["forward_ms"] for n, r in runs.items()},
            "checks": checks, "ok": all(checks.values())}


def attention_routes_run(seed: int) -> dict:
    """(c): GluonNLP's interleaved route and the flash route over one
    (L, B, 3 * 768) projection, every key valid, fp32."""
    g = np.random.default_rng(seed + 4)
    qkv = nd.array(g.standard_normal(
        (SYM_SEQ, SYM_BATCH, 3 * SYM_UNITS)).astype(np.float32), ctx=gpu(0))
    outs = {}
    for name, symbol in zip(("interleaved", "flash"),
                            sym_attention_routes(mx_sym)):
        zero_counts()
        exe = symbol.bind(gpu(0), args={"qkv": qkv}, grad_req="null")
        outs[name] = exe.forward()[0]._data
        outs[name + "_launches"] = flash_attention.launches
    torch.cuda.synchronize()
    err = (outs["interleaved"] - outs["flash"]).abs().max().item()
    checks = {"within_bound": err <= SYM_ROUTE_TOL,
              "shape": tuple(outs["flash"].shape)
              == (SYM_SEQ, SYM_BATCH, SYM_UNITS),
              "flash_once": outs["flash_launches"] == 1
              and outs["interleaved_launches"] == 0}
    return {"max_abs_err": err, "bound": SYM_ROUTE_TOL,
            "flash_launches": outs["flash_launches"],
            "interleaved_launches": outs["interleaved_launches"],
            "checks": checks, "ok": all(checks.values())}


def amp_lm_run(seed: int, trained: dict, out_dir: Path) -> dict:
    """(d): config #4's LM (``lm_sym_gen``) with phase 12's trained weights
    (``trained``: ``arg`` and ``aux`` as ``lm_phase`` returns them),
    every bucket's graph converted by ``amp.convert_model``, bound for
    inference in one ``BucketingModule``: the perplexity over one batch a
    bucket against the fp32 module's over the same batches, and the
    logits (the log of the softmax's output, centred over the vocabulary:
    the logits less their mean) by relative L2 against fp32's; the converted
    checkpoint (``save_checkpoint(..., remove_amp_cast=True)``) loaded
    back, its graph and parameters as saved."""
    arg, aux = trained["arg"], trained["aux"]

    def converted(key):
        sym, data_names, label_names = lm_sym_gen(key)
        return amp.convert_model(sym, arg, aux, "bfloat16")[0], \
            data_names, label_names

    it = lm_iter(seed + 5, 1500)
    batches = {}
    for b in it:
        batches.setdefault(b.bucket_key, b)
    ppl, casts, logits, rel = {}, {}, {}, {}
    for name, gen in (("fp32", lm_sym_gen), ("bf16", converted)):
        bmod = mx_mod.BucketingModule(gen, default_bucket_key=LM_BUCKETS[-1],
                                      context=gpu(0))
        shape = (LM_BATCH, LM_BUCKETS[-1])
        bmod.bind([("data", shape)], [("softmax_label", shape)],
                  for_training=False)
        bmod.init_params(arg_params=arg, aux_params=aux)
        m = metric.Perplexity(ignore_label=0)
        for key in sorted(batches):
            bmod.forward(batches[key], is_train=False)
            bmod.update_metric(m, batches[key].label)
            z = bmod.get_outputs()[0]._data.float().log()
            z = z - z.mean(-1, keepdim=True)
            if name == "fp32":
                logits[key] = z
            else:
                rel[key] = ((z - logits[key]).norm()
                            / logits[key].norm()).item()
        ppl[name] = m.get()[1]
        casts[name] = [n.op for n in gen(LM_BUCKETS[-1])[0]._topo()].count(
            "amp_cast")
    sym60 = converted(LM_BUCKETS[-1])[0]
    out_dir.mkdir(parents=True, exist_ok=True)
    prefix = str(out_dir / "lm_bf16")
    mx_model.save_checkpoint(prefix, 0, sym60, arg, aux,
                             remove_amp_cast=True)
    sym2, arg2, aux2 = mx_model.load_checkpoint(prefix, 0, ctx=cpu())
    round_trip = sym2.tojson() == sym60.tojson() and arg.keys() == \
        arg2.keys() and all(torch.equal(arg[k]._data.cpu(), arg2[k]._data)
                            for k in arg)
    for path in (f"{prefix}-symbol.json", f"{prefix}-0000.params"):
        os.remove(path)
    gap = abs(ppl["bf16"] - ppl["fp32"]) / ppl["fp32"]
    checks = {"within_bound": gap <= LM_BF16_RTOL,
              "logits_within_bound": max(rel.values()) <= LM_LOGIT_TOL,
              "finite": all(math.isfinite(v) for v in ppl.values())
              and all(math.isfinite(v) for v in rel.values()),
              "casts_inserted": casts["bf16"] > 0 == casts["fp32"],
              "checkpoint_round_trip": round_trip}
    return {"buckets": sorted(batches), "perplexity": ppl,
            "rel_gap": gap, "bound": LM_BF16_RTOL,
            "logits_rel_l2_by_bucket": rel, "logits_bound": LM_LOGIT_TOL,
            "amp_cast_nodes_at_60": casts["bf16"], "checks": checks,
            "ok": all(checks.values())}


def head_data(seed: int, n: int, head: str) -> tuple:
    """``n`` seeded 784-feature samples and a label for ``head``: an
    integer class for ``SVMOutput``, its one-hot row (B, 10) otherwise."""
    g = np.random.default_rng(seed)
    centers = g.standard_normal((10, 784)).astype(np.float32)
    y = g.integers(0, 10, n)
    x = (centers[y] + g.standard_normal((n, 784)).astype(np.float32))
    label = y.astype(np.float32) if head == "SVMOutput" else \
        np.eye(10, dtype=np.float32)[y]
    return x.astype(np.float32), label


def head_module(head: str, ctx):
    mod = mx_mod.Module(sym_mlp(mx_sym, head), data_names=("data",),
                        label_names=("label",), context=ctx)
    label_shape = (HEAD_BATCH,) if head == "SVMOutput" else (HEAD_BATCH, 10)
    mod.bind(data_shapes=[("data", (HEAD_BATCH, 784))],
             label_shapes=[("label", label_shape)])
    return mod


def heads_run(seed: int) -> dict:
    """(e): config #1's MLP under each Module-era output layer through
    ``Module.fit`` (SGD with momentum, ``HEAD_SAMPLES`` samples, batch
    ``HEAD_BATCH``, ``HEAD_EPOCHS`` epochs), ``score`` on a held-out set
    before and after (accuracy for ``SVMOutput``, MSE against the one-hot
    label otherwise: it must improve), and one step of each from the
    initial weights held against the CPU."""
    res = {}
    for i, head in enumerate(HEAD_OPS):
        x, y = head_data(seed + 10 + i, HEAD_SAMPLES + HEAD_HELD_OUT, head)
        train = mx_io.NDArrayIter(x[:HEAD_SAMPLES], y[:HEAD_SAMPLES],
                                  HEAD_BATCH, label_name="label")
        held = mx_io.NDArrayIter(x[HEAD_SAMPLES:], y[HEAD_SAMPLES:],
                                 HEAD_BATCH, label_name="label")
        metric_name = "acc" if head == "SVMOutput" else "mse"
        mx_random.seed(seed + 20 + i)
        mod = head_module(head, gpu(0))
        mod.init_params(initializer=Xavier())
        arg0, _ = mod.get_params()
        before = mod.score(held, metric_name)[0][1]
        zero_counts()
        t0 = time.monotonic()
        mod.fit(train, num_epoch=HEAD_EPOCHS, optimizer="sgd",
                optimizer_params=dict(HEAD_OPT), eval_metric=metric_name)
        torch.cuda.synchronize()
        fit_s = time.monotonic() - t0
        launches = other_launches()
        after = mod.score(held, metric_name)[0][1]
        check = held_step(lambda ctx, h=head: head_module(h, ctx), arg0,
                          ([x[:HEAD_BATCH]], [y[:HEAD_BATCH]]), HEAD_OPT,
                          relu=True)
        improved = after > before if metric_name == "acc" else \
            after < before
        res[head] = {"steps": HEAD_EPOCHS * HEAD_SAMPLES // HEAD_BATCH,
                     "fit_s": fit_s, "metric": metric_name,
                     "held_out_before": before, "held_out_after": after,
                     "kernel_launches": launches, "check": check,
                     "ok": check["ok"] and math.isfinite(after)
                     and improved}
    return res


def _tie_rules(x: np.ndarray) -> dict:
    """The JAX package's orders, in numpy: ``topk`` a stable sort of
    ``-x``; ``argsort`` descending the stable ascending sort flipped."""
    return {"topk": np.argsort(-x, axis=-1, kind="stable")[..., :3],
            "argsort": np.flip(np.argsort(x, axis=-1, kind="stable"), -1)}


def new_op_cases(g) -> list:
    """Each of the 43 ops this slice adds, once: (name, inputs as numpy
    arrays or (array, torch dtype), kwargs, whether to take the gradient
    of the first input)."""
    f = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    ties = np.array([[1, 3, 3, 2, 3, 1, 0, 3]] * 4, np.float32)
    nan = f(3, 4)
    nan[0, 1] = nan[2, 3] = np.nan
    labels = g.integers(0, 5, 4).astype(np.float32)
    d64 = (f(4, 64, 64), f(4, 64, 64), f(4, 64, 64),
           np.array([64, 40, 17, 1], np.float32))
    return [
        ("amp_cast", [f(4, 5)], {"dtype": "bfloat16"}, False),
        ("amp_multicast", [(f(4,), torch.bfloat16), (f(4,), torch.float16)],
         {"num_outputs": 2}, False),
        ("linalg_gemm2", [f(3, 4, 5), f(3, 5, 6)], {"alpha": 0.5}, True),
        ("shape_array", [f(2, 3, 4)], {}, False),
        ("size_array", [f(2, 3, 4)], {}, False),
        ("slice_like", [f(4, 5), f(2, 3)], {}, True),
        ("_basic_index", [f(4, 5, 6)],
         {"key": (("__slice__", 1, 3, None), 2)}, True),
        ("_advanced_index", [f(4, 5), np.array([0, 5, -1, -7], np.float32)],
         {}, True),
        ("gather_nd", [f(3, 4), np.array([[0, 5, -1, -9], [1, 9, -2, 2]],
                                         np.float32)], {}, True),
        ("scatter_nd", [f(5), np.array([[0, 2, 0, 7, -1]], np.float32)],
         {"shape": (6,)}, True),
        ("broadcast_axis", [f(1, 3)], {"axis": 0, "size": 4}, True),
        ("diag", [f(4, 4)], {"k": 1}, True),
        ("reshape_like", [f(2, 6), f(3, 4)], {}, True),
        ("cumsum", [f(3, 4)], {"axis": 1}, True),
        ("trace", [f(4, 4)], {}, True),
        ("tril", [f(4, 5)], {"k": 1}, True),
        ("triu", [f(4, 5)], {"k": -1}, True),
        ("depth_to_space", [f(1, 8, 2, 3)], {"block_size": 2}, True),
        ("space_to_depth", [f(1, 2, 4, 6)], {"block_size": 2}, True),
        ("identity", [f(3, 4)], {}, True),
        ("norm", [f(4, 5)], {"ord": 2, "axis": 1}, True),
        ("nansum", [nan], {"axis": 1}, False),
        ("nanprod", [nan], {"axis": 0}, False),
        ("argmax_channel", [f(3, 5, 2)], {}, False),
        ("topk", [ties], {"k": 3, "ret_typ": "both"}, False),
        ("sort", [ties], {"is_ascend": False}, False),
        ("argsort", [ties], {"is_ascend": False}, False),
        ("all_finite", [nan], {}, False),
        ("multi_all_finite", [f(3, 4), f(5)], {"num_arrays": 2}, False),
        ("softmax_cross_entropy", [f(4, 5), labels], {}, True),
        ("LinearRegressionOutput", [f(4, 5), f(4, 5)], {"grad_scale": 2.0},
         True),
        ("MAERegressionOutput", [f(4, 5), f(4, 5)], {}, True),
        ("LogisticRegressionOutput", [f(4, 5), f(4, 5)], {}, True),
        ("SVMOutput", [f(4, 5), labels], {"margin": 1.0}, True),
        ("MakeLoss", [f(4, 5)], {"normalization": "valid"}, True),
        ("SoftmaxActivation", [f(2, 3, 4)], {"mode": "channel"}, True),
        ("_contrib_interleaved_matmul_selfatt_qk", [f(6, 2, 3 * 2 * 8)],
         {"heads": 2}, True),
        ("_contrib_interleaved_matmul_selfatt_valatt",
         [f(6, 2, 3 * 2 * 8), f(4, 6, 6)], {"heads": 2}, True),
        ("_contrib_interleaved_matmul_encdec_qk",
         [f(5, 2, 2 * 8), f(6, 2, 2 * 2 * 8)], {"heads": 2}, True),
        ("_contrib_interleaved_matmul_encdec_valatt",
         [f(6, 2, 2 * 2 * 8), f(4, 5, 6)], {"heads": 2}, True),
        ("softmin", [f(3, 4)], {"axis": -1}, True),
        ("lars_update", [f(4, 5), f(4, 5)],
         {"lr": 0.1, "eta": 0.01, "wd": 1e-4}, False),
        ("_contrib_flash_attention", list(d64), {"scale": 0.125}, True)]


def _run_op(name, inputs, kwargs, grad: bool, dev) -> tuple:
    ts = [torch.as_tensor(a[0]).to(dev, a[1]) if isinstance(a, tuple)
          else torch.as_tensor(a).to(dev) for a in inputs]
    if grad:
        ts[0].requires_grad_()
    out = invoke(get_op(name), ts, kwargs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    g = None
    if grad:
        g, = torch.autograd.grad(sum(o.float().sum() for o in outs), ts[0])
    return [o.detach().cpu() for o in outs], g.cpu() if g is not None \
        else None


def new_ops_run(seed: int, grads: list) -> dict:
    """(f): each new op on the card against its CPU run (and gradient),
    exact where the op is (casts, shapes, indexing, orders, counts), else
    within ``OP_TOL``; the tie orders against the JAX package's rules;
    ``multi_all_finite`` over (a)'s gradients, 1 when clean and 0 with one
    ``inf`` written in, with no host read until the caller reads it."""
    g = np.random.default_rng(seed + 30)
    exact = {"amp_cast", "amp_multicast", "shape_array", "size_array",
             "slice_like", "_basic_index", "_advanced_index", "gather_nd",
             "scatter_nd", "broadcast_axis", "diag", "reshape_like",
             "tril", "triu", "depth_to_space", "space_to_depth",
             "identity", "argmax_channel", "topk", "sort", "argsort",
             "all_finite", "multi_all_finite", "MakeLoss"}
    rows, failed = {}, []
    zero_counts()
    flash_before = flash_attention.launches
    for name, inputs, kwargs, grad in new_op_cases(g):
        card_out, card_g = _run_op(name, inputs, kwargs, grad, gpu(0))
        cpu_out, cpu_g = _run_op(name, inputs, kwargs, grad, cpu())
        pairs = list(zip(card_out, cpu_out)) + (
            [(card_g, cpu_g)] if grad else [])
        err = max(((a.double() - b.double()).abs().nan_to_num(0.0).max()
                   .item() if a.numel() else 0.0) for a, b in pairs)
        scale = max(1.0, max(b.double().abs().nan_to_num(0.0).max().item()
                             if b.numel() else 0.0 for _, b in pairs))
        same = all(a.dtype == b.dtype and a.shape == b.shape
                   for a, b in pairs)
        tol = TOL[torch.float32] if name == "_contrib_flash_attention" \
            else OP_TOL
        ok = same and (err == 0.0 if name in exact else err <= tol * scale)
        rows[name] = {"max_abs_err": err, "exact": name in exact,
                      "dtype": str(card_out[0].dtype), "ok": ok}
        if name in ("topk", "argsort"):
            want = _tie_rules(np.asarray(inputs[0]))[name]
            got = card_out[-1].numpy().astype(np.int64)
            rows[name]["jax_rule"] = bool(np.array_equal(got, want))
            ok = ok and rows[name]["jax_rule"]
        if not ok:
            failed.append(name)
    flash_launches = flash_attention.launches - flash_before
    # multi_all_finite over (a)'s gradients: one host read, the caller's
    eng = mx_engine.engine()
    reads0 = eng.host_reads
    clean = nd.multi_all_finite(*grads, num_arrays=len(grads))
    reads_before_read = eng.host_reads - reads0
    clean_v = clean.asscalar()
    saved = grads[-1]._data.view(-1)[0].clone()
    grads[-1]._data.view(-1)[0] = math.inf
    dirty = nd.multi_all_finite(*grads, num_arrays=len(grads))
    reads_dirty = eng.host_reads - reads0
    dirty_v = dirty.asscalar()
    grads[-1]._data.view(-1)[0] = saved
    finite = {"arrays": len(grads), "clean": clean_v, "with_inf": dirty_v,
              "host_reads_before_reading": [reads_before_read,
                                            reads_dirty - 1],
              "ok": clean_v == 1.0 and dirty_v == 0.0
              and reads_before_read == 0 and reads_dirty == 1}
    return {"ops": len(rows), "rows": rows, "failed": failed,
            "flash_launches": flash_launches, "multi_all_finite": finite,
            "ok": not failed and len(rows) == 43 and finite["ok"]
            and flash_launches == 1}


def symbolic_phase(seed: int, card: str, out_dir: Path,
                   lm_trained: dict) -> dict:
    """Phase 19: (a)-(f), each with the counts zeroed just before it;
    ``lm_trained`` is phase 12's LM (``lm_phase(...)["trained"]``)."""
    start = time.monotonic()
    seconds = {}
    t0 = time.monotonic()
    train = encoder_train_run(seed)
    trained = train.pop("module")
    seconds["encoder_train"] = time.monotonic() - t0
    res = {"card": card, "encoder_train": train}
    for key, fn in (("amp_encoder", lambda: amp_encoder_run(seed, trained)),
                    ("attention_routes", lambda: attention_routes_run(seed)),
                    ("amp_lm", lambda: amp_lm_run(seed, lm_trained, out_dir)),
                    ("heads", lambda: heads_run(seed))):
        t0 = time.monotonic()
        res[key] = fn()
        seconds[key] = time.monotonic() - t0
    t0 = time.monotonic()
    grads = [g for g in trained._exec_group.execs[0].grad_arrays
             if g is not None]
    res["new_ops"] = new_ops_run(seed, grads)
    seconds["new_ops"] = time.monotonic() - t0
    del trained, grads
    gc.collect()
    torch.cuda.empty_cache()
    res.update(seconds=time.monotonic() - start, part_seconds=seconds)
    res["ok"] = all(res[k]["ok"] for k in (
        "encoder_train", "amp_encoder", "attention_routes", "amp_lm",
        "new_ops")) and all(r["ok"] for r in res["heads"].values())
    return res


# ----------------------------------------------------------------------
# Phase 20: MXNet's export seam on the card.  ResNet-50 v1 trained a few
# steps, Parameter.data()/grad() read as NDArrays, HybridBlock.export,
# SymbolBlock.imports, ModelServer.from_exported and load_checkpoint +
# Module over the same files; then config #1's MLP exported and served,
# its served logits through the softmax_rtc custom op on NDArrays.

EXPORT_STEPS = 3
EXPORT_REQUESTS = 64
EXPORT_BUCKETS = (1, 8, 32)            # batch buckets; the largest is 32
# the logits' bound against the Gluon forward, x max(1, max |logit|): 12x
# the largest reading on an H100 (8.1e-7, served at batches 32 and 8)
EXPORT_TOL = 1e-5
EXPORT_DIR = "export_phase"


def _rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Max-abs difference over ``max(1, max |ref|)``."""
    a, ref = a.float().cpu(), ref.float().cpu()
    return (a - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def serve_exported(srv, images: np.ndarray) -> dict:
    """Every row of ``images`` as one request through ``srv`` (started
    here, after ``warmup`` of every batch bucket), in two rounds
    (``serve_round``): the first replays each bucket's graph for the
    first time; the second is timed.  Its figures, with its answers
    stacked, and the first round's wall time and latencies."""
    reqs = [(img,) for img in images]
    try:
        t0 = time.monotonic()
        srv.warmup(images[0])
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        srv.start()
        first = serve_round(srv, reqs)
        timed = serve_round(srv, reqs)
        executables = srv.stats()["executables"]
    finally:
        srv.stop()
    del first["results"]
    answers = torch.as_tensor(np.stack(timed.pop("results")))
    return timed | {"warmup_s": warm_s, "executables": executables,
                    "first_round": first, "answers": answers}


def export_phase(seed: int, card: str, out_dir: Path) -> dict:
    """Phase 20 (a)-(e); the counts are zeroed just before each part."""
    from mxnet_tpu_torch.gluon import SymbolBlock
    start = time.monotonic()
    dev = gpu(0)
    path = out_dir / EXPORT_DIR
    path.mkdir(parents=True, exist_ok=True)
    checks, res = {}, {"card": card}

    # (a) three momentum-SGD steps, the NDArray reads, export
    net = resnet50_v1(classes=1000)
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    x = torch.randn(RESNET_BATCH, 3, 224, 224, device=dev, generator=gen)
    y = torch.randint(0, 1000, (RESNET_BATCH,), device=dev,
                      generator=gen).float()
    xe = torch.randn(RESNET_BATCH, 3, 224, 224, device=dev, generator=gen)
    params = net.collect_params()
    trainer = gluon.Trainer(params, "sgd", RESNET_OPT)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainable = [p for p in params.values() if p.grad_req != "null"]
    torch.cuda.synchronize()
    zero_counts()
    losses = []
    for _ in range(EXPORT_STEPS):
        with autograd.record():
            loss = lossfn(net(x), y)
        autograd.backward(loss)
        trainer.step(RESNET_BATCH)
        losses.append(loss.detach().mean())
    torch.cuda.synchronize()
    launches = multi_sgd_mom.launches
    expected = -(-len(trainable) // AGG) * EXPORT_STEPS
    checks["a_launches"] = launches == expected and \
        other_launches(multi_sgd_mom) == 0
    losses = [v.item() for v in losses]
    checks["a_losses_finite"] = all(math.isfinite(v) for v in losses)
    w_param, g_param = net.features[0].weight, net.output.weight
    w, g = w_param.data(), g_param.grad()
    checks["a_ndarray_reads"] = (
        isinstance(w, nd.NDArray) and isinstance(g, nd.NDArray)
        and w.context == dev and g.context == dev
        and _bitwise([w._data.detach()], [w_param._tensor().detach()])
        and _bitwise([g._data], [g_param._grad_tensor()])
        and np.array_equal(w.asnumpy(), w_param._tensor().detach().cpu()
                           .numpy())
        and w_param.list_ctx() == [dev])
    t0 = time.monotonic()
    sym_file, param_file = net.export(str(path / "resnet50_v1"))
    export_s = time.monotonic() - t0
    arg_keys = [k for k in nd.load(param_file, ctx=cpu())]
    checks["a_export_keys"] = len(arg_keys) == len(params) and all(
        k.startswith("arg:") for k in arg_keys)
    with torch.no_grad(), autograd.predict_mode():
        ref = net(xe)
    torch.cuda.synchronize()
    res["train"] = {
        "batch": RESNET_BATCH, "steps": EXPORT_STEPS, "losses": losses,
        "launches": launches, "expected_launches": expected,
        "trainable_params": len(trainable),
        "ndarray_reads": {"weight": w_param.name, "grad": g_param.name,
                          "dtype": str(w.dtype), "context": str(w.context)},
        "export_s": export_s, "param_entries": len(arg_keys),
        "files_bytes": {f: os.path.getsize(f)
                        for f in (sym_file, param_file)}}
    del trainer, g, w
    gc.collect()

    # (b) SymbolBlock.imports on the card, its forward vs the Gluon one
    zero_counts()
    t0 = time.monotonic()
    sb = SymbolBlock.imports(sym_file, "data", param_file, ctx=dev)
    import_s = time.monotonic() - t0
    with torch.no_grad(), autograd.predict_mode():
        imported = sb(xe)
    torch.cuda.synchronize()
    imp_err = _rel_err(imported, ref)
    checks["b_imported"] = imp_err <= EXPORT_TOL and \
        sb.collect_params()[w_param.name]._tensor().device == dev and \
        bool(torch.isfinite(imported).all())
    res["imported"] = {
        "import_s": import_s, "max_abs_err": (imported - ref).abs().max()
        .item(), "rel_err": imp_err, "ref_max_abs": ref.abs().max().item(),
        "params": len(sb.collect_params()),
        "arguments": len(mx_sym.load(sym_file).list_arguments())}

    # (c) ModelServer.from_exported: 64 single-image requests
    srv = ModelServer.from_exported(
        sym_file, "data", param_file, ctx=dev, max_batch=EXPORT_BUCKETS[-1],
        batch_buckets=EXPORT_BUCKETS, queue_depth=4 * EXPORT_REQUESTS,
        deadline_ms=0, workers=2, batch_window_us=5000)
    images = xe[:EXPORT_REQUESTS].cpu().numpy()
    served = serve_exported(srv, images)
    answers = served.pop("answers")
    serve_err = _rel_err(answers, ref[:EXPORT_REQUESTS])
    served_vs_imported = _rel_err(answers, imported[:EXPORT_REQUESTS])
    checks["c_served"] = serve_err <= EXPORT_TOL and \
        served["executables"] == len(EXPORT_BUCKETS)
    res["served"] = served | {
        "requests": EXPORT_REQUESTS, "batch_buckets": list(EXPORT_BUCKETS),
        "rel_err": serve_err, "rel_err_vs_imported": served_vs_imported,
        "graphs": srv._block.graph_stats()["graphs"]}
    del srv
    gc.collect()

    # (d) load_checkpoint + Module for inference on the same files
    symbol, arg, aux = mx_model.load_checkpoint(str(path / "resnet50_v1"),
                                                0, ctx=dev)
    mod = mx_mod.Module(symbol, data_names=["data"], label_names=None,
                        context=dev)
    mod.bind(data_shapes=[("data", tuple(xe.shape))], for_training=False)
    mod.set_params(arg, aux, allow_extra=True)
    mod.forward(mx_io.DataBatch([nd.NDArray(xe)]), is_train=False)
    out = mod.get_outputs()[0]._data
    torch.cuda.synchronize()
    mod_err = _rel_err(out, ref)
    checks["d_module"] = mod_err <= EXPORT_TOL and len(aux) == 0 and \
        len(arg) == len(params)
    res["module"] = {"rel_err": mod_err,
                     "rel_err_vs_imported": _rel_err(out, imported),
                     "bitwise_imported": _bitwise([out], [imported]),
                     "arg_params": len(arg), "aux_params": len(aux)}
    checks["bcd_no_kernels"] = other_launches() == 0
    del mod, arg, aux, sb, imported, out, net, x, xe, ref
    gc.collect()
    torch.cuda.empty_cache()

    # (e) config #1's MLP exported and served; its logits through the
    # softmax_rtc custom op, on NDArrays
    mlp = mlp_net(dev, seed=seed)
    mlp_sym, mlp_params = mlp.export(str(path / "mlp"))
    rng = np.random.RandomState(seed + 20)
    feats = rng.standard_normal((EXPORT_REQUESTS, 784)).astype(np.float32)
    with torch.no_grad(), autograd.predict_mode():
        mlp_ref = mlp(torch.as_tensor(feats, device=dev))
    srv = ModelServer.from_exported(
        mlp_sym, "data", mlp_params, ctx=dev, max_batch=EXPORT_BUCKETS[-1],
        batch_buckets=EXPORT_BUCKETS, queue_depth=4 * EXPORT_REQUESTS,
        deadline_ms=0, workers=2, batch_window_us=5000)
    mlp_served = serve_exported(srv, feats)
    logits = mlp_served.pop("answers")
    mlp_err = _rel_err(logits, mlp_ref)
    labels = rng.randint(0, 10, EXPORT_REQUESTS).astype(np.float32)
    rtc_modules()
    zero_counts()
    probs = nd.Custom(nd.array(logits.numpy(), ctx=dev),
                      nd.array(labels, ctx=dev), op_type="softmax_rtc")
    torch.cuda.synchronize()
    rtc_launches = {k: _RTC[k].launches for k in ("softmax_fwd",
                                                  "softmax_bwd")}
    rtc_err = (probs._data.cpu() - softmax_plain(logits)).abs().max().item()
    checks["e_mlp_served"] = mlp_err <= EXPORT_TOL and \
        mlp_served["executables"] == len(EXPORT_BUCKETS)
    checks["e_rtc_on_ndarrays"] = isinstance(probs, nd.NDArray) and \
        rtc_launches == {"softmax_fwd": 1, "softmax_bwd": 0} and \
        rtc_err <= SOFTMAX_TOL and \
        sum(w.launches for w in COUNTED) == 0
    res["mlp"] = mlp_served | {"rel_err": mlp_err,
                               "rtc_launches": rtc_launches,
                               "rtc_max_abs_err": rtc_err}
    del srv, mlp
    gc.collect()
    torch.cuda.empty_cache()
    # the parameter files (ResNet-50's 102 MB) go; the graphs stay
    for f in (param_file, mlp_params):
        os.remove(f)
    res.update(checks=checks, seconds=time.monotonic() - start,
               ok=all(checks.values()))
    return res


# ----------------------------------------------------------------------
# Phase 21: the rest of the op files on the card.  (a) every deterministic
# op of the slice against its CPU run at realistic sizes, (b) the draws'
# moments, reseeding, shuffle, multinomial and a draw inside a captured
# graph, (c) a spatial transformer in front of ResNet-50 v1 (config #2)
# trained at batch 128, (d) a batched Gaussian-process likelihood fitted
# through linalg_potrf, linalg_trsm and linalg_sumlogdiag in fp64 and fp32.

# the deterministic ops of ops_tail (44), ops_misc (46), ops_linalg (17)
# and ops_spatial (6) this slice ports; the draws of ops_random (19)
SLICE_OPS = (
    "erfc", "bessel_i0", "bessel_i1", "bessel_i0e", "bessel_i1e", "erfcinv",
    "polygamma", "gammainc", "gammaincc", "zeta", "gelu", "log_sigmoid",
    "mish", "silu", "hard_swish", "isnan", "isinf", "isfinite", "isposinf",
    "isneginf", "copysign", "gcd", "lcm", "heaviside", "ldexp", "logaddexp",
    "interp", "nan_to_num", "cumprod", "logsumexp", "bincount", "digitize",
    "searchsorted", "ediff1d", "trapz", "einsum", "roll", "rot90",
    "tensordot", "vander", "meshgrid", "kron", "masked_softmax",
    "masked_log_softmax",
    "add_n", "IdentityAttachKLSparseReg", "_random_pdf_uniform",
    "_random_pdf_normal", "_random_pdf_gamma", "_random_pdf_exponential",
    "_random_pdf_poisson", "_random_pdf_negative_binomial",
    "_random_pdf_generalized_negative_binomial", "_random_pdf_dirichlet",
    "_contrib_fft", "_contrib_ifft", "_contrib_boolean_mask",
    "_contrib_arange_like", "_contrib_quadratic",
    "_contrib_gradientmultiplier", "Crop", "im2col", "col2im", "histogram",
    "choose_element_0index", "fill_element_0index", "split_v2",
    "_contrib_hawkesll", "_square_sum", "_hypot", "_hypot_scalar",
    "_logical_and", "_logical_or", "_logical_xor", "_zeros", "_ones",
    "_full", "_arange", "_linspace", "_eye", "_slice_assign",
    "_slice_assign_scalar", "_onehot_encode", "_scatter_set_nd", "_copyto",
    "_set_value", "_identity_with_attr_like_rhs", "_rnn_param_concat",
    "round_ste", "sign_ste",
    "linalg_gemm", "linalg_potrf", "linalg_potri", "linalg_trsm",
    "linalg_trmm", "linalg_syrk", "linalg_gelqf", "linalg_sumlogdiag",
    "linalg_extractdiag", "linalg_makediag", "linalg_extracttrian",
    "linalg_maketrian", "linalg_inverse", "linalg_det", "linalg_slogdet",
    "linalg_syevd", "khatri_rao",
    "GridGenerator", "BilinearSampler", "SpatialTransformer", "batch_take",
    "_ravel_multi_index", "_unravel_index")
SLICE_DRAWS = (
    "_random_gamma", "_random_exponential", "_random_poisson",
    "_random_negative_binomial", "_random_generalized_negative_binomial",
    "_random_uniform_like", "_random_normal_like", "_random_gamma_like",
    "_random_exponential_like", "_random_poisson_like", "_sample_uniform",
    "_sample_normal", "_sample_gamma", "_sample_exponential",
    "_sample_poisson", "_sample_negative_binomial",
    "_sample_generalized_negative_binomial", "_sample_multinomial",
    "_shuffle")
OP_ACT = (8, 512, 768)          # a BERT-base activation
OP_SCORES = (8, 12, 512, 512)   # BERT-base's attention scores
OP_SPD = (64, 256)              # 64 SPD matrices of 256 x 256
OP_IMG = (128, 3, 224, 224)     # ResNet-50's input
OP_COL = (128, 256, 56, 56)     # ResNet-50's stage-2 activation
OP_ROWS = 1024                  # MLM rows over the vocabulary
OP_CLASSES = 1000
# card vs CPU by family (``_pair_err``): each output element by element
# (|card - CPU| / max(1, |CPU|)), or, for the families in SLICE_SCALED
# and for every gradient (a sum over the outputs an input reaches), the
# largest |card - CPU| over max(1, max |CPU|); "cancel": the gradient of a
# sum of log-softmax rows is 1 - n p, n ~ 410 kept keys, whose fp32
# rounding the CPU's own fp32 run already shows 8.9e-5 from float64.  Set
# 4-40x above an H100's largest readings: elementwise 9.9e-7, special
# 2.7e-5, contraction 1.7e-6, cancel 1.2e-4, linalg fp32 2.1e-4, float64
# 2.8e-14, spatial 5.5e-7
SLICE_TOL = {"exact": 0.0, "elementwise": 1e-5, "special": 1e-4,
             "contraction": 1e-5, "cancel": 5e-4, "linalg32": 1e-3,
             "linalg64": 1e-12, "spatial": 1e-5}
SLICE_SCALED = ("contraction", "linalg32", "linalg64", "spatial")
DRAWS = 1 << 22
DRAW_SIGMAS = 6.0
STN_BATCH, STN_SIZE, STN_STEPS, STN_HYBRID_STEPS = 128, 224, 3, 3
STN_CHECK = 2
STN_SCALE, STN_DEGREES = 0.9, 10.0
STN_LOC_LR_MULT = 1e-4      # the loc net's rate, of the base (Jaderberg et al.)
STN_BODY = "resnet50_v1"
GP = {"problems": 16, "points": 1024, "dims": 8, "steps": 20, "lr": 0.05,
      "init": (0.0, 0.0, math.log(0.3))}   # log length, signal, noise
GP_TOL64, GP_TOL32 = 1e-12, 2e-5      # card vs the CPU's float64 fit


def _launch_total() -> int:
    return sum(w.launches for w in COUNTED) + rtc.launches


class SamplerDecisions(ZooDecisions):
    """``ZooDecisions``, and the spatial sampler's floors
    (``ops_spatial.bilinear_sample``'s ``torch.floor`` calls): recorded on
    one run and handed to another, where a floor of its own that differs
    counts as a flip.  A sample point within rounding of a pixel's edge
    can floor either way on two devices; the value is continuous there,
    its gradient in the grid is not."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.floor:
            return super().__torch_function__(func, types, args, kwargs)
        own = func(*args, **kwargs)
        self.units += own.numel()
        if self._forced is None:
            self.masks.append(own.detach())     # a floor's gradient is 0
            return own
        want = self._take().to(own.device, own.dtype)
        self.flips += int((own != want).sum())
        return want


def _orthogonal(g, b: int, n: int) -> torch.Tensor:
    q, r = torch.linalg.qr(torch.randn(b, n, n, generator=g,
                                       dtype=torch.float64))
    return q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None]


def slice_spd(g, b: int, n: int) -> torch.Tensor:
    """``b`` SPD matrices ``Q diag(l) Q^T`` in float64, eigenvalues
    ``exp(linspace(-1, 1, n))`` scaled by up to 1 %: determinant near 1,
    condition number near e**2, eigenvalues apart."""
    q = _orthogonal(g, b, n)
    lam = torch.exp(torch.linspace(-1.0, 1.0, n, dtype=torch.float64)) * (
        1 + 0.01 * torch.rand(b, n, generator=g, dtype=torch.float64))
    return (q * lam[:, None]) @ q.transpose(1, 2)


def stn_affine() -> list:
    """The STN's starting affine: scale ``STN_SCALE``, rotation
    ``STN_DEGREES``."""
    a = math.radians(STN_DEGREES)
    c, s = STN_SCALE * math.cos(a), STN_SCALE * math.sin(a)
    return [c, -s, 0.0, s, c, 0.0]


def _blind_pair(outs):
    """``sum(w * w) + sum(W * U**2)`` of ``syevd``'s ``(U, w)`` (or
    ``gelqf``'s ``(Q, L)``): blind to each eigenvector's sign."""
    u, w = outs
    weight = torch.linspace(0.5, 1.5, u.numel(), dtype=u.dtype,
                            device=u.device).reshape(u.shape)
    return (weight * u * u).sum() + (w * w).sum()


def _aligned(outs, ref):
    """``outs`` of ``syevd``/``gelqf`` with each row of the first (column
    of ``gelqf``'s second) flipped to ``ref``'s sign."""
    sign = torch.sign((outs[0] * ref[0]).sum(-1, keepdim=True))
    second = outs[1] if outs[1].dim() < outs[0].dim() else \
        outs[1] * sign.transpose(-1, -2)
    return [outs[0] * sign, second]


def slice_op_cases(seed: int) -> list:
    """One case of each op in ``SLICE_OPS`` (the linalg ops in fp32 and in
    float64) at the sizes of the models that run them: (row, op, inputs
    as CPU tensors, kwargs, family, gradient: False, True (the first
    input), an input's index, or a function of the outputs)."""
    g = torch.Generator().manual_seed(seed + 21)
    f = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(  # noqa: E731
        s, generator=g)
    ints = lambda lo, hi, *s: torch.randint(  # noqa: E731
        lo, hi, s, generator=g, dtype=torch.int32)
    b, s, h = OP_ACT
    act, act2 = f(*OP_ACT), f(*OP_ACT)
    odd = act.clone()
    flat = odd.view(-1)
    flat[::97], flat[::89], flat[::83] = math.nan, math.inf, -math.inf
    holes = act.clone()
    holes.view(-1)[::7] = 0.0
    rows = act.reshape(b * s, h)
    counts = ints(0, 8, *OP_ACT).float()
    par = lambda lo, hi: u(lo, hi, b, s)  # noqa: E731
    expo = -torch.log(torch.rand(b * s // 4, 8, 16, generator=g))
    simplex = expo / expo.sum(-1, keepdim=True)      # Dirichlet(1, ..., 1)
    img = f(*OP_IMG)
    theta = torch.tensor(stn_affine()) + 0.02 * f(OP_IMG[0], 6)
    grid = ops_spatial.affine_grid(theta, *OP_IMG[2:])
    col_in = f(*OP_COL)
    cols = get_op("im2col").get_fn({"kernel": (3, 3), "pad": (1, 1)})(
        col_in)
    logits = f(OP_ROWS, VOCAB)
    labels = ints(0, VOCAB, OP_ROWS).float()
    n_ev = 128
    hawkes = [u(0.2, 1.0, 256, 8), u(0.1, 0.5, 8), u(0.5, 2.0, 8),
              u(0.0, 0.5, 256, 8), u(0.01, 0.2, 256, n_ev),
              ints(0, 8, 256, n_ev).float(), ints(n_ev // 2, n_ev + 1,
                                                  256).float(),
              u(12.0, 20.0, 256)]
    n_set = min(1000, b * s * h // 2)
    scatter_at = torch.randperm(b * s * h, generator=g)[:n_set]
    scatter_idx = torch.stack(torch.unravel_index(scatter_at, OP_ACT)) \
        .float()
    E, S, C, X, P = ("elementwise", "special", "contraction", "exact",
                     "spatial")
    cases = [
        ("erfc", [act], {}, E, True),
        ("bessel_i0", [2 * act], {}, S, True),
        ("bessel_i1", [2 * act], {}, S, True),
        ("bessel_i0e", [2 * act], {}, S, True),
        ("bessel_i1e", [2 * act], {}, S, True),
        ("erfcinv", [u(0.05, 1.95, *OP_ACT)], {}, S, True),
        ("polygamma", [u(0.5, 3, *OP_ACT)], {"n": 1}, S, True),
        ("gammainc", [u(0.5, 3, *OP_ACT), u(0.1, 3, *OP_ACT)], {}, S, True),
        ("gammaincc", [u(0.5, 3, *OP_ACT), u(0.1, 3, *OP_ACT)], {}, S,
         True),
        ("zeta", [u(1.5, 4, *OP_ACT), u(0.5, 3, *OP_ACT)], {}, S, True),
        ("gelu", [act], {"approximation": "tanh"}, E, True),
        ("log_sigmoid", [4 * act], {}, E, True),
        ("mish", [4 * act], {}, E, True),
        ("silu", [4 * act], {}, E, True),
        ("hard_swish", [4 * act], {}, E, True),
        ("isnan", [odd], {}, X, False),
        ("isinf", [odd], {}, X, False),
        ("isfinite", [odd], {}, X, False),
        ("isposinf", [odd], {}, X, False),
        ("isneginf", [odd], {}, X, False),
        ("copysign", [act, act2], {}, X, True),
        ("gcd", [ints(-1000, 1000, *OP_ACT), ints(1, 1000, *OP_ACT)], {}, X,
         False),
        ("lcm", [ints(-1000, 1000, *OP_ACT), ints(1, 1000, *OP_ACT)], {}, X,
         False),
        ("heaviside", [holes, act2], {}, X, 1),
        ("ldexp", [act, u(-3, 3, *OP_ACT)], {}, E, True),
        ("logaddexp", [act, act2], {}, E, True),
        ("interp", [act, torch.sort(u(-3, 3, 1000)).values, f(1000)], {}, E,
         True),
        ("nan_to_num", [odd], {}, X, True),
        ("cumprod", [u(0.99, 1.01, *OP_ACT)], {"axis": -1}, C, True),
        ("logsumexp", [act], {"axis": -1}, C, True),
        ("bincount", [ints(0, VOCAB, b * s)], {}, X, False),
        ("digitize", [act, torch.linspace(-3, 3, 101)], {}, X, False),
        ("searchsorted", [torch.linspace(-3, 3, 101), act], {}, X, False),
        ("ediff1d", [act], {}, E, True),
        ("trapz", [act], {"dx": 0.5}, C, True),
        ("einsum", [act, f(h, h) / math.sqrt(h)],
         {"subscripts": "bsh,hk->bsk"}, C, True),
        ("roll", [act], {"shift": 7, "axis": 1}, X, True),
        ("rot90", [act], {"axes": (1, 2)}, X, True),
        ("tensordot", [act, f(h, h) / math.sqrt(h)], {"axes": 1}, C, True),
        ("vander", [u(-1, 1, h)], {"N": 8}, C, True),
        ("meshgrid", [f(s), f(h)], {}, X, True),
        ("kron", [f(64, 64), f(12, 12)], {}, C, True),
        ("masked_softmax", [f(*OP_SCORES) / 8, (u(0, 1, b, 1, 1, s) > 0.2)
                            .float()], {}, E, True),
        ("masked_log_softmax", [f(*OP_SCORES) / 8,
                                (u(0, 1, b, 1, 1, s) > 0.2).float()], {},
         "cancel", True),
        ("add_n", [act, act2, holes], {}, E, True),
        ("IdentityAttachKLSparseReg", [rows],
         {"sparseness_target": 0.1, "penalty": 1e-3}, E, True),
        ("_random_pdf_uniform", [u(-1, 1, *OP_ACT), par(-1.5, -1.0),
                                 par(1.0, 2.0)], {}, S, 1),
        ("_random_pdf_normal", [act, par(-1, 1), par(0.5, 2)],
         {"is_log": True}, S, True),
        ("_random_pdf_gamma", [u(0.1, 3, *OP_ACT), par(0.5, 3),
                               par(0.5, 2)], {}, S, True),
        ("_random_pdf_exponential", [u(0.1, 3, *OP_ACT), par(0.5, 2)], {},
         S, True),
        ("_random_pdf_poisson", [counts, par(0.5, 4)], {"is_log": True}, S,
         1),
        ("_random_pdf_negative_binomial", [counts, par(1, 4),
                                           par(0.2, 0.8)], {}, S, 1),
        ("_random_pdf_generalized_negative_binomial",
         [counts, par(1, 4), par(0.2, 1.5)], {"is_log": True}, S, 1),
        ("_random_pdf_dirichlet", [simplex, u(0.5, 3, b * s // 4, 16)], {},
         S, True),
        ("_contrib_fft", [rows], {}, C, True),
        ("_contrib_ifft", [f(b * s, 2 * h)], {}, C, True),
        ("_contrib_boolean_mask", [rows, (u(0, 1, b * s) > 0.3).float()],
         {}, X, True),
        ("_contrib_arange_like", [act], {"axis": 1}, X, False),
        ("_contrib_quadratic", [act], {"a": 0.5, "b": -1.0, "c": 2.0}, E,
         True),
        ("_contrib_gradientmultiplier", [act], {"scalar": -0.5}, X, True),
        ("Crop", [img], {"h_w": (200, 200), "center_crop": True}, X, True),
        ("im2col", [col_in], {"kernel": (3, 3), "pad": (1, 1)}, X, True),
        ("col2im", [cols], {"output_size": OP_COL[2:], "kernel": (3, 3),
                            "pad": (1, 1)}, C, True),
        ("histogram", [act], {"bin_cnt": 20}, E, False),
        ("choose_element_0index", [logits, labels], {}, X, True),
        ("fill_element_0index", [logits, f(OP_ROWS), labels], {}, X, True),
        ("split_v2", [act], {"sections": 12, "axis": -1}, X, True),
        ("_contrib_hawkesll", hawkes, {}, E, True),
        ("_square_sum", [act], {"axis": -1}, C, True),
        ("_hypot", [act, act2], {}, E, True),
        ("_hypot_scalar", [act, torch.tensor(1.5)], {}, E, True),
        ("_logical_and", [holes, act2], {}, X, False),
        ("_logical_or", [holes, torch.zeros(OP_ACT)], {}, X, False),
        ("_logical_xor", [holes, act2], {}, X, False),
        ("_zeros", [], {"shape": OP_ACT}, X, False),
        ("_ones", [], {"shape": OP_ACT, "dtype": "int32"}, X, False),
        ("_full", [], {"shape": OP_ACT, "value": 2.5}, X, False),
        ("_arange", [], {"start": 0.0, "stop": float(VOCAB)}, X, False),
        ("_linspace", [], {"start": -1.0, "stop": 1.0, "num": STN_SIZE}, X,
         False),
        ("_eye", [], {"N": h}, X, False),
        ("_slice_assign", [act, act2[:, :s // 2]],
         {"begin": (None, s // 2), "end": (None, s)}, X, True),
        ("_slice_assign_scalar", [act],
         {"begin": (0, 0), "end": (b, s), "step": (1, 2), "scalar": 0.0}, X,
         True),
        ("_onehot_encode", [ints(0, OP_CLASSES, OP_IMG[0]).float(),
                            torch.zeros(OP_IMG[0], OP_CLASSES)], {}, X,
         False),
        ("_scatter_set_nd", [act, f(n_set), scatter_idx], {}, X, False),
        ("_copyto", [act], {}, X, True),
        ("_set_value", [act], {"src": 3.0}, X, False),
        ("_identity_with_attr_like_rhs", [act, act2], {}, X, True),
        ("_rnn_param_concat", [f(2600, 650), f(2600, 650), f(2600),
                               f(2600)], {"num_args": 4}, X, True),
        ("round_ste", [3 * act], {}, X, True),
        ("sign_ste", [holes], {}, X, True),
        ("GridGenerator", [theta], {"target_shape": OP_IMG[2:]}, P, True),
        ("BilinearSampler", [img, grid], {}, P, 1),
        ("SpatialTransformer", [img, theta], {"target_shape": OP_IMG[2:]},
         P, 1),
        ("batch_take", [f(OP_IMG[0], OP_CLASSES),
                        ints(0, OP_CLASSES, OP_IMG[0]).float()], {}, X,
         True),
        ("_ravel_multi_index", [torch.stack([ints(0, s, 100000),
                                             ints(0, h, 100000)]).float()],
         {"shape": (s, h)}, X, False),
        ("_unravel_index", [ints(0, s * h, 100000).float()],
         {"shape": (s, h)}, X, False)]
    cases = [(name, name) + tuple(rest) for name, *rest in cases]
    nb, n = OP_SPD
    for dt, fam in ((torch.float32, "linalg32"), (torch.float64,
                                                  "linalg64")):
        spd = slice_spd(g, nb, n)
        low = torch.linalg.cholesky(spd)
        # eigenvalues 1, 2, ..., n: an eigenvector moves by rounding over
        # the gap to its neighbours, and so does syevd's gradient
        q = _orthogonal(g, nb, n)
        spread = (q * torch.arange(1, n + 1, dtype=torch.float64)) @ \
            q.transpose(1, 2)
        rnd = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                                     dtype=torch.float64) / math.sqrt(n)
        tag = "" if dt == torch.float32 else ":float64"
        lin = [
            ("linalg_gemm", [rnd(nb, n, n), rnd(nb, n, n), rnd(nb, n, n)],
             {"transpose_b": True, "alpha": 0.5, "beta": -1.0}, True),
            ("linalg_potrf", [spd], {}, True),
            ("linalg_potri", [low], {}, True),
            ("linalg_trsm", [low, rnd(nb, n, 64)], {}, True),
            ("linalg_trmm", [low, rnd(nb, n, 64)], {"transpose": True},
             True),
            ("linalg_syrk", [rnd(nb, n // 2, n)], {}, True),
            ("linalg_gelqf", [rnd(nb, n // 2, n)], {}, _blind_pair),
            ("linalg_sumlogdiag", [spd], {}, True),
            ("linalg_extractdiag", [spd], {"offset": 1}, True),
            ("linalg_makediag", [rnd(nb, n)], {}, True),
            ("linalg_extracttrian", [spd], {}, True),
            ("linalg_maketrian", [rnd(nb, n * (n + 1) // 2)], {}, True),
            ("linalg_inverse", [spd], {}, True),
            ("linalg_det", [spd], {}, True),
            ("linalg_slogdet", [spd], {}, True),
            ("linalg_syevd", [spread], {}, _blind_pair),
            ("khatri_rao", [rnd(n, 64), rnd(n // 2, 64)], {}, True)]
        exact = ("linalg_extractdiag", "linalg_makediag",
                 "linalg_extracttrian", "linalg_maketrian")
        cases += [(name + tag, name, [t.to(dt) for t in ins], kw,
                   "exact" if name in exact else fam, grad)
                  for name, ins, kw, grad in lin]
    return cases


def _slice_run(op, inputs, kwargs, grad, dev, decisions=None):
    """``op`` on ``inputs`` moved to ``dev`` (``ctx=dev`` for an op
    without inputs): the outputs and, if asked, the gradient, where they
    were computed."""
    ts = [t.to(dev) for t in inputs]
    wrt = grad if isinstance(grad, int) and not isinstance(grad, bool) \
        else 0
    if grad is not False:
        ts[wrt] = ts[wrt].detach().requires_grad_()
    if not inputs:
        kwargs = dict(kwargs, ctx=dev)
    with decisions if decisions is not None else contextlib.nullcontext():
        out = invoke(get_op(op), ts, kwargs)
    outs = [o._data if isinstance(o, nd.NDArray) else o for o in (
        out if isinstance(out, (list, tuple)) else [out])]
    dg = None
    if grad is not False:
        total = grad(outs) if callable(grad) else sum(
            o.sum(dtype=torch.float64) for o in outs
            if o.is_floating_point())
        dg, = torch.autograd.grad(total, ts[wrt])
    return [o.detach() for o in outs], dg


def _pair_err(a: torch.Tensor, b: torch.Tensor, scaled: bool) -> float:
    """``a`` against the reference ``b``: the largest ``|a - b|`` over
    ``max(1, max |b|)`` (``scaled``: a sum's error goes with its terms,
    not with its result) or the largest ``|a - b| / max(1, |b|)``; in
    chunks (the largest outputs are GBs).  NaNs and infinities must sit
    in the same places, integers must be equal (else inf)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return math.inf
    if torch.equal(a, b):
        return 0.0
    if not a.is_floating_point():
        return math.inf
    err, scale = 0.0, 1.0
    for x, y in zip(a.reshape(-1).split(1 << 26), b.reshape(-1).split(
            1 << 26)):
        same = (x == y) | (torch.isnan(x) & torch.isnan(y))
        if not bool((same | (torch.isfinite(x) & torch.isfinite(y))).all()):
            return math.inf
        d = torch.where(same, torch.zeros_like(x), (x - y).abs())
        if scaled:
            fin = torch.isfinite(y)
            if bool(fin.any()):
                scale = max(scale, y[fin].abs().max().item())
        else:
            d = d / y.abs().clamp(min=1.0)
        err = max(err, d.max().item() if d.numel() else 0.0)
    return err / scale if scaled else err


def slice_ops_run(seed: int, cases_fn=slice_op_cases,
                  ops=SLICE_OPS) -> dict:
    """(a): each case of ``cases_fn`` (``slice_op_cases``) on the card and
    on the CPU; the spatial cases' CPU runs take the card's floors
    (``SamplerDecisions``).  Exact families must agree bit for bit, the
    others within ``SLICE_TOL``; every op of ``ops`` must be checked."""
    dev = gpu(0)
    rows, failed = {}, []
    cases = cases_fn(seed)
    names = {op for _, op, *_ in cases}
    before = _launch_total()
    t0 = time.monotonic()
    for row, op, inputs, kwargs, fam, grad in cases:
        t1 = time.monotonic()
        rec = SamplerDecisions() if fam == "spatial" else None
        card_out, card_g = _slice_run(op, inputs, kwargs, grad, dev, rec)
        forced = SamplerDecisions(rec.masks) if rec is not None else None
        cpu_out, cpu_g = _slice_run(op, inputs, kwargs, grad, cpu(), forced)
        # compared where the card's results lie (the largest are GBs)
        place = card_out[0].device
        cpu_out = [o.to(place) for o in cpu_out]
        if op in ("linalg_syevd", "linalg_gelqf"):
            card_out = _aligned(card_out, cpu_out)
        errs = [_pair_err(a, b, fam in SLICE_SCALED)
                for a, b in zip(card_out, cpu_out)]
        grad_err = _pair_err(card_g, cpu_g.to(place), True) \
            if card_g is not None else None
        tol = SLICE_TOL[fam]
        gtol = SLICE_TOL["elementwise"] if fam == "exact" else tol
        ok = len(card_out) == len(cpu_out) and all(
            e <= tol for e in errs) and (grad_err is None or grad_err <= gtol)
        rows[row] = {"family": fam, "max_err": max(errs),
                     "grad_err": grad_err, "tol": tol,
                     "shape": list(card_out[0].shape),
                     "dtype": str(card_out[0].dtype).replace("torch.", ""),
                     "seconds": time.monotonic() - t1, "ok": ok}
        if forced is not None:
            rows[row]["decisions"] = {"floors": rec.units,
                                      "flips": forced.flips}
            ok = ok and forced.flips <= DECISION_FLIPS * max(rec.units, 1)
            rows[row]["ok"] = ok
        if not ok:
            failed.append(row)
        del card_out, cpu_out, card_g, cpu_g
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    worst = {fam: max((r["max_err"] for r in rows.values()
                       if r["family"] == fam), default=0.0)
             for fam in SLICE_TOL}
    worst_grad = {fam: max((r["grad_err"] or 0.0 for r in rows.values()
                            if r["family"] == fam), default=0.0)
                  for fam in SLICE_TOL}
    launches = _launch_total() - before
    return {"ops": len(names), "cases": len(rows), "rows": rows,
            "failed": failed, "worst_by_family": worst,
            "worst_grad_by_family": worst_grad, "launches": launches,
            "seconds": time.monotonic() - t0,
            "ok": not failed and names == set(ops)
            and launches == 0}


def _moments(x: torch.Tensor, mean: float, var: float) -> dict:
    """The sample mean and variance against the exact values, each in
    standard errors (the variance's from the sample's fourth central
    moment); computed in float64 where the draws lie."""
    x = x.reshape(-1).double()
    m, v = x.mean(), x.var(correction=0)
    m4 = ((x - m) ** 4).mean()
    n = x.numel()
    se_m, se_v = math.sqrt(var / n), math.sqrt(max((m4 - v * v).item(),
                                                   1e-300) / n)
    zm, zv = abs(m.item() - mean) / se_m, abs(v.item() - var) / se_v
    return {"mean": m.item(), "var": v.item(), "z_mean": zm, "z_var": zv,
            "ok": zm <= DRAW_SIGMAS and zv <= DRAW_SIGMAS}


class NoiseBlock(gluon.HybridBlock):
    """``x`` plus a normal, a gamma and a Poisson draw of its shape."""

    def hybrid_forward(self, F, x):
        return x + F.random.normal_like(x) + F.random.gamma_like(
            x, alpha=2.0) + F.random.poisson_like(x, lam=3.0)


def slice_draws_run(seed: int) -> dict:
    """(b): ``DRAWS`` draws of every ``_random_*``/``_sample_*`` form on
    the card, their moments within ``DRAW_SIGMAS`` standard errors of the
    exact values (each row of a ``_sample_*`` draw its own), a reseed
    repeating every draw bit for bit (another seed not), ``_shuffle`` a
    permutation, ``_sample_multinomial``'s frequencies its probabilities;
    then the draws of ``NoiseBlock`` hybridized: fresh at each replay,
    repeated after a reseed."""
    dev = gpu(0)
    t0 = time.monotonic()
    r = nd.random
    n, half = DRAWS, DRAWS // 2
    like = nd.zeros((n,), ctx=dev)

    def vec(*v):
        return nd.array(np.array(v, np.float32), ctx=dev)

    # name, draw (an NDArray on the card), exact mean(s) and variance(s)
    scalar = [
        ("_random_gamma", lambda: r.gamma(2.5, 1.5, shape=(n,), ctx=dev),
         3.75, 5.625),
        ("_random_gamma(0.5)", lambda: r.gamma(0.5, 2.0, shape=(n,),
                                               ctx=dev), 1.0, 2.0),
        ("_random_exponential", lambda: r.exponential(2.0, shape=(n,),
                                                      ctx=dev), 2.0, 4.0),
        ("_random_poisson", lambda: r.poisson(3.5, shape=(n,), ctx=dev),
         3.5, 3.5),
        ("_random_negative_binomial", lambda: r.negative_binomial(
            3, 0.4, shape=(n,), ctx=dev), 4.5, 11.25),
        ("_random_generalized_negative_binomial",
         lambda: r.generalized_negative_binomial(2.0, 0.5, shape=(n,),
                                                 ctx=dev), 2.0, 4.0),
        ("_random_uniform_like", lambda: r.uniform_like(like, -1.0, 3.0),
         1.0, 16 / 12),
        ("_random_normal_like", lambda: r.normal_like(like, 2.0, 3.0), 2.0,
         9.0),
        ("_random_gamma_like", lambda: r.gamma_like(like, 2.5, 1.5), 3.75,
         5.625),
        ("_random_exponential_like", lambda: r.exponential_like(like, 0.5),
         2.0, 4.0),
        ("_random_poisson_like", lambda: r.poisson_like(like, 3.5), 3.5,
         3.5)]
    per_row = [
        ("_sample_uniform", lambda: r.sample_uniform(
            vec(-1, 0), vec(3, 1), shape=(half,)), (1.0, 0.5),
         (16 / 12, 1 / 12)),
        ("_sample_normal", lambda: r.sample_normal(
            vec(2, -1), vec(3, 0.5), shape=(half,)), (2.0, -1.0),
         (9.0, 0.25)),
        ("_sample_gamma", lambda: r.sample_gamma(
            vec(2.5, 0.5), vec(1.5, 2.0), shape=(half,)), (3.75, 1.0),
         (5.625, 2.0)),
        ("_sample_exponential", lambda: r.sample_exponential(
            vec(0.5, 2.0), shape=(half,)), (2.0, 0.5), (4.0, 0.25)),
        ("_sample_poisson", lambda: r.sample_poisson(
            vec(3.5, 0.7), shape=(half,)), (3.5, 0.7), (3.5, 0.7)),
        ("_sample_negative_binomial", lambda: r.sample_negative_binomial(
            vec(3, 1), vec(0.4, 0.7), shape=(half,)), (4.5, 3 / 7),
         (11.25, 0.3 / 0.49)),
        ("_sample_generalized_negative_binomial",
         lambda: r.sample_generalized_negative_binomial(
             vec(2.0, 0.5), vec(0.5, 1.5), shape=(half,)), (2.0, 0.5),
         (4.0, 0.875))]
    probs = torch.tensor([[0.05, 0.15, 0.3, 0.5, 0.0],
                          [0.2, 0.2, 0.2, 0.2, 0.2]], device=dev)

    def all_draws():
        out = [fn()._data for _, fn, *_ in scalar + per_row]
        out.append(r.multinomial(nd.NDArray(probs), shape=(half,))._data)
        out.append(r.shuffle(nd.arange(n, ctx=dev))._data)
        return out

    before = _launch_total()
    mx_random.seed(seed + 21)
    first = all_draws()
    mx_random.seed(seed + 21)
    again = all_draws()
    mx_random.seed(seed + 22)
    other = all_draws()
    torch.cuda.synchronize()
    reseed_same = _bitwise(first, again)
    reseed_other = [not torch.equal(a, b) for a, b in zip(first, other)]
    moments = {}
    for (name, _, mean, var), x in zip(scalar, first):
        moments[name] = _moments(x, mean, var)
    for (name, _, means, vars_), x in zip(per_row, first[len(scalar):]):
        moments[name] = [_moments(x[i], means[i], vars_[i])
                         for i in range(2)]
    draws = first[-2]
    freq = torch.stack([torch.bincount(draws[i].long(), minlength=5)
                        for i in range(2)]).double() / half
    p = probs.double()
    se = torch.sqrt(p * (1 - p) / half).clamp(min=1e-12)
    z = ((freq - p).abs() / se).max().item()
    shuffled = first[-1]
    perm = torch.equal(torch.sort(shuffled).values, nd.arange(
        n, ctx=dev)._data) and not torch.equal(shuffled, nd.arange(
            n, ctx=dev)._data)
    launches = _launch_total() - before
    del first, again, other

    # a draw inside a captured graph
    block = NoiseBlock()
    block.initialize(ctx=dev)
    block.hybridize()
    x = nd.zeros((1 << 16,), ctx=dev)
    mx_random.seed(seed + 23)
    calls = [block(x)._data.clone() for _ in range(4)]
    mx_random.seed(seed + 23)
    repeat = [block(x)._data.clone() for _ in range(4)]
    torch.cuda.synchronize()
    stats = block.graph_stats()
    graph = {"replays": stats["replays"], "graphs": stats["graphs"],
             "fresh": all(not torch.equal(a, b)
                          for a, b in zip(calls, calls[1:])),
             "reseed_repeats": _bitwise(calls, repeat),
             "mean": calls[-1].double().mean().item()}
    on_card = as_device(gpu(0)).type == "cuda"
    graph["ok"] = graph["fresh"] and graph["reseed_repeats"] and (
        not on_card or graph["replays"] >= 4) and abs(
        graph["mean"] - 5.0) < 0.1
    free_graphs(block)
    checks = {
        "moments": all(m["ok"] for v in moments.values()
                       for m in (v if isinstance(v, list) else [v])),
        "reseed_bitwise": reseed_same, "other_seed_differs":
            all(reseed_other), "multinomial": z <= DRAW_SIGMAS,
        "shuffle_permutes": perm, "captured_draws": graph["ok"],
        "no_kernel_launches": launches == 0}
    return {"draws_each": n, "forms": len(scalar) + len(per_row) + 2,
            "moments": moments, "multinomial_z": z, "graph": graph,
            "checks": checks, "seconds": time.monotonic() - t0,
            "ok": all(checks.values())}


class STN(gluon.HybridBlock):
    """Jaderberg et al. 2015's spatial transformer in front of a
    classifier: a ``Dense(6)`` over the pooled input gives each image's
    affine, ``SpatialTransformer`` resamples the image at ``size`` x
    ``size`` with it, the body classifies the result."""

    def __init__(self, body, size: int):
        super().__init__()
        self.size = size
        with self.name_scope():
            self.loc = nn.Dense(6, in_units=3)
            self.body = body

    def hybrid_forward(self, F, x):
        theta = self.loc(F.mean(x, axis=(2, 3)))
        return self.body(F.SpatialTransformer(
            x, theta, target_shape=(self.size, self.size)))


def stn_build(dev, seed: int = 0, arrays=None):
    """The STN over ``STN_BODY`` (1000 classes); weights from ``seed``
    (Xavier, the loc net's weight 0 and its bias ``stn_affine()``) or
    ``arrays``; the loc net learns at ``STN_LOC_LR_MULT`` of the rate."""
    body = vision_zoo.get_model(STN_BODY, classes=1000) \
        if isinstance(STN_BODY, str) else STN_BODY()
    net = STN(body, STN_SIZE)
    net.loc.collect_params().setattr("lr_mult", STN_LOC_LR_MULT)
    if arrays is not None:
        load_reference_params(net, arrays, ctx=dev)
        return net
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    net.loc.weight.set_data(nd.zeros((6, 3), ctx=dev))
    net.loc.bias.set_data(nd.array(np.array(stn_affine(), np.float32),
                                   ctx=dev))
    return net


def stn_check(net, w_init: dict, xb, yb, seed: int, loc: list) -> dict:
    """One SGD-momentum step of ``net`` (on the card, at its initial
    weights ``w_init``) at batch ``STN_CHECK``, recording its ReLU,
    max-pool and sampler-floor decisions (``SamplerDecisions``), against
    the same step on the CPU in fp32 and float64 taking them:
    ``decision_leaf_check``, the loc net's gradient and update among the
    leaves (``loc``, their names), which are also reported, and held, on
    their own."""
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    arrays = {k: v.cpu().numpy() for k, v in w_init.items()}
    with SamplerDecisions(seed=seed) as card:
        after = {"card": check_step(
            net, lambda: lossfn(net(xb), yb).mean(), RESNET_OPT)}
    flips = {}
    for nm, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        model = stn_build(cpu(), arrays=arrays).to(dtype)
        xc = xb.cpu().to(dtype)
        with SamplerDecisions(card.masks) as forced:
            after[nm] = check_step(model, lambda: lossfn(
                model(xc), yb.cpu()).mean(), RESNET_OPT)
        flips[nm] = {"decisions": forced.flips}
        del model
    res = decision_leaf_check(after, w_init, flips,
                              {"decisions": card.units})
    names = list(w_init)
    grads = [list(after[k][1].values()) for k in ("card", "cpu", "cpu64")]
    res["loc"] = {}
    for name in loc:
        i = names.index(name)
        card_g, cpu_g, ref = (g[i].double().cpu() for g in grads)
        share = [(t - ref).norm().item() / max(ref.norm().item(), 1e-30)
                 for t in (card_g, cpu_g)]
        res["loc"][name] = {"grad_share": share[0], "cpu_share": share[1],
                            "limit": LEAF_K * share[1] + LEAF_FLOOR,
                            "card_grad": card_g.reshape(-1).tolist()}
    res["ok"] = res["ok"] and all(r["grad_share"] <= r["limit"]
                                  for r in res["loc"].values())
    return res


def stn_run(seed: int) -> dict:
    """(c): the STN + ``STN_BODY`` at batch ``STN_BATCH`` fp32: the check
    step, ``STN_STEPS`` eager steps of ``autograd.record`` ->
    ``SoftmaxCrossEntropyLoss`` -> ``backward`` -> ``Trainer("sgd",
    momentum 0.9)``, then ``STN_HYBRID_STEPS`` hybridized (the warm call,
    the capture, replays): finite losses, the momentum kernel's launches
    exact (one per group of ``AGG`` trainable tensors a step, the check
    step's too)."""
    dev = gpu(0)
    t0 = time.monotonic()
    gen = torch.Generator(device=as_device(dev)).manual_seed(seed + 21)
    x = torch.randn(STN_BATCH, 3, STN_SIZE, STN_SIZE, device=as_device(dev),
                    generator=gen)
    y = torch.randint(0, 1000, (STN_BATCH,), device=as_device(dev),
                      generator=gen).float()
    net = stn_build(dev, seed)
    w_init = _snapshot(net)
    trainable = [p for p in net.collect_params().values()
                 if p.grad_req != "null"]
    groups = -(-len(trainable) // AGG)
    before, others = multi_sgd_mom.launches, other_launches(multi_sgd_mom)
    check = stn_check(net, w_init, x[:STN_CHECK], y[:STN_CHECK], seed,
                      [net.loc.weight.name, net.loc.bias.name])
    load_reference_params(net, {k: v.cpu().numpy()
                                for k, v in w_init.items()}, ctx=dev)
    trainer = gluon.Trainer(net.collect_params(), "sgd", RESNET_OPT)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, step_ms = [], []
    for i in range(STN_STEPS + STN_HYBRID_STEPS):
        if i == STN_STEPS:
            net.hybridize()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        with autograd.record():
            loss = lossfn(net(x), y)
        autograd.backward(loss)
        trainer.step(STN_BATCH)
        losses.append(loss.detach().mean())
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t1) * 1e3)
    launches = multi_sgd_mom.launches - before
    expected = groups * (STN_STEPS + STN_HYBRID_STEPS + 1)
    stats = graph_summary(net)
    losses = [v.item() for v in losses]
    with torch.no_grad():
        theta = net.loc(x.mean(dim=(2, 3))).detach().cpu()
    free_graphs(net)
    on_card = as_device(dev).type == "cuda"
    checks = {"losses_finite": all(math.isfinite(v) for v in losses),
              "launches_exact": launches == expected
              and other_launches(multi_sgd_mom) == others,
              "leaf_check": check["ok"],
              "replayed": not on_card or stats["replays"] >= 2}
    return {"batch": STN_BATCH, "size": STN_SIZE, "body": str(STN_BODY),
            "trainable_params": len(trainable), "losses": losses,
            "step_ms": step_ms, "launches": launches,
            "expected_launches": expected, "graphs": stats,
            "theta_mean": theta.mean(0).tolist(), "check": check,
            "checks": checks, "seconds": time.monotonic() - t0,
            "ok": all(checks.values())}


def gp_data(seed: int):
    """``GP``'s problems: points uniform in the unit cube, targets a smooth
    function of them plus noise (float64, on the CPU)."""
    g = torch.Generator().manual_seed(seed + 24)
    b, n, d = GP["problems"], GP["points"], GP["dims"]
    x = torch.rand(b, n, d, generator=g, dtype=torch.float64)
    w = torch.randn(b, d, 1, generator=g, dtype=torch.float64)
    y = torch.sin(3 * x @ w) + 0.1 * torch.randn(b, n, 1, generator=g,
                                                 dtype=torch.float64)
    return x, y


def gp_nll(params, x, y):
    """The negative log marginal likelihood of each problem, through
    ``nd``'s linalg ops: ``K = s^2 exp(-|xi - xj|^2 / (2 l^2)) + n^2 I``,
    ``L = potrf(K)``, ``a = trsm(L, y)``, ``a^T a / 2 + sumlogdiag(L) +
    n/2 log 2 pi``; ``params`` the logs of ``l``, ``s``, ``n``."""
    ell, sf, sn = (params[i].exp() for i in range(3))
    sq = (x * x).sum(-1)
    d2 = (sq[:, :, None] + sq[:, None, :]
          - 2 * nd.batch_dot(x, x, transpose_b=True)).clamp(min=0)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    k = sf * sf * torch.exp(-d2 / (2 * ell * ell)) + sn * sn * eye
    low = nd.linalg_potrf(k)
    alpha = nd.linalg_trsm(low, y)
    return 0.5 * (alpha * alpha).sum((1, 2)) + nd.linalg_sumlogdiag(low) \
        + 0.5 * x.shape[1] * math.log(2 * math.pi)


def gp_fit(x, y, dev, dtype) -> dict:
    """``GP["steps"]`` Adam steps on the mean NLL over the problems (lr
    ``GP["lr"]``), autograd through ``gp_nll``: the NLL before each step
    and the parameters after it."""
    x, y = x.to(dev, dtype), y.to(dev, dtype)
    params = torch.tensor(GP["init"], dtype=dtype, device=as_device(dev))
    m, v = torch.zeros_like(params), torch.zeros_like(params)
    nll, path = [], []
    for t in range(1, GP["steps"] + 1):
        params.requires_grad_()
        loss = gp_nll(params, x, y).mean()
        g, = torch.autograd.grad(loss, params)
        with torch.no_grad():
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            step = GP["lr"] * (m / (1 - 0.9 ** t)) / (
                torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
            params = params.detach() - step
        nll.append(loss.detach())
        path.append(params.clone())
    return {"nll": torch.stack(nll).double().cpu(),
            "params": torch.stack(path).double().cpu()}


def _dev_from(run, ref) -> float:
    """Largest deviation of a fit from the reference fit, relative:
    ``|a - b| / max(1, |b|)`` over the NLLs and the parameters."""
    return max(((run[k] - ref[k]).abs() / ref[k].abs().clamp(min=1.0))
               .max().item() for k in ("nll", "params"))


def gp_run(seed: int) -> dict:
    """(d): ``GP`` fitted on the card in float64 and in fp32, and on the
    CPU in float64 (the reference): the card's float64 fit within
    ``GP_TOL64`` of the CPU's, its fp32 fit within ``GP_TOL32``; the NLL
    falls."""
    t0 = time.monotonic()
    x, y = gp_data(seed)
    before = _launch_total()
    fits = {}
    for name, dev, dtype in (("card64", gpu(0), torch.float64),
                             ("card32", gpu(0), torch.float32),
                             ("cpu64", cpu(), torch.float64)):
        t1 = time.monotonic()
        fits[name] = gp_fit(x, y, dev, dtype)
        fits[name]["seconds"] = time.monotonic() - t1
    ref = fits["cpu64"]
    dev64 = _dev_from(fits["card64"], ref)
    dev32 = _dev_from(fits["card32"], ref)
    launches = _launch_total() - before
    checks = {"fp64_within": dev64 <= GP_TOL64,
              "fp32_within": dev32 <= GP_TOL32,
              "nll_falls": all(f["nll"][-1] < f["nll"][0]
                               for f in fits.values()),
              "finite": all(bool(torch.isfinite(f["nll"]).all())
                            for f in fits.values()),
              "no_kernel_launches": launches == 0}
    return {"problems": GP["problems"], "points": GP["points"],
            "dims": GP["dims"], "steps": GP["steps"],
            "nll_first_last": {k: [f["nll"][0].item(), f["nll"][-1].item()]
                               for k, f in fits.items()},
            "params_last": {k: f["params"][-1].tolist()
                            for k, f in fits.items()},
            "fit_seconds": {k: f["seconds"] for k, f in fits.items()},
            "card64_dev": dev64, "card32_dev": dev32, "checks": checks,
            "seconds": time.monotonic() - t0, "ok": all(checks.values())}


def op_slice_phase(seed: int, card: str) -> dict:
    """Phase 21 (a)-(d): every count set to 0 just before the phase and
    read just after it (each part also checks its own launches): the
    momentum kernel launched by (c) alone, exactly, no other kernel."""
    start = time.monotonic()
    zero_counts()
    res = {"card": card}
    for key, fn in (("ops", slice_ops_run), ("draws", slice_draws_run),
                    ("stn", stn_run), ("gp", gp_run)):
        res[key] = fn(seed)
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = multi_sgd_mom.launches
    res["other_launches"] = other_launches(multi_sgd_mom)
    res.update(seconds=time.monotonic() - start, ok=all(
        res[k]["ok"] for k in ("ops", "draws", "stn", "gp"))
        and res["launches"] == res["stn"]["expected_launches"]
        and res["other_launches"] == 0)
    return res


# ---- phase 22: control flow, the rest of Symbol/Module, the rest of
# detection --------------------------------------------------------------

CONTRIB_OPS = (
    "_contrib_DeformableConvolution", "_contrib_PSROIPooling",
    "_contrib_DeformablePSROIPooling", "ROIPooling", "Correlation",
    "_contrib_bipartite_matching", "_contrib_count_sketch",
    "_contrib_AdaptiveAvgPooling2D", "_contrib_index_copy",
    "_contrib_index_array", "_contrib_allclose", "_contrib_getnnz",
    "_contrib_div_sqrt_dim", "_contrib_backward_gradientmultiplier")
DEFORM_IN = (1, 512, 38, 63)    # R-FCN's res5 at 600 x 1000 (stride 16)
ROIPOOL_IN = (2, 512, 38, 50)   # Fast R-CNN's VGG-16 conv5_3 at 600 x 800
ROIPOOL_ROIS = 128              # rois an image
FLOW_IN = (8, 256, 48, 64)      # FlowNetC's conv3 at 384 x 512, batch 8
FLOW_CORR = {"kernel_size": 1, "max_displacement": 20, "stride1": 1,
             "stride2": 2, "pad_size": 20}
MATCH_IN = (32, 50, 5630)       # 50 ground truths x the port's SSD-512
SKETCH_IN, SKETCH_OUT = (12544, 2048), 16000   # compact bilinear pooling
PSP_IN = (8, 2048, 60, 60)      # PSPNet's pyramid pooling input
TABLE, COPY_ROWS = (30522, 768), 4096
OP_HEADS = (8, 12, 512, 64)     # BERT-base's per-head activations
ZIPF_RANGE, ZIPF_SAMPLED = 793471, 8192
ZIPF_SIGMAS = 6.0
CF = {"steps": 50, "batch": 64, "hidden": 1024}   # the loops' sizes


def _rois(g, n: int, height: int, width: int, batch: int = 1):
    """``n`` rois [b, x1, y1, x2, y2] in an image of ``height`` x
    ``width`` pixels, sides 1/16 to 1/2 of the image's."""
    lo = torch.rand(n, 2, generator=g) * torch.tensor([width, height]) * 0.6
    size = (torch.rand(n, 2, generator=g) * 0.44 + 0.06) * torch.tensor(
        [width, height])
    b = torch.randint(0, batch, (n, 1), generator=g).float()
    return torch.cat([b, lo, lo + size], 1)


def contrib_op_cases(seed: int) -> list:
    """Each op of ``CONTRIB_OPS`` at the size its model runs it: (row, op,
    inputs, kwargs, family, gradient input or False), as
    ``slice_op_cases``."""
    g = torch.Generator().manual_seed(seed + 22)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    n, c, h, w = DEFORM_IN
    dg, gs, cls = RFCN["dg"], RFCN["group"], RFCN["classes"]
    x, off = r(*DEFORM_IN), r(n, 2 * 9 * dg, h, w) * 2.0
    wt = r(c, c, 3, 3) * math.sqrt(2.0 / (c * 9))
    dconv = {"kernel": (3, 3), "dilate": (2, 2), "pad": (2, 2),
             "num_filter": c, "num_deformable_group": dg, "no_bias": True}
    cases = [(f"deformable_conv {name}", "_contrib_DeformableConvolution",
              [x, off, wt], dconv, "spatial", i)
             for i, name in enumerate(("data", "offset", "weight"))]
    fmap = r(n, gs * gs * cls, h, w)
    rois = _rois(g, RFCN["rois"], h * 16, w * 16)
    ps = {"spatial_scale": 1 / 16, "output_dim": cls, "pooled_size": gs,
          "group_size": gs}
    dps = dict(ps, part_size=gs, sample_per_part=RFCN["samples"],
               trans_std=RFCN["trans_std"])
    trans = r(RFCN["rois"], 2, gs, gs)
    cases += [
        ("psroi_pooling", "_contrib_PSROIPooling", [fmap, rois], ps,
         "spatial", 0),
        ("deformable_psroi data", "_contrib_DeformablePSROIPooling",
         [fmap, rois, trans], dps, "spatial", 0),
        ("deformable_psroi trans", "_contrib_DeformablePSROIPooling",
         [fmap, rois, trans], dps, "spatial", 2),
        ("deformable_psroi no_trans", "_contrib_DeformablePSROIPooling",
         [fmap, rois], dict(dps, no_trans=True), "spatial", 0)]
    vgg = r(*ROIPOOL_IN)
    rois2 = _rois(g, ROIPOOL_IN[0] * ROIPOOL_ROIS, ROIPOOL_IN[2] * 16,
                  ROIPOOL_IN[3] * 16, batch=ROIPOOL_IN[0])
    cases.append(("roi_pooling", "ROIPooling", [vgg, rois2],
                  {"pooled_size": (7, 7), "spatial_scale": 1 / 16}, "exact",
                  0))
    cases.append(("correlation", "Correlation", [r(*FLOW_IN), r(*FLOW_IN)],
                  FLOW_CORR, "contraction", 0))
    cases.append(("bipartite_matching", "_contrib_bipartite_matching",
                  [torch.rand(*MATCH_IN, generator=g)], {"threshold": 0.5},
                  "exact", False))
    cases.append(("count_sketch", "_contrib_count_sketch", [
        r(*SKETCH_IN), torch.randint(0, SKETCH_OUT, (1, SKETCH_IN[1]),
                                     generator=g).float(),
        torch.randint(0, 2, (1, SKETCH_IN[1]), generator=g).float() * 2 - 1],
        {"out_dim": SKETCH_OUT}, "contraction", False))
    psp = r(*PSP_IN)
    cases += [(f"adaptive_avg_pool {s}", "_contrib_AdaptiveAvgPooling2D",
               [psp], {"output_size": s}, "contraction", 0)
              for s in (1, 2, 3, 6)]
    table, new = r(*TABLE), r(COPY_ROWS, TABLE[1])
    rows = torch.randperm(TABLE[0], generator=g)[:COPY_ROWS].float()
    cases += [("index_copy old", "_contrib_index_copy", [table, rows, new],
               {}, "exact", 0),
              ("index_copy new", "_contrib_index_copy", [table, rows, new],
               {}, "exact", 2)]
    act, heads = r(*OP_ACT), r(*OP_HEADS)
    cases += [
        ("index_array", "_contrib_index_array", [act], {}, "exact", False),
        ("index_array axes", "_contrib_index_array", [act],
         {"axes": (0, 2)}, "exact", False),
        ("allclose", "_contrib_allclose", [act, act + 1e-9 * r(*OP_ACT)],
         {}, "exact", False),
        ("getnnz", "_contrib_getnnz", [act.clamp(min=0)], {}, "exact",
         False),
        ("getnnz axis", "_contrib_getnnz", [act.clamp(min=0)], {"axis": 2},
         "exact", False),
        ("div_sqrt_dim", "_contrib_div_sqrt_dim", [heads], {},
         "elementwise", 0),
        ("backward_gradientmultiplier",
         "_contrib_backward_gradientmultiplier", [heads], {"scalar": -0.1},
         "exact", 0)]
    return cases


def contrib_ops_run(seed: int) -> dict:
    """(a) the ops of ``CONTRIB_OPS`` on the card against the CPU
    (``slice_ops_run``'s comparison; the sampling ops' CPU runs take the
    card's floors), and the peak memory of the sampling ops' card runs."""
    peaks = {}
    for row, op, inputs, kwargs, fam, grad in contrib_op_cases(seed):
        if fam != "spatial" or grad not in (0, False):
            continue
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _slice_run(op, inputs, kwargs, grad, gpu(0), SamplerDecisions())
        torch.cuda.synchronize()
        peaks[row] = (torch.cuda.max_memory_allocated() - base) / 2**20
    res = slice_ops_run(seed, contrib_op_cases, CONTRIB_OPS)
    res["peak_mb_forward_backward"] = peaks
    return res


def zipf_run(seed: int) -> dict:
    """``_sample_unique_zipfian`` and ``rand_zipfian`` at
    ``ZIPF_SAMPLED`` classes of ``ZIPF_RANGE`` on the card: distinct
    classes in range, a reseed repeating the draw bit for bit, and a
    moment: the sum of ``log(c + 1)`` over the classes drawn against its
    expectation for that many draws with replacement
    (``sum_c log(c + 1) (1 - (1 - p_c)^T)``, ``p_c = log((c + 2) / (c +
    1)) / log(range_max + 1)``), within ``ZIPF_SIGMAS`` of its standard
    deviation; ``rand_zipfian``'s expected counts by their formula."""
    dev = gpu(0)
    kw = {"range_max": ZIPF_RANGE, "shape": (1, ZIPF_SAMPLED), "ctx": dev}
    mx_random.seed(seed + 22)
    s1, t1 = nd._sample_unique_zipfian(**kw)
    mx_random.seed(seed + 22)
    s2, t2 = nd._sample_unique_zipfian(**kw)
    a = s1.asnumpy()[0]
    tries = int(t1.asnumpy()[0])
    c = np.arange(ZIPF_RANGE, dtype=np.float64)
    p = np.log((c + 2) / (c + 1)) / np.log(ZIPF_RANGE + 1.0)
    q = -np.expm1(tries * np.log1p(-p))           # P(c among T draws)
    f = np.log(c + 1)
    mean, sd = (f * q).sum(), math.sqrt((f * f * q * (1 - q)).sum())
    got = float(np.log(a.astype(np.float64) + 1).sum())
    true = nd.array(np.array([0, 10, 1000, 100000], np.float32), ctx=dev)
    mx_random.seed(seed + 23)
    samples, exp_true, exp_sampled = nd.contrib.rand_zipfian(
        true, ZIPF_SAMPLED, ZIPF_RANGE)
    mx_random.seed(seed + 23)
    _, t3 = nd._sample_unique_zipfian(**kw)
    n3 = float(t3.asnumpy()[0])
    tv = np.array([0, 10, 1000, 100000], np.float64)
    sv = samples.asnumpy().astype(np.float64)
    form = lambda v: np.log((v + 2) / (v + 1)) / np.log(  # noqa: E731
        ZIPF_RANGE + 1.0) * n3
    counts_err = max(
        np.abs(exp_true.asnumpy() - form(tv)).max() / form(tv).max(),
        np.abs(exp_sampled.asnumpy() - form(sv)).max() / form(sv).max())
    checks = {
        "distinct": len(set(a.tolist())) == ZIPF_SAMPLED,
        "in_range": int(a.min()) >= 0 and int(a.max()) < ZIPF_RANGE,
        "tries_at_least_classes": tries >= ZIPF_SAMPLED,
        "reseed_bitwise": bool(torch.equal(s1._data, s2._data)
                               and torch.equal(t1._data, t2._data)),
        "moment": bool(abs(got - mean) <= ZIPF_SIGMAS * sd),
        "expected_counts": bool(counts_err <= 1e-6),
        "on_device": s1._data.device.type == as_device(dev).type}
    return {"tries": tries, "log_sum": got, "log_sum_expected": float(mean),
            "sigmas": float((got - mean) / sd), "expected_counts_rel_err":
            float(counts_err), "checks": checks, "ok": all(checks.values())}


def _cf_graphs(sym, limit: float):
    """The three loops of (a) in ``mx.sym`` over a captured ``(H, H)``
    weight ``w``: a tanh RNN by ``foreach``, a growing state by
    ``while_loop`` (stopping where its abs-sum passes ``limit``), and a
    ``cond`` on the sign of ``p``."""
    h = CF["hidden"]
    w = sym.var("w")

    def fc(x):
        return sym.FullyConnected(x, weight=w, num_hidden=h, no_bias=True)
    data, s0 = sym.var("data"), sym.var("s0")
    outs, fin = sym.contrib.foreach(
        lambda x, st: (sym.tanh(fc(st[0]) + x), [sym.tanh(fc(st[0]) + x)]),
        data, [s0])
    v = sym.var("v")
    wo, wf = sym.contrib.while_loop(
        lambda x: sym.sum(sym.abs(x)) < limit,
        lambda x: (sym.tanh(fc(x)), [x * 1.1 + 0.01]), [v],
        max_iterations=CF["steps"])
    p, a = sym.var("p"), sym.var("a")
    c = sym.contrib.cond(sym.sum(p) > 0.0, lambda: sym.tanh(fc(a)),
                         lambda: fc(a) * 0.5)
    return {"foreach": sym.Group([outs, fin[0]]),
            "while_loop": sym.Group([wo, wf[0]]), "cond": c}


def _cf_sym_run(graph, feed: dict, ctx, dtype) -> dict:
    """Forward (training) and backward with heads of ones: the outputs and
    every argument's gradient, by name, on the CPU."""
    shapes = {k: tuple(v.shape) for k, v in feed.items()}
    exe = graph.simple_bind(ctx, **shapes)
    for k, v in feed.items():
        exe.arg_dict[k]._data = v.to(as_device(ctx), dtype)
        exe.grad_dict[k]._data = exe.grad_dict[k]._data.to(dtype)
    outs = exe.forward(is_train=True)
    exe.backward([nd.ones(o.shape, ctx=ctx, dtype=dtype) for o in outs])
    res = {f"out{i}": o._data.detach().cpu() for i, o in enumerate(outs)}
    res.update({f"grad {k}": g._data.detach().cpu()
                for k, g in exe.grad_dict.items()})
    return res


def _cf_nd_run(feed: dict, ctx, dtype, limit: float) -> dict:
    """The same three loops through ``nd.contrib`` under
    ``autograd.record()``."""
    arr = {k: nd.array(v.numpy(), ctx=ctx, dtype=dtype)
           for k, v in feed.items()}
    for a in arr.values():
        a.attach_grad()
    h, w = CF["hidden"], arr["w"]

    def fc(x):
        return nd.FullyConnected(x, w, num_hidden=h, no_bias=True)
    with autograd.record():
        outs, fin = nd.contrib.foreach(
            lambda x, st: (nd.tanh(fc(st[0]) + x), [nd.tanh(fc(st[0]) + x)]),
            arr["data"], [arr["s0"]])
        wo, wf = nd.contrib.while_loop(
            lambda x: nd.sum(nd.abs(x)) < limit,
            lambda x: (nd.tanh(fc(x)), [x * 1.1 + 0.01]), [arr["v"]],
            max_iterations=CF["steps"])
        c = nd.contrib.cond(nd.sum(arr["p"]) > 0.0,
                            lambda: nd.tanh(fc(arr["a"])),
                            lambda: fc(arr["a"]) * 0.5)
        loss = sum(nd.sum(t) for t in (outs, fin[0], wo, wf[0], c))
    loss.backward()
    res = {"foreach": outs, "final": fin[0], "while": wo,
           "while_final": wf[0], "cond": c}
    res = {k: v._data.detach().cpu() for k, v in res.items()}
    res.update({f"grad {k}": a.grad._data.detach().cpu()
                for k, a in arr.items()})
    return res


def control_flow_run(seed: int) -> dict:
    """(a) ``_foreach``/``_while_loop``/``_cond`` in ``sym`` (bound by
    ``simple_bind``) and in ``nd`` (recording) at ``CF``'s sizes (a
    1024-wide tanh RNN over 50 steps of batch 64, its weight captured by
    the body), on the card and on the CPU in fp32 and float64: every
    output and gradient held by ``leaf_check``'s bounds."""
    g = torch.Generator().manual_seed(seed + 220)
    t, b, h = CF["steps"], CF["batch"], CF["hidden"]
    feed = {"data": torch.randn(t, b, h, generator=g) * 0.5,
            "s0": torch.zeros(b, h),
            "w": torch.randn(h, h, generator=g) / math.sqrt(h),
            "v": torch.randn(b, h, generator=g) * 0.01,
            "p": torch.ones(1),
            "a": torch.randn(b, h, generator=g)}
    # the loop stops half a step's growth from either side of the limit
    limit = float(feed["v"].double().abs().sum()) * 1.1 ** 20.5
    res, ok = {}, True
    for name in ("foreach", "while_loop", "cond"):
        graph = _cf_graphs(mx_sym, limit)[name]
        args = graph.list_arguments()
        sub = {k: feed[k] for k in args}
        runs = [_cf_sym_run(graph, sub, ctx, dt) for ctx, dt in (
            (gpu(0), torch.float32), (cpu(), torch.float32),
            (cpu(), torch.float64))]
        zeros = {k: torch.zeros_like(v) for k, v in runs[2].items()}
        check = leaf_check(*runs, zeros)
        res[f"sym {name}"] = _brief(check)
        ok = ok and check["ok"]
    runs = [_cf_nd_run(feed, ctx, dt, limit) for ctx, dt in (
        (gpu(0), torch.float32), (cpu(), torch.float32),
        (cpu(), torch.float64))]
    zeros = {k: torch.zeros_like(v) for k, v in runs[2].items()}
    check = leaf_check(*runs, zeros)
    res["nd"] = _brief(check)
    steps = int((runs[0]["while"].abs().sum((1, 2)) > 0).sum())
    res["while_loop_steps"] = steps
    res["ok"] = ok and check["ok"] and 0 < steps < CF["steps"]
    return res


# ---- phase 22 (b): deformable R-FCN (Dai et al. 2017, section 4) --------

RFCN = {"size": (600, 1000), "classes": 21, "group": 7, "rois": 300,
        "sampled": 128, "fg": 32, "gt": 3, "dg": 4, "trans_std": 0.1,
        "samples": 4, "c4": 1024, "c5": 2048, "new": 1024}
RFCN_BODY = "resnet101_v1"
RFCN_STEPS, RFCN_HYBRID_STEPS = 3, 3
#: the bounding-box regression targets' scale (Fast R-CNN's)
RFCN_BOX_STD = (0.1, 0.1, 0.2, 0.2)


class DeformBottleneck(gluon.HybridBlock):
    """Deformable ConvNets' res5 bottleneck: 1x1 conv, BN, relu, a 3x3
    ``DeformableConvolution`` (dilation 2, ``RFCN["dg"]`` deformable
    groups), BN, relu, 1x1 conv, BN, plus the shortcut, relu."""

    def __init__(self, channels: int, in_channels: int, **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        with self.name_scope():
            self.conv1 = nn.Conv2D(mid, 1, use_bias=False,
                                   in_channels=in_channels)
            self.bn1 = nn.BatchNorm(in_channels=mid)
            self.conv2 = gluon.contrib.cnn.DeformableConvolution(
                mid, 3, padding=2, dilation=2,
                num_deformable_group=RFCN["dg"], use_bias=False,
                in_channels=mid)
            self.bn2 = nn.BatchNorm(in_channels=mid)
            self.conv3 = nn.Conv2D(channels, 1, use_bias=False,
                                   in_channels=mid)
            self.bn3 = nn.BatchNorm(in_channels=channels)
            self.down = None
            if in_channels != channels:
                self.down = nn.HybridSequential(prefix="down_")
                self.down.add(nn.Conv2D(channels, 1, use_bias=False,
                                        in_channels=in_channels),
                              nn.BatchNorm(in_channels=channels))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.down is None else self.down(x)))


class RFCNHead(gluon.HybridBlock):
    """Position-sensitive score maps for ``classes`` and class-agnostic
    boxes, each pooled by ``DeformablePSROIPooling`` with offsets from a
    ``no_trans`` pooling and a fully connected layer (zero at first), and
    averaged over the bins (R-FCN's voting)."""

    def __init__(self, classes: int, group: int, in_channels: int,
                 **kwargs):
        super().__init__(**kwargs)
        self.classes, self.group = classes, group
        k = group * group
        with self.name_scope():
            self.cls = nn.Conv2D(k * classes, 1, in_channels=in_channels)
            self.bbox = nn.Conv2D(k * 8, 1, in_channels=in_channels)
            self.cls_off = nn.Dense(2 * k, in_units=k * classes,
                                    weight_initializer="zeros")
            self.bbox_off = nn.Dense(2 * k, in_units=k * 8,
                                     weight_initializer="zeros")

    def _pool(self, fmap, rois, dim, offsets):
        kw = {"spatial_scale": 1 / 16, "output_dim": dim,
              "group_size": self.group, "pooled_size": self.group,
              "part_size": self.group, "sample_per_part": RFCN["samples"]}
        plain = nd.contrib.DeformablePSROIPooling(fmap, rois, no_trans=True,
                                                  **kw)
        trans = offsets(plain.reshape(plain.shape[0], -1)).reshape(
            -1, 2, self.group, self.group)
        pooled = nd.contrib.DeformablePSROIPooling(
            fmap, rois, trans, trans_std=RFCN["trans_std"], **kw)
        return pooled.mean(dim=(2, 3))

    def forward(self, feat, rois):
        return (self._pool(self.cls(feat), rois, self.classes, self.cls_off),
                self._pool(self.bbox(feat), rois, 8, self.bbox_off))


class RFCNNet(gluon.HybridBlock):
    """``RFCN_BODY``'s features to stride 16 (``RFCN["c4"]`` channels),
    res5 as three deformable bottlenecks at stride 1 (``RFCN["c5"]``), a
    1x1 conv to ``RFCN["new"]`` channels and relu, the R-FCN head."""

    def __init__(self, body, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="body_")
            for i in range(7):       # the stem and stages 1-3 (stride 16)
                self.body.add(body.features[i])
            self.res5 = nn.HybridSequential(prefix="res5_")
            c4, c5 = RFCN["c4"], RFCN["c5"]
            with self.res5.name_scope():
                for i in range(3):
                    self.res5.add(DeformBottleneck(
                        c5, c4 if i == 0 else c5, prefix=f"unit{i}_"))
            self.new1 = nn.Conv2D(RFCN["new"], 1, in_channels=c5)
            self.head = RFCNHead(RFCN["classes"], RFCN["group"],
                                 RFCN["new"])

    def forward(self, x, rois):
        feat = F.relu(self.new1(self.res5(self.body(x))))
        return self.head(feat, rois)


def rfcn_build(dev, seed: int = 0, arrays=None):
    """The R-FCN over ``RFCN_BODY`` (1000 classes, whose classifier goes
    unused); weights Xavier from ``seed`` (the offset branches zero), or
    ``arrays``."""
    body = vision_zoo.get_model(RFCN_BODY, classes=1000) \
        if isinstance(RFCN_BODY, str) else RFCN_BODY()
    net = RFCNNet(body)
    if arrays is not None:
        load_reference_params(net, arrays, ctx=dev)
        return net
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    return net


def rfcn_data(seed: int):
    """One 600 x 1000 image, ``RFCN["rois"]`` rois jittered about
    ``RFCN["gt"]`` seeded ground-truth boxes (the RPN's stand-in), and
    the sampled rois' targets: up to ``RFCN["fg"]`` of the
    ``RFCN["sampled"]`` with IoU >= 0.5 (their box's class and its
    regression target, Fast R-CNN's parametrisation), the rest
    background (IoU < 0.5)."""
    rng = np.random.default_rng(seed + 22)
    height, width = RFCN["size"]
    x = rng.standard_normal((1, 3, height, width), dtype=np.float32)
    gt = []
    for _ in range(RFCN["gt"]):
        w, h = rng.uniform(width / 10, width / 2.5), \
            rng.uniform(height / 8, height / 2)
        x1, y1 = rng.uniform(0, width - w), rng.uniform(0, height - h)
        gt.append([x1, y1, x1 + w, y1 + h])
    gt = np.array(gt)
    cls = rng.integers(1, RFCN["classes"], RFCN["gt"])
    n_near = RFCN["rois"] * 2 // 3
    pick = rng.integers(0, RFCN["gt"], n_near)
    wh = gt[pick, 2:] - gt[pick, :2]
    near = gt[pick] + rng.normal(0, 0.15, (n_near, 4)) * np.concatenate(
        [wh, wh], 1)
    far_lo = rng.uniform(0, 1, (RFCN["rois"] - n_near, 2)) * [width * .8,
                                                            height * .8]
    far = np.concatenate([far_lo, far_lo + rng.uniform(
        0.05, 0.5, (RFCN["rois"] - n_near, 2)) * [width, height]], 1)
    boxes = np.concatenate([near, far])
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, width - 1)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, height - 1)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 4)
    tl = np.maximum(boxes[:, None, :2], gt[None, :, :2])
    br = np.minimum(boxes[:, None, 2:], gt[None, :, 2:])
    inter = np.prod((br - tl).clip(min=0), 2)
    area = lambda b: np.prod(b[..., 2:] - b[..., :2], -1)  # noqa: E731
    iou = inter / (area(boxes)[:, None] + area(gt)[None] - inter)
    best, arg = iou.max(1), iou.argmax(1)
    fg = np.flatnonzero(best >= 0.5)
    bg = np.flatnonzero(best < 0.5)
    fg = rng.permutation(fg)[:RFCN["fg"]]
    bg = rng.permutation(bg)[:RFCN["sampled"] - len(fg)]
    idx = np.concatenate([fg, bg])
    labels = np.where(best[idx] >= 0.5, cls[arg[idx]], 0)
    g = gt[arg[idx]]
    b = boxes[idx]
    bw, bh = b[:, 2] - b[:, 0] + 1, b[:, 3] - b[:, 1] + 1
    gw, gh = g[:, 2] - g[:, 0] + 1, g[:, 3] - g[:, 1] + 1
    target = np.stack([(g[:, 0] + gw / 2 - b[:, 0] - bw / 2) / bw,
                       (g[:, 1] + gh / 2 - b[:, 1] - bh / 2) / bh,
                       np.log(gw / bw), np.log(gh / bh)], 1) / RFCN_BOX_STD
    rois = np.concatenate([np.zeros((len(boxes), 1)), boxes], 1)
    return {"x": torch.as_tensor(x),
            "rois": torch.as_tensor(rois.astype(np.float32)),
            "idx": torch.as_tensor(idx.astype(np.int64)),
            "labels": torch.as_tensor(labels.astype(np.float32)),
            "targets": torch.as_tensor(target.astype(np.float32)),
            "fg": len(fg)}


def rfcn_loss(net, data: dict, lossfn):
    """Softmax cross-entropy over the classes of the sampled rois plus
    smooth L1 of the foreground rois' class-agnostic box (the second
    four of the eight outputs), over the sampled count."""
    scores, boxes = net(data["x"], data["rois"])
    idx = data["idx"]
    cls = lossfn(scores[idx], data["labels"]).mean()
    fg = (data["labels"] > 0).to(boxes.dtype)[:, None]
    diff = (boxes[idx][:, 4:] - data["targets"]) * fg
    box = torch.where(diff.abs() < 1, 0.5 * diff * diff,
                      diff.abs() - 0.5).sum() / idx.shape[0]
    return cls + box


def rfcn_check(net, w_init: dict, data: dict, seed: int) -> dict:
    """One SGD-momentum step from the initial weights on the card at
    phase 6's rate (``RESNET_OPT``: at R-FCN's 1e-3 a BatchNorm scale
    moves ~2e-5, a few of fp32's steps at 1.0, so its updated value
    would test the rounding, not the step), recording its ReLU, max-pool
    and sampling-floor decisions (``SamplerDecisions``), against the same
    step on the CPU in fp32 and float64 taking them:
    ``decision_leaf_check``; the peak memory of the card's step."""
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    arrays = {k: v.cpu().numpy() for k, v in w_init.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with SamplerDecisions(seed=seed) as card:
        after = {"card": check_step(net, lambda: rfcn_loss(
            net, data, lossfn), RESNET_OPT)}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    flips = {}
    for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        model = rfcn_build(cpu(), arrays=arrays).to(dtype)
        host = {k: v.cpu().to(dtype) if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v.cpu()
                if isinstance(v, torch.Tensor) else v
                for k, v in data.items()}
        with SamplerDecisions(card.masks) as forced:
            after[name] = check_step(model, lambda: rfcn_loss(
                model, host, lossfn), RESNET_OPT)
        flips[name] = {"decisions": forced.flips}
        del model
    res = decision_leaf_check(after, w_init, flips, {"decisions": card.units})
    res["peak_memory_gb"] = peak
    return res


def rfcn_run(seed: int) -> dict:
    """(b) the check step, ``RFCN_STEPS`` eager steps of
    ``autograd.record`` -> loss -> ``backward`` -> ``Trainer("sgd",
    momentum 0.9)``, then ``RFCN_HYBRID_STEPS`` hybridized: finite
    losses, the momentum kernel's launches exact (one per group of
    ``AGG`` trainable tensors a step, the check step's too), the
    hybridized steps replayed."""
    dev = gpu(0)
    t0 = time.monotonic()
    data = {k: v.to(as_device(dev)) if isinstance(v, torch.Tensor) else v
            for k, v in rfcn_data(seed).items()}
    net = rfcn_build(dev, seed)
    w_init = _snapshot(net)
    trainable = [p for p in net.collect_params().values()
                 if p.grad_req != "null"]
    groups = -(-len(trainable) // AGG)
    before, others = multi_sgd_mom.launches, other_launches(multi_sgd_mom)
    check = rfcn_check(net, w_init, data, seed)
    load_reference_params(net, {k: v.cpu().numpy()
                                for k, v in w_init.items()}, ctx=dev)
    trainer = gluon.Trainer(net.collect_params(), "sgd", RCNN_OPT)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, step_ms = [], []
    for i in range(RFCN_STEPS + RFCN_HYBRID_STEPS):
        if i == RFCN_STEPS:
            net.hybridize()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        with autograd.record():
            loss = rfcn_loss(net, data, lossfn)
        autograd.backward(loss)
        trainer.step(1)
        losses.append(loss.detach())
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t1) * 1e3)
    launches = multi_sgd_mom.launches - before
    expected = groups * (RFCN_STEPS + RFCN_HYBRID_STEPS + 1)
    stats = graph_summary(net)
    losses = [v.item() for v in losses]
    free_graphs(net)
    on_card = as_device(dev).type == "cuda"
    checks = {"losses_finite": all(math.isfinite(v) for v in losses),
              "launches_exact": launches == expected
              and other_launches(multi_sgd_mom) == others,
              "leaf_check": check["ok"],
              "replayed": not on_card or stats["replays"] >= 2}
    return {"size": list(RFCN["size"]), "body": str(RFCN_BODY),
            "rois": RFCN["rois"], "sampled": RFCN["sampled"],
            "foreground": data["fg"], "trainable_params": len(trainable),
            "losses": losses, "step_ms": step_ms, "launches": launches,
            "expected_launches": expected, "graphs": stats,
            "check": {k: check[k] for k in (
                "loss_abs_err_vs_cpu", "decisions", "flips",
                "peak_memory_gb", "ok")} | {
                part: _brief(check[part]) for part in ("weights", "grads")},
            "checks": checks, "seconds": time.monotonic() - t0,
            "ok": all(checks.values())}


# ---- phase 22 (c): a Sockeye-width RNN NMT in mx.sym ---------------------

#: Sockeye 1.x's RNN model (``sockeye/arguments.py``): --num-embed 512,
#: --rnn-num-hidden 1024 (the encoder's bidirectional layer 512 a
#: direction), LSTM, MLP attention of --rnn-attention-num-hidden = 1024,
#: --rnn-residual-connections with two decoder layers, dropout 0.1,
#: --bucket-width 10 up to 50, batch 64, vocabularies of 32,000
NMT22 = {"vocab": 32000, "embed": 512, "enc": 512, "dec": 1024, "att": 1024,
         "dropout": 0.1, "batch": 64, "buckets": (10, 20, 30, 40, 50)}
NMT22_BOS, NMT22_EOS = 1, 2
NMT22_OPT = {"learning_rate": 2e-4}            # Adam, Sockeye's default
NMT22_CHECK_OPT = {"learning_rate": 0.1}       # the check step's SGD
NMT22_TRANSLATE = 50                           # while_loop's max_iterations


def nmt22_params(pkg, w: dict) -> dict:
    """The decoder's weight variables, with their shapes (shape inference
    does not look inside a loop's body) and the LSTM cells' parameters
    (``RNNParams``, the forget gate's bias initialised to 1)."""
    sym, rnn = pkg.sym, pkg.rnn
    e, he, hd, a = w["embed"], 2 * w["enc"], w["dec"], w["att"]
    lstm_bias = json.dumps(["lstmbias", {"forget_bias": 1.0}])
    cells = []
    for i, n_in in enumerate((e + he, hd)):
        p = rnn.RNNParams(f"dec{i}_")
        p.get("i2h_weight", shape=(4 * hd, n_in))
        p.get("h2h_weight", shape=(4 * hd, hd))
        p.get("i2h_bias", shape=(4 * hd,), __init__=lstm_bias)
        p.get("h2h_bias", shape=(4 * hd,))
        cells.append(p)
    return {"cells": cells,
            "att_q": sym.var("att_q_weight", shape=(a, hd)),
            "att_v": sym.var("att_v_weight", shape=(1, a)),
            "out_w": sym.var("dec_out_weight", shape=(hd, hd + he)),
            "out_b": sym.var("dec_out_bias", shape=(hd,))}


def nmt22_encoder(pkg, length: int, w: dict):
    """Source embedding, one bidirectional ``FusedRNNCell`` layer, and the
    attention's length mask picked by a ``_cond`` (a bias of -1e9 on
    padding where the batch has any, else zeros): ``(enc, bias)``."""
    sym, rnn = pkg.sym, pkg.rnn
    src = sym.var("src")
    emb = sym.Embedding(src, sym.var("src_embed_weight", shape=(
        w["vocab"], w["embed"])), input_dim=w["vocab"],
        output_dim=w["embed"], name="src_embed")
    cell = rnn.FusedRNNCell(w["enc"], bidirectional=True, prefix="enc_",
                            input_size=w["embed"])
    enc, _ = cell.unroll(length, emb, layout="NTC", merge_outputs=True)
    mask = sym.clip(src, 0.0, 1.0)
    bias = sym.contrib.cond(sym.min(mask) < 0.5,
                            lambda: (mask - 1.0) * 1e9, lambda: mask * 0.0,
                            name="length_mask")
    return enc, bias


def nmt22_step(pkg, x, states, enc, enc_proj, bias, p: dict, w: dict,
               dropout: float):
    """One decoder step (Sockeye's RNN decoder with input feeding): the
    embedding and the last attention context into ``LSTMCell`` ->
    ``DropoutCell`` -> ``ResidualCell(LSTMCell)``, MLP attention over the
    encoder states, a tanh hidden layer: ``(hidden, new states)``."""
    sym, rnn = pkg.sym, pkg.rnn
    h0, c0, h1, c1, ctx = states
    cell0 = rnn.LSTMCell(w["dec"], prefix="dec0_", params=p["cells"][0])
    cell1 = rnn.ResidualCell(rnn.LSTMCell(w["dec"], prefix="dec1_",
                                          params=p["cells"][1]))
    drop = rnn.DropoutCell(dropout, prefix="dec_drop_")
    o0, (h0, c0) = cell0(sym.concat(x, ctx, dim=1), [h0, c0])
    o0, _ = drop(o0, [])
    o1, (h1, c1) = cell1(o0, [h1, c1])
    q = sym.FullyConnected(o1, weight=p["att_q"], num_hidden=w["att"],
                           no_bias=True)
    e = sym.tanh(sym.broadcast_add(enc_proj, sym.expand_dims(q, axis=1)))
    score = sym.reshape(sym.FullyConnected(
        e, weight=p["att_v"], num_hidden=1, no_bias=True, flatten=False),
        shape=(0, -1))
    att = sym.softmax(score + bias, axis=1)
    ctx = sym.sum(sym.broadcast_mul(enc, sym.expand_dims(att, axis=2)),
                  axis=1)
    hid = sym.tanh(sym.FullyConnected(sym.concat(o1, ctx, dim=1),
                                      weight=p["out_w"], bias=p["out_b"],
                                      num_hidden=w["dec"]))
    return hid, [h0, c0, h1, c1, ctx]


def _nmt22_start(pkg, enc, w):
    """The attention's projection of the encoder states and the decoder's
    initial states (Sockeye's ``--rnn-decoder-state-init``: a tanh layer
    over the encoder's mean state; zero cells and context)."""
    sym = pkg.sym
    he = 2 * w["enc"]
    enc_proj = sym.FullyConnected(
        enc, sym.var("att_enc_weight", shape=(w["att"], he)),
        num_hidden=w["att"], no_bias=True, flatten=False, name="att_enc")
    mean = sym.mean(enc, axis=1)
    h = sym.tanh(sym.FullyConnected(
        mean, sym.var("dec_init_weight", shape=(w["dec"], he)),
        sym.var("dec_init_bias", shape=(w["dec"],)), num_hidden=w["dec"],
        name="dec_init"))
    return enc_proj, [h, h * 0.0, h, h * 0.0, mean * 0.0]


def nmt22_decoder(pkg, enc, bias, tgt, length: int, w: dict):
    """The decoder over the target embeddings by ``sym.contrib.foreach``
    (the encoder states a free input of the body), the output layer to
    the vocabulary and ``SoftmaxOutput`` ignoring label 0."""
    sym = pkg.sym
    p = nmt22_params(pkg, w)
    enc_proj, init = _nmt22_start(pkg, enc, w)
    emb = sym.Embedding(tgt, sym.var("tgt_embed_weight", shape=(
        w["vocab"], w["embed"])), input_dim=w["vocab"],
        output_dim=w["embed"], name="tgt_embed")
    outs, _ = sym.contrib.foreach(
        lambda x, st: nmt22_step(pkg, x, st, enc, enc_proj, bias, p, w,
                                 w["dropout"]),
        sym.swapaxes(emb, dim1=0, dim2=1), init, name="decoder")
    hid = sym.reshape(sym.swapaxes(outs, dim1=0, dim2=1),
                      shape=(-1, w["dec"]))
    logits = sym.FullyConnected(
        hid, sym.var("logits_weight", shape=(w["vocab"], w["dec"])),
        sym.var("logits_bias", shape=(w["vocab"],)), num_hidden=w["vocab"],
        name="logits")
    return sym.SoftmaxOutput(logits, sym.reshape(sym.var("label"),
                                                 shape=(-1,)),
                             ignore_label=0, use_ignore=True, name="softmax")


def nmt22_sym(pkg, length: int, w: dict = None):
    """The whole model at bucket ``length`` (source and target)."""
    w = w or NMT22
    enc, bias = nmt22_encoder(pkg, length, w)
    return nmt22_decoder(pkg, enc, bias, pkg.sym.var("tgt"), length, w)


def nmt22_stages(pkg, length: int, w: dict = None):
    """The model as two stages for ``SequentialModule``: the encoder
    (data ``src``, ``tgt``; outputs the encoder states, the attention
    bias and ``tgt`` passed on) and the decoder (data ``enc``, ``bias``,
    ``tgt``; label ``label``)."""
    w = w or NMT22
    sym = pkg.sym
    enc, bias = nmt22_encoder(pkg, length, w)
    first = sym.Group([enc, bias, sym.BlockGrad(sym.var("tgt"))])
    second = nmt22_decoder(pkg, sym.var("enc"), sym.var("bias"),
                           sym.var("tgt"), length, w)
    return first, second


def nmt22_translate_sym(pkg, length: int, w: dict = None,
                        steps: int = NMT22_TRANSLATE):
    """Greedy translation by ``sym.contrib.while_loop``: from ``BOS``,
    each step's arg-max token until every sentence has given ``EOS`` (or
    ``steps``); the tokens (``steps``, batch), 0 after a sentence ended.
    The weights are the training graph's (the same names)."""
    w = w or NMT22
    sym = pkg.sym
    p = nmt22_params(pkg, w)
    enc, bias = nmt22_encoder(pkg, length, w)
    enc_proj, init = _nmt22_start(pkg, enc, w)
    v = w["vocab"]
    emb_w = sym.var("tgt_embed_weight", shape=(v, w["embed"]))
    logit_w = sym.var("logits_weight", shape=(v, w["dec"]))
    logit_b = sym.var("logits_bias", shape=(v,))
    tok0 = sym.sum(bias * 0.0, axis=1) + float(NMT22_BOS)

    def body(tok, done, h0, c0, h1, c1, ctx):
        x = sym.Embedding(tok, weight=emb_w, input_dim=w["vocab"],
                          output_dim=w["embed"])
        hid, st = nmt22_step(pkg, x, [h0, c0, h1, c1, ctx], enc, enc_proj,
                             bias, p, w, 0.0)
        logits = sym.FullyConnected(hid, weight=logit_w, bias=logit_b,
                                    num_hidden=w["vocab"])
        nxt = sym.argmax(logits, axis=1) * (1.0 - done)
        done = sym.maximum(done, sym.broadcast_equal(
            nxt, sym.ones_like(nxt) * float(NMT22_EOS)))
        return nxt, [nxt, done] + st

    tokens, _ = sym.contrib.while_loop(
        lambda tok, done, *st: sym.sum(1.0 - done) > 0.0, body,
        [tok0, tok0 * 0.0] + init, max_iterations=steps, name="translate")
    return tokens


def nmt22_batch(rng, length: int, w: dict, batch: int):
    """A batch at bucket ``length``: source sentences of ``length - 9``
    to ``length - 1`` tokens (ids from 3, 0 pads), the target their
    reverse then ``EOS``, the decoder's input ``BOS`` then the target."""
    src = np.zeros((batch, length), np.float32)
    tgt = np.zeros((batch, length), np.float32)
    label = np.zeros((batch, length), np.float32)
    for i, n in enumerate(rng.integers(max(1, length - 9), length, batch)):
        s = rng.integers(3, w["vocab"], n)
        src[i, :n] = s
        label[i, :n], label[i, n] = s[::-1], NMT22_EOS
        tgt[i, 0], tgt[i, 1:n + 1] = NMT22_BOS, s[::-1]
    return mx_io.DataBatch(
        data=[nd.array(src, ctx=cpu()), nd.array(tgt, ctx=cpu())],
        label=[nd.array(label, ctx=cpu())], bucket_key=length,
        provide_data=[mx_io.DataDesc("src", (batch, length)),
                      mx_io.DataDesc("tgt", (batch, length))],
        provide_label=[mx_io.DataDesc("label", (batch, length))])


def nmt22_module(ctx, w: dict, batch: int, buckets):
    """A ``BucketingModule`` of ``nmt22_sym`` over ``buckets`` (the
    longest the default), bound and initialised (Uniform(0.1))."""
    def gen(length):
        return nmt22_sym(mxt, length, w), ("src", "tgt"), ("label",)
    key = max(buckets)
    mod = mx_mod.BucketingModule(gen, default_bucket_key=key, context=ctx)
    mod.bind([("src", (batch, key)), ("tgt", (batch, key))],
             [("label", (batch, key))])
    mod.init_params(mx_init.Uniform(0.1))
    return mod


class _Batches(mx_io.DataIter):
    """A ``DataIter`` over a list of batches."""

    def __init__(self, batches):
        super().__init__(batches[0].data[0].shape[0])
        self._batches, self._i = batches, 0
        self.provide_data = batches[0].provide_data
        self.provide_label = batches[0].provide_label

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= len(self._batches):
            raise StopIteration
        self._i += 1
        return self._batches[self._i - 1]


def _to(batch, ctx):
    return mx_io.DataBatch(
        data=[a.as_in_context(ctx) for a in batch.data],
        label=[a.as_in_context(ctx) for a in batch.label],
        bucket_key=batch.bucket_key, provide_data=batch.provide_data,
        provide_label=batch.provide_label)


def _grads(mod) -> dict:
    """name -> a copy of the gradient, over every stage of a module."""
    mods = getattr(mod, "_modules", None) or [mod]
    out = {}
    for m in mods:
        m = getattr(m, "_curr_module", None) or m
        out.update({n: g._data.detach().clone()
                    for n, g in m._grad_params.items() if g is not None})
    return out


def nmt22_sequential(ctx, w: dict, batch: int, length: int, arg, aux):
    """The model as a ``SequentialModule`` of an encoder ``Module`` and a
    decoder ``Module`` (``take_labels``), bound at ``length`` and set to
    ``arg``."""
    first, second = nmt22_stages(mxt, length, w)
    seq = mx_mod.SequentialModule()
    seq.add(mx_mod.Module(first, data_names=("src", "tgt"),
                          label_names=None, context=ctx))
    seq.add(mx_mod.Module(second, data_names=("enc", "bias", "tgt"),
                          label_names=("label",), context=ctx),
            take_labels=True)
    seq.bind([("src", (batch, length)), ("tgt", (batch, length))],
             [("label", (batch, length))])
    seq.init_params(arg_params=arg, aux_params=aux)
    return seq


def nmt22_check(w: dict, arg: dict, batch) -> dict:
    """The check step at the batch's bucket: ``held_step`` (card, CPU fp32
    and float64 from ``arg``; the CPU runs taking the card's dropout
    masks, ``DropoutDecisions``)."""
    length = batch.bucket_key

    def make(ctx):
        mod = mx_mod.Module(nmt22_sym(mxt, length, w),
                            data_names=("src", "tgt"),
                            label_names=("label",), context=ctx)
        mod.bind(batch.provide_data, batch.provide_label)
        return mod
    arrays = ([a.asnumpy() for a in batch.data],
              [a.asnumpy() for a in batch.label])
    return held_step(make, arg, arrays, NMT22_CHECK_OPT,
                     decisions=DropoutDecisions)


class DropoutDecisions(Decisions):
    """``Decisions`` of the ``Dropout`` op's masks: each
    ``Tensor.bernoulli_`` is recorded, or, given ``masks``, its result
    replaced by the recorded mask (``flips`` stays 0: a draw has no
    decision of its own to compare)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.Tensor.bernoulli_:
            return super().__torch_function__(func, types, args, kwargs)
        out = func(*args, **kwargs)
        self.units += out.numel()
        if self._forced is None:
            self.masks.append(out.detach().cpu().clone())
            return out
        mask = self._forced[self._calls]
        self._calls += 1
        return out.copy_(mask.to(out.device, out.dtype))


def nmt22_run(seed: int, w: dict = None) -> dict:
    """(c) the NMT of ``nmt22_sym`` at ``NMT22``'s widths, batch
    ``w["batch"]``: the check step (``nmt22_check``) at the shortest
    bucket; one Adam step in every bucket (step ms); the same step as a
    ``SequentialModule`` (outputs and gradients against the single
    module's); a ``Monitor(".*weight")`` through ``fit`` (one SGD step)
    on one batch against the CPU's; the encoder's fused output against ``unfuse()``'s
    cells; greedy translation by ``while_loop`` (saved and loaded back:
    bit for bit); ``mx.name.Prefix`` and ``mx.AttrScope`` on the
    graph."""
    w = w or NMT22
    dev = gpu(0)
    t0 = time.monotonic()
    rng = np.random.default_rng(seed + 22)
    bsz, buckets = w["batch"], w["buckets"]
    batches = {b: nmt22_batch(rng, b, w, bsz) for b in buckets}
    mx_random.seed(seed)
    mod = nmt22_module(dev, w, bsz, buckets)
    arg, aux = mod.get_params()
    res, checks = {"params": int(sum(v.size for v in arg.values()))}, {}
    res["check"] = nmt22_check(w, arg, batches[buckets[0]])
    checks["leaf_check"] = res["check"]["ok"]
    # the SequentialModule against the single module, at the shortest bucket
    b = _to(batches[buckets[0]], dev)
    single = mx_mod.Module(nmt22_sym(mxt, buckets[0], w),
                           data_names=("src", "tgt"), label_names=("label",),
                           context=dev)
    single.bind(b.provide_data, b.provide_label)
    single.init_params(arg_params=arg, aux_params=aux)
    seq = nmt22_sequential(dev, w, bsz, buckets[0], arg, aux)
    outs = {}
    for name, m in (("single", single), ("sequential", seq)):
        mx_random.seed(seed + 5)            # the same dropout masks
        m.forward_backward(b)
        outs[name] = (m.get_outputs()[0]._data.detach().clone(), _grads(m))
    (o1, g1), (o2, g2) = outs["single"], outs["sequential"]
    scale = max(v.abs().max().item() for v in g1.values())
    res["sequential"] = {
        "output_max_abs_err": (o1 - o2).abs().max().item(),
        "grad_max_abs_err": max((g1[k] - g2[k]).abs().max().item()
                                for k in g1),
        "grad_scale": scale, "params": len(g2)}
    checks["sequential_matches"] = (
        sorted(g1) == sorted(g2)
        and res["sequential"]["output_max_abs_err"] <= 1e-6
        and res["sequential"]["grad_max_abs_err"] <= 1e-5 * scale)
    del single, seq, outs
    # one Adam step in every bucket
    mod.init_optimizer(optimizer="adam", optimizer_params=dict(NMT22_OPT))
    step_ms, losses = {}, {}
    for key in buckets:
        bb = _to(batches[key], dev)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        mod.forward_backward(bb)
        mod.update()
        torch.cuda.synchronize()
        step_ms[key] = (time.monotonic() - t1) * 1e3
        prob = mod.get_outputs()[0]._data
        lab = bb.label[0]._data.reshape(-1).long()
        keep = lab > 0
        losses[key] = -torch.log(prob[keep, lab[keep]].clamp(min=1e-30)) \
            .mean().item()
    res["step_ms"], res["losses"] = step_ms, losses
    checks["losses_finite"] = all(math.isfinite(v) for v in losses.values())
    trained, trained_aux = mod.get_params()
    # Monitor through fit on one batch, card against CPU (the CPU's fit
    # taking the card's dropout masks), by SGD: Adam's first step moves
    # each weight by its rate whatever the gradient's size, so a gradient
    # that is zero up to rounding would part the two runs' weights by
    # twice the rate at random
    stats, masks = {}, None
    for name, ctx in (("card", dev), ("cpu", cpu())):
        m = mx_mod.BucketingModule(
            lambda n: (nmt22_sym(mxt, n, w), ("src", "tgt"), ("label",)),
            default_bucket_key=buckets[0], context=ctx)
        mon = mxt.Monitor(interval=1, pattern=".*weight")
        rows = []
        mon.toc_print = lambda mon=mon, rows=rows: rows.extend(mon.toc())
        with DropoutDecisions(masks) as drops:
            m.fit(_Batches([_to(batches[buckets[0]], ctx)]), num_epoch=1,
                  arg_params=trained, aux_params=trained_aux,
                  optimizer="sgd", optimizer_params=dict(NMT22_CHECK_OPT),
                  monitor=mon, eval_metric=metric.Perplexity(ignore_label=0))
        masks = drops.masks
        mon.uninstall()
        stats[name] = {n: float(s) for _, n, s in rows}
    errs = {n: abs(stats["card"][n] - stats["cpu"][n]) / max(
        1e-12, abs(stats["cpu"][n])) for n in stats["cpu"]}
    res["monitor"] = {"stats": len(stats["card"]),
                      "max_rel_err_vs_cpu": max(errs.values(), default=0.0)}
    checks["monitor"] = (sorted(stats["card"]) == sorted(stats["cpu"])
                         and len(stats["card"]) > 0
                         and res["monitor"]["max_rel_err_vs_cpu"] <= 1e-4)
    # the fused encoder against unfuse()'s cells
    cell = mx_rnn.FusedRNNCell(w["enc"], bidirectional=True, prefix="enc_",
                               input_size=w["embed"])
    x = mx_sym.var("data")
    fused, _ = cell.unroll(buckets[0], x, merge_outputs=True)
    unfused, _ = cell.unfuse().unroll(buckets[0], x, merge_outputs=True)
    emb = torch.randn(bsz, buckets[0], w["embed"],
                      generator=torch.Generator().manual_seed(seed))
    feed = {"data": nd.array(emb.numpy(), ctx=dev),
            "enc_parameters": trained["enc_parameters"].as_in_context(dev)}
    y1 = fused.eval(**feed)[0]._data
    cells = cell.unpack_weights(feed)
    y2 = unfused.eval(**{k: v.as_in_context(dev) for k, v in cells.items()
                         })[0]._data
    res["unfuse_max_abs_err"] = (y1 - y2).abs().max().item()
    checks["unfuse_matches"] = res["unfuse_max_abs_err"] <= 1e-5 * max(
        1.0, y1.abs().max().item())
    # greedy translation by while_loop, saved and loaded back
    tr = nmt22_translate_sym(mxt, buckets[0], w)
    loaded = mx_sym.load_json(tr.tojson())
    feed = {k: trained[k].as_in_context(dev) for k in tr.list_arguments()
            if k in trained}
    feed["src"] = batches[buckets[0]].data[0].as_in_context(dev)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    toks = tr.eval(**feed)[0]._data
    torch.cuda.synchronize()
    translate_ms = (time.monotonic() - t1) * 1e3
    again = loaded.eval(**feed)[0]._data
    ended = toks == NMT22_EOS
    after = torch.cumsum(ended.long(), 0) - ended.long() > 0
    res["translate"] = {"ms": translate_ms, "steps": NMT22_TRANSLATE,
                        "tokens": list(toks.shape),
                        "ended": int(ended.any(0).sum())}
    checks["translate_valid"] = bool(
        (toks >= 0).all() and (toks < w["vocab"]).all()
        and (toks[after] == 0).all())
    checks["loaded_bitwise"] = bool(torch.equal(toks, again))
    # the name and attribute scopes stamp the graph
    with mxt.name.Prefix("nmt_"), mxt.AttrScope(ctx_group="decoder"):
        scoped = mx_sym.FullyConnected(mx_sym.var("h"), num_hidden=4)
        plain = mx_sym.FullyConnected(mx_sym.var("h"), num_hidden=4,
                                      name="given")
    checks["scopes"] = (scoped.name.startswith("nmt_fullyconnected")
                        and plain.name == "given"
                        and scoped.attr("ctx_group") == "decoder"
                        and "nmt_fullyconnected" in scoped.list_arguments(
                        )[1] and mx_sym.var("z").attr("ctx_group") is None)
    res.update(checks=checks, seconds=time.monotonic() - t0,
               ok=all(checks.values()))
    return res


# ---- phase 22 (d): mx.model.FeedForward ----------------------------------

FF = {"samples": 2000, "held_out": 500, "batch": 100, "epochs": 2,
      "opt": {"learning_rate": 0.1, "momentum": 0.9}}


def ff_sym():
    """Config #1's MLP in ``mx.sym``: 784-128 relu - 64 relu - 10,
    ``SoftmaxOutput`` (label ``softmax_label``)."""
    x = mx_sym.var("data")
    for i, n in enumerate((128, 64)):
        x = mx_sym.Activation(mx_sym.FullyConnected(
            x, num_hidden=n, name=f"fc{i + 1}"), act_type="relu")
    return mx_sym.SoftmaxOutput(mx_sym.FullyConnected(
        x, num_hidden=10, name="fc3"), name="softmax")


def ff_data(seed: int):
    """784-feature samples of 10 classes (a class's mean plus noise),
    ``FF["samples"]`` to train on and ``FF["held_out"]`` held out."""
    rng = np.random.default_rng(seed + 220)
    means = rng.standard_normal((10, 784)).astype(np.float32)
    n = FF["samples"] + FF["held_out"]
    y = rng.integers(0, 10, n).astype(np.float32)
    x = means[y.astype(int)] + 2.0 * rng.standard_normal(
        (n, 784)).astype(np.float32)
    return (x[:FF["samples"]], y[:FF["samples"]]), \
        (x[FF["samples"]:], y[FF["samples"]:])


def feedforward_run(seed: int) -> dict:
    """(d) ``FeedForward`` fits the MLP for ``FF["epochs"]`` epochs on the
    card (SGD with momentum, batch 100, Xavier from ``seed``), then
    ``predict``s and ``score``s the held-out samples; the same run
    through ``Module.fit``/``score`` from the same seed must reach the
    same accuracy, with the same kernel launches."""
    dev = gpu(0)
    t0 = time.monotonic()
    (x, y), (xt, yt) = ff_data(seed)
    res = {}
    for name in ("feedforward", "module"):
        train = mx_io.NDArrayIter(x, y, batch_size=FF["batch"])
        mx_random.seed(seed)
        before = multi_sgd_mom.launches
        t1 = time.monotonic()
        if name == "feedforward":
            model = mx_model.FeedForward(
                ff_sym(), ctx=dev, num_epoch=FF["epochs"], optimizer="sgd",
                initializer=Xavier(), numpy_batch_size=FF["batch"],
                **FF["opt"])
            model.fit(train)
            prob = model.predict(xt)
            acc = model.score(xt, yt)
        else:
            mod = mx_mod.Module(ff_sym(), context=dev)
            mod.fit(train, num_epoch=FF["epochs"], optimizer="sgd",
                    optimizer_params=dict(FF["opt"]), initializer=Xavier())
            held = mx_io.NDArrayIter(xt, yt, batch_size=FF["batch"])
            acc = dict(mod.score(held, "acc"))["accuracy"]
            prob = mod.predict(held).asnumpy()
        res[name] = {"accuracy": float(acc),
                     "predict_accuracy": float((prob.argmax(1) == yt).mean()),
                     "launches": multi_sgd_mom.launches - before,
                     "seconds": time.monotonic() - t1}
    ff, mo = res["feedforward"], res["module"]
    checks = {"accuracy_matches_module":
              abs(ff["accuracy"] - mo["accuracy"]) <= 1e-9,
              "predict_matches_score":
              abs(ff["predict_accuracy"] - ff["accuracy"]) <= 1e-9,
              "learned": ff["accuracy"] > 0.5,
              "launches_match": ff["launches"] == mo["launches"]}
    res.update(checks=checks, seconds=time.monotonic() - t0,
               launches=ff["launches"] + mo["launches"],
               ok=all(checks.values()))
    return res


def slice22_phase(seed: int, card: str) -> dict:
    """Phase 22 (a)-(d): every count set to 0 just before the phase and
    read just after it: the momentum kernel launched by (b) and (d)
    alone, no other kernel."""
    start = time.monotonic()
    zero_counts()
    res, seconds = {"card": card}, {}
    for key, fn in (("ops", contrib_ops_run), ("zipf", zipf_run),
                    ("control_flow", control_flow_run), ("rfcn", rfcn_run),
                    ("nmt", nmt22_run), ("feedforward", feedforward_run)):
        t0 = time.monotonic()
        res[key] = fn(seed)
        seconds[key] = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = multi_sgd_mom.launches
    res["other_launches"] = other_launches(multi_sgd_mom)
    res.update(part_seconds=seconds, seconds=time.monotonic() - start,
               ok=all(res[k]["ok"] for k in seconds)
               and res["launches"] == res["rfcn"]["expected_launches"]
               + res["feedforward"]["launches"]
               and res["other_launches"] == 0)
    return res


# ---- phase 23: observability, the rest of serving, and tuning -----------
# BERT-base behind the HTTP front door with causal tracing, the metrics
# endpoint, /debug, the watchdog, the flight recorder, the SLO and
# decode-slot controllers and mx.profiler's device trace.

OBS_REQUESTS = 32                 # (a): phase 4's mix of lengths 16..512
OBS_COST_REQUESTS = 64            # (b): the requests the clients cycle
OBS_COST_SECONDS = 3.0            # (b): each round's window
OBS_COST_REPEATS = 3              # (b): rounds of each setting
OBS_COST_SETTINGS = (("off", "0", "1"), ("sample_1", "1", "1"),
                     ("sample_8", "1", "8"))   # label, MXTPU_TRACE, _SAMPLE
OBS_CLIENTS = 4
OBS_TRACED_CLIENTS = 16           # (a): enough at once to batch requests
OBS_WINDOW_US = 5000              # the batch window, as phase 4's
OBS_TRACED_WINDOW_US = 20000      # (a)'s: its requests share batches
OBS_LM_REQUESTS = 4               # (a): generations beside BERT-base
OBS_PRIORITY = {"bert_base": 2, "causal_lm_small": 1}
OBS_SLO_MS = 25.0                 # BERT-base's socket-to-socket p99 budget
OBS_OVERLOAD = {"clients": 48, "requests": 192, "length": 512}
OBS_QUIET = {"clients": 1, "requests": 12, "length": 16}
#: the quiet spell: up to this many rounds, one controller tick after
#: each, until the shed steps down.  The controller steps down on the
#: second consecutive interval whose served p99 is under 0.6 x the SLO;
#: one slow request on a shared host spoils an interval of 12.
OBS_QUIET_ROUNDS = 8
OBS_SAMPLE_HZ = 100.0
OBS_WD_FACTOR = 4.0
OBS_WD_TICK_S = 0.5
OBS_HOLD_TICKS = 12
OBS_SLOT_ROUNDS = 5
OBS_SLOT_REQUESTS = 24
OBS_SLOT_NEW = (16, 64)
OBS_PROFILE_FORWARDS = 3
OBS_PROFILE_ATTEMPTS = 4          # a trace that lost records is retaken
OBS_SENTINEL_KERNELS = 32         # small kernels opening each trace
OBS_FORWARD_RANGE = "phase23.forward"
OBS_PROFILE_SHAPE = (8, 128)      # batch, sequence of the eager forwards


class BertClassify(gluon.HybridBlock):
    """BERT-base served as a sentence-pair classifier: the NSP logits, 2 a
    request, at the front door, whose JSON would otherwise carry every
    position's 30,522 MLM logits.  The whole forward runs (12 flash
    launches)."""

    def __init__(self, bert):
        super().__init__(prefix=bert.prefix)
        self.bert = bert

    def forward(self, tokens, types, valid_len):
        return self.bert(tokens, types, valid_len)[1]


class HeldServer(ModelServer):
    """A ``ModelServer`` whose batch call can be held on a host event:
    while ``holding``, the graph call waits on ``hold`` (after setting
    ``entered``) before it runs, so its worker goes silent."""

    def __init__(self, *args, **kw):
        self.hold, self.entered = threading.Event(), threading.Event()
        self.holding = False
        super().__init__(*args, **kw)

    def _build_graph(self, block, key, batch):
        raw = super()._build_graph(block, key, batch)

        def held(*arrays):
            if self.holding:
                self.entered.set()
                self.hold.wait(300)
            return raw(*arrays)
        return held


def obs_requests(seed: int, n: int, length=None) -> list:
    """BERT-base requests: lengths 16..512 cycling the buckets (phase 4's
    mix), or all of ``length``."""
    rng = np.random.default_rng(seed)
    lens = bucket_lengths(rng, n) if length is None else [length] * n
    return [(rng.integers(0, VOCAB, k).astype(np.int32),
             rng.integers(0, 2, k).astype(np.int32), np.float32(k))
            for k in lens]


def obs_callers(seed: int, n: int) -> list:
    """W3C parents for ``n`` requests: a trace id from the seed and the
    request's index, a span id from the seed."""
    rng = np.random.default_rng(seed)
    return [(tracing.deterministic_trace_id("phase23", seed, i),
             "%016x" % int(rng.integers(1, 1 << 62))) for i in range(n)]


def traceparent(parent) -> dict:
    """The W3C header of a ``(trace id, span id)`` caller, sampled."""
    return {} if parent is None else {
        "traceparent": f"00-{parent[0]}-{parent[1]}-01"}


def obs_predict(port: int, name: str, req, parent=None) -> dict:
    """One predict over HTTP: status, the echoed traceparent, the rid and
    outputs, and the client's seconds."""
    tokens, types, vl = req
    body = {"inputs": [tokens.tolist(), types.tolist(), float(vl)],
            "dtypes": ["int32", "int32", "float32"]}
    t0 = time.monotonic()
    status, headers, raw = http_json(port, "POST",
                                     f"/v1/models/{name}/predict", body,
                                     traceparent(parent), raw=True)
    s = time.monotonic() - t0
    data = json.loads(raw)
    return {"status": status, "traceparent": headers.get("traceparent"),
            "rid": data.get("rid"), "outputs": data.get("outputs"), "s": s}


def obs_round(port: int, reqs: list, clients: int, parents=None,
              name: str = "bert_base", seconds: float = 0.0) -> dict:
    """Every request over HTTP from ``clients`` threads, released
    together, each client sending its share in turn; with ``seconds``,
    the clients go on cycling their shares until that window has passed.
    The first response of each request by index, requests/s, the
    clients' p50/p99 ms over every request sent, and the process's CPU
    ms a request (clients, front door, workers: every thread's host
    work, which a busy shared host stretches less than it does the wall
    clock)."""
    out, lat = {}, []
    start = threading.Barrier(clients)
    lock = threading.Lock()

    def client(tid):
        start.wait(60)
        end = time.monotonic() + seconds
        mine = range(tid, len(reqs), clients)
        k = 0
        while mine and (k < len(mine) or time.monotonic() < end):
            i = mine[k % len(mine)]
            r = obs_predict(port, name, reqs[i],
                            None if parents is None else parents[i])
            with lock:
                out.setdefault(i, r)
                lat.append((r["s"] * 1e3, r["status"] == 200))
            k += 1
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(clients)]
    c0, t0 = time.process_time(), time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    cpu = time.process_time() - c0
    if any(t.is_alive() for t in threads) or len(out) != len(reqs):
        raise AssertionError(f"{len(out)} of {len(reqs)} requests answered")
    ms = [m for m, _ok in lat]
    return {"responses": out, "requests": len(lat), "wall_s": wall,
            "requests_per_s": len(lat) / wall,
            "cpu_ms_per_request": cpu * 1e3 / len(lat),
            "answered": sum(ok for _m, ok in lat),
            "latency_ms_p50": _pct(ms, 50), "latency_ms_p99": _pct(ms, 99)}


def cost_summary(rounds: list) -> dict:
    """(b) over ``(label, round)`` pairs: each setting's median and range
    of requests/s, CPU ms a request and the clients' p50/p99 over its
    rounds; each traced setting's medians of requests/s and of CPU ms a
    request against the untraced ones; and whether the untraced rounds'
    own range of each is inside 5 % of its median, so that a 5 % cost
    would show."""
    by = {}
    for label, r in rounds:
        by.setdefault(label, []).append(r)
    out = {}
    for label, rs in by.items():
        out[label] = {"rounds": len(rs), "requests": sum(
            r["requests"] for r in rs)}
        for key in ("requests_per_s", "cpu_ms_per_request",
                    "latency_ms_p50", "latency_ms_p99"):
            v = [r[key] for r in rs]
            out[label][key] = {"median": float(np.median(v)),
                               "min": min(v), "max": max(v), "values": v}
    if "off" not in out:
        return {"by_setting": out}
    res = {"by_setting": out}
    for key, tag in (("requests_per_s", ""), ("cpu_ms_per_request", "cpu_")):
        off = out["off"][key]
        spread = (off["max"] - off["min"]) / off["median"] * 100
        res[f"{tag}off_range_pct"] = spread
        res[f"{tag}resolves_5pct"] = spread < 5.0
        res[f"{tag}vs_off_pct"] = {
            label: (v[key]["median"] / off["median"] - 1) * 100
            for label, v in out.items() if label != "off"}
    return res


def _brief_round(r: dict) -> dict:
    return {k: v for k, v in r.items() if k != "responses"}


def trace_trees(spans: list, callers: list, responses: dict) -> dict:
    """Each traced request's spans against the contract: its
    ``serving.request`` root parented on the caller's span, an assembly
    span parented on the root or linking it (and linking only the batch's
    other requests), a dispatch span under it, a readback span under that;
    and the echoed traceparent carrying the caller's trace id.  ``linked``
    counts the requests that reached their batch by a link (a batch of
    more than one traced request links all but its first)."""
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.get("parent_id"), []).append(s)
    linking = {}
    for s in spans:
        for _t, sid in s.get("links") or ():
            linking.setdefault(sid, []).append(s)
    requests = {s["span_id"]: s for s in spans
                if s["name"] == "serving.request"}
    bad, linked = [], 0
    for i, (tid, sid) in enumerate(callers):
        echoed = (responses[i]["traceparent"] or "-").split("-")
        roots = [s for s in by_parent.get(sid, [])
                 if s["name"] == "serving.request" and s["trace_id"] == tid]
        if len(roots) != 1 or len(echoed) < 2 or echoed[1] != tid:
            bad.append((i, "root"))
            continue
        root = roots[0]
        asm = [s for s in by_parent.get(root["span_id"], []) +
               linking.get(root["span_id"], [])
               if s["name"] == "serving.assemble"]
        if len(asm) != 1 or not all(
                requests.get(sid_) for _t, sid_ in asm[0].get("links")
                or ()):
            bad.append((i, "assemble"))
            continue
        linked += asm[0]["parent_id"] != root["span_id"]
        disp = [s for s in by_parent.get(asm[0]["span_id"], [])
                if s["name"] == "serving.dispatch"]
        rb = [s for s in by_parent.get(disp[0]["span_id"], [])
              if s["name"] == "serving.readback"] if len(disp) == 1 else []
        if len(rb) != 1:
            bad.append((i, "dispatch/readback"))
    return {"requests": len(callers), "bad": bad[:8], "n_bad": len(bad),
            "linked": linked, "ok": not bad}


def like_batches(on: dict, off: dict, batch_of: dict) -> dict:
    """The served logits of the same requests with tracing on and off,
    compared bit for bit where both ran in the same batch bucket (the
    graph of one shape: cuBLAS picks its algorithm by shape)."""
    same = differ = 0
    for i, a in on["responses"].items():
        b = off["responses"][i]
        if batch_of.get(a["rid"]) != batch_of.get(b["rid"]) or \
                batch_of.get(a["rid"]) is None:
            continue
        if np.array_equal(np.asarray(a["outputs"], np.float32),
                          np.asarray(b["outputs"], np.float32)):
            same += 1
        else:
            differ += 1
    return {"compared": same + differ, "bitwise": same, "differ": differ,
            "ok": differ == 0 and same > 0}


def parse_prometheus(text: str) -> dict:
    """Samples by metric name: ``{name: [(labels, value, exemplar)]}``
    (``exemplar`` the trace id of an OpenMetrics suffix, or None)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample, _, ex = line.partition(" # ")
        head, _, value = sample.rpartition(" ")
        name, _, labels = head.partition("{")
        labels = dict(kv.split("=", 1) for kv in labels.rstrip("}").split(
            ",") if kv) if labels else {}
        labels = {k: v.strip('"') for k, v in labels.items()}
        m = re.search(r'trace_id="([0-9a-f]+)"', ex) if ex else None
        out.setdefault(name, []).append(
            (labels, float(value), m.group(1) if m else None))
    return out


def exemplar_check(text: str, trc) -> dict:
    """The p99 bucket of ``serving.request_us`` in the scraped text and
    the exemplar trace id it carries, looked up in the span ring."""
    samples = parse_prometheus(text)
    total = samples["mxtpu_serving_request_us_count"][0][1]
    buckets = samples["mxtpu_serving_request_us_bucket"]
    p99 = next(b for b in buckets if b[1] >= 0.99 * total)
    found = bool(p99[2]) and bool(trc.find(p99[2]))
    return {"count": total, "p99_le": p99[0]["le"], "exemplar": p99[2],
            "in_ring": found, "buckets_with_exemplars":
                sum(1 for b in buckets if b[2]), "ok": found}


def tagged_worker_stacks(windows: list, trc) -> dict:
    """Sampled stacks of the dispatch workers tagged with a trace id that
    the span ring holds (``/debug/profile``'s JSON windows)."""
    n = tagged = 0
    for w in windows:
        for st in w["stacks"]:
            if not st["stack"].startswith("mxtpu-serving-worker"):
                continue
            n += st["count"]
            if st["trace_id"] and trc.find(st["trace_id"]):
                tagged += st["count"]
    return {"worker_samples": n, "tagged": tagged, "ok": tagged > 0}


def obs_get(port: int, path: str):
    """A GET's status and body bytes."""
    status, _headers, body = http_json(port, "GET", path, raw=True)
    return status, body


def obs_generate(port: int, n: int, parents=None) -> list:
    """``n`` short generations over SSE (with W3C parents): the statuses
    and echoed trace ids."""
    out = []
    for i in range(n):
        status, headers, _ = http_json(
            port, "POST", "/v1/models/causal_lm_small/generate",
            {"prompt": list(range(3, 9 + i)), "max_new_tokens": 8},
            traceparent(None if parents is None else parents[i]), raw=True)
        tp = headers.get("traceparent")
        out.append((status, tp.split("-")[1] if tp else None))
    return out


@contextlib.contextmanager
def obs_env(**values):
    """Set knobs for a block (strings; None unsets), then put them back."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def batch_sizes(rec) -> dict:
    """Request id -> the batch bucket it was served in, from a flight
    recorder's request ring."""
    return {r["request_id"]: r["batch_size"] for r in rec.requests()}


def front_door_cell(seed: int, dev, out_dir: Path, classify, lm) -> dict:
    """(a) BERT-base (priority 2, ``slo_ms``) and ``causal_lm_small``
    (priority 1) behind ``HttpFrontend``: a traced round of requests with
    W3C parents, their span trees, the Chrome trace, the flash launches;
    (b) tracing's cost; (c) the metrics endpoint, the JSONL writer and
    ``/debug``; (e) the SLO controller shedding the generation model."""
    trc = tracing.tracer()
    reg = registry()
    # the front door's own request ring (the process's holds phase 4 on),
    # deep enough for every request of the phase
    rec = obs_flight.FlightRecorder(capacity=16384)
    # the batch window is the live knob: OBS_WINDOW_US, and the traced
    # round's wider one, so its requests share batches (the links)
    srv = ModelServer(classify, max_batch=BATCH_BUCKETS[-1],
                      length_buckets=LENGTH_BUCKETS,
                      batch_buckets=BATCH_BUCKETS, queue_depth=1024,
                      deadline_ms=0, workers=2, flight=rec)
    gen = GenerationServer(lm, deadline_ms=0, flight=rec, **GEN_SMALL)
    models = ModelRegistry()
    t0 = time.monotonic()
    models.load("bert_base", srv, priority=OBS_PRIORITY["bert_base"],
                slo_ms=OBS_SLO_MS, warm=[(
                    np.zeros(n, np.int32), np.zeros(n, np.int32),
                    np.float32(n)) for n in LENGTH_BUCKETS])
    models.load("causal_lm_small", gen,
                priority=OBS_PRIORITY["causal_lm_small"], warm=True)
    warm_s = time.monotonic() - t0
    fe = HttpFrontend(models, port=0, addr="127.0.0.1").start()
    reqs = obs_requests(seed + 23, OBS_REQUESTS)
    cost_reqs = obs_requests(seed + 24, OBS_COST_REQUESTS)
    callers = obs_callers(seed + 23, OBS_REQUESTS + OBS_LM_REQUESTS)
    res = {"warm_s": warm_s}
    window = obs_env(MXTPU_SERVING_BATCH_WINDOW_US=str(OBS_WINDOW_US))
    window.__enter__()
    try:
        # the endpoint binds an ephemeral port, read back from it
        with obs_env(MXTPU_TRACE="1", MXTPU_TRACE_SAMPLE="1",
                     MXTPU_METRICS_PORT="0", MXTPU_DEBUG_ENDPOINTS="1",
                     MXTPU_PROF_SAMPLE_HZ=str(OBS_SAMPLE_HZ)):
            obs_export.maybe_start_from_env()
            if obs_export.env_server() is None:
                raise AssertionError("phase 23: the metrics endpoint of "
                                     "MXTPU_METRICS_PORT did not start")
            metrics_port = obs_export.env_server().port
            obs_sampler.maybe_start_from_env()
            # (a) the traced round: counts set to 0 just before
            reg.histogram("serving.request_us").reset()
            trc.clear()
            done0 = reg.counter("serving.requests_done").n
            b0 = srv.stats()["batches"]
            zero_counts()
            with obs_env(MXTPU_SERVING_BATCH_WINDOW_US=str(
                    OBS_TRACED_WINDOW_US)):
                traced = obs_round(fe.port, reqs, OBS_TRACED_CLIENTS,
                                   callers[:OBS_REQUESTS])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            flash = flash_attention.launches
            other = other_launches(flash_attention)
            batches = srv.stats()["batches"] - b0
            lm_calls = obs_generate(fe.port, OBS_LM_REQUESTS,
                                    callers[OBS_REQUESTS:])
            res["lm_generations"] = lm_calls
            traced_batches = batch_sizes(rec)
            spans = trc.spans()
            res["trees"] = trace_trees(spans, callers[:OBS_REQUESTS],
                                       traced["responses"])
            res["lm_trace_echo"] = all(
                st == 200 and tid == callers[OBS_REQUESTS + i][0]
                for i, (st, tid) in enumerate(lm_calls))
            chrome = trc.dump_chrome_trace(
                str(out_dir / "phase23_trace.json"))
            events = json.load(open(chrome))["traceEvents"]
            res["chrome"] = {"events": len(events), "flows": sum(
                1 for e in events if e["ph"] in ("s", "f")),
                "ok": any(e["ph"] == "s" for e in events)}
            res["flash"] = {"launches": flash, "batches": batches,
                            "per_forward": flash / max(1, batches),
                            "other_launches": other,
                            "ok": flash == LAYERS * batches and
                            batches > 0 and other == 0}
            # (c) the metrics endpoint, scraped right after the round
            answered = traced["answered"] + sum(st == 200
                                                for st, _ in lm_calls)
            status, text = obs_get(metrics_port, "/metrics?exemplars=1")
            if status != 200:
                raise AssertionError(f"phase 23: /metrics answered {status}")
            text = text.decode()
            samples = parse_prometheus(text)
            scraped = samples["mxtpu_serving_requests_done"][0][1]
            res["metrics"] = {
                "requests_done": scraped,
                "answered_in_phase": answered,
                "done_delta": scraped - done0,
                "exemplars": exemplar_check(text, trc),
                "per_model_families": sorted({
                    s[0].get("model") for s in samples.get(
                        "mxtpu_serving_model_request_us_count", [])})}
            jsonl = out_dir / "phase23_metrics.jsonl"
            jsonl.unlink(missing_ok=True)
            writer = obs_export.JsonlWriter(str(jsonl), interval=3600.0)
            writer.write_now()
            writer.write_now()
            lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
            res["jsonl"] = {"lines": len(lines), "ok": len(lines) == 2 and
                            all("serving.requests_done" in x["metrics"]
                                for x in lines)}
            # /debug over the front door while a traced round runs
            debug = {}

            def probe():
                debug["stacks"] = obs_get(fe.port, "/debug/stacks")
                debug["profile"] = obs_get(
                    fe.port, "/debug/profile?seconds=1&hz=100&format=json")
            prober = threading.Thread(target=probe)
            prober.start()
            during = obs_round(fe.port, reqs, OBS_CLIENTS,
                               callers[:OBS_REQUESTS])
            prober.join(120)
            windows = json.loads(obs_get(
                fe.port, "/debug/profile?windows=1&format=json")[1])[
                "windows"]
            on_demand = json.loads(debug["profile"][1])
            res["debug"] = {
                "stacks_status": debug["stacks"][0],
                "profile_status": debug["profile"][0],
                "daemon": tagged_worker_stacks(windows, trc),
                "on_demand": tagged_worker_stacks([on_demand], trc),
                "during_round_ok": during["answered"] == OBS_REQUESTS}
        obs_sampler.maybe_start_from_env()      # the knob is unset: stop
        with obs_env(MXTPU_DEBUG_ENDPOINTS=None):
            res["debug"]["off_statuses"] = [
                obs_get(fe.port, p)[0] for p in ("/debug/stacks",
                                                 "/debug/profile")]
        # (b) tracing's cost: off, every root, 1 in 8, each in windows
        # of OBS_COST_SECONDS, the order rotated each repeat (drift)
        k = len(OBS_COST_SETTINGS)
        cost = []
        for rep in range(OBS_COST_REPEATS):
            for j in range(k):
                label, trace, sample = OBS_COST_SETTINGS[(rep + j) % k]
                with obs_env(MXTPU_TRACE=trace, MXTPU_TRACE_SAMPLE=sample):
                    cost.append((label, obs_round(
                        fe.port, cost_reqs, OBS_CLIENTS,
                        seconds=OBS_COST_SECONDS)))
        with obs_env(MXTPU_TRACE="0", MXTPU_SERVING_BATCH_WINDOW_US=str(
                OBS_TRACED_WINDOW_US)):
            # as the traced round, so like batches form
            untraced = obs_round(fe.port, reqs, OBS_TRACED_CLIENTS)
        batch_of = {**batch_sizes(rec), **traced_batches}
        res["bitwise"] = like_batches(traced, untraced, batch_of)
        first = dict(reversed(cost))
        res["bitwise_cost"] = like_batches(
            first["sample_1"], first["off"], batch_of) if cost else None
        res["traced_round"] = _brief_round(traced)
        res["cost"] = cost_summary(cost)
        # (e) the SLO controller over the front door
        res["slo"] = slo_cell(seed, fe, models)
    finally:
        fe.stop(drain=True)
        window.__exit__(None, None, None)
        obs_export.stop_from_env()
    res["checks"] = {
        "span_trees": res["trees"]["ok"] and res["trees"]["linked"] > 0,
        "lm_trace_echo":
            res["lm_trace_echo"], "chrome_trace": res["chrome"]["ok"],
        "flash_12_a_forward": res["flash"]["ok"],
        "logits_tracing_on_off_bitwise": res["bitwise"]["ok"]
        and (res["bitwise_cost"] or {}).get("differ", 0) == 0,
        "requests_done_scraped": res["metrics"]["done_delta"]
        == res["metrics"]["answered_in_phase"],
        "p99_exemplar_in_ring": res["metrics"]["exemplars"]["ok"],
        "per_model_family": {"bert_base", "causal_lm_small"}
        <= set(res["metrics"]["per_model_families"]),
        "jsonl_parses": res["jsonl"]["ok"],
        "debug_200_when_on": res["debug"]["stacks_status"] == 200
        and res["debug"]["profile_status"] == 200,
        "debug_404_when_off": res["debug"]["off_statuses"] == [404, 404],
        "workers_tagged_by_trace": res["debug"]["daemon"]["ok"]
        or res["debug"]["on_demand"]["ok"],
        "slo": res["slo"]["ok"]}
    res["ok"] = all(res["checks"].values())
    return res


def unshed_due(p99_ms: list, threshold_ms: float):
    """The quiet tick (0-based) on which ``SloController`` is due to step
    its shed down: the second of two consecutive intervals whose served
    p99 is under ``threshold_ms``; None if no two are."""
    good = [v < threshold_ms for v in p99_ms]
    return next((i for i in range(1, len(good))
                 if good[i - 1] and good[i]), None)


def slo_cell(seed: int, fe, models) -> dict:
    """(e) an overload round of BERT-base past its ``slo_ms`` makes
    ``SloController.tick()`` shed the generation model (429 at the door)
    and double BERT-base's workers; quiet rounds un-shed it on the second
    consecutive interval whose served p99 is under the recovery
    threshold, read beside the controller from the same histogram."""
    ctl = tuning.SloController(models, enabled=True)
    bert = models.get("bert_base")
    rec = obs_flight.recorder()
    n_tune = len(rec.tunings())
    ctl.tick()                                   # the intervals' baseline
    # the controller's signal, read alongside it: each tick's interval
    # of BERT-base's served latency
    seen = tuning.HistogramDelta(bert.h_request)
    seen.take()
    heavy = obs_requests(seed + 25, OBS_OVERLOAD["requests"],
                         OBS_OVERLOAD["length"])
    light = obs_requests(seed + 26, OBS_QUIET["requests"],
                         OBS_QUIET["length"])
    with obs_env(MXTPU_TRACE="0"):
        over = obs_round(fe.port, heavy, OBS_OVERLOAD["clients"])
        shed_tick = ctl.tick()
        level, workers = models.shed_level, bert.server.workers
        shed_status = obs_generate(fe.port, 1)[0][0]
        seen.take()
        threads = sorted(t.name for t in threading.enumerate())
        quiet, ticks, p99_ms = [], [], []
        for _ in range(OBS_QUIET_ROUNDS):
            quiet.append(obs_round(fe.port, light, OBS_QUIET["clients"]))
            ticks.append(ctl.tick())
            p99_ms.append(seen.take()["p99"] / 1e3)
            if models.shed_level < level:
                break
        after_status = obs_generate(fe.port, 1)[0][0]
    due = unshed_due(p99_ms, OBS_SLO_MS * ctl.recover)
    stepped = next((i for i, d in enumerate(ticks) if d is not None
                    and d["to"] < d["from"]), None)
    decisions = [d for d in [shed_tick] + ticks if d is not None]
    tunings = [d for d in rec.tunings()[n_tune:] if d["controller"] == "slo"]
    metric = registry().counter("tuning.slo.decisions").n
    checks = {
        "overload_past_slo": over["latency_ms_p99"] > OBS_SLO_MS,
        "shed_generation": level > OBS_PRIORITY["causal_lm_small"]
        and shed_status == 429,
        "workers_raised": workers > 2,
        "quiet_unsheds": models.shed_level
        <= OBS_PRIORITY["causal_lm_small"] and after_status == 200,
        "unshed_when_due": stepped is not None and stepped == due,
        "workers_back": bert.server.workers == 2,
        "flight_records": len(tunings) == len(decisions) >= 2,
        "tuning_metrics": metric >= len(decisions)}
    return {"overload": _brief_round(over),
            "quiet": [_brief_round(q) for q in quiet],
            "quiet_served_p99_ms": p99_ms, "unshed_due_tick": due,
            "unshed_tick": stepped, "threads_at_quiet": threads,
            "shed_level_after_overload": level,
            "workers_after_overload": workers,
            "shed_status": shed_status, "after_status": after_status,
            "decisions": decisions, "checks": checks,
            "ok": all(checks.values())}


def watchdog_cell(seed: int, out_dir: Path, classify) -> dict:
    """(d) one dispatch held on a host event: ``Watchdog.tick(dt)`` with
    synthetic ``dt`` flags ``serving.dispatch`` once and writes one
    postmortem (stacks showing the held worker, the four rings, the span
    ring, a registry snapshot); released, the touchpoint re-arms.  Then a
    forced exception dumps the flight recorder."""
    wd = obs_watchdog.Watchdog(factor=OBS_WD_FACTOR,
                               path=str(out_dir / "phase23_postmortem.json"))
    srv = HeldServer(classify, max_batch=1, length_buckets=(32,),
                     batch_buckets=(1,), deadline_ms=0, workers=1,
                     batch_window_us=0)
    # the held server's workers beat this watchdog's touchpoint
    srv._tp_dispatch = wd.touchpoint("serving.dispatch",
                                     hist="serving.dispatch_us")
    x = obs_requests(seed + 27, 1, 24)[0]
    newly, tp, fut, held = [], {"fired": True}, None, False
    try:
        srv.warmup(x)
        srv.start()
        srv.infer(*x, timeout=300)
        wd.tick(OBS_WD_TICK_S)
        srv.holding = True
        fut = srv.submit(*x)
        held = srv.entered.wait(120)
        for _ in range(OBS_HOLD_TICKS):
            newly += wd.tick(OBS_WD_TICK_S)
        srv.holding = False
        srv.hold.set()
        fut.result(timeout=300)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            time.sleep(0.3)          # a worker beats every 0.25 s idle
            wd.tick(OBS_WD_TICK_S)
            tp = next(t for t in wd.touchpoints()
                      if t["touchpoint"] == "serving.dispatch")
            if not tp["fired"]:
                break
    finally:
        srv.hold.set()
        srv.stop()
    bundle = json.load(open(wd.last_postmortem)) if wd.last_postmortem \
        else {}
    held_frames = [t for t in bundle.get("stacks", ())
                   if any(f["func"] == "held" for f in t["frames"])]
    flight_path = out_dir / "phase23_flight.json"
    rec = obs_flight.recorder()
    with obs_env(MXTPU_FLIGHT_PATH=str(flight_path)):
        flight_path.unlink(missing_ok=True)
        rec.install()
        try:
            raise RuntimeError("phase 23: a forced exception")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        finally:
            rec.uninstall()
    dump = json.load(open(flight_path)) if flight_path.exists() else {}
    # the held server's two requests are the ring's last
    served = [(r.get("request_id"), r.get("ok"))
              for r in dump.get("requests", ())[-2:]]
    checks = {
        "held": held,
        "flagged_once": [s["touchpoint"] for s in newly]
        == ["serving.dispatch"],
        "postmortem_written": bool(bundle),
        "postmortem_shows_held_worker": bool(held_frames),
        "postmortem_sections": {"stacks", "flight", "trace_spans",
                                "snapshot"} <= set(bundle)
        and {"steps", "requests", "tuning", "membership"}
        <= set(bundle.get("flight", {})),
        "rearmed": not tp["fired"],
        "flight_dump_on_exception": dump.get("reason", "").startswith(
            "unhandled RuntimeError") and dump.get("n_requests", 0) > 0
        and fut is not None and served == [(0, True), (fut.rid, True)]}
    return {"stalls": newly, "postmortem": wd.last_postmortem,
            "held_threads": [t["name"] for t in held_frames],
            "flight_dump": {k: dump.get(k) for k in (
                "reason", "n_steps", "n_requests", "n_tuning",
                "n_membership", "n_trace_spans")},
            "checks": checks, "ok": all(checks.values())}


def decode_slot_cell(seed: int, dev) -> dict:
    """(e) ``DecodeSlotController`` ticking between rounds of the 16-slot
    generation at BERT-base's widths (phase 15 (b)'s model): each
    round's tokens bit for bit those at a fixed 16 slots."""
    net = CausalLM(**GEN_BASE_MODEL)
    net.initialize(ctx=dev, seed=seed)
    net.hybridize()
    prompts, caps = gen_requests(seed + 28, OBS_SLOT_REQUESTS,
                                 GEN_BASE_PROMPT, OBS_SLOT_NEW)
    kw = {**GEN_BASE, "max_new_tokens": OBS_SLOT_NEW[1]}
    fixed = gen_serve(net, prompts, caps, kw, "interleave")["tokens"]
    srv = GenerationServer(net, queue_depth=4096, deadline_ms=0, **kw)
    ctl = tuning.DecodeSlotController(srv, enabled=True)
    rounds = []
    try:
        srv.start()
        srv.warmup()
        ctl.tick()
        for _ in range(OBS_SLOT_ROUNDS):
            reqs = [srv.submit_generate(p, max_new_tokens=c)
                    for p, c in zip(prompts, caps)]
            tokens = [list(r.result(timeout=600)) for r in reqs]
            # a new slot count takes effect at the round's first iteration
            rounds.append({"slots": srv.decode_slots,
                           "bitwise": tokens == fixed,
                           "decision": ctl.tick()})
    finally:
        srv.stop()
    free_graphs(net)
    del net
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    widths = sorted({r["slots"] for r in rounds})
    checks = {"bitwise_every_round": all(r["bitwise"] for r in rounds),
              "moved": len(widths) > 1,
              "decisions_recorded": registry().counter(
                  "tuning.decode_slots.decisions").n >= 1}
    return {"rounds": rounds, "widths": widths, "checks": checks,
            "ok": all(checks.values())}


def profiler_cell(seed: int, dev, out_dir: Path, bert, make_replay) -> dict:
    """(f) ``mx.profiler`` with ``profile_all=True`` around 3 eager
    BERT-base forwards and an ``nd``-op MLP step: the Chrome trace holds
    the engine's op events and the card's kernels (the flash kernel 12
    times a forward, by CUPTI's records and by the wrapper's count),
    ``dumps()`` the ops' rows.  Then what one replay of a forward that
    ``make_replay()`` captures shows in ``torch.profiler``.  Each trace
    opens with a sentinel kernel, as ``device_ms``'s do.  The phase runs
    this cell in a process of its own (:func:`in_child`): CUPTI lost 1-2
    of 36 flash records in a process that had replayed many graphs.  A
    trace that lost records even so (CUPTI does now and then, in a fresh
    process too) is taken again, up to ``OBS_PROFILE_ATTEMPTS`` times; the
    wrapper's count must be exact in every attempt, and every attempt's
    counts are reported."""
    from torch.profiler import ProfilerActivity, profile
    b, s = OBS_PROFILE_SHAPE
    rng = np.random.default_rng(seed + 29)
    x = (torch.as_tensor(rng.integers(0, VOCAB, (b, s)).astype(np.int32),
                         device=dev),
         torch.zeros((b, s), dtype=torch.int32, device=dev),
         torch.full((b,), float(s), device=dev))
    mlp = ImperativeMLP(seed, gpu(0))
    with torch.inference_mode():
        bert(*x)                              # warm: kernels loaded
    mlp.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    path = out_dir / "phase23_profile.json"
    trace_dir = out_dir / "phase23_profile_cuda"
    want = LAYERS * OBS_PROFILE_FORWARDS

    scratch = torch.zeros(1, device=dev)

    def sentinel():
        """A trace's first kernels (a trace can lose its first records)."""
        if dev.type == "cuda":
            torch.cuda._sleep(SENTINEL_CYCLES)
            for _ in range(OBS_SENTINEL_KERNELS):
                scratch.add_(1)
            torch.cuda.synchronize()

    def window():
        mxt.profiler.set_config(profile_all=True, filename=str(path),
                                trace_dir=str(trace_dir))
        mxt.profiler.Profiler.get().reset()
        launches = flash_attention.launches
        mxt.profiler.set_state("run")
        try:
            sentinel()
            for _ in range(OBS_PROFILE_FORWARDS):
                with torch.inference_mode(), \
                        torch.profiler.record_function(OBS_FORWARD_RANGE):
                    bert(*x)
            mlp.step()
            nd.waitall()
        finally:
            mxt.profiler.set_state("stop")
            mxt.profiler.set_config(profile_all=False)
        launches = flash_attention.launches - launches
        mxt.profiler.dump()
        table = mxt.profiler.dumps(reset=True)
        events = json.load(open(path))["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        flash = [e for e in kernels if "flash_fwd_kernel" in e["name"]]
        # each forward's device span, and the flash records inside it
        spans = sorted((e["ts"], e["ts"] + e.get("dur", 0))
                       for e in events if e.get("name") == OBS_FORWARD_RANGE
                       and e.get("cat") == "gpu_user_annotation")
        return {"ops": {e["name"] for e in events
                        if e.get("cat") == "operator"},
                "kernels": len(kernels), "flash": len(flash),
                "launches": launches,
                "flash_by_forward": [sum(1 for e in flash
                                         if a <= e["ts"] <= b)
                                     for a, b in spans],
                "rows": [ln.split()[0] for ln in table.splitlines()[2:]
                         if ln and not ln.startswith(" ")
                         and len(ln.split()) == 6]}

    def replayed():
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            sentinel()
            replay()
            if dev.type == "cuda":
                torch.cuda.synchronize()
        device = [e for e in prof.events() if _is_kernel(e)]
        return {"cuda_graph_launch": sum(1 for e in prof.events()
                                         if "GraphLaunch" in e.name),
                "device_events": len(device),
                "flash_fwd_kernel": sum(1 for e in device
                                        if "flash_fwd_kernel" in e.name)}

    runs = []
    for _ in range(OBS_PROFILE_ATTEMPTS):
        runs.append(window())
        if runs[-1]["flash"] == want:
            break
    run = runs[-1]
    replay = make_replay()
    replays = []
    for _ in range(OBS_PROFILE_ATTEMPTS):
        replays.append(replayed())
        if replays[-1]["flash_fwd_kernel"] == LAYERS:
            break
    # the traces are large: the report keeps their counts
    shutil.rmtree(trace_dir, ignore_errors=True)
    path.unlink(missing_ok=True)
    checks = {"op_events": {"FullyConnected", "log_softmax", "pick"}
              <= run["ops"],
              "kernel_events": run["kernels"] > 0,
              "flash_launches_12_a_forward": all(
                  r["launches"] == want for r in runs),
              "flash_12_a_forward": run["flash"] == want,
              "dumps_rows": {"FullyConnected", "log_softmax"}
              <= set(run["rows"])}
    return {"op_names": sorted(run["ops"]), "kernel_events": run["kernels"],
            "flash_kernel_events": run["flash"],
            "flash_by_attempt": [r["flash"] for r in runs],
            "flash_launches_by_attempt": [r["launches"] for r in runs],
            "flash_by_forward": run["flash_by_forward"],
            "dumps_rows": run["rows"], "replayed_forward": replays[-1],
            "replay_flash_by_attempt": [r["flash_fwd_kernel"]
                                        for r in replays],
            "checks": checks, "ok": all(checks.values())}


def profiler_entry(seed: int, out_dir: Path) -> dict:
    """(f) on its own: BERT-base from the seed (phase 23's weights), the
    profiler cell, and for its replay the front door's capture of the
    largest batch and length bucket, taken after the profiled window."""
    dev = gpu(0)
    bert = bert_base(dropout=0.0)
    bert.initialize(ctx=dev, seed=seed)
    classify = BertClassify(bert)
    b, s = BATCH_BUCKETS[-1], LENGTH_BUCKETS[-1]
    arrays = (np.zeros((b, s), np.int32), np.zeros((b, s), np.int32),
              np.full((b,), s, np.float32))

    def make_replay():
        graph = classify.cached_graph(*arrays)
        return lambda: readback(graph.raw(*arrays))
    try:
        return profiler_cell(seed, dev, out_dir, bert, make_replay)
    finally:
        free_graphs(classify)


def nmt_flash_backward(seed: int, out_dir: Path) -> dict:
    """The flash backward at the NMT's shapes (phase 12), with SDPA's
    time beside it."""
    return check_flash_backward(
        torch.Generator().manual_seed(seed), NMT_BATCH, NMT_HEADS, 48,
        HEAD_DIM, torch.float32, 20, lk=64, lost=3)


#: measurements that ``main`` takes in a fresh process of this script
#: (``CHILD_FLAG``): CUPTI lost records of their traces in the whole
#: script's process, after many graph replays (phase 23's flash kernel
#: 1-2 of 36; phase 12's SDPA backward a whole call's in 3 of 3 traces)
CHILD_TASKS = {"phase23_profiler": profiler_entry,
               "nmt_flash_backward": nmt_flash_backward}
CHILD_FLAG = "--child"


def in_child(task: str, seed: int, out_dir: Path) -> dict:
    """``CHILD_TASKS[task]`` in a fresh process of this script, so that
    no earlier graph replay sits in front of CUPTI: its report, and the
    child's seconds from start to exit."""
    report = out_dir / f"{task}.json"
    report.unlink(missing_ok=True)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
         "--out", str(out_dir.resolve()), CHILD_FLAG, task],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or not report.exists():
        raise AssertionError(f"{task}: its process exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    out = json.loads(report.read_text())
    EVENT_FALLBACKS.extend(out.pop("event_fallbacks", []))
    out["child_s"] = time.monotonic() - t0
    return out


def observability_phase(seed: int, card: str, out_dir: Path) -> dict:
    """Phase 23: (a)-(c) and (e)'s SLO part at the front door, (d) the
    watchdog and the flight recorder, (e) the decode-slot controller, (f)
    ``mx.profiler`` in a process of its own.  The flash launches are read
    over (a)'s traced round, the counts set to 0 just before it."""
    dev = gpu(0)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    parts = {}
    bert = bert_base(dropout=0.0)
    bert.initialize(ctx=dev, seed=seed)
    lm = causal_lm_small()
    lm.initialize(ctx=dev, seed=seed)
    lm.hybridize()
    classify = BertClassify(bert)
    t = time.monotonic()
    front = front_door_cell(seed, dev, out_dir, classify, lm)
    parts["front_door"] = time.monotonic() - t
    t = time.monotonic()
    wd = watchdog_cell(seed, out_dir, classify)
    parts["watchdog"] = time.monotonic() - t
    free_graphs(lm)
    t = time.monotonic()
    slots = decode_slot_cell(seed, dev)
    parts["decode_slots"] = time.monotonic() - t
    free_graphs(classify)
    del bert, lm, classify
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.monotonic()
    prof = in_child("phase23_profiler", seed, out_dir)
    parts["profiler"] = time.monotonic() - t
    return {"card": card, "front_door": front, "watchdog": wd,
            "decode_slots": slots, "profiler": prof,
            "launches": front["flash"]["launches"],
            "seconds": time.monotonic() - t0, "part_seconds": parts,
            "ok": front["ok"] and wd["ok"] and slots["ok"] and prof["ok"]}


# ---- phase 24: int8 ResNet-50 v1 served, Longformer-base trained --------
#: the served requests and the timed forwards' batch (int8 and fp32)
Q_BATCH = 32
Q_SIZE = 224
#: entropy calibration: batches x images (host numpy: 54 layers of
#: 8001-bin |x| histograms over both passes, then ~65 candidate
#: thresholds x 255 groups a layer)
Q_CALIB = (2, 4)
Q_TIMED = 5
#: the card's int8 logits against the CPU's int8 run with the card's
#: roundings, over max(1, max |logit|)
Q_LOGIT_TOL = 1e-4
#: served against eager, over max(1, max |logit|)
Q_SERVE_TOL = 1e-6
Q_BUCKETS = (8, 32)

#: Longformer-base (``allenai/longformer-base-4096``): 12 layers, 768
#: units, FFN 3072, 12 heads, window 512 (w = 256 a side), 4096 positions,
#: RoBERTa's vocabulary of 50,265
LF = {"vocab": 50265, "layers": 12, "units": 768, "ffn": 3072, "heads": 12,
      "w": 256, "length": 4096}
LF_BATCH, LF_STEPS, LF_SERVE_BATCH = 1, 3, 4
LF_OPT = {"learning_rate": 0.01, "momentum": 0.9}
LF_MEM_GB = 24.0
#: the sliding-window ops against their direct-gather plain version, and
#: the fp32 encoder against float64, over max(1, max |ref|)
SLDWIN_TOL = 1e-5
LF64_TOL = 1e-4
LF_SERVE_TOL = 1e-6


def q_model():
    return resnet50_v1(classes=1000)


def lf_encoder():
    return LongformerEncoder(LF["vocab"], num_layers=LF["layers"],
                             units=LF["units"], hidden_size=LF["ffn"],
                             num_heads=LF["heads"], w=LF["w"],
                             max_length=LF["length"])


class RoundDecisions(Decisions):
    """While open, every ``torch.round`` (int8 quantization's, in
    ``ops_quantization.quantize_tensor``) records its result, one tensor a
    call in call order, or, given ``masks`` (the card's results), returns
    those and counts the elements where its own rounding differs
    (``flips``).  A value within rounding of a half step can fall either
    way in the card's and the CPU's fp32 arithmetic; holding the CPU run
    to the card's int8 inputs keeps the comparison about the rest."""

    ROUNDS = (torch.round, torch.Tensor.round)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self.ROUNDS:
            return func(*args, **kwargs)
        own = func(*args, **kwargs)
        self.units += own.numel()
        if self._forced is None:
            self.masks.append(own.detach())
            return own
        card = self._forced[self._calls].to(own.device, own.dtype)
        self._calls += 1
        self.flips += int((own != card).sum())
        return card


def quantize_like(net, twin) -> None:
    """Swap ``net``'s Dense and Conv2D layers for int8 blocks with the
    input ranges calibrated for ``twin``, its quantized copy (so both
    quantize alike)."""
    for (name, child), other in zip(list(net._modules.items()),
                                    twin._modules.values()):
        if isinstance(other, (QuantizedConv2D, QuantizedDense)):
            net._modules[name] = type(other)(child, other._calib)
        elif isinstance(child, gluon.Block):
            quantize_like(child, other)


def _predict(model, data):
    with torch.no_grad(), autograd.predict_mode():
        return model(data)


def int8_resnet_run(seed: int) -> dict:
    """(a) ResNet-50 v1 at 224 x 224, calibrated (``entropy``) on
    ``Q_CALIB`` seeded batches, quantized (53 convolutions and the Dense)
    and served ``Q_BATCH`` requests through ``ModelServer``'s captured
    graphs; each quantized layer's int32 accumulator on the card's own
    int8 input against the CPU's; the card's int8 logits against a CPU
    int8 run given the card's roundings (``RoundDecisions``)."""
    dev = gpu(0)
    checks, res = {}, {}
    net = q_model()
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    weights = {k: v.cpu().numpy() for k, v in _snapshot(net).items()}
    gen = torch.Generator(device=dev).manual_seed(seed + 24)
    x = torch.randn(Q_BATCH, 3, Q_SIZE, Q_SIZE, device=dev, generator=gen)
    calib = [torch.randn(Q_CALIB[1], 3, Q_SIZE, Q_SIZE, device=dev,
                         generator=gen) for _ in range(Q_CALIB[0])]
    targets = {"QuantizedConv2D": sum(isinstance(m, nn.Conv2D)
                                      for m in net.modules()),
               "QuantizedDense": sum(isinstance(m, nn.Dense)
                                     for m in net.modules())}
    fp32 = _predict(net, x)
    res["fp32_forward_ms"] = cuda_ms(lambda: _predict(net, x), Q_TIMED)
    t0 = time.monotonic()
    quantize_net(net, calib_data=[nd.NDArray(c) for c in calib],
                 calib_mode="entropy")
    res["calibrate_s"] = time.monotonic() - t0
    layers = [m for m in net.modules()
              if isinstance(m, (QuantizedConv2D, QuantizedDense))]
    kinds = [type(m).__name__ for m in layers]
    res["layers"] = {k: kinds.count(k) for k in sorted(set(kinds))}
    checks["layers"] = res["layers"] == targets
    int8 = _predict(net, x)
    res["int8_forward_ms"] = cuda_ms(lambda: _predict(net, x), Q_TIMED)
    checks["finite"] = tuple(int8.shape) == (Q_BATCH, 1000) and \
        bool(torch.isfinite(int8).all())
    res["int8_vs_fp32"] = {
        "rel_err": _rel_err(int8, fp32),
        "top1_agree": (int8.argmax(1) == fp32.argmax(1)).float().mean()
        .item()}

    # each layer's accumulator on the card's own int8 input, and the card's
    # roundings for the CPU's run of one image
    inputs = {}
    handles = [blk.register_forward_hook(
        lambda b, args, out, i=i: inputs.__setitem__(i, args[0]._data))
        for i, blk in enumerate(layers)]
    with RoundDecisions() as card_rounds:
        one = _predict(net, x[:1])
    for h in handles:
        h.remove()
    acc_equal, acc_max = 0, 0
    for i, blk in enumerate(layers):
        acc, ins = blk.accumulate(inputs[i])
        ref = blk._int_op(*[t.cpu() for t in ins])[0]
        acc_equal += int(torch.equal(acc.cpu(), ref))
        acc_max = max(acc_max, int(ref.abs().max()))
    del inputs
    checks["accumulators_bitwise"] = acc_equal == len(layers)
    cpu_net = q_model()
    load_reference_params(cpu_net, weights, ctx=cpu())
    quantize_like(cpu_net, net)
    with RoundDecisions(card_rounds.masks) as forced:
        cpu_one = _predict(cpu_net, x[:1].cpu())
    e2e = _rel_err(one, cpu_one)
    checks["cpu_logits"] = e2e <= Q_LOGIT_TOL and \
        forced.flips <= DECISION_FLIPS * max(forced.units, 1)
    res["accumulators"] = {"layers": len(layers), "bitwise": acc_equal,
                           "max_abs": acc_max, "images": 1}
    res["cpu_int8"] = {"rel_err": e2e, "tol": Q_LOGIT_TOL,
                       "rounded": forced.units, "flips": forced.flips}
    del cpu_net, card_rounds, forced

    # served: Q_BATCH requests through the captured graphs
    srv = ModelServer(net, max_batch=Q_BUCKETS[-1], batch_buckets=Q_BUCKETS,
                      queue_depth=4 * Q_BATCH, deadline_ms=0, workers=2,
                      batch_window_us=5000)
    served = serve_exported(srv, x.cpu().numpy())
    answers = served.pop("answers")
    serve_err = _rel_err(answers, int8)
    checks["served"] = serve_err <= Q_SERVE_TOL and \
        served["executables"] >= 1
    res["served"] = served | {
        "requests": Q_BATCH, "rel_err_vs_eager": serve_err,
        "bitwise_eager": _bitwise([answers.to(int8.device)], [int8]),
        "graphs": srv._block.graph_stats()["graphs"]}
    del srv
    free_graphs(net)
    res.update(batch=Q_BATCH, calibration_images=Q_CALIB[0] * Q_CALIB[1],
               checks=checks, ok=all(checks.values()))
    return res


def sldwin_check(seed: int) -> dict:
    """One layer's score and context ops, forward and gradients, at
    Longformer-base's heads and width, B=1 and L=4096, against the
    direct-gather plain version on the card (which holds both 6.46 GB
    bands), with the bytes each saves for its backward."""
    dev = gpu(0)
    b, length, h = LF_BATCH, LF["length"], LF["heads"]
    d, w = LF["units"] // h, LF["w"]
    gen = torch.Generator(device=dev).manual_seed(seed + 241)
    q, k, v, g = (torch.randn(b, length, h, d, device=dev, generator=gen)
                  for _ in range(4))
    dil = torch.ones(h, dtype=torch.int32, device=dev)

    def run(score_fn, context_fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            s = score_fn(ins[0], ins[1], dil, w) * (1.0 / math.sqrt(d))
            c = context_fn(torch.softmax(s, dim=-1), ins[2], dil, w)
        kept = sum(saved)
        (c * g).sum().backward()
        torch.cuda.synchronize()
        out = [s.detach(), c.detach()] + [t.grad for t in ins]
        return out, kept, (time.monotonic() - t0) * 1e3
    ours, kept, ms = run(sldwin_score, sldwin_context)
    plain, plain_kept, plain_ms = run(direct_score, direct_context)
    errs = {name: _rel_err(a, r) for name, a, r in zip(
        ("score", "context", "dq", "dk", "dv"), ours, plain)}
    band = b * h * length * (2 * w + 1) * d * 4
    del ours, plain
    gc.collect()
    torch.cuda.empty_cache()
    return {"shape": [b, length, h, d], "w": w, "rel_err": errs,
            "tol": SLDWIN_TOL, "kept_bytes": kept,
            "plain_kept_bytes": plain_kept, "band_bytes": band,
            "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms,
            "ok": all(e <= SLDWIN_TOL for e in errs.values())
            and kept < band <= plain_kept}


class _StepClock(BatchBegin, BatchEnd):
    """An Estimator handler: each step's wall time and peak memory, the
    first step's loss and updated weights."""

    def __init__(self, net):
        self.net, self.ms, self.peak_gb = net, [], []
        self.first = None

    def batch_begin(self, estimator):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.monotonic()

    def batch_end(self, estimator):
        torch.cuda.synchronize()
        self.ms.append((time.monotonic() - self.t0) * 1e3)
        self.peak_gb.append(torch.cuda.max_memory_allocated() / 1e9)
        if estimator.processed_batches == 1:
            self.first = (estimator._batch_loss._data.detach().clone(),
                          _snapshot(self.net))


def longformer_run(seed: int) -> dict:
    """(b) Longformer-base with a Dense(50265) head trained ``LF_STEPS``
    steps at B=1, L=4096 through ``Estimator.fit`` (``StoppingHandler``,
    ``CheckpointHandler`` into a temporary directory, ``LoggingHandler``),
    ``gluon.Trainer("sgd", momentum=0.9)`` in the momentum kernel; its
    first step again from the same weights, bit for bit; the fp32 encoder
    against float64; the encoder served hybridized at B=4 against
    eager."""
    dev = gpu(0)
    checks, res = {}, {}
    enc = lf_encoder()
    head = nn.Dense(LF["vocab"], flatten=False, in_units=LF["units"])
    net = nn.HybridSequential()
    net.add(enc, head)
    net.initialize(mx_init.Xavier(), ctx=dev, seed=seed)
    params = net.collect_params()
    res["params"] = sum(p._tensor().numel() for p in params.values())
    res["encoder_params"] = sum(p._tensor().numel()
                                for p in enc.collect_params().values())
    gen = torch.Generator(device=dev).manual_seed(seed + 242)
    shape = (LF_BATCH, LF["length"])
    tokens = torch.randint(0, LF["vocab"], shape, device=dev,
                           generator=gen).float()
    labels = torch.randint(0, LF["vocab"], shape, device=dev,
                           generator=gen).float()
    w_init = _snapshot(net)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(params, "sgd", LF_OPT)
    est = Estimator(net, lossfn, train_metrics=metric.Loss("ce"),
                    trainer=trainer)
    clock = _StepClock(net)
    batch = (nd.NDArray(tokens), nd.NDArray(labels))
    trainable = [p for p in params.values() if p.grad_req != "null"]
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        zero_counts()
        est.fit([batch] * (LF_STEPS + 1), epochs=1, batch_size=LF_BATCH,
                event_handlers=[StoppingHandler(max_batch=LF_STEPS),
                                CheckpointHandler(tmp, "longformer"),
                                LoggingHandler(log_interval=1), clock])
        torch.cuda.synchronize()
        launches = multi_sgd_mom.launches
        others = other_launches(multi_sgd_mom)
        saved = {f: os.path.getsize(os.path.join(tmp, f))
                 for f in sorted(os.listdir(tmp))}
    expected = -(-len(trainable) // AGG) * LF_STEPS
    losses = est.loss_metric.get()[1]
    checks["steps"] = est.processed_batches == LF_STEPS
    checks["launches"] = launches == expected and others == 0
    checks["checkpoint"] = sorted(saved) == ["longformer-epoch0.params",
                                             "longformer.states"] and \
        all(n > 0 for n in saved.values())
    checks["memory"] = max(clock.peak_gb) < LF_MEM_GB
    checks["finite"] = math.isfinite(losses)
    res.update(steps=est.processed_batches, step_ms=clock.ms,
               peak_memory_gb=clock.peak_gb, launches=launches,
               expected_launches=expected, trainable_params=len(trainable),
               mean_loss=losses, checkpoint_bytes=saved)
    del est, trainer

    # the first step again from the same weights: the same bits
    with torch.no_grad():
        for p, t in zip(params.values(), w_init.values()):
            p._tensor().copy_(t)
    rerun = gluon.Trainer(params, "sgd", LF_OPT)
    with autograd.record():
        loss = lossfn(net(batch[0]), batch[1])
    loss.backward()
    rerun.step(LF_BATCH)
    torch.cuda.synchronize()
    first_loss, first_weights = clock.first
    checks["step_bitwise"] = _bitwise([loss._data.detach()], [first_loss]) \
        and _bitwise(list(_snapshot(net).values()),
                     list(first_weights.values()))
    res["rerun_launches"] = multi_sgd_mom.launches - launches
    del rerun, loss, clock, w_init, first_weights
    gc.collect()
    torch.cuda.empty_cache()

    # the fp32 encoder against float64, on the card
    out32 = _predict(enc, tokens)
    enc64 = lf_encoder()
    load_reference_params(enc64, {k: p._tensor().detach().cpu().numpy()
                                  for k, p in enc.collect_params().items()},
                          ctx=dev)
    enc64.cast("float64")
    out64 = _predict(enc64, tokens)
    res["fp64"] = {"rel_err": _rel_err(out32, out64), "tol": LF64_TOL,
                   "max_abs_ref": out64.abs().max().item()}
    checks["fp64"] = res["fp64"]["rel_err"] <= LF64_TOL and \
        bool(torch.isfinite(out32).all())
    del enc64, out64, out32
    gc.collect()
    torch.cuda.empty_cache()

    # the encoder served hybridized at B=4 against its eager forward
    many = torch.randint(0, LF["vocab"], (LF_SERVE_BATCH, LF["length"]),
                         device=dev, generator=gen).float()
    eager = _predict(enc, many)
    enc.hybridize()
    srv = ModelServer(enc, max_batch=LF_SERVE_BATCH,
                      batch_buckets=(LF_SERVE_BATCH,), deadline_ms=0,
                      workers=1, batch_window_us=20000)
    served = serve_exported(srv, many.cpu().numpy())
    answers = served.pop("answers")
    res["served"] = served | {
        "batch": LF_SERVE_BATCH, "rel_err_vs_eager": _rel_err(answers, eager),
        "bitwise_eager": _bitwise([answers.to(eager.device)], [eager]),
        "graphs": enc.graph_stats()["graphs"]}
    checks["served"] = res["served"]["rel_err_vs_eager"] <= LF_SERVE_TOL
    del srv, eager, answers
    free_graphs(enc)
    res.update(checks=checks, ok=all(checks.values()))
    return res


def slice24_phase(seed: int, card: str) -> dict:
    """Phase 24: (a) int8 ResNet-50 v1, (b) the sliding-window ops and
    Longformer-base; every count set to 0 just before the phase (and
    again just before (b)'s fit, whose momentum launches are read just
    after it), no kernel launched but (b)'s momentum SGD."""
    start = time.monotonic()
    zero_counts()
    res, seconds = {"card": card}, {}
    for key, fn in (("int8_resnet", int8_resnet_run),
                    ("sldwin", sldwin_check),
                    ("longformer", longformer_run)):
        t0 = time.monotonic()
        if key == "longformer":
            res["other_launches"] = other_launches()
        res[key] = fn(seed)
        seconds[key] = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = res["longformer"]["launches"]
    res.update(part_seconds=seconds, seconds=time.monotonic() - start,
               ok=all(res[k]["ok"] for k in seconds)
               and res["other_launches"] == 0)
    return res


# ---------------------------------------------------------------------------
# Phase 25: data-parallel training across processes
# ---------------------------------------------------------------------------

DIST_RANKS = 2
DIST_BATCH = 64                      # a rank: global batch 128
DIST_WARM, DIST_STEPS = 2, 3
DIST_CHECK = 2                       # a rank at the check steps: global 4
DIST_THRESHOLD = 0.5                 # 2-bit compression
DIST_TIMEOUT = 900                   # the ranks' launch, seconds
SHARDED_VARIANTS = {"zero0": {}, "zero1": {"zero_stage": 1},
                    "zero2": {"zero_stage": 2},
                    "accum2": {"accum_steps": 2},
                    "bucket25": {"comm_bucket_mb": 25}}
SHARDED_WARM, SHARDED_STEPS = 1, 3
ONE_PROCESS_WARM, ONE_PROCESS_STEPS = 2, 3
LAUNCHER = "mxnet_tpu_torch/tools/launch.py"


def _trainable(net) -> list:
    return [p for p in net.collect_params().values() if p.grad_req != "null"]


def _digest(net, trainable_only: bool) -> bytes:
    """SHA-1 of the parameters' bytes (trainable ones, or every one)."""
    h = hashlib.sha1()
    params = _trainable(net) if trainable_only else \
        list(net.collect_params().values())
    for p in params:
        h.update(p._tensor().detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest().encode()


def replicas_equal(net, trainable_only: bool = False) -> bool:
    """Every rank holds the same parameter bits."""
    return len(set(mx_dist.allgather_bytes(
        _digest(net, trainable_only)))) == 1


def load_snapshot(net, snap: dict) -> None:
    """The weights of ``snap`` into ``net``, in place; gradients dropped."""
    with torch.no_grad():
        for k, p in net.collect_params().items():
            p._tensor().copy_(snap[k])
    for p in _trainable(net):
        p._data.grad = None
        p.fresh = True


def global_batch(seed: int, n: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed + 25)
    x = torch.randn(n, 3, 224, 224, device=dev, generator=gen)
    y = torch.randint(0, 1000, (n,), device=dev, generator=gen).float()
    return x, y


def quantize_2bit(g: np.ndarray) -> np.ndarray:
    """The JAX package's 2-bit quantization of one pushed gradient
    (``mxnet_tpu/kvstore.py:277-294``, no residual yet) as signed codes:
    +1 at or above the threshold, -1 at or below its negative."""
    return (g >= DIST_THRESHOLD).astype(np.int8) - \
        (g <= -DIST_THRESHOLD).astype(np.int8)


def dist_invariants(ctx) -> dict:
    """``tests/test_dist.py:19-60``'s four kvstore invariants on CUDA
    tensors."""
    nd = mxt.nd
    rank, nw = mx_dist.rank(), mx_dist.num_workers()
    store = mx_kv.create("dist_sync")
    store.init(3, nd.ones((4, 5), ctx=ctx) * (1.0 if rank == 0 else 99.0))
    out = nd.zeros((4, 5), ctx=ctx)
    store.pull(3, out=out)
    checks = {"init_broadcasts_rank0": bool((out.asnumpy() == 1.0).all())}
    store.push(3, nd.ones((4, 5), ctx=ctx) * 2.0)
    store.pull(3, out=out)
    checks["pull_is_workers_times_push"] = bool(
        (out.asnumpy() == 2.0 * nw).all())
    store.push(3, nd.ones((4, 5), ctx=ctx) * (rank + 1))
    store.pull(3, out=out)
    checks["distinct_pushes_sum"] = bool(
        (out.asnumpy() == sum(r + 1 for r in range(nw))).all())
    s2 = mx_kv.KVStore("dist_sync")
    s2.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    s2.init(7, nd.zeros((8,), ctx=ctx))
    g = nd.array(np.full((8,), 0.3, np.float32), ctx=ctx)
    o2 = nd.zeros((8,), ctx=ctx)
    s2.push(7, g)
    s2.pull(7, out=o2)
    first = o2.asnumpy()
    s2.push(7, g)
    s2.pull(7, out=o2)
    checks["compression_error_feedback"] = bool(
        (first == 0.0).all() and (o2.asnumpy() == 0.5 * nw).all())
    checks["on_cuda"] = o2._data.is_cuda
    return {"backend": mx_dist.backend(), "checks": checks}


def summed_step(arrays: dict, parts, dtype, lossfn, shared: bool) -> dict:
    """One ResNet-50 SGD step (``RESNET_OPT``) on the CPU in ``dtype``
    whose gradient is the sum of each part's forward and backward: each
    part on its own copy of the model (its own BatchNorm statistics, as
    ranks under ``gluon.Trainer``), or in turn on one model (``shared``:
    microbatches).  Returns the first model's snapshot after the step."""
    models = []
    grads = None
    for i, (xp, yp) in enumerate(parts):
        if shared and models:
            model = models[0]
        else:
            model = resnet50_v1(classes=1000)
            load_reference_params(model, arrays, ctx=cpu())
            model.to(dtype)
            models.append(model)
        with autograd.record():
            loss = lossfn(model(xp.cpu().to(dtype)), yp.cpu())
        autograd.backward(loss)
        g = [p._grad_tensor().detach().clone() for p in _trainable(model)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    main = models[0]
    for p, g in zip(_trainable(main), grads):
        p._grad_tensor().copy_(g)
        p.fresh = False
    gluon.Trainer(main.collect_params(), "sgd", RESNET_OPT).step(
        sum(int(xp.shape[0]) for xp, _ in parts))
    return _snapshot(main)


def dist_store_run(seed: int, net, w_init, x, y, lossfn) -> dict:
    """(a) ``gluon.Trainer`` over ``dist_sync``: the timed steps, the
    check step at global batch 4 through the local update and through
    ``update_on_kvstore``, and one step with 2-bit compression."""
    rank, nw = mx_dist.rank(), mx_dist.num_workers()
    lo, hi = rank * DIST_BATCH, (rank + 1) * DIST_BATCH
    xr, yr = x[lo:hi], y[lo:hi]
    params = net.collect_params()

    def step(tr, xb, yb, total):
        with autograd.record():
            loss = lossfn(net(xb), yb)
        autograd.backward(loss)
        tr.step(total)
        return loss.detach().mean()

    load_snapshot(net, w_init)
    tr = gluon.Trainer(params, "sgd", RESNET_OPT, kvstore="dist_sync",
                       update_on_kvstore=False)
    torch.cuda.synchronize()
    zero_counts()
    ms, equal, losses = [], [], []
    for _ in range(DIST_WARM + DIST_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(step(tr, xr, yr, nw * DIST_BATCH))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        equal.append(replicas_equal(net, trainable_only=True))
    launches = multi_sgd_mom.launches
    other = other_launches(multi_sgd_mom)
    steps = DIST_WARM + DIST_STEPS
    per_step = -(-len(_trainable(net)) // AGG)
    # the all-reduce of the 25.56 M fp32 gradients alone
    flat = torch.cat([p._grad_tensor().reshape(-1) for p in _trainable(net)])
    reduce_ms = []
    for _ in range(3):
        mx_dist.barrier()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        mx_dist.all_reduce(flat)
        torch.cuda.synchronize()
        reduce_ms.append((time.monotonic() - t0) * 1e3)
    del flat
    # the check step: 2 rows a rank from the initial weights
    c_lo, c_hi = rank * DIST_CHECK, (rank + 1) * DIST_CHECK
    load_snapshot(net, w_init)
    step(gluon.Trainer(params, "sgd", RESNET_OPT,
                       kvstore=mx_kv.KVStore("dist_sync"),
                       update_on_kvstore=False),
         x[c_lo:c_hi], y[c_lo:c_hi], nw * DIST_CHECK)
    check_after = _snapshot(net)
    check_equal = replicas_equal(net, trainable_only=True)
    # the same check step with update_on_kvstore: the store's updater
    # (per key) in place of the local multi-tensor update
    load_snapshot(net, w_init)
    step(gluon.Trainer(params, "sgd", RESNET_OPT,
                       kvstore=mx_kv.KVStore("dist_sync"),
                       update_on_kvstore=True),
         x[c_lo:c_hi], y[c_lo:c_hi], nw * DIST_CHECK)
    on_after = _snapshot(net)
    on_equal = replicas_equal(net, trainable_only=True)
    on_vs_off = _max_diff(on_after, check_after)
    # 2-bit compression: the pulled gradient is the sum over the ranks of
    # each one's quantized gradient, bit for bit
    load_snapshot(net, w_init)
    tr2 = gluon.Trainer(params, "sgd", RESNET_OPT,
                        kvstore=mx_kv.KVStore("dist_sync"),
                        update_on_kvstore=False,
                        compression_params={"type": "2bit",
                                            "threshold": DIST_THRESHOLD})
    with autograd.record():
        loss = lossfn(net(xr), yr)
    autograd.backward(loss)
    local = [p._grad_tensor().detach().reshape(-1).to("cpu", copy=True)
             .numpy() for p in _trainable(net)]
    tr2.step(nw * DIST_BATCH)
    codes = mx_dist.allreduce_host(np.concatenate(
        [quantize_2bit(g) for g in local]))
    want = codes.astype(np.float32) * np.float32(DIST_THRESHOLD)
    pulled = torch.cat([p._grad_tensor().reshape(-1)
                        for p in _trainable(net)]).cpu().numpy()
    compressed = {"bitwise": bool(np.array_equal(pulled, want)),
                  "nonzero": int(np.count_nonzero(want)),
                  "elements": int(want.size),
                  "replicas_equal": replicas_equal(net, trainable_only=True)}
    del local, codes, want, pulled
    timed = ms[DIST_WARM:]
    losses = [v.item() for v in losses]
    checks = {
        "launches_exact": launches == per_step * steps,
        "no_other_launches": other == 0,
        "replicas_bitwise_every_step": all(equal),
        "finite_losses": all(math.isfinite(v) for v in losses),
        "check_step_replicas_bitwise": check_equal,
        "update_on_kvstore_replicas_bitwise": on_equal,
        "compressed_pull_bitwise": compressed["bitwise"]
        and compressed["replicas_equal"] and compressed["nonzero"] > 0,
    }
    return {"launches": launches, "expected_launches_per_step": per_step,
            "steps": steps, "other_launches": other, "losses": losses,
            "step_ms": sum(timed) / len(timed), "step_ms_each": ms,
            "images_per_s_per_rank": DIST_BATCH * 1e3 * len(timed)
            / sum(timed), "allreduce_ms": reduce_ms,
            "allreduce_bytes": 4 * sum(p._tensor().numel()
                                       for p in _trainable(net)),
            "update_on_kvstore_vs_local_max_abs": on_vs_off,
            "compression": compressed, "check_after": check_after,
            "on_after": on_after,
            "checks": checks}


def sharded_run(net, w_init, x, y, lossfn) -> dict:
    """(b) ``ShardedTrainer`` at dp = 2: every variant's check step at
    global batch 4 from the initial weights, then its timed steps at 128."""
    nw = mx_dist.num_workers()
    x4, y4 = x[:nw * DIST_CHECK], y[:nw * DIST_CHECK]
    out = {}
    for name, kw in SHARDED_VARIANTS.items():
        load_snapshot(net, w_init)
        tr = mx_par.ShardedTrainer(net, lossfn, "sgd", dict(RESNET_OPT),
                                   **kw)
        torch.cuda.synchronize()
        zero_counts()
        tr.step(x4, y4)
        after = _snapshot(net)
        equal = [replicas_equal(net)]
        ms, losses = [], []
        for _ in range(SHARDED_WARM + SHARDED_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            losses.append(tr.step(x, y).item())
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t0) * 1e3)
            equal.append(replicas_equal(net))
        steps = 1 + SHARDED_WARM + SHARDED_STEPS
        per_step = -(-len(_trainable(net)) // MAX_TENSORS)
        timed = ms[SHARDED_WARM:]
        out[name] = {
            "launches": multi_sgd_mom.launches,
            "expected_launches": per_step * steps,
            "other_launches": other_launches(multi_sgd_mom),
            "step_ms": sum(timed) / len(timed), "step_ms_each": ms,
            "losses": losses, "replicas_equal": equal,
            "opt_state_bytes": tr.peak_opt_state_bytes(),
            "buckets": None if tr.grad_buckets is None
            else len(tr.grad_buckets), "check_after": after}
        del tr
        gc.collect()
    return out


def dist25_rank(seed: int, out_dir: Path) -> dict:
    """One rank of phase 25 (started two at a time by ``tools/launch.py``
    in ``dist25_phase``): (a) the dist store, (b) ``ShardedTrainer``;
    rank 0 then holds both check steps to the CPU by ``leaf_check``."""
    t0 = time.monotonic()
    mx_dist.init_process_group()
    rank, dev = mx_dist.rank(), mx_dist.rank_device()
    ctx = gpu(dev.index)
    res = {"rank": rank, "device": str(dev), "join_s": time.monotonic() - t0}
    res["invariants"] = dist_invariants(ctx)
    net = resnet50_v1(classes=1000)
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    w_init = _snapshot(net)
    x, y = global_batch(seed, mx_dist.num_workers() * DIST_BATCH, dev)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    t1 = time.monotonic()
    res["dist_store"] = dist_store_run(seed, net, w_init, x, y, lossfn)
    res["sharded"] = sharded_run(net, w_init, x, y, lossfn)
    res["train_s"] = time.monotonic() - t1
    nw = mx_dist.num_workers()
    sh = res["sharded"]
    checks = {"gloo": res["invariants"]["backend"] == "gloo"}
    for name, r in sh.items():
        checks[f"{name}_launches_exact"] = \
            r["launches"] == r["expected_launches"]
        checks[f"{name}_no_other_launches"] = r["other_launches"] == 0
        checks[f"{name}_replicas_bitwise"] = all(r["replicas_equal"])
        checks[f"{name}_finite"] = all(math.isfinite(v)
                                       for v in r["losses"])
    ratio = sh["zero1"]["opt_state_bytes"] / sh["zero0"]["opt_state_bytes"]
    checks["zero1_state_about_half"] = 0.45 < ratio < 0.6
    checks["buckets_formed"] = (sh["bucket25"]["buckets"] or 0) > 1
    res["zero1_state_ratio"] = ratio
    if rank == 0:
        # the CPU references: fp32, and float64 as the arbiter
        t2 = time.monotonic()
        arrays = {k: v.cpu().numpy() for k, v in w_init.items()}
        xc, yc = x[:nw * DIST_CHECK].cpu(), y[:nw * DIST_CHECK].cpu()
        halves = [(xc[r * DIST_CHECK:(r + 1) * DIST_CHECK],
                   yc[r * DIST_CHECK:(r + 1) * DIST_CHECK])
                  for r in range(nw)]
        micro = [(xc[m * 2:(m + 1) * 2], yc[m * 2:(m + 1) * 2])
                 for m in range(2)]
        refs = {}
        for dt in (torch.float32, torch.float64):
            refs[("halves", dt)] = summed_step(arrays, halves, dt, lossfn,
                                               shared=False)
            refs[("whole", dt)] = summed_step(arrays, [(xc, yc)], dt,
                                              lossfn, shared=True)
            refs[("micro", dt)] = summed_step(arrays, micro, dt, lossfn,
                                              shared=True)
        leaves = {name: leaf_check(
            res["dist_store"][key], refs[("halves", torch.float32)],
            refs[("halves", torch.float64)], w_init)
            for name, key in (("dist_store", "check_after"),
                              ("update_on_kvstore", "on_after"))}
        for name, r in sh.items():
            kind = "micro" if name == "accum2" else "whole"
            leaves[name] = leaf_check(r["check_after"],
                                      refs[(kind, torch.float32)],
                                      refs[(kind, torch.float64)], w_init)
        res["variant_vs_zero0_max_abs"] = {
            name: _max_diff(r["check_after"], sh["zero0"]["check_after"])
            for name, r in sh.items()}
        res["leaf_checks"] = {
            k: {f: v[f] for f in ("ok", "leaves", "failed",
                                  "cpu_share_median", "worst_margin")}
            for k, v in leaves.items()}
        for k, v in leaves.items():
            checks[f"{k}_leaf_check"] = v["ok"]
        res["cpu_check_s"] = time.monotonic() - t2
        del refs
    # rank 1 waits here while rank 0 computes the CPU references
    mx_dist.barrier("phase25_done", timeout=DIST_TIMEOUT)
    res["dist_store"].pop("check_after")
    res["dist_store"].pop("on_after")
    for r in sh.values():
        r.pop("check_after")
    res["checks"] = {**checks, **res["dist_store"]["checks"],
                     **res["invariants"]["checks"]}
    res["ok"] = all(res["checks"].values())
    res["seconds"] = time.monotonic() - t0
    mx_dist.shutdown()
    return res


#: the tasks a rank of a launched group runs (``RANK_FLAG``), each writing
#: ``<out>/<task><rank>.json``
RANK_TASKS = {"phase25_rank": dist25_rank}
RANK_FLAG = "--rank-task"


def one_process_sharded(seed: int, card: str) -> dict:
    """(c) ``ShardedTrainer`` at dp = 1 in this process at batch 128: the
    JAX bench row's path (``bench.py:34-77``)."""
    dev = gpu(0)
    net = resnet50_v1(classes=1000)
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    x, y = global_batch(seed, DIST_RANKS * DIST_BATCH, dev)
    tr = mx_par.ShardedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                               "sgd", dict(RESNET_OPT))
    torch.cuda.synchronize()
    zero_counts()
    ms, losses = [], []
    for _ in range(ONE_PROCESS_WARM + ONE_PROCESS_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(tr.step(x, y).item())
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    steps = ONE_PROCESS_WARM + ONE_PROCESS_STEPS
    per_step = -(-len(_trainable(net)) // MAX_TENSORS)
    timed = ms[ONE_PROCESS_WARM:]
    launches = multi_sgd_mom.launches
    other = other_launches(multi_sgd_mom)
    res = {"card": card, "batch": x.shape[0], "dp": tr.dp_size,
           "launches": launches, "expected_launches": per_step * steps,
           "step_ms": sum(timed) / len(timed), "step_ms_each": ms,
           "images_per_s": x.shape[0] * 1e3 * len(timed) / sum(timed),
           "losses": losses}
    res["checks"] = {"launches_exact": launches == per_step * steps,
                     "no_other_launches": other == 0,
                     "finite": all(math.isfinite(v) for v in losses)}
    res["ok"] = all(res["checks"].values())
    del tr, net
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dist25_phase(seed: int, card: str, out_dir: Path) -> dict:
    """Phase 25: two ranks of ``dist25_rank`` on this card through the
    port's launcher (gloo: the ranks share the card), then (c) in this
    process."""
    start = time.monotonic()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out_dir = out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    reports = [out_dir / f"phase25_rank{r}.json" for r in range(DIST_RANKS)]
    for f in reports:
        f.unlink(missing_ok=True)
    root = Path(__file__).resolve().parent
    proc = subprocess.Popen(
        [sys.executable, str(root / LAUNCHER), "-n", str(DIST_RANKS),
         sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
         "--out", str(out_dir), RANK_FLAG, "phase25_rank"],
        cwd=str(root), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        log, _ = proc.communicate()
        raise AssertionError(f"phase 25: the ranks outlived "
                             f"{DIST_TIMEOUT} s:\n{log[-4000:]}")
    if proc.returncode != 0 or not all(f.exists() for f in reports):
        raise AssertionError(f"phase 25: the launch exited "
                             f"{proc.returncode}:\n{log[-6000:]}")
    ranks = [json.loads(f.read_text()) for f in reports]
    ranks_s = time.monotonic() - start
    one = one_process_sharded(seed, card)
    res = {"card": card, "ranks": ranks, "one_process": one,
           "ranks_s": ranks_s, "seconds": time.monotonic() - start}
    res["dist_launches"] = [r["dist_store"]["launches"] for r in ranks]
    res["sharded_launches"] = [
        {k: v["launches"] for k, v in r["sharded"].items()} for r in ranks]
    res["ok"] = all(r["ok"] for r in ranks) and one["ok"]
    return res


def failed_checks(report, path: str = "") -> list:
    """The dotted path of every false entry of every ``checks`` dict in
    a phase's report, so that a failure names what failed."""
    out = []
    if isinstance(report, dict):
        for key, value in report.items():
            at = f"{path}.{key}" if path else str(key)
            if key == "checks" and isinstance(value, dict):
                out += [f"{at}.{c}" for c, ok in value.items() if not ok]
            else:
                out += failed_checks(value, at)
    elif isinstance(report, (list, tuple)):
        for i, value in enumerate(report):
            out += failed_checks(value, f"{path}[{i}]")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/chip_smoke")
    ap.add_argument(CHILD_FLAG, choices=sorted(CHILD_TASKS),
                    help="one measurement alone, in the process that "
                         "in_child starts")
    ap.add_argument(RANK_FLAG, dest="rank_task",
                    choices=sorted(RANK_TASKS),
                    help="one rank of a phase that tools/launch.py starts")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.child:
        out = Path(args.out)
        report = CHILD_TASKS[args.child](args.seed, out)
        report["event_fallbacks"] = EVENT_FALLBACKS
        (out / f"{args.child}.json").write_text(json.dumps(report))
        return 0
    if args.rank_task:
        # one rank of a group that tools/launch.py started: its report
        # carries its rank in the name
        out = Path(args.out)
        report = RANK_TASKS[args.rank_task](args.seed, out)
        name = f"{args.rank_task}{os.environ['DMLC_WORKER_ID']}"
        (out / f"{name}.json").write_text(json.dumps(report))
        return 0

    start = t0 = time.monotonic()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.monotonic() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  [{name}] {line.strip()}")
    sass = {"flash_attention": flash_sass(), "multi_sgd": sgd_sass()}
    for name, census in sass.items():
        print(f"sass census {name}:", json.dumps(census), flush=True)
    sgd_build = {"ptxas": ptxas_report(logs.get("multi_sgd", ""))}
    print("ptxas multi_sgd:", json.dumps(sgd_build), flush=True)
    spills = [fn for fn, r in sgd_build["ptxas"].items()
              if r["spill_stores"] or r["spill_loads"]]
    if spills or len(sgd_build["ptxas"]) != 10:
        print(f"chip_smoke: multi-SGD ptxas report: spills in {spills}, "
              f"{len(sgd_build['ptxas'])} kernels", file=sys.stderr)
        return 1

    rows = kernel_phase(args.seed)
    for r in rows:
        print("flash", json.dumps(r), flush=True)

    serving = serve_phase(args.seed, N_REQUESTS, card)
    print(f"serving on {card}: {serving['requests']} requests in "
          f"{serving['batches']} batches, p50 "
          f"{serving['latency_ms_p50']:.3f} ms, p99 "
          f"{serving['latency_ms_p99']:.3f} ms, "
          f"{serving['requests_per_s']:.3f} requests/s, peak memory "
          f"{serving['peak_memory_gb']:.3f} GB")
    print(f"stats on {card}:", json.dumps(serving["stats"]))
    print(f"serving graphs on {card}:", json.dumps(serving["graph_stats"]))
    print(f"profile on {card}:", json.dumps(serving["profile"]))

    sgd = sgd_kernel_phase(args.seed)
    for c in sgd["checks"]:
        print("sgd check", json.dumps(c), flush=True)
    for name, t in sgd["times"].items():
        print(f"sgd time {name} on {card}:", json.dumps(t), flush=True)
        for b in t.get("per_launch_bins", []):
            print(f"  sgd launches {name} {b['bin']}: {b['launches']} "
                  f"launches, {b['elements']} elements, {b['ms']:.6f} ms "
                  f"device, bound {b['bound_ms']:.6f} ms", flush=True)

    mlp = mlp_phase(args.seed)
    print(f"mlp on {card}:", json.dumps(mlp), flush=True)
    resnet = resnet_phase(args.seed, card)
    print(f"resnet50 on {card}: {resnet['images_per_s']:.1f} images/s, "
          f"step {resnet['step_ms']:.2f} ms, peak memory "
          f"{resnet['peak_memory_gb']:.2f} GB, "
          f"{resnet['launches_per_step']} momentum launches per step")
    print(f"resnet50 on {card}:", json.dumps(resnet), flush=True)
    for name, g in (("mlp", mlp["graphs"]), ("resnet50", resnet["graphs"])):
        print(f"{name} graphs on {card}: {g['entries']} entries, "
              f"{g['replays']} replays, {g['warm_calls']} warm calls, "
              f"{g['deferred_calls']} deferred-shape calls, "
              f"capture ms {[r['capture_ms'] for r in g['by_graph']]}, "
              f"pool bytes {[r['pool_bytes'] for r in g['by_graph']]}",
              flush=True)

    rtc_res = rtc_phase(args.seed)
    print(f"rtc on {card}:", json.dumps(rtc_res), flush=True)
    custom = custom_mlp_phase(args.seed)
    print(f"custom-op mlp on {card}: {custom['steps']} steps, launches "
          f"{custom['launches']}, first-step gradients vs twin "
          f"{custom['first_step_grad_max_abs_vs_twin']:.3g}, losses vs twin "
          f"{custom['loss_max_rel_vs_twin']:.3g} relative, held-out "
          f"accuracy {custom['custom']['held_out_accuracy']:.4f}",
          flush=True)
    print(f"custom-op mlp on {card}:", json.dumps(custom), flush=True)

    bert = bert_train_phase(args.seed, card)
    for mode in ("fp32", "amp_bf16"):
        r = bert[mode]
        print(f"bert-base training {mode} on {card}: step "
              f"{r['step_ms']:.3f} ms, {r['sequences_per_s']:.3f} "
              f"sequences/s, {r['tokens_per_s']:.1f} tokens/s, flash "
              f"launches {r['flash_launches_by_dtype']}, losses "
              f"{r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}, peak memory "
              f"{r['peak_memory_gb']:.2f} GB", flush=True)
        print(f"bert-base profile {mode} on {card}:",
              json.dumps(r["profile"]), flush=True)
    print(f"bert-base leaf check on {card}:", json.dumps({
        k: bert["fp32"]["leaf_check"][k] for k in
        ("loss_abs_err_vs_cpu", "ok")} | {
        part: {k: bert["fp32"]["leaf_check"][part][k] for k in
               ("ok", "leaves", "failed", "cpu_share_median",
                "worst_margin")}
        for part in ("weights", "grads")}), flush=True)
    print(f"bert-base checks on {card}:", json.dumps(bert["checks"]),
          flush=True)

    low = low_precision_phase(args.seed, card, resnet, bert)
    for recipe in ("amp", "cast"):
        r = low[f"resnet50_{recipe}"]
        print(f"resnet50 bf16 {recipe} on {card}: step {r['step_ms']:.3f} "
              f"ms, {r['images_per_s']:.1f} images/s, {r['kernel']} "
              f"launches per step {r['launches_per_step']}, first loss "
              f"{r['first_loss_rel_vs_fp32']:.3g} from fp32's, device "
              f"{json.dumps(r['profile']['device_ms'])}, idle "
              f"{r['profile']['device_idle_share']:.3f}", flush=True)
    r = low["bert_fp16"]
    print(f"bert-base fp16 amp on {card}: step {r['step_ms']:.3f} ms, "
          f"{r['sequences_per_s']:.3f} sequences/s, skipped "
          f"{r['skipped_steps']}, scales {r['loss_scales'][0]} -> "
          f"{r['loss_scales'][-1]}, flash launches "
          f"{r['flash_launches_by_dtype']}", flush=True)
    print(f"low precision checks on {card}:", json.dumps(low["checks"]),
          flush=True)

    imp = imperative_phase(args.seed)
    print(f"imperative mlp on {card}: step {imp['step_ms']:.3f} ms "
          f"(gluon loop {imp['gluon_loop']['step_ms']:.3f} ms), "
          f"{imp['launches_per_step']} momentum launches per step, "
          f"{imp['waits_per_step']} waits and {imp['host_reads_per_step']} "
          f"host reads per step, nd.FullyConnected "
          f"{imp['host_us']['nd_fully_connected']:.2f} us on the host vs "
          f"F.linear {imp['host_us']['f_linear']:.2f} us, losses "
          f"{imp['losses'][0]:.5f} -> {imp['losses'][-1]:.5f}", flush=True)
    print(f"imperative mlp on {card}:", json.dumps(imp), flush=True)

    nmt = nmt_phase(args.seed, card)
    tr = nmt["train"]
    print(f"nmt on {card}: {nmt['params']} parameters, "
          f"{tr['tokens_per_s']:.1f} tokens/s, step ms by bucket "
          f"{json.dumps(tr['step_ms'])}, flash launches "
          f"{tr['flash_launches']} in {tr['steps']} steps, device "
          f"{json.dumps(tr['profile']['device_ms'])}, idle "
          f"{tr['profile']['device_idle_share']:.3f}, peak memory "
          f"{tr['peak_memory_gb']:.2f} GB", flush=True)
    for mode, r in nmt["translate"].items():
        print(f"nmt translate {mode} on {card}: {r['ms_per_token']:.3f} ms "
              f"per output token, {r['ms_per_decoder_call']:.3f} ms per "
              f"decoder call ({r['decoder_calls']} calls, "
              f"{r['host_reads']} host reads), flash launches "
              f"{r['flash_launches']} of {r['flash_launches_expected']}, "
              f"teacher forcing {json.dumps(r['teacher_forcing'])}",
              flush=True)
    print(f"nmt leaf check on {card}:", json.dumps({
        "loss_abs_err_vs_cpu": nmt["leaf_check"]["loss_abs_err_vs_cpu"]} | {
        part: {k: nmt["leaf_check"][part][k] for k in
               ("ok", "leaves", "failed", "cpu_share_median",
                "worst_margin")}
        for part in ("weights", "grads")}), flush=True)
    print(f"nmt checks on {card}:", json.dumps(nmt["checks"]), flush=True)
    lm = lm_phase(args.seed, card, Path(args.out))
    lm_trained = lm.pop("trained")       # phase 19 converts these weights
    print(f"lstm bucketing on {card}: {lm['samples_per_s']:.1f} samples/s "
          f"over {lm['batches']} batches, step ms by bucket "
          f"{json.dumps(lm['step_ms'])}, host share "
          f"{lm['host_share']:.3f}, perplexity "
          f"{lm['perplexity_windows'][0]:.1f} -> "
          f"{lm['perplexity_windows'][-1]:.1f}", flush=True)
    print(f"lstm bucketing on {card}:", json.dumps(lm), flush=True)
    nmt_backward = in_child("nmt_flash_backward", args.seed, Path(args.out))
    print("flash backward", json.dumps(nmt_backward), flush=True)

    det = detection_phase(args.seed, card)
    for name, r in (("ssd-512", det["ssd"]), ("mask-rcnn", det["rcnn"])):
        run = r["train"]
        print(f"{name} on {card}: batch {r['batch']}, step "
              f"{run['step_ms']:.3f} ms, {run['images_per_s']:.2f} images/s, "
              f"{r['trainable_params']} trainable tensors, momentum "
              f"launches {run['launches']} in {run['steps']} steps "
              f"({r['expected_launches_per_step']} a step expected), "
              f"device {json.dumps(run['profile']['device_ms'])}, idle "
              f"{run['profile']['device_idle_share']:.3f}, peak memory "
              f"{run['peak_memory_gb']:.2f} GB", flush=True)
        print(f"{name} leaf check on {card}:", json.dumps({
            k: r["leaf_check"][k] for k in (
                "loss_abs_err_vs_cpu", "decisions", "flips", "ok")} | {
            part: {k: r["leaf_check"][part][k] for k in
                   ("ok", "leaves", "failed", "cpu_share_median",
                    "worst_margin")}
            for part in ("weights", "grads")}), flush=True)
        print(f"{name} checks on {card}:", json.dumps(r["checks"]),
              flush=True)
    for name, g in (("resnet50 bf16 amp", low["resnet50_amp"]["graphs"]),
                    ("resnet50 bf16 cast", low["resnet50_cast"]["graphs"]),
                    ("ssd-512", det["ssd"]["graphs"])):
        print(f"{name} graphs on {card}: {g['entries']} entries, "
              f"{g['replays']} replays, {g['warm_calls']} warm calls, "
              f"{g['deferred_calls']} deferred-shape calls",
              flush=True)
    d = det["ssd"]["detection"]
    print(f"ssd-512 detection on {card}: {d['ms_per_batch']:.3f} ms a batch "
          f"of {d['batch']}, NMS {d['nms_ms']:.3f} ms, "
          f"{d['nms_passes']['run']} NMS passes (settled after "
          f"{d['nms_passes']['settled']}) over {d['candidates']} candidates, "
          f"kept {d['kept_per_image']}, vs CPU {d['max_abs_err_vs_cpu']:.3g}",
          flush=True)

    graph = graph_phase(args.seed, card, nmt, bert, det["rcnn"])
    g = graph["nmt"]
    print(f"nmt hybridized on {card}: {g['train']['tokens_per_s']:.1f} "
          f"tokens/s (eager {g['eager_tokens_per_s']:.1f}), step ms by "
          f"bucket {json.dumps(g['train']['step_ms'])} (eager "
          f"{json.dumps(g['eager_step_ms'])}), device "
          f"{json.dumps(g['train']['profile']['device_ms'])}, idle "
          f"{g['train']['profile']['device_idle_share']:.3f}, host launches "
          f"{g['train']['profile']['host_launches']} + "
          f"{g['train']['profile']['host_graph_launches']} graphs a step, "
          f"graphs {json.dumps({k: v for k, v in g['graphs'].items()})}, "
          f"losses bitwise eager {g['losses_bitwise_eager']}", flush=True)
    print(f"nmt replayed leaf check on {card}:",
          json.dumps(_leaf_brief(g["leaf_check"])), flush=True)
    for mode, r in graph["bert"]["runs"].items():
        e = graph["bert"]["eager"][mode]
        print(f"bert-base hybridized {mode} on {card}: step "
              f"{r['step_ms']:.3f} ms (eager {e['step_ms']:.3f}), "
              f"{r['sequences_per_s']:.3f} sequences/s (eager "
              f"{e['sequences_per_s']:.3f}), idle "
              f"{r['profile']['device_idle_share']:.3f} (eager "
              f"{e['device_idle_share']:.3f}), device busy "
              f"{r['profile']['device_busy_ms']:.3f} ms (eager "
              f"{e['device_busy_ms']:.3f}), host launches "
              f"{r['profile']['host_launches']} + "
              f"{r['profile']['host_graph_launches']} graphs (eager "
              f"{e['host_launches']}), graphs {json.dumps(r['graphs'])}",
              flush=True)
    print(f"bert-base replayed leaf check on {card}:",
          json.dumps(_leaf_brief(graph["bert"]["leaf_check"])), flush=True)
    sv = graph["serving"]
    for name, r in sv["runs"].items():
        print(f"bert-base served {name} on {card}: "
              f"{r['requests_per_s']:.3f} requests/s, p50 "
              f"{r['latency_ms_p50']:.3f} ms, p99 {r['latency_ms_p99']:.3f} "
              f"ms, {r['batches']} batches, "
              f"{r['stats']['executables']} executables", flush=True)
    print(f"graph checks on {card}:", json.dumps(
        {name: graph[name]["checks"] for name in
         ("nmt", "bert", "serving", "rcnn")}), flush=True)

    gen = generation_phase(args.seed, card)
    for cell in ("small", "base"):
        for name, r in gen[cell]["runs"].items():
            print(f"generation {cell} {name} on {card}: slots {r['slots']}, "
                  f"{r['requests']} requests, {r['tokens_per_s']:.1f} "
                  f"tokens/s, TTFT p50 {r['ttft_ms_p50']:.3f} ms p99 "
                  f"{r['ttft_ms_p99']:.3f} ms, decode step p50 "
                  f"{r['decode_step_ms_p50']:.3f} ms p99 "
                  f"{r['decode_step_ms_p99']:.3f} ms over "
                  f"{r['decode_steps']} steps, blocks used "
                  f"{r['stats']['kv_blocks_used']}", flush=True)
        print(f"generation {cell} graphs on {card}:",
              json.dumps(gen[cell]["graph_costs"]), flush=True)
        print(f"generation {cell} teacher forcing on {card}:",
              json.dumps(gen[cell]["teacher_forcing"]), flush=True)
    print(f"generation base decode step profile on {card}:",
          json.dumps(gen["base"]["decode_profile"]), "bytes",
          json.dumps(gen["base"]["decode_step_bytes"]), "bound ms",
          gen["base"]["decode_step_bound_ms"], flush=True)
    print(f"generation front door on {card}:", json.dumps(
        {k: v for k, v in gen["frontdoor"].items() if k != "checks"}),
        flush=True)
    print(f"generation checks on {card}:", json.dumps(
        {"launches": gen["generation_launches"], **gen["checks"],
         **{cell: gen[cell]["checks"] for cell in
            ("small", "base", "frontdoor")}}), flush=True)
    surface = surface_phase(args.seed, card, bert)
    r = surface["resnet"]
    print(f"resnet50 recipe on {card}: {r['launches_per_step']} momentum "
          f"launches a step ({r['expected_launches_per_step']} expected), "
          f"rates {r['rates']}, {r['no_decay_params']} parameters without "
          f"decay, checkpoint {json.dumps(r['checkpoint_bytes'])} bytes, "
          f"save {r['save_ms']:.1f} ms, load {r['load_ms']:.1f} ms, checks "
          f"{json.dumps(r['checks'])}", flush=True)
    r = surface["bert"]
    print(f"bert-base lamb on {card}: step {r['step_ms']:.3f} ms (adam "
          f"{r['adam']['step_ms']:.3f}), {r['sequences_per_s']:.3f} "
          f"sequences/s (adam {r['adam']['sequences_per_s']:.3f}), device "
          f"busy {r['profile']['device_busy_ms']:.3f} ms (adam "
          f"{r['adam']['device_busy_ms']:.3f}), host launches "
          f"{r['profile']['host_launches']} (adam "
          f"{r['adam']['host_launches']}), flash launches "
          f"{r['flash_launches_per_step']} a step, host reads "
          f"{r['host_reads_per_step']}, losses {r['losses'][0]:.5f} -> "
          f"{r['losses'][-1]:.5f}", flush=True)
    print(f"bert-base lamb leaf check on {card}:", json.dumps({
        "loss_abs_err_vs_cpu": r["leaf_check"]["loss_abs_err_vs_cpu"]} | {
        part: {k: r["leaf_check"][part][k] for k in
               ("ok", "leaves", "failed", "cpu_share_median",
                "worst_margin")}
        for part in ("weights", "grads")}), flush=True)
    print(f"bert-base lamb checks on {card}:", json.dumps(r["checks"]),
          flush=True)
    for row in surface["zoo"]["rows"]:
        launched = {k: v for k, v in row["launches"].items() if v}
        print(f"optimizer {row['optimizer']} "
              f"{json.dumps(row['options'])} on {card}: max rel err "
              f"{row['max_rel_err']:.3g}, host reads {row['host_reads']}, "
              f"launches {json.dumps(launched)}, ok {row['ok']}",
              flush=True)
    print(f"optimizer sgld on {card}:", json.dumps(surface["zoo"]["sgld"]),
          flush=True)
    data = data_phase(args.seed, card, DATA_DIR)
    rr = data["record_iter"]
    print(f"data pipeline (a) ImageRecordIter on {card}: "
          f"{rr['images_per_s']:.1f} images/s over {rr['images']} images "
          f"({data['threads']} threads, native {rr['native']}), first "
          f"batch {json.dumps(rr['first'])}, one thread "
          f"{json.dumps(rr['one_thread_first'])} at "
          f"{rr['one_thread_images_per_s']:.1f} images/s; a batch's copy "
          f"to the idle card {json.dumps(data['copy'])}", flush=True)
    for name in ("fp32", "bf16"):
        r = data[name]
        print(f"data pipeline (b) resnet50 {name} from the record file on "
              f"{card}: step {r['run']['step_ms']:.3f} ms, "
              f"{r['run']['images_per_s']:.1f} images/s, iterator wait "
              f"{r['run']['iter_wait_ms_per_step']:.3f} ms and copy "
              f"{r['run']['copy_and_wait_ms_per_step']:.3f} ms a step; "
              f"resident batch step {r['resident']['step_ms']:.3f} ms, "
              f"{r['resident']['images_per_s']:.1f} images/s; idle "
              f"{r['profile']['device_idle_share']:.3f} fed, "
              f"{r['resident_profile']['device_idle_share']:.3f} resident, "
              f"profiled memcpy "
              f"{r['profile']['device_ms']['memcpy']:.3f} ms fed, "
              f"{r['resident_profile']['device_ms']['memcpy']:.3f} "
              f"resident; "
              f"{r['launches_per_step']} momentum launches a step",
              flush=True)
    c = data["dataloader"]
    print(f"data pipeline (c) DataLoader on {card}: step "
          f"{c['run']['step_ms']:.3f} ms, {c['run']['images_per_s']:.1f} "
          f"images/s ({c['run']['epoch_images_per_s']:.1f} over the epoch), "
          f"loader wait {c['run']['next_wait_ms_per_step']:.3f} ms a step, "
          f"stage {json.dumps(c['stage'])}, labels match idx "
          f"{c['labels_match_idx']}, resume bitwise {c['resume_bitwise']}",
          flush=True)
    print(f"data pipeline (d) scaling on {card}:",
          json.dumps(data["scaling"]), flush=True)
    print(f"data pipeline leaf check on {card}:",
          json.dumps(data["leaf_check"]), flush=True)
    print(f"data pipeline checks on {card} ({data['seconds']:.1f} s: "
          f"{json.dumps(data['part_seconds'])}):",
          json.dumps(data["checks"]), flush=True)
    surface18 = model_surface_phase(args.seed, card)
    for name, r in surface18["zoo"].items():
        print(f"zoo {name} on {card}: {r['parameters']} parameters, step "
              f"{r['step_ms']:.3f} ms, {r['images_per_s']:.1f} images/s at "
              f"batch {r['batch']} ({r['input']}x{r['input']}), "
              f"{r['launches_per_step']} momentum launches a step "
              f"({r['expected_launches_per_step']} expected), pool bytes "
              f"{json.dumps(r['pool_bytes'])}, losses {r['losses'][0]:.4f} "
              f"-> {r['losses'][-1]:.4f}, peak memory "
              f"{r['peak_memory_gb']:.2f} GB", flush=True)
        print(f"zoo {name} profile on {card}:", json.dumps(
            r["profile"]), flush=True)
        print(f"zoo {name} checks on {card}:", json.dumps(
            {"check": r["check"], **r["checks"]}), flush=True)
    r = surface18["word_lm"]
    print(f"word lm on {card}: {r['parameters']} parameters, window "
          f"{r['window_ms']:.3f} ms, {r['tokens_per_s']:.1f} tokens/s, "
          f"{r['launches_per_window']} sgd launches a window "
          f"({r['expected_launches_per_window']} expected), cuDNN weight "
          f"copies {r['cudnn_weight_copies']}, losses {r['losses'][0]:.4f} "
          f"-> {r['losses'][-1]:.4f}, peak memory "
          f"{r['peak_memory_gb']:.2f} GB", flush=True)
    print(f"word lm profile on {card}:", json.dumps(r["profile"]),
          flush=True)
    print(f"word lm checks on {card}:", json.dumps(
        {"first_window": r["first_window"], **r["checks"]}), flush=True)
    print(f"model surface phase on {card}: {surface18['seconds']:.1f} s",
          json.dumps(surface18["part_seconds"]), flush=True)
    symbolic = symbolic_phase(args.seed, card, Path(args.out), lm_trained)
    del lm_trained
    r = symbolic["encoder_train"]
    print(f"symbolic encoder on {card}: {r['layers']} layers, "
          f"{r['params']} parameters, Module step {r['step_ms']:.3f} ms at "
          f"batch {r['batch']} x {r['seq']}, flash launches "
          f"{r['flash_launches']} ({r['flash_launches_per_forward']} a "
          f"forward), SGD kernel launches {r['sgd_kernel_launches']}, "
          f"losses {r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}",
          flush=True)
    print(f"symbolic encoder leaf check on {card}:", json.dumps(r["check"]),
          flush=True)
    print(f"symbolic encoder profile on {card}:", json.dumps(r["profile"]),
          flush=True)
    for key in ("amp_encoder", "attention_routes", "amp_lm"):
        print(f"symbolic {key} on {card}:", json.dumps(symbolic[key]),
              flush=True)
    for name, r in symbolic["heads"].items():
        print(f"module head {name} on {card}:", json.dumps(r), flush=True)
    print(f"new ops on {card}:", json.dumps(symbolic["new_ops"]),
          flush=True)
    print(f"symbolic phase on {card}: {symbolic['seconds']:.1f} s",
          json.dumps(symbolic["part_seconds"]), flush=True)
    export = export_phase(args.seed, card, Path(args.out))
    r = export["served"]
    print(f"exported resnet50 served on {card}: {r['requests']} requests, "
          f"{r['requests_per_s']:.3f} requests/s, p50 "
          f"{r['latency_ms_p50']:.3f} ms, p99 {r['latency_ms_p99']:.3f} ms, "
          f"{r['batches']} batches over buckets {r['batch_buckets']}, "
          f"vs gluon {r['rel_err']:.3g}", flush=True)
    for key in ("train", "imported", "served", "module", "mlp"):
        print(f"export {key} on {card}:", json.dumps(export[key]),
              flush=True)
    print(f"export checks on {card} ({export['seconds']:.1f} s):",
          json.dumps(export["checks"]), flush=True)
    slice21 = op_slice_phase(args.seed, card)
    r = slice21["ops"]
    print(f"phase 21 ops on {card}: {r['ops']} ops checked in "
          f"{r['cases']} cases ({r['seconds']:.1f} s), failed "
          f"{r['failed']}, worst by family {json.dumps(r['worst_by_family'])}"
          f", gradients {json.dumps(r['worst_grad_by_family'])}",
          flush=True)
    print(f"phase 21 op rows on {card}:", json.dumps(r["rows"]), flush=True)
    r = slice21["draws"]
    print(f"phase 21 draws on {card}: {r['forms']} forms of {r['draws_each']}"
          f" draws ({r['seconds']:.1f} s):", json.dumps(r["checks"]),
          json.dumps(r["moments"]), json.dumps(r["graph"]), flush=True)
    r = slice21["stn"]
    print(f"phase 21 stn + {r['body']} on {card}: batch {r['batch']}, "
          f"losses {r['losses']}, step ms {r['step_ms']}, momentum "
          f"launches {r['launches']} (expected {r['expected_launches']})",
          json.dumps(r["checks"]), flush=True)
    print(f"phase 21 stn check on {card}:", json.dumps(
        {k: r["check"][k] for k in ("loss_abs_err_vs_cpu", "decisions",
                                    "flips", "loc", "ok")}), flush=True)
    r = slice21["gp"]
    print(f"phase 21 gp on {card}: {r['problems']} problems of "
          f"{r['points']} points, card64 dev {r['card64_dev']:.3g}, card32 "
          f"dev {r['card32_dev']:.3g} (limits {GP_TOL64}, {GP_TOL32})",
          json.dumps(r["nll_first_last"]), json.dumps(r["checks"]),
          json.dumps(r["fit_seconds"]), flush=True)
    print(f"phase 21 on {card}: {slice21['seconds']:.1f} s, momentum "
          f"launches {slice21['launches']}, other launches "
          f"{slice21['other_launches']}", flush=True)
    slice22 = slice22_phase(args.seed, card)
    r = slice22["ops"]
    print(f"phase 22 ops on {card}: {r['ops']} ops checked in "
          f"{r['cases']} cases ({r['seconds']:.1f} s), failed "
          f"{r['failed']}, worst by family {json.dumps(r['worst_by_family'])}"
          f", gradients {json.dumps(r['worst_grad_by_family'])}, peak MB "
          f"{json.dumps(r['peak_mb_forward_backward'])}", flush=True)
    print(f"phase 22 op rows on {card}:", json.dumps(r["rows"]), flush=True)
    print(f"phase 22 zipfian on {card}:", json.dumps(slice22["zipf"]),
          flush=True)
    print(f"phase 22 control flow on {card}:",
          json.dumps(slice22["control_flow"]), flush=True)
    r = slice22["rfcn"]
    print(f"phase 22 deformable r-fcn + {r['body']} on {card}: "
          f"{r['size'][0]}x{r['size'][1]}, {r['rois']} rois ({r['sampled']} "
          f"sampled, {r['foreground']} foreground), losses {r['losses']}, "
          f"step ms {r['step_ms']}, momentum launches {r['launches']} "
          f"(expected {r['expected_launches']}), graphs "
          f"{json.dumps({k: r['graphs'][k] for k in ('entries', 'graphs', 'replays')})}",
          json.dumps(r["checks"]), flush=True)
    print(f"phase 22 r-fcn check on {card}:", json.dumps(r["check"]),
          flush=True)
    r = slice22["nmt"]
    print(f"phase 22 rnn nmt on {card}: {r['params']} parameters, step ms "
          f"by bucket {json.dumps(r['step_ms'])}, losses "
          f"{json.dumps(r['losses'])}, sequential "
          f"{json.dumps(r['sequential'])}, monitor {json.dumps(r['monitor'])}"
          f", unfuse max abs err {r['unfuse_max_abs_err']:.3g}, translate "
          f"{json.dumps(r['translate'])}", json.dumps(r["checks"]),
          flush=True)
    print(f"phase 22 nmt check on {card}:", json.dumps(r["check"]),
          flush=True)
    r = slice22["feedforward"]
    print(f"phase 22 feedforward on {card}:", json.dumps(r), flush=True)
    print(f"phase 22 on {card}: {slice22['seconds']:.1f} s "
          f"{json.dumps(slice22['part_seconds'])}, momentum launches "
          f"{slice22['launches']}, other launches "
          f"{slice22['other_launches']}", flush=True)

    obs = observability_phase(args.seed, card, Path(args.out))
    r = obs["front_door"]
    print(f"phase 23 front door on {card}: traced round",
          json.dumps(r["traced_round"]), "trees", json.dumps(r["trees"]),
          "flash", json.dumps(r["flash"]), "bitwise on/off",
          json.dumps(r["bitwise"]), json.dumps(r["bitwise_cost"]),
          flush=True)
    for label, c in r["cost"]["by_setting"].items():
        print(f"phase 23 tracing cost on {card}: {label}: median "
              f"{c['requests_per_s']['median']} requests/s (rounds "
              f"{c['requests_per_s']['values']}), CPU ms a request "
              f"{c['cpu_ms_per_request']['values']}, p50 "
              f"{c['latency_ms_p50']['values']} ms, p99 "
              f"{c['latency_ms_p99']['values']} ms, {c['requests']} requests"
              f" in {c['rounds']} rounds of {OBS_COST_SECONDS} s",
              flush=True)
    print(f"phase 23 tracing cost on {card}:", json.dumps(
        {k: v for k, v in r["cost"].items() if k != "by_setting"}),
        flush=True)
    print(f"phase 23 metrics on {card}:", json.dumps(r["metrics"]),
          json.dumps(r["jsonl"]), "debug", json.dumps(r["debug"]),
          "chrome", json.dumps(r["chrome"]), flush=True)
    print(f"phase 23 slo controller on {card}:",
          json.dumps({k: v for k, v in r["slo"].items()
                      if k != "decisions"}), flush=True)
    print(f"phase 23 watchdog and flight on {card}:",
          json.dumps(obs["watchdog"]), flush=True)
    print(f"phase 23 decode slots on {card}:",
          json.dumps(obs["decode_slots"]), flush=True)
    print(f"phase 23 profiler on {card}:", json.dumps(obs["profiler"]),
          flush=True)
    print(f"phase 23 on {card}: {obs['seconds']:.1f} s "
          f"{json.dumps(obs['part_seconds'])}, checks "
          f"{json.dumps(r['checks'])}", flush=True)
    slice24 = slice24_phase(args.seed, card)
    r = slice24["int8_resnet"]
    print(f"phase 24 int8 resnet50_v1 on {card}: {json.dumps(r['layers'])}, "
          f"calibrated on {r['calibration_images']} images in "
          f"{r['calibrate_s']:.1f} s, forward at batch {r['batch']}: int8 "
          f"{r['int8_forward_ms']:.3f} ms, fp32 {r['fp32_forward_ms']:.3f} "
          f"ms, int8 vs fp32 {json.dumps(r['int8_vs_fp32'])}", flush=True)
    print(f"phase 24 int8 checks on {card}: accumulators "
          f"{json.dumps(r['accumulators'])}, cpu int8 "
          f"{json.dumps(r['cpu_int8'])}, served {r['served']['requests']} "
          f"requests p50 {r['served']['latency_ms_p50']:.3f} ms, "
          f"{r['served']['requests_per_s']:.1f} requests/s, vs eager "
          f"{r['served']['rel_err_vs_eager']:.3g} (bitwise "
          f"{r['served']['bitwise_eager']}), {json.dumps(r['checks'])}",
          flush=True)
    print(f"phase 24 sldwin ops on {card}:", json.dumps(slice24["sldwin"]),
          flush=True)
    r = slice24["longformer"]
    print(f"phase 24 longformer-base on {card}: {r['params']} parameters, "
          f"{r['steps']} Estimator steps at B={LF_BATCH} L={LF['length']}, "
          f"step ms {[round(v, 3) for v in r['step_ms']]}, peak memory GB "
          f"{[round(v, 3) for v in r['peak_memory_gb']]}, momentum launches "
          f"{r['launches']} (expected {r['expected_launches']}), mean loss "
          f"{r['mean_loss']:.5f}, fp64 {json.dumps(r['fp64'])}", flush=True)
    print(f"phase 24 longformer served on {card}: batch "
          f"{r['served']['batch']}, vs eager "
          f"{r['served']['rel_err_vs_eager']:.3g} (bitwise "
          f"{r['served']['bitwise_eager']}), p50 "
          f"{r['served']['latency_ms_p50']:.3f} ms, checks "
          f"{json.dumps(r['checks'])}", flush=True)
    print(f"phase 24 on {card}: {slice24['seconds']:.1f} s "
          f"{json.dumps(slice24['part_seconds'])}", flush=True)
    slice25 = dist25_phase(args.seed, card, Path(args.out))
    for r in slice25["ranks"]:
        d = r["dist_store"]
        print(f"phase 25 rank {r['rank']} gluon.Trainer dist_sync on {card} "
              f"(two ranks sharing one card over gloo, not a scaling "
              f"number): step {d['step_ms']:.3f} ms at {DIST_BATCH} a rank "
              f"({d['images_per_s_per_rank']:.1f} images/s a rank), "
              f"all-reduce of {d['allreduce_bytes']} bytes "
              f"{[round(v, 3) for v in d['allreduce_ms']]} ms, momentum "
              f"launches {d['launches']} ({d['expected_launches_per_step']}"
              f" a step x {d['steps']} steps expected), update_on_kvstore "
              f"at the check step vs local "
              f"{d['update_on_kvstore_vs_local_max_abs']:.3g} max-abs, "
              f"2-bit {json.dumps(d['compression'])}", flush=True)
        for name, v in r["sharded"].items():
            print(f"phase 25 rank {r['rank']} ShardedTrainer {name} on "
                  f"{card} (two ranks sharing one card): step "
                  f"{v['step_ms']:.3f} ms at 128, momentum launches "
                  f"{v['launches']} ({v['expected_launches']} expected), "
                  f"optimizer state {v['opt_state_bytes']} bytes, buckets "
                  f"{v['buckets']}, losses "
                  f"{[round(x, 5) for x in v['losses']]}", flush=True)
        if "leaf_checks" in r:
            print(f"phase 25 leaf checks on {card}:",
                  json.dumps(r["leaf_checks"]), "variants vs zero0",
                  json.dumps(r["variant_vs_zero0_max_abs"]), flush=True)
        print(f"phase 25 rank {r['rank']} checks on {card} "
              f"({r['seconds']:.1f} s):", json.dumps(r["checks"]),
              flush=True)
    o = slice25["one_process"]
    print(f"phase 25 (c) ShardedTrainer dp=1 on {card}: step "
          f"{o['step_ms']:.3f} ms, {o['images_per_s']:.1f} images/s at "
          f"batch {o['batch']}, momentum launches {o['launches']} "
          f"({o['expected_launches']} expected); phase 6's hybridized "
          f"gluon.Trainer step {resnet['step_ms']:.3f} ms, "
          f"{resnet['images_per_s']:.1f} images/s", flush=True)
    print(f"phase 25 on {card}: {slice25['seconds']:.1f} s (ranks "
          f"{slice25['ranks_s']:.1f} s)", flush=True)
    main_row, bf16_row = (next(r for r in rows if r["case"] ==
                               f"bert_base B=8 L=512 {dt}")
                          for dt in ("float32", "bfloat16"))
    def lp_err(mode, dtype, case=None):
        return max(c["max_abs_err"] for c in sgd["checks"]
                   if c["kernel"] == mode and c["dtype"] == dtype
                   and case in (None, c["case"]))

    # each SGD kernel's error at the shapes of its main path
    sgd_err = {"multi_sgd": lp_err("sgd", "float32", "mlp"),
               "multi_sgd_mom": lp_err("sgd_mom", "float32", "resnet50")}

    def timing(t, prefix=""):
        return {f"{prefix}{key}": t[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    def sgd_row(name, replaces, launches, t):
        return {"name": name, "route": "cuda", "source": SGD_SRC,
                "replaces": replaces, "launches": launches,
                "max_abs_err": sgd_err[name], **timing(t),
                "shape": f"{t['tensors']} tensors, {t['elements']} fp32"}

    def zoo_launches(name):
        return sum(r["launches"][name] for r in surface["zoo"]["rows"])

    times = sgd["times"]
    fp16_rows = [r for r in rows if r["dtype"] == "float16"]
    fp16_main = next(r for r in fp16_rows if r["case"] ==
                     "fp16 B=8 L=512 D=64")
    bf16_mlp, mixed = times["multi_sgd_bf16_mlp"], \
        times["multi_mp_sgd_mom_resnet50"]
    kernels = [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU, "launches": serving["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        **timing(main_row), "shape": main_row["case"],
        **{f"bf16_{key}": bf16_row[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "fp16_launches": low["bert_fp16"]["flash_launches_by_dtype"][
            "float16"],
        "fp16_max_abs_err": max(r["max_abs_err"] for r in fp16_rows),
        **timing(fp16_main, "fp16_"),
        "fp16_cases": {r["case"]: {key: r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for r in fp16_rows},
        "train_launches": {mode: bert[mode]["flash_launches"]
                           for mode in ("fp32", "amp_bf16")},
        "train_shape": {r["case"]: {key: r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for r in rows if r["case"].startswith(
                "bert_train")},
        "backward": {r["case"]: {key: r[key] for key in (
            "max_abs_err", "forward_max_abs_err", "fwd_bwd_ms", "bwd_ms",
            "plain_fwd_bwd_ms", "library_fwd_bwd_ms", "bound_ms",
            "bound_by", "bwd_peak_memory_mb", "full_matrix_mb")}
            for r in bert["backward"] + low["backward"] + [nmt_backward]},
        "nmt_train_launches": tr["flash_launches"],
        "under_replay_bitwise_eager": graph["flash"]["ok"],
        "hybridized_launches": {
            "nmt": graph["nmt"]["train"]["flash_launches"],
            **{f"bert_{mode}": r["flash_launches"]
               for mode, r in graph["bert"]["runs"].items()},
            "served_from_graphs": graph["serving"]["runs"]["graphs"][
                "flash_launches"]},
        "nmt_translate_launches": {
            mode: r["flash_launches"]
            for mode, r in nmt["translate"].items()},
        "nmt_shapes": {r["case"]: {key: r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for r in rows if r["case"].startswith("nmt")},
        "lamb_train_launches": surface["bert"]["flash_launches"],
        "symbolic_module_launches": {
            "encoder_fp32": symbolic["encoder_train"]["flash_launches"],
            "amp_bf16_inference": symbolic["amp_encoder"][
                "flash_launches_by_dtype"]["bf16"][str(torch.bfloat16)],
            "attention_routes": symbolic["attention_routes"][
                "flash_launches"],
            "new_ops": symbolic["new_ops"]["flash_launches"]},
        "observability_flash_launches": obs["launches"],
    }, sgd_row("multi_sgd", SGD_TPU, mlp["launches"],
               times["multi_sgd_mlp"])
        | {"optimizer_zoo_launches": zoo_launches("multi_sgd"),
           "word_lm_launches": surface18["word_lm"]["launches"],
           "optimizer_zoo_mixed_launches": zoo_launches("multi_mp_sgd"),
           "bf16_launches": low["mlp_bf16"]["launches"],
           "bf16_max_abs_err": lp_err("sgd", "bfloat16"),
           **timing(bf16_mlp, "bf16_"),
           "fp16_max_abs_err": lp_err("sgd", "float16")},
        sgd_row("multi_sgd_mom", SGD_MOM_TPU, resnet["launches"],
                times["multi_sgd_mom_resnet50"])
        | {"recipe_resume_launches": surface["resnet"]["launches"],
           "vision_zoo_launches": {
               name: r["launches"]
               for name, r in surface18["zoo"].items()},
           "data_pipeline_launches": data["launches"],
           "symbolic_module_launches": {
               "encoder": symbolic["encoder_train"]["sgd_kernel_launches"][
                   "multi_sgd_mom"],
               "heads": sum(r["kernel_launches"] for r in
                            symbolic["heads"].values())},
           "optimizer_zoo_launches": zoo_launches("multi_sgd_mom"),
           "export_launches": export["train"]["launches"],
           "op_slice_launches": slice21["launches"],
           "longformer_launches": slice24["launches"],
           "dist_launches": {f"rank{r['rank']}": r["dist_store"]["launches"]
                             for r in slice25["ranks"]},
           "sharded_launches": {
               **{f"rank{r['rank']}": {k: v["launches"] for k, v in
                                       r["sharded"].items()}
                  for r in slice25["ranks"]},
               "one_process": slice25["one_process"]["launches"]},
           "control_flow_detection_launches": {
               "rfcn": slice22["rfcn"]["launches"],
               "feedforward": slice22["feedforward"]["launches"]},
           "amp_bf16_launches": low["resnet50_amp"]["launches"],
           "imperative_launches": imp["launches"],
           **{f"{name}_launches": det[name]["train"]["launches"]
              for name in ("ssd", "rcnn")},
           **{f"{name}_update": timing(det[name]["update"]) | {
               "shape": f"{det[name]['update']['tensors']} tensors, "
                        f"{det[name]['update']['elements']} fp32",
               "max_abs_err": det[name]["update"]["check"]["max_abs_err"]}
              for name in ("ssd", "rcnn")},
           **{f"{dt}_{key}": value for dt, t in (
               ("bf16", times["multi_sgd_mom_bf16_resnet50"]),
               ("fp16", times["multi_sgd_mom_fp16_resnet50"]))
              for key, value in timing(t).items()},
           "bf16_max_abs_err": lp_err("sgd_mom", "bfloat16"),
           "fp16_max_abs_err": lp_err("sgd_mom", "float16")},
        {"name": "multi_mp_sgd_mom", "route": "cuda", "source": SGD_SRC,
         "replaces": SGD_MOM_TPU,
         "launches": low["resnet50_cast"]["launches"],
         "max_abs_err": max(lp_err(m, dt) for m in ("mp_sgd", "mp_sgd_mom")
                            for dt in ("bfloat16", "float16")),
         **timing(mixed),
         "shape": f"{mixed['tensors']} tensors, {mixed['elements']} bf16 "
                  f"weights with fp32 masters and momenta",
         "optimizer_zoo_launches": zoo_launches("multi_mp_sgd_mom"),
         "before_ms": times["unfused_mixed_resnet50"]["ms"],
         "before_launches_per_update":
             times["unfused_mixed_resnet50"]["launches_per_update"]}]
    timed = rtc_res["softmax"][f"{SOFTMAX_SHAPES[-1][0]}x"
                               f"{SOFTMAX_SHAPES[-1][1]}"]
    for name in ("softmax_fwd", "softmax_bwd"):
        t = timed[name]
        kernels.append({
            "name": f"rtc:{name}", "route": "cuda", "source": RTC_SRC,
            "replaces": RTC_TPU, "launches": custom["launches"][name],
            "max_abs_err": max(rows[name]["max_abs_err"]
                               for rows in rtc_res["softmax"].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": f"timed at {t['shape'][0]}x{t['shape'][1]} fp32; "
                     f"100x10 on the main path",
            "compile_ms": rtc_res["compile_ms"]["softmax"],
            "export_launches": export["mlp"]["rtc_launches"][name],
            "host_us_per_launch":
                rtc_res["host_us_per_launch"]["softmax_fwd_100x10"]})
    elapsed = time.monotonic() - start
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_logs": logs, "sass": sass,
         "multi_sgd_build": sgd_build, "flash": rows,
         "serving": serving, "sgd": sgd, "mlp": mlp, "resnet50": resnet,
         "rtc": rtc_res, "custom_mlp": custom, "bert_train": bert,
         "low_precision": low, "imperative_mlp": imp,
         "nmt": nmt, "lstm_bucketing": lm, "nmt_flash_backward":
             nmt_backward, "detection": det, "graphs": graph,
         "generation": gen, "training_surface": surface,
         "data_pipeline": data, "model_surface": surface18,
         "symbolic": symbolic, "export": export, "op_slice": slice21, "slice22": slice22,
         "observability": obs, "slice24": slice24, "slice25": slice25,
         "kernels": kernels,
         "event_fallbacks": EVENT_FALLBACKS, "elapsed_s": elapsed},
        indent=1))
    print(f"timings by CUDA events where every trace lost records: "
          f"{json.dumps(EVENT_FALLBACKS)}", flush=True)
    failed = [f"sgd kernel checks {sgd['failed']}"] if sgd["failed"] else []
    failed += [f"{name} phase {failed_checks(ph)[:20]}" for name, ph in (
        ("mlp", mlp), ("resnet50", resnet), ("rtc", rtc_res),
        ("custom-op mlp", custom), ("bert train", bert),
        ("low precision", low), ("imperative mlp", imp), ("nmt", nmt),
        ("lstm bucketing", lm), ("nmt flash backward", nmt_backward),
        ("detection", det), ("hybridized graphs", graph),
        ("generation serving", gen), ("training surface", surface),
        ("data pipeline", data), ("model surface", surface18),
        ("symbolic", symbolic), ("export", export), ("op slice", slice21),
        ("control flow and detection", slice22),
        ("observability", obs), ("int8 and longformer", slice24),
        ("data parallel", slice25))
        if not ph["ok"]]
    if failed:
        print(f"chip_smoke: failed: {failed}", file=sys.stderr)
        return 1
    print(f"chip_smoke: every phase passed in {elapsed:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
