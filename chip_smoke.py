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
phase 17, each model of phase 18 and each part of phases 19 and 20) and
read just after;
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
21. prints one JSON line of kernel measurements (flash: the fp32 and, as
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
   ``symbolic_module_launches``, phase 20's under ``export_launches``;
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
from mxnet_tpu_torch.gluon.model_zoo.transformer import (CausalLM, bert_base,
                                                          causal_lm_small)
from mxnet_tpu_torch.gluon.model_zoo import vision as vision_zoo
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
from mxnet_tpu_torch.initializer import Xavier
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
from mxnet_tpu_torch.ndarray import ops_contrib, ops_optimizer
from mxnet_tpu_torch.ndarray.register import get_op, invoke
from mxnet_tpu_torch.kernels.multi_sgd import (multi_mp_sgd,
                                               multi_mp_sgd_mom,
                                               multi_mp_sgd_mom_plain,
                                               multi_mp_sgd_plain, multi_sgd,
                                               multi_sgd_mom,
                                               multi_sgd_mom_plain,
                                               multi_sgd_plain)
from mxnet_tpu_torch.observability import registry
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
            ms=device_ms(kernel, iters, only="flash_fwd_kernel"),
            plain_ms=device_ms(plain, 5),
            library_ms=device_ms(library, iters, kernels=library_kernels),
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
    if not classes["flash_attention"] > 0:
        raise AssertionError(f"profile: no device time in flash_fwd_kernel "
                             f"({classes})")
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


def device_ms(fn, iters: int, attempts: int = 3, only: str = "",
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
    raise AssertionError(f"torch.profiler saw no device time, or partial "
                         f"records, in {attempts} traces of {iters} calls; "
                         f"the last: {seen}")


def launch_ms(fn, n_launches: int, iters: int, only: str,
              attempts: int = 5) -> list:
    """Device time of each of the ``n_launches`` kernel launches (those
    whose name holds ``only``) that one ``fn`` call makes, in launch order,
    averaged over ``iters`` calls after three warm calls: torch.profiler's
    kernel events, ordered by their start on the device.  Each trace
    opens with a small synchronised op (a trace can lose its first kernel
    record); a trace with another number of ``only`` events is taken
    again, up to ``attempts`` times, and then raises."""
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
    raise AssertionError(f"torch.profiler saw {found} {only!r} launches in "
                         f"{iters} calls, not {n_launches * iters}")


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
                           "multi_sgd_kernel")
    row.update(
        per_launch=[{"elements": n, "ms": t,
                     "bound_ms": sgd_bound(n, momentum)[0]}
                    for n, t in zip(elements, per_launch)],
        per_launch_bins=launch_bins(elements, per_launch, momentum),
        ms=device_ms(lambda: kernel(groups), 5, lost=1),
        one_group_ms=device_ms(lambda: kernel(one_group), 5, lost=1),
        one_group_wall_ms=cuda_ms(lambda: kernel(one_group), iters),
        plain_ms=device_ms(plain, 5, lost=1),
        plain_wall_ms=cuda_ms(plain, iters),
        library_ms=device_ms(lib.step, 5, lost=1),
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
    row.update(ms=device_ms(run, 5, lost=1),
               plain_ms=device_ms(lambda: plain(*sgd_args(
                   mode, state, case.g, lrs, wds, rescale, -1.0)), 3,
                   lost=1))
    row["library_ms"] = None
    if not mode.startswith("mp"):
        params = [torch.nn.Parameter(t.clone()) for t in case.w]
        for p, g in zip(params, case.g):
            p.grad = g
        lib = torch.optim.SGD(params, lr=0.1, weight_decay=1e-4, fused=True,
                              momentum=0.9 if mode.endswith("mom") else 0.0)
        row["library_ms"] = device_ms(lib.step, 5, lost=1)
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
    return {"ms": device_ms(run, 5, kernels=kernels, lost=1),
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
    fwd_bwd_ms = device_ms(ours, iters, kernels=launches["ours"],
                           lost=lost)
    # on an H100, traces taken after phases that replayed CUDA graphs
    # lost 2 of these 20 records (bf16, L=512) and 4 (fp32, Lq=48)
    fwd_ms = device_ms(forward, iters, only="flash_fwd_kernel", per_call=1)
    return {
        "case": f"B={b} H={h} L={length} D={d} {_short(dtype)}"
                if lk == length else
                f"B={b} H={h} Lq={length} Lk={lk} D={d} {_short(dtype)}",
        "max_abs_err": err, "tolerance": tol, "ref_max_abs": ref_max,
        "forward_max_abs_err": fwd_err, "forward_tolerance": TOL[dtype],
        "ok": err <= tol and fwd_err <= TOL[dtype],
        "fwd_bwd_ms": fwd_bwd_ms, "fwd_ms": fwd_ms,
        "bwd_ms": fwd_bwd_ms - fwd_ms,
        "plain_fwd_bwd_ms": device_ms(plain, 3, lost=lost),
        # SDPA's cuDNN backward: a trace of 20 fp16 calls read one
        # elementwise kernel 2 records short in 3 traces running
        "library_fwd_bwd_ms": device_ms(library, iters,
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
            "plain_ms": device_ms(lambda: multi_sgd_mom_plain(
                w, case.g, m, lrs, wds, opt["momentum"], rescale), 5,
                attempts=UPDATE_ATTEMPTS, lost=UPDATE_LOST),
            "library_ms": device_ms(lib.step, 5, attempts=UPDATE_ATTEMPTS,
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


def http_json(port: int, method: str, path: str, obj=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        c.request(method, path, body=None if obj is None else
                  json.dumps(obj))
        r = c.getresponse()
        return r.status, json.loads(r.read())
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
    Images are made and encoded on one thread per usable core."""
    from concurrent.futures import ThreadPoolExecutor
    payload = "jpeg" if jpeg else "rawn"
    rec = out_dir / f"phase17_{seed}_{payload}_{n}.rec"
    idx = rec.with_suffix(".idx")
    t0 = time.monotonic()
    made = not (rec.exists() and idx.exists())
    if made:
        out_dir.mkdir(parents=True, exist_ok=True)

        def record(i):
            header = recordio.IRHeader(0, float(i % 1000), i, 0)
            img = phase17_image(seed, i)
            if jpeg:
                return recordio.pack_img(header, img, quality=DATA_QUALITY)
            return recordio.pack(header, recordio._raw_payload(img))

        tmp_rec, tmp_idx = (p.with_suffix(p.suffix + ".tmp")
                            for p in (rec, idx))
        writer = recordio.MXIndexedRecordIO(str(tmp_idx), str(tmp_rec), "w")
        torch_threads = torch.get_num_threads()
        torch.set_num_threads(1)       # one core per image, in parallel
        try:
            with ThreadPoolExecutor(len(os.sched_getaffinity(0))) as pool:
                for i, buf in enumerate(pool.map(record, range(n))):
                    writer.write_idx(i, buf)
        finally:
            torch.set_num_threads(torch_threads)
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


def held_step(make, arg_params, arrays, opt, relu: bool = False) -> dict:
    """The same Module step on the card and on the CPU in fp32 and in
    float64, held leaf by leaf (``leaf_check``) on the gradients and the
    updated weights, the card's outputs within 1e-4 (x max(1, max|out|))
    of the CPU's.  With ``relu`` the CPU runs take the card's ReLU
    decisions (``Decisions``), float64's own at most ``DECISION_FLIPS``
    of them."""
    card = Decisions()
    runs = {"card": module_step(make, gpu(0), torch.float32, arg_params,
                                arrays, opt, card if relu else None)}
    flips = {}
    for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        forced = Decisions(card.masks)
        runs[name] = module_step(make, cpu(), dtype, arg_params, arrays,
                                 opt, forced if relu else None)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/chip_smoke")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    nmt_backward = check_flash_backward(
        torch.Generator().manual_seed(args.seed), NMT_BATCH, NMT_HEADS, 48,
        HEAD_DIM, torch.float32, 20, lk=64, lost=3)
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
         "symbolic": symbolic, "export": export, "kernels": kernels,
         "elapsed_s": elapsed}, indent=1))
    failed = [f"sgd kernel checks {sgd['failed']}"] if sgd["failed"] else []
    failed += [f"{name} phase" for name, ph in (
        ("mlp", mlp), ("resnet50", resnet), ("rtc", rtc_res),
        ("custom-op mlp", custom), ("bert train", bert),
        ("low precision", low), ("imperative mlp", imp), ("nmt", nmt),
        ("lstm bucketing", lm), ("nmt flash backward", nmt_backward),
        ("detection", det), ("hybridized graphs", graph),
        ("generation serving", gen), ("training surface", surface),
        ("data pipeline", data), ("model surface", surface18),
        ("symbolic", symbolic), ("export", export))
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
